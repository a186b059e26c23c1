"""Readings of the numbers that decide a cell's ``correct``, from which its
limits are set (``checks/<workload>.json``):

  * the program's, on each of ``--seeds``: the cell's own set-up and
    window path at the cell's size (a window of no length: the sample of a
    prefill cell and the checked steps of a training cell are those of a
    run), judged as a run judges them;
  * the control's, on each of ``--control-seeds``: the plain reference in
    fp8 (``reference/lm.py``), put in the program's place on the same
    inputs and judged against the float32 reference;
  * on the control seeds, faults. A training cell's are planted in the
    reference put in the program's place: half of each batch left out
    (the mean over the rest), and one token of each batch altered; a step
    that returns its state unchanged reads 1 on ``change_norm_gap`` by its
    definition and needs no run. A prefill cell's are planted in what the
    program's window produced: half of each batch's rows answered with
    the other half's logits, and one answer altered (the first sampled
    row's first logit set above the row's best, so that its greedy token
    changes).

From the root of a checkout, on the card:

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--out chiprun_out/control.jsonl]

Each reading is a JSON line; the last line sums them up: each number's
lower reading (the largest over the program's seeds), the control's and
each fault's least, and the upper reading: the control's least where it
is three times the lower or more, and for a training cell the least of
that and of each fault that reads ten times the lower or more.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_run(root: Path, workload: str, seed: int, device: str):
    """A run of the cell on ``seed`` up to its judgement, without a
    window's length; returns it."""
    import torch
    from bench.harness import Run, cell_files, load_manifest
    files = cell_files(root, load_manifest(root), workload, False)
    run = Run(Path(root), workload, seed, 0.0, False, torch.device(device),
              files, time.perf_counter())
    files.driver.setup(run)
    files.driver.window(run)
    files.driver.release(run)
    run.record["numbers"] = files.driver.judge(run)
    return run


def control_prefill(run, fault: str) -> dict:
    """The fp8 reference on the run's sampled batches ("fp8"), or the
    program's own answers with a fault ("half_batch", "answer_altered"),
    against the float32 reference's logits."""
    import torch
    from bench import weights
    from bench.drivers._common import WEIGHTS
    from bench.drivers.prefill import numbers, row_numbers
    from bench.harness import derive_seed
    from bench.reference.lm import prefill_logits
    kept = sorted(run.state["kept"].items())
    w = weights.make(run.config, derive_seed(run.seed, WEIGHTS),
                     run.device) if fault == "fp8" else None
    rows = []
    for j, ((i, (toks, out)), ref) in enumerate(zip(kept,
                                                    run.state["refs"])):
        if fault == "fp8":
            got = prefill_logits(run.config, w,
                                 torch.from_numpy(toks).to(run.device), "fp8")
        elif fault == "half_batch":
            h = max(1, out.shape[0] // 2)
            got = torch.cat([out[:h], out[:h]])[:out.shape[0]]
        else:
            got = out.clone()
            if j == 0:
                got[0, 0] = got[0].max() + 1.0
        rows.append(row_numbers(got, ref.to(run.device)))
    return numbers(rows)


def control_train(run, fault: str) -> dict:
    """The reference put in the program's place, in fp8 ("fp8") or in
    float32 with a fault ("half_batch", "token_altered"), against the
    float32 reference's readings."""
    from bench.drivers._common import WEIGHTS
    from bench.drivers.train import _batch, numbers, optimizer
    from bench.harness import derive_seed
    from bench.reference.lm import train
    n = int(run.traffic["checked_steps"])
    batches = [_batch(run, s).to(run.device) for s in range(n)]
    prec = "fp8" if fault == "fp8" else "fp32"
    if fault == "half_batch":
        batches = [b[: b.shape[0] // 2] for b in batches]
    elif fault == "token_altered":
        V = run.config["vocab_size"]
        batches = [b.clone() for b in batches]
        for b in batches:
            b[0, b.shape[1] // 2] = (b[0, b.shape[1] // 2] + 1) % V
    got = train(run.config, derive_seed(run.seed, WEIGHTS), batches,
                optimizer(run), prec, run.device)
    return numbers(got, run.record["reference"])


def readings(root: Path, workload: str, seeds, control_seeds,
             device: str = "cuda", emit=print) -> dict:
    import gc
    import torch
    out = {"program": [], "control": [], "faults": {}, "train": False}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        run = program_run(root, workload, seed, device)
        out["train"] = run.traffic["driver"] == "train"
        got = run.record["numbers"]
        rows = []
        if seed in seeds:
            out["program"].append(got)
            rows.append(("program", got))
        if seed in control_seeds:
            for fault in ("fp8", "half_batch", "token_altered"
                          if out["train"] else "answer_altered"):
                r = (control_train(run, fault) if out["train"]
                     else control_prefill(run, fault))
                if fault == "fp8":
                    out["control"].append(r)
                else:
                    out["faults"].setdefault(fault, []).append(r)
                rows.append((fault, r))
        extra = {k: run.record[k] for k in ("dropped_share",)
                 if k in run.record}
        for kind, r in rows:
            emit(json.dumps({"workload": workload, "seed": seed,
                             "kind": kind, "numbers": r, **extra,
                             "seconds": time.perf_counter() - t0}))
        del run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(out: dict, train: bool) -> dict:
    """Each number's lower reading, the control's and each fault's least,
    and the upper reading (the module's docstring)."""
    res = {}
    for name in out["program"][0]:
        lower = max(r[name] for r in out["program"])
        ctl = min(r[name] for r in out["control"]) if out["control"] \
            else None
        faults = {f: min(r[name] for r in rs)
                  for f, rs in out["faults"].items()}
        cands = [ctl] if ctl is not None and ctl >= 3 * lower else []
        if train:
            cands += [v for v in faults.values() if v >= 10 * lower]
        res[name] = {"lower": lower, "control": ctl, "faults": faults,
                     "upper": min(cands) if cands else None}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        out = readings(ROOT, args.workload, seeds, cseeds, "cuda", emit)
        emit(json.dumps({"workload": args.workload,
                         "summary": summary(out, out["train"])}))
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
