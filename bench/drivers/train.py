"""Training steps of the port's train step (``build_train_step``, the step
``train_loop`` runs) on the benchmark's copy of the synthetic batches,
one loss read on the host a step.

Set-up builds the step, its params (the benchmark's weights from the
seed) and AdamW's state once, and drives that same object through the
mix's ``checked_steps`` first steps (data steps 0, 1, ...), which are its
warm-up; the window goes on from there with the same object. A traced
run profiles six steps after the window's first, three a phase
(``trace.Phases``).

``correct``: the plain reference follows the checked steps from the same
weights and batches, once the port's state is freed (two steps, so that
it takes less time than the window), and ``judge`` reads four numbers;
the cell's checks file says which are compared:

  * ``first_loss_gap``: |port - reference| / reference of the first
    step's loss; ``loss_gap``: the largest of it over the checked steps
    (the second step's loss, after AdamW's first step at the peak lr,
    lies on a slope that differs from seed to seed and swings with it);
  * ``grad_norm_gap``: the first gradient as the optimizer took it (the
    port's, worked out from its first moment after step 1: m / (1 - b1)),
    by the worst leaf: |norm(port) - norm(reference)| over the
    reference's norm of that leaf or of the median leaf, the larger;
  * ``change_norm_gap``: the params' change over the checked steps, read
    before the next step changes them, by the worst leaf, as above;
    leaves whose first gradient in the reference is under a thousandth of
    the median leaf's (moved by round-off alone) are left out.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from bench import generator as T
from bench import weights
from bench.drivers._common import (TOKENS, WEIGHTS, build, finite, free,
                                   mark_setup_done)
from bench.harness import derive_seed, note
from bench.trace import Phases

#: window steps before the traced ones; traced steps
TRACE_AFTER, TRACED = 1, 3
#: elements of a leaf compared at once
SLICE = 1 << 26


def optimizer(run) -> dict:
    return dict(run.config["assumed"]["optimizer"])


def _batch(run, s: int) -> torch.Tensor:
    toks = T.train_batch(run.traffic, derive_seed(run.seed, TOKENS), s,
                         run.config["vocab_size"])["tokens"]
    return torch.from_numpy(toks)


def _step(run, s: int) -> float:
    st = run.state
    batch = {"tokens": _batch(run, s).to(run.device)}
    with run.span("step"):
        st["params"], st["opt"], metrics = st["step"](st["params"], st["opt"],
                                                      batch)
    st["metrics"] = metrics
    return float(metrics["loss"])


def _change_norm(p: torch.Tensor, p0: torch.Tensor) -> float:
    a, b = p.reshape(-1), p0.reshape(-1)
    sq = 0.0
    for i in range(0, a.numel(), SLICE):
        sq += float(((a[i:i + SLICE].float() - b[i:i + SLICE].float())
                     ** 2).sum())
    return sq ** 0.5


def setup(run) -> None:
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, build_train_step
    o = optimizer(run)
    if o["param_dtype"] != "bfloat16":
        raise ValueError(f"param dtype {o['param_dtype']}")
    opt = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"],
                      grad_clip=o["grad_clip"],
                      state_dtype=getattr(torch, o["state_dtype"]),
                      warmup_steps=o["warmup_steps"])
    _, model, params = build(run)
    run.state.update(
        model=model, params=params, opt=init_opt_state(params, opt),
        step=build_train_step(model, StepConfig(
            remat=bool(run.traffic["remat"]), opt=opt)))
    losses = []
    for s in range(int(run.traffic["checked_steps"])):
        losses.append(_step(run, s))
        if s == 0:
            run.record["global_grad_norm"] = float(
                run.state["metrics"]["grad_norm"])
            m = weights.named_leaves(run.state["opt"]["m"], run.config)
            run.record["grad_norms"] = {
                n: float(t.float().norm()) / (1 - o["b1"]) for n, t in m}
    start = weights.make(run.config, derive_seed(run.seed, WEIGHTS),
                         run.device)
    run.record["change_norms"] = {
        n: _change_norm(p, weights.get(start, path))
        for (n, p), (path, _, _, _) in zip(
            weights.named_leaves(run.state["params"], run.config),
            weights.leaf_table(run.config))}
    del start
    run.record["losses"] = losses
    mark_setup_done(run)


def window(run) -> None:
    s = int(run.traffic["checked_steps"])
    phases = Phases(run, TRACE_AFTER, TRACED)
    n = failed = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        phases.before(n)
        loss = _step(run, s)
        t = time.perf_counter()
        phases.after(n, s)
        s, n = s + 1, n + 1
        failed += not math.isfinite(loss)
        if t >= end and phases.done:
            break
    mix = run.traffic
    run.record.update(window_s=t - t0, attempted=n, failed=failed,
                      tokens=n * int(mix["global_batch"]) * int(mix["seq_len"]),
                      traced_steps=phases.units["device"])


def release(run) -> None:
    free(run)


def _gap(got: dict, want: dict, names) -> float:
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in names)


def numbers(got: dict, ref: dict) -> dict:
    """The numbers of a run's readings against the reference's (the
    module's docstring)."""
    names = list(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moved = [k for k in names if ref["grad_norms"][k] >= 1e-3 * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                ref["losses"])]
    return {"first_loss_gap": finite(gaps[0]), "loss_gap": finite(max(gaps)),
            "grad_norm_gap": finite(_gap(got["grad_norms"],
                                         ref["grad_norms"], names)),
            "change_norm_gap": finite(_gap(got["change_norms"],
                                           ref["change_norms"], moved))}


def judge(run) -> dict:
    from bench.reference.lm import train
    n = int(run.traffic["checked_steps"])
    batches = [_batch(run, s).to(run.device) for s in range(n)]
    ref = train(run.config, derive_seed(run.seed, WEIGHTS), batches,
                optimizer(run), "fp32", run.device)
    run.record["reference"] = ref
    note(f"global grad norm {run.record['global_grad_norm']!r} reference "
         f"{ref['global_grad_norm']!r}; losses {run.record['losses']!r} "
         f"reference {ref['losses']!r}")
    for key in ("grad_norms", "change_norms"):
        note(f"{key} by leaf (port, reference): " + ", ".join(
            f"{n} {run.record[key][n]:.6g} {ref[key][n]:.6g}"
            for n in ref[key]))
    return numbers(run.record, ref)
