"""Prefill under a token budget: a closed loop with one batch in flight
through the port's ``LM.prefill``, every batch of ``tokens_per_batch``
tokens (``generator.py``), the last-position logits read back to the host.

A batch is timed from its tokens on the host to its logits on the host.
Set-up warms every S of the mix twice. A traced run profiles two whole
cycles of the mix after two batches of the window, one a phase
(``trace.Phases``).

``correct``: the logits of a sample of the window's first batches (some
hundreds of rows, the longest S among them), as the window produced them,
against the plain reference over the same tokens and weights, once the
port's state is freed. Each row's error is ||port - reference|| /
||reference|| over the real vocabulary; ``numbers`` reads its mean, its
median and its largest over the sampled rows, the largest of the
batches' upper quartiles, and the greedy gap; the cell's checks file
says which are compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import generator as T
from bench import weights
from bench.drivers._common import (SAMPLE, TOKENS, WARMUP, WEIGHTS, build,
                                   finite, free, mark_setup_done)
from bench.harness import derive_seed, note
from bench.trace import Phases

#: window batches before the traced cycle starts
TRACE_AFTER = 2


def _prefill(run, toks: np.ndarray) -> torch.Tensor:
    st = run.state
    with torch.no_grad(), run.span("prefill"):
        logits = st["model"].prefill(st["params"],
                                     torch.from_numpy(toks).to(run.device))
    return logits.cpu()[:, :run.config["vocab_size"]]


def setup(run) -> None:
    mix, V = run.traffic, run.config["vocab_size"]
    _, model, params = build(run)
    seed = derive_seed(run.seed, TOKENS)
    run.state.update(model=model, params=params,
                     tokens=T.PrefillTokens(mix, seed, V),
                     sample=set(T.prefill_sample(
                         mix, derive_seed(run.seed, SAMPLE))))
    warm = np.random.default_rng(derive_seed(run.seed, WARMUP))
    for S in sorted(set(mix["seq_lens"])):
        for _ in range(2):
            _prefill(run, warm.integers(0, V, size=T.prefill_shape(mix, S),
                                        dtype=np.int32))
    mark_setup_done(run)


def window(run) -> None:
    st = run.state
    gen, sample = st["tokens"], st["sample"]
    phases = Phases(run, TRACE_AFTER, len(gen.order))
    lat, kept = [], {}
    tokens = i = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        phases.before(i)
        toks = gen.next(i)
        a = time.perf_counter()
        out = _prefill(run, toks)
        b = time.perf_counter()
        phases.after(i, toks.shape)
        lat.append(b - a)
        tokens += toks.size
        if i in sample:
            kept[i] = (toks, out)
        i += 1
        if b >= end and phases.done and i > max(sample):
            break
    run.record.update(window_s=b - t0, tokens=tokens, latencies_s=lat,
                      attempted=i, failed=0,
                      traced_shapes=phases.units["device"])
    st["kept"] = kept
    by_s: dict = {}
    for j, t in enumerate(lat):
        by_s.setdefault(gen.order[j % len(gen.order)], []).append(t)
    note("batch ms by S (count, median, p95): " + ", ".join(
        f"{S} {len(v)} {1e3 * np.median(v):.3f} "
        f"{1e3 * np.percentile(v, 95):.3f}" for S, v in sorted(by_s.items())))


def release(run) -> None:
    kept = run.state.pop("kept")
    free(run)
    run.state["kept"] = kept


def row_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Per row of one batch's logits, against the reference's: the error
    ||got - ref|| / ||ref||, and the greedy gap, how far the reference's
    logit of got's first token lies below the reference's best, over the
    reference row's standard deviation."""
    got = got.to(ref.device, torch.float32)
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    pick = ref.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
    gap = (ref.max(-1).values - pick) / ref.std(-1)
    return {"err": err.cpu(), "gap": gap.cpu()}


def numbers(rows: list) -> dict:
    """The numbers over the sampled batches' rows (``rows``: one
    ``row_numbers`` a batch). Half of a batch's rows wrong moves the mean
    and that batch's upper quartile, whatever the batch's size."""
    err = torch.cat([r["err"] for r in rows])
    return {"logit_err_mean": finite(float(err.mean())),
            "logit_err_median": finite(float(err.quantile(0.5))),
            "logit_err_max": finite(float(err.max())),
            "batch_err_q75_max": finite(max(float(r["err"].quantile(0.75))
                                            for r in rows)),
            "greedy_gap_max": finite(float(torch.cat(
                [r["gap"] for r in rows]).max()))}


def judge(run) -> dict:
    from bench.reference.lm import prefill_logits
    w = weights.make(run.config, derive_seed(run.seed, WEIGHTS), run.device)
    rows, refs, drops = [], [], []
    for i, (toks, out) in sorted(run.state["kept"].items()):
        ref = prefill_logits(run.config, w,
                             torch.from_numpy(toks).to(run.device),
                             drops=drops)
        rows.append(row_numbers(out, ref))
        refs.append(ref.cpu())
    del w
    run.state["refs"] = refs
    run.record["rows_checked"] = sum(len(r["err"]) for r in rows)
    if drops:
        layers = len(drops) // len(refs)
        tokens = sum(t.size for t, _ in run.state["kept"].values())
        run.record["dropped_share"] = sum(drops) / (
            int(run.config["num_experts_per_tok"]) * layers * tokens)
        note(f"reference: share of expert assignments capacity drops "
             f"{run.record['dropped_share']!r}")
    note(f"rows checked {run.record['rows_checked']}")
    return numbers(rows)
