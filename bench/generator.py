"""The one generator of the benchmark's traffic. A mix is a data file
(``traffic/<mix>.json``); its ``driver`` says which loop serves it, and
the functions here read the rest.

Prefill mixes (``driver`` "prefill"): a closed loop with one batch in
flight (``loop`` "closed", ``in_flight`` 1: the only loop the prefill
driver has); every batch holds ``tokens_per_batch`` tokens, B =
tokens_per_batch / S rows of S tokens, S drawn from ``seq_lens`` at
``shares``. So that every seed sends the same work, one cycle of
``cycle`` batches holds each S exactly its share, and a seed only orders
the cycle (the same order every cycle) and draws the token ids, uniform
over the vocabulary.

Training mixes (``driver`` "train"): the port's synthetic batches, copied
from ``repro_torch/train/data.py`` (a copy, not an import): step s's batch
is a pure function of (seed, s), Zipf-distributed ids with copy motifs.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def prefill_cycle(mix: dict, seed: int) -> List[int]:
    """One cycle's sequence lengths in the seed's order."""
    lens, shares, n = mix["seq_lens"], mix["shares"], int(mix["cycle"])
    counts = [round(s * n) for s in shares]
    if sum(counts) != n or any(abs(c - s * n) > 1e-9
                               for c, s in zip(counts, shares)):
        raise ValueError(f"shares {shares} do not divide a cycle of {n}")
    for S in lens:
        if mix["tokens_per_batch"] % S:
            raise ValueError(f"S {S} does not divide tokens_per_batch")
    cycle = [S for S, c in zip(lens, counts) for _ in range(c)]
    rng = np.random.default_rng(seed)
    return [cycle[i] for i in rng.permutation(n)]


def prefill_shape(mix: dict, S: int) -> tuple:
    return (mix["tokens_per_batch"] // S, S)


class PrefillTokens:
    """Batch i's token ids (B, S) int32: uniform over ``vocab``, one
    generator from the seed drawn in batch order."""

    def __init__(self, mix: dict, seed: int, vocab: int) -> None:
        if mix.get("token_ids", "uniform") != "uniform":
            raise ValueError(f"token ids {mix['token_ids']!r}")
        if (mix["loop"], mix["in_flight"]) != ("closed", 1):
            raise ValueError(f"loop {mix['loop']!r} with {mix['in_flight']!r}"
                             " in flight: the prefill driver runs a closed "
                             "loop with one batch in flight")
        self.mix, self.vocab = mix, vocab
        self.order = prefill_cycle(mix, seed)
        self.rng = np.random.default_rng([seed, 1])

    def next(self, i: int) -> np.ndarray:
        S = self.order[i % len(self.order)]
        return self.rng.integers(0, self.vocab, size=prefill_shape(self.mix, S),
                                 dtype=np.int32)


def prefill_sample(mix: dict, seed: int) -> List[int]:
    """The batches whose answers are checked: ``sample_batches`` of the
    window's first ``sample_of`` batches, drawn from the seed, the first
    batch of the longest S among them."""
    n, k = int(mix["sample_of"]), int(mix["sample_batches"])
    order = prefill_cycle(mix, seed)
    longest = order.index(max(order))
    if not 1 <= k <= n or longest >= n:
        raise ValueError(f"{k} sampled batches of the first {n}, the "
                         f"longest S at batch {longest}")
    rest = [i for i in range(n) if i != longest]
    rng = np.random.default_rng([seed, 2])
    return sorted([longest] + [int(i) for i in rng.choice(rest, size=k - 1,
                                                          replace=False)])


# --------------------------------------------------------------------------
# training: a copy of the port's synthetic batches
# --------------------------------------------------------------------------

def train_batch(mix: dict, seed: int, step: int, vocab: int
                ) -> Dict[str, np.ndarray]:
    """The global batch of ``step``: (global_batch, seq_len) int32."""
    if mix.get("tokens", "zipf_motifs") != "zipf_motifs":
        raise ValueError(f"tokens {mix['tokens']!r}")
    rng = np.random.default_rng((seed, step))
    B, S, V = int(mix["global_batch"]), int(mix["seq_len"]), vocab
    ranks = np.arange(1, V + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(V, size=(B, S), p=probs).astype(np.int32)
    m = int(mix["motif_len"])
    spans = rng.integers(0, 2, size=(B, S // (2 * m)))
    for b in range(B):
        for j, on in enumerate(spans[b]):
            if on:
                lo = j * 2 * m + m
                toks[b, lo:lo + m] = toks[b, lo - m:lo]
    return {"tokens": toks}
