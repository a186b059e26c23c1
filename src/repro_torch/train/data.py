"""Deterministic synthetic data pipeline.

A copy of ``repro.train.data`` (numpy only): the port imports nothing
of the reference.

Properties needed at scale and reproduced here:
  * **stateless addressing**: batch b of step s is a pure function of
    (seed, step) — any host can produce exactly its shard, restarts
    resume mid-epoch without coordination (the iterator state in the
    checkpoint manifest is just the step counter);
  * **host sharding**: ``host_slice`` yields only this host's rows;
  * **prefetch**: a background thread keeps ``depth`` batches ready
    (straggler smoothing on the input side).

The token stream is a mixture of Zipf-distributed ids with short
copy-motifs, which gives the ~100M-model example a learnable signal
(loss drops well below the uniform entropy floor).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0
    motif_len: int = 8


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full global batch for `step` (pure function)."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    # Zipf-ish marginal
    ranks = np.arange(1, V + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(V, size=(B, S), p=probs).astype(np.int32)
    # plant copy motifs: x[t] = x[t - motif_len] on motif spans
    m = cfg.motif_len
    spans = rng.integers(0, 2, size=(B, S // (2 * m)))
    for b in range(B):
        for j, on in enumerate(spans[b]):
            if on:
                lo = j * 2 * m + m
                toks[b, lo:lo + m] = toks[b, lo - m:lo]
    return {"tokens": toks}


def host_slice(cfg: DataConfig, batch: Dict[str, np.ndarray]
               ) -> Dict[str, np.ndarray]:
    per = cfg.global_batch // cfg.n_hosts
    lo = cfg.host_id * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of synthetic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 depth: int = 2) -> None:
        self.cfg = cfg
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = host_slice(self.cfg, synthetic_batch(self.cfg, s))
            try:
                self.q.put((s, batch), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self) -> None:
        self._stop.set()
