"""Batched serving engine: continuous batching over a fixed slot pool.

Port of ``repro.serve.engine``. Requests enter a queue; each decode step
runs the whole slot batch (one token per live slot) through
``LM.decode_step``. Finished or empty slots are refilled from the queue
between steps. A prompt is prefilled token by token through the same
``decode_step``, as the reference does.

Admission control and backpressure, as in the reference: a bounded
submit queue rejects overflow with ``EngineBusy``; per-request
wall-clock deadlines fail slow requests individually; transient
``EngineFault``s (the ``serve.prefill`` / ``serve.decode`` injection
sites) are retried with deterministic jittered backoff before the
affected requests are failed. The engine itself never dies.

The model runs where its params are (the card in a deployment, the CPU
in the tests). ``decode_step`` is a plain call and updates the cache in
place; the ``serve.decode`` site fires before it, so a retry after an
injected fault runs on unchanged state, and a rerun of a step that
failed part-way writes the same KV rows.

Recurrent state (the mamba layers' conv and SSM states) differs from KV
rows: every slot that a step runs is advanced, and a slot's state holds
everything the slot has seen. So, unlike the reference (ROADMAP C9), the
engine zeroes a slot's recurrent state when it starts to feed a prompt
into it, and a prompt-feed step, which runs filler tokens in every
other slot, leaves the other slots' recurrent state as it found it: it
copies their rows of the recurrent leaves before the step and writes
them back after. Each request then gets the tokens it would get alone,
where an MoE layer's capacity drops nothing (the slots of a step still
compete for expert capacity, ROADMAP C7 and C8). A model of attention
layers only has no recurrent leaves and copies nothing.
"""
from __future__ import annotations

import collections
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import faults as _faults
from ..core.faults import EngineBusy, EngineFault  # noqa: F401


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set when the request failed alone
    #: wall-clock budget from submission; None inherits the engine
    #: default.  Expiry fails THIS request individually.
    deadline_ms: Optional[float] = None
    _deadline_t: Optional[float] = field(default=None, repr=False)


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 8,
                 max_seq: int = 512,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 retries: int = 2, backoff_ms: float = 0.5,
                 seed: int = 0) -> None:
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_seq = max_seq
        self.max_queue = max_queue       # None = unbounded
        self.deadline_ms = deadline_ms   # default per-request deadline
        self.retries = retries
        self.backoff_ms = backoff_ms
        self._rng = random.Random(seed)  # jitter stays deterministic
        self.queue: "collections.deque[Request]" = collections.deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = model.init_cache(slots, max_seq, device=self.device)
        self._recurrent = model.recurrent_state(self.cache)
        self.pos = np.zeros((slots,), np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
        self.telemetry: Dict[str, int] = collections.defaultdict(int)

    def _decode(self, toks: np.ndarray, pos: np.ndarray):
        """One ``decode_step`` of the slot batch; copies the host arrays
        to the model's device."""
        return self.model.decode_step(
            self.params, self.cache,
            torch.tensor(toks, dtype=torch.long, device=self.device),
            torch.tensor(pos, dtype=torch.long, device=self.device))

    def submit(self, req: Request) -> None:
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.telemetry["busy_rejections"] += 1
            raise EngineBusy(
                f"submit queue full ({len(self.queue)}/{self.max_queue}"
                f"); retry after the engine drains")
        if req.deadline_ms is None:
            req.deadline_ms = self.deadline_ms
        if req.deadline_ms is not None:
            req._deadline_t = time.perf_counter() + req.deadline_ms * 1e-3
        self.queue.append(req)

    def _retry(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn``, retrying transient EngineFaults with jittered
        exponential backoff; the last failure propagates to the caller,
        which fails the affected request(s) individually."""
        delay = self.backoff_ms * 1e-3
        attempt = 0
        while True:
            try:
                return fn()
            except EngineFault:
                if attempt >= self.retries:
                    self.telemetry["retry_exhausted"] += 1
                    raise
                attempt += 1
                self.telemetry["transient_retries"] += 1
                time.sleep(delay * (0.5 + self._rng.random()))
                delay *= 2

    def _free(self, s: int) -> None:
        self.active[s] = None
        self.pos[s] = 0
        self.last_tok[s] = 0

    def _fail(self, s: int, req: Request, e: BaseException) -> None:
        """Request isolation: a failing request is marked failed with
        its error, its slot is freed, and the batch continues."""
        req.error = f"{type(e).__name__}: {e}"
        req.done = True
        self._free(s)

    def _expired(self, req: Request) -> bool:
        return (req._deadline_t is not None
                and time.perf_counter() >= req._deadline_t)

    def _expire(self, s: Optional[int], req: Request) -> None:
        self.telemetry["deadline_failures"] += 1
        req.error = (f"DeadlineExceeded: request {req.rid} exceeded its "
                     f"{req.deadline_ms:.3g} ms deadline")
        req.done = True
        if s is not None:
            self._free(s)

    def _prefill(self, s: int, req: Request) -> None:
        if _faults.ACTIVE:
            _faults.maybe_fault("serve.prefill")
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)} tokens) "
                f"+ max_new ({req.max_new}) exceeds max_seq "
                f"({self.max_seq})")
        # feed all but the last prompt token through decode_step;
        # step() feeds the last one and samples the first new token.
        # Restarting from pos 0 with a zero recurrent state rewrites the
        # same KV rows and states, so a retry after a mid-prefill
        # transient is idempotent.
        self.pos[s] = 0
        for t in self._recurrent:
            t[:, s].zero_()
        others = torch.tensor([o for o in range(self.slots) if o != s],
                              dtype=torch.long, device=self.device
                              ) if self._recurrent else None
        for t in req.prompt[:-1]:
            tok = np.zeros((self.slots, 1), np.int32)
            tok[s, 0] = int(t)
            kept = [r[:, others] for r in self._recurrent]
            try:
                self._decode(tok, self.pos)
            finally:
                for r, k in zip(self._recurrent, kept):
                    r[:, others] = k
            self.pos[s] += 1
        self.last_tok[s] = int(req.prompt[-1])

    def _admit(self) -> None:
        for s in range(self.slots):
            while self.active[s] is None and self.queue:
                req = self.queue.popleft()
                if self._expired(req):
                    # expired while queued: fail it without ever
                    # occupying the slot, keep filling
                    self._expire(None, req)
                    continue
                self.active[s] = req
                try:
                    self._retry(lambda: self._prefill(s, req))
                except Exception as e:
                    self._fail(s, req, e)

    def step(self) -> int:
        """One continuous-batching decode step; returns #live slots."""
        self._admit()
        # deadline sweep: slow requests fail alone, their slots free up
        for s in range(self.slots):
            req = self.active[s]
            if req is not None and self._expired(req):
                self._expire(s, req)
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0

        def _decode_batch():
            if _faults.ACTIVE:
                _faults.maybe_fault("serve.decode")
            return self._decode(self.last_tok.reshape(-1, 1), self.pos)

        try:
            logits, self.cache = self._retry(_decode_batch)
        except EngineFault as e:
            # a persistent decode failure poisons only this step's
            # batch: its requests fail individually, the engine (and
            # the queue behind it) lives on
            for s in live:
                self._fail(s, self.active[s], e)
            return len(live)
        nxt = logits[:, 0, :].argmax(-1).to(torch.int32).cpu().numpy()
        for s in live:
            req = self.active[s]
            assert req is not None
            try:
                req.out.append(int(nxt[s]))
                self.last_tok[s] = nxt[s]
                self.pos[s] += 1
                if (len(req.out) >= req.max_new
                        or self.pos[s] >= self.max_seq - 1):
                    req.done = True
                    self.active[s] = None
            except Exception as e:
                self._fail(s, req, e)
        return len(live)

    def run_until_drained(self, max_steps: int = 10_000,
                          fail_stragglers: bool = False) -> None:
        """Step until every request terminates. On ``max_steps``
        exhaustion: ``fail_stragglers=True`` fails every still-live or
        still-queued request individually (error set, done=True) and
        returns; the default raises, naming the live requests."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
        if fail_stragglers:
            for s in range(self.slots):
                req = self.active[s]
                if req is not None:
                    self.telemetry["straggler_failures"] += 1
                    self._fail(s, req, RuntimeError(
                        f"straggler: not drained after {max_steps} "
                        f"steps"))
            while self.queue:
                req = self.queue.popleft()
                self.telemetry["straggler_failures"] += 1
                req.error = (f"RuntimeError: straggler: still queued "
                             f"after {max_steps} steps")
                req.done = True
            return
        live = [req.rid for req in self.active if req is not None]
        raise RuntimeError(
            f"run_until_drained: not drained after {max_steps} steps "
            f"(live requests: {live}, queued: {len(self.queue)})")
