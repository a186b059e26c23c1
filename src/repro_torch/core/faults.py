"""Fault taxonomy and deterministic, site-addressable fault injection.

Port of the part of ``repro.core.faults`` that the serve engine uses:
``EngineFault`` (an internal, transient failure: the engine retries it),
``EngineBusy`` (admission backpressure), and the injection harness with
the ``serve.prefill`` and ``serve.decode`` sites. The executor rungs and
the sites scoped to them wait for the port's Runtime (ROADMAP A3).

Arming is deterministic per seed::

    with faults.inject("serve.decode", prob=1.0, seed=0):
        engine.step()
"""
from __future__ import annotations

import fnmatch
import random
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional


class EngineFault(RuntimeError):
    """Internal, transient failure: retried, never a result."""

    def __init__(self, msg: str, *, site: Optional[str] = None) -> None:
        super().__init__(msg)
        self.site = site


class InjectedFault(EngineFault):
    """An ``EngineFault`` raised by the injection harness itself."""


class EngineBusy(RuntimeError):
    """Admission control backpressure: a bounded submit queue is full.
    Raised before any work starts, so the caller can shed load or retry."""


#: site name -> description
SITES: Dict[str, str] = {}


def register_site(name: str, desc: str) -> None:
    SITES[name] = desc


register_site("serve.prefill", "serve-engine prompt prefill")
register_site("serve.decode", "serve-engine batched decode step, before "
              "any cache write")

#: hot-path guard: callers check this one module attribute before calling
#: maybe_fault, so an unarmed process pays a single attribute read
ACTIVE = False


class _Injection:
    __slots__ = ("pattern", "prob", "seed", "rng", "hits", "fired")

    def __init__(self, pattern: str, prob: float, seed: int) -> None:
        self.pattern = pattern
        self.prob = float(prob)
        self.seed = int(seed)
        self.rng = random.Random(int(seed))
        self.hits = 0       # matching site executions observed
        self.fired = 0      # faults actually raised


_INJECTIONS: List[_Injection] = []


def _sync_active() -> None:
    global ACTIVE
    ACTIVE = bool(_INJECTIONS)


def maybe_fault(site: str) -> None:
    """Raise InjectedFault if an armed injection matches ``site``. Each
    injection draws from its own seeded RNG in execution order."""
    for inj in _INJECTIONS:
        if not fnmatch.fnmatchcase(site, inj.pattern):
            continue
        inj.hits += 1
        if inj.prob >= 1.0 or inj.rng.random() < inj.prob:
            inj.fired += 1
            raise InjectedFault(
                f"injected fault at site {site!r} (hit {inj.hits}, "
                f"seed {inj.seed})", site=site)


@contextmanager
def inject(site: str, prob: float = 1.0,
           seed: int = 0) -> Iterator[_Injection]:
    """Arm one injection for the dynamic extent of the block. ``site`` may
    be an fnmatch pattern."""
    if "*" not in site and "?" not in site and site not in SITES:
        raise ValueError(f"unknown fault site {site!r} "
                         f"(known: {sorted(SITES)})")
    inj = _Injection(site, prob, seed)
    _INJECTIONS.append(inj)
    _sync_active()
    try:
        yield inj
    finally:
        _INJECTIONS.remove(inj)
        _sync_active()


def clear() -> None:
    """Disarm every injection."""
    del _INJECTIONS[:]
    _sync_active()
