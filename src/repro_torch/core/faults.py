"""Fault taxonomy + deterministic, site-addressable fault injection.

A copy of the reference's module (``repro.core.faults``) with the codegen
rung's sites renamed: the port's top rung is the torch rung
(``core/backends/torchgen.py``), so its sites are ``torch.trace``,
``torch.exec`` and ``torch.cache.load`` and ``DEMOTABLE`` names
``"torch"``.  The serve engine's ``serve.prefill`` and ``serve.decode``
sites are unscoped, as in the reference.

Two error families split the launch stack's failure modes (the
degradation contract lives in ``core/runtime.py``, see
docs/robustness.md):

  * ``KernelFault`` — SEMANTIC errors of the kernel itself (OOB store,
    trap, barrier divergence, out of fuel).  Deterministic: every
    executor must raise the same class on the same launch, and the
    conformance suite holds them to it.  Surfaced to the caller.
  * ``EngineFault`` — INTERNAL errors of a fast path (an unexpected
    exception inside a batched/grid executor, a licence found invalid
    at run time, a corrupt plan).  Never the kernel's fault: the
    runtime retries the launch one executor rung down instead of
    surfacing it.

Injection sites are the second half of the contract: named points
threaded through decode, plan/cache load+store, chunk dispatch and the
batched handler families, each a one-line ``maybe_fault(site)`` guard
that is dead (one module-attribute check) unless an injection is armed.

Arming is deterministic per seed, via either

  * the context manager::

        with faults.inject("decode", prob=1.0, seed=0):
            rt.launch(...)

  * or the environment, parsed at import:
    ``VOLT_FAULT=site:prob:seed[,site:prob:seed...]``.

SCOPED sites (the executor-internal ones) only fire while a demotable
executor rung is driving the launch — ``interp.launch`` brackets its
fast paths with ``faults.rung(label)`` — so the oracle rung can never
be injected and recovery always terminates.  Unscoped sites (the disk
caches) fire anywhere; their callers recover locally (drop the entry,
recompute) without demoting anything.
"""
from __future__ import annotations

import fnmatch
import os
import random
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional


class KernelFault(Exception):
    """Semantic kernel error — deterministic, surfaced to the caller.

    ``interp.ExecError`` subclasses this, so every existing raise site
    and every error-class conformance comparison is unchanged."""


class DeadlineExceeded(KernelFault):
    """Launch wall-clock budget expired (``core/governor.py``).

    A KernelFault, not an EngineFault: the deadline is the CALLER's
    verdict on the launch, so the chain must not retry it on a slower
    rung.  Carries the partial ``ExecStats`` at expiry; when raised
    through ``Runtime.launch`` the buffers are rolled back (a timed-out
    launch is bit-invisible) and ``.report`` holds the LaunchReport."""

    def __init__(self, msg: str, *, deadline_ms: Optional[float] = None,
                 elapsed_ms: Optional[float] = None,
                 stats: Optional[object] = None) -> None:
        super().__init__(msg)
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms
        self.stats = stats
        self.report: Optional[object] = None


class EngineFault(RuntimeError):
    """Internal fast-path failure — triggers demotion, never results."""

    def __init__(self, msg: str, *, site: Optional[str] = None,
                 rung: Optional[str] = None) -> None:
        super().__init__(msg)
        self.site = site
        self.rung = rung


class InjectedFault(EngineFault):
    """An ``EngineFault`` raised by the injection harness itself."""


class EngineBusy(RuntimeError):
    """Admission control backpressure: a bounded submit queue (the serve
    engine's request queue, the runtime's launch-service queue) is full.
    Raised BEFORE any work starts, so the caller can shed load or retry
    with backoff; never a kernel-launch demotion.  Lives here (not in
    serve/engine.py, which re-exports it) so core/runtime.py's launch
    service can raise it without a core → serve import."""


class FaultSpecError(ValueError):
    """Malformed ``VOLT_FAULT`` / ``install_spec`` component.  The
    message names the offending component so a fat-fingered env var
    fails in one readable line instead of a bare ``ValueError``."""


# --------------------------------------------------------------------------
# site registry
# --------------------------------------------------------------------------

#: site name -> {"desc": ..., "scoped": bool}; scoped sites fire only
#: inside a demotable executor rung (see module docstring)
SITES: Dict[str, Dict[str, object]] = {}


def register_site(name: str, desc: str, *, scoped: bool = True) -> None:
    SITES[name] = {"desc": desc, "scoped": scoped}


# disk caches: callers recover locally (drop entry, recompute) ---------------
register_site("cache.load", "compile-cache disk read (.vck deserialize)",
              scoped=False)
register_site("cache.store", "compile-cache disk write, before tmp write",
              scoped=False)
register_site("cache.commit", "atomic-write commit: after the tmp file "
              "is written, before os.replace (a crash mid-write)",
              scoped=False)
register_site("plan.load", "decode-plan disk read (.vdp deserialize)",
              scoped=False)
register_site("plan.store", "decode-plan disk write", scoped=False)
# executor internals: an injected fault demotes the launch one rung ----------
register_site("decode", "handler-table decode (_decode/_decode_batched)")
register_site("decode.plan", "static decode-plan computation")
register_site("chunk.dispatch", "grid-mode per-chunk decode + dispatch")
register_site("grid.exec", "grid-batched lockstep node walk")
register_site("wg.exec", "workgroup-batched lockstep node walk")
register_site("decoded.exec", "per-warp decoded node walk")
register_site("handler.mem", "coalescing-engine memory counting handlers")
register_site("handler.atomic", "contended-RMW serialization ladder")
register_site("mem.alloc", "device-memory lazy allocation (shared tiles, "
              "zero-filled globals) — also where VOLT_MEM_BUDGET "
              "overruns surface")
register_site("coalesce.exec", "cross-launch coalesced lockstep node "
              "walk — a hit aborts the GROUP (staging tables dropped, "
              "tenant buffers untouched) and every tenant reruns solo")
# host-parallel chunk dispatcher (core/parallel.py + interp): a hit at
# any of the three sites aborts the whole in-flight chunk set and the
# launch demotes with bit-exact rollback, like any other engine fault --
register_site("parallel.submit", "host-parallel dispatcher: per-chunk "
              "submission to the worker pool (main thread, chunk order)")
register_site("parallel.worker.exec", "host-parallel dispatcher: chunk "
              "execution on a pool worker — the verdict is drawn on the "
              "MAIN thread in chunk order (see faults.decide) and the "
              "fault raised inside the worker, so injection stays "
              "deterministic under any thread schedule")
register_site("parallel.merge", "host-parallel dispatcher: deterministic "
              "chunk-order merge of per-chunk stats/telemetry")
# torch codegen rung (core/backends/torchgen.py): licence + static walk,
# chunked execution on the device, certification-cache read — all scoped,
# so a faulted torch launch demotes to the grid rung with buffers
# untouched ----------------------------------------------------------------
register_site("torch.trace", "torchgen licence check + static chunk walk")
register_site("torch.exec", "torchgen per-chunk execution on the device")
register_site("torch.cache.load", "torch certification-cache read (.vtc "
              "deserialize / in-memory verdict lookup)")
# serve engine: per-request recovery (retry with backoff, then fail the
# one request) — never a kernel-launch demotion -------------------------------
register_site("serve.prefill", "serve-engine prompt prefill", scoped=False)
register_site("serve.decode", "serve-engine batched decode step",
              scoped=False)

#: executor rungs an EngineFault can demote AWAY from (the oracle is the
#: floor: scoped sites never fire there)
DEMOTABLE = ("torch", "grid", "wg", "decoded")

#: hot-path guard: executors check this one module attribute before
#: calling maybe_fault, so an unarmed process pays a single dict-free
#: attribute read per site
ACTIVE = False

_RUNG: List[Optional[str]] = [None]


class _Injection:
    __slots__ = ("pattern", "prob", "seed", "after", "rng", "hits",
                 "fired")

    def __init__(self, pattern: str, prob: float, seed: int,
                 after: int) -> None:
        self.pattern = pattern
        self.prob = float(prob)
        self.seed = int(seed)
        self.after = int(after)
        self.rng = random.Random(int(seed))
        self.hits = 0       # matching site executions observed
        self.fired = 0      # faults actually raised

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"_Injection({self.pattern!r}, prob={self.prob}, "
                f"seed={self.seed}, hits={self.hits}, "
                f"fired={self.fired})")


_INJECTIONS: List[_Injection] = []


def _sync_active() -> None:
    global ACTIVE
    ACTIVE = bool(_INJECTIONS)


def current_rung() -> Optional[str]:
    return _RUNG[-1]


def rung_depth() -> int:
    return len(_RUNG)


def push_rung(label: str) -> None:
    """Enter a rung without a context manager (interp.launch selects
    its executor mid-body; the launch wrapper trims back to the saved
    depth on every exit path)."""
    _RUNG.append(label)


def trim_rungs(depth: int) -> None:
    del _RUNG[depth:]


@contextmanager
def rung(label: str) -> Iterator[None]:
    """Bracket an executor rung: scoped sites fire only while the
    innermost rung is demotable."""
    _RUNG.append(label)
    try:
        yield
    finally:
        _RUNG.pop()


def maybe_fault(site: str) -> None:
    """Raise InjectedFault if an armed injection matches ``site``.
    Deterministic: each injection draws from its own seeded RNG in
    execution order.  Scoped sites are suppressed outside demotable
    rungs so recovery to the oracle always terminates."""
    meta = SITES.get(site)
    if meta is not None and meta["scoped"] and _RUNG[-1] not in DEMOTABLE:
        return
    for inj in _INJECTIONS:
        if not fnmatch.fnmatchcase(site, inj.pattern):
            continue
        inj.hits += 1
        if inj.hits <= inj.after:
            continue
        if inj.prob >= 1.0 or inj.rng.random() < inj.prob:
            inj.fired += 1
            raise InjectedFault(
                f"injected fault at site {site!r} (hit {inj.hits}, "
                f"seed {inj.seed})", site=site, rung=_RUNG[-1])


def decide(site: str) -> bool:
    """Draw the injection verdict for ``site`` WITHOUT raising:
    identical bookkeeping to ``maybe_fault`` (hits, ``after`` skip,
    per-injection seeded RNG), but the verdict is returned so the
    caller can carry it somewhere else before raising.  The parallel
    dispatcher uses this to pre-draw ``parallel.worker.exec`` verdicts
    on the MAIN thread in chunk order — drawing from worker threads
    would make the shared RNG sequence depend on the thread schedule,
    breaking seed-determinism."""
    meta = SITES.get(site)
    if meta is not None and meta["scoped"] and _RUNG[-1] not in DEMOTABLE:
        return False
    for inj in _INJECTIONS:
        if not fnmatch.fnmatchcase(site, inj.pattern):
            continue
        inj.hits += 1
        if inj.hits <= inj.after:
            continue
        if inj.prob >= 1.0 or inj.rng.random() < inj.prob:
            inj.fired += 1
            return True
    return False


def parallel_safe() -> bool:
    """True when parallel chunk dispatch cannot perturb injection
    determinism.  Sites that fire from inside worker threads
    (``grid.exec``, the handler family, ``mem.alloc``, ...) draw from
    the armed injections' shared RNGs in execution order; under a
    thread schedule that order is not reproducible, so the dispatcher
    falls back to exact sequential dispatch whenever any armed
    injection could match a non-``parallel.*`` site.  The
    ``parallel.*`` sites themselves stay safe at any worker count:
    their verdicts are drawn on the main thread in chunk order."""
    for inj in _INJECTIONS:
        for site in SITES:
            if (not site.startswith("parallel.")
                    and fnmatch.fnmatchcase(site, inj.pattern)):
                return False
    return True


@contextmanager
def inject(site: str, prob: float = 1.0, seed: int = 0,
           after: int = 0) -> Iterator[_Injection]:
    """Arm one injection for the dynamic extent of the block.  ``site``
    may be an fnmatch pattern (``"handler.*"``); ``after`` skips the
    first N matching executions (mid-run faults: stores already
    committed when the fault lands)."""
    if "*" not in site and "?" not in site and site not in SITES:
        raise ValueError(f"unknown fault site {site!r} "
                         f"(known: {sorted(SITES)})")
    inj = _Injection(site, prob, seed, after)
    _INJECTIONS.append(inj)
    _sync_active()
    try:
        yield inj
    finally:
        _INJECTIONS.remove(inj)
        _sync_active()


def _parse_component(part: str) -> _Injection:
    """One ``site[:prob[:seed]]`` component -> validated _Injection."""
    bits = part.split(":")
    if len(bits) > 3:
        raise FaultSpecError(
            f"fault spec component {part!r}: expected site[:prob[:seed]]"
            f", got {len(bits)} ':'-separated fields")
    site = bits[0]
    if not site:
        raise FaultSpecError(
            f"fault spec component {part!r}: empty site name")
    if any(ch in site for ch in "*?["):
        if not any(fnmatch.fnmatchcase(s, site) for s in SITES):
            raise FaultSpecError(
                f"fault spec component {part!r}: pattern {site!r} "
                f"matches no registered site (known: {sorted(SITES)})")
    elif site not in SITES:
        raise FaultSpecError(
            f"fault spec component {part!r}: unknown site {site!r} "
            f"(known: {sorted(SITES)})")
    prob = 1.0
    if len(bits) > 1 and bits[1]:
        try:
            prob = float(bits[1])
        except ValueError:
            raise FaultSpecError(
                f"fault spec component {part!r}: prob {bits[1]!r} is "
                f"not a number") from None
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(
                f"fault spec component {part!r}: prob must be in "
                f"[0, 1], got {prob}")
    seed = 0
    if len(bits) > 2 and bits[2]:
        try:
            seed = int(bits[2])
        except ValueError:
            raise FaultSpecError(
                f"fault spec component {part!r}: seed {bits[2]!r} is "
                f"not an integer") from None
        if seed < 0:
            raise FaultSpecError(
                f"fault spec component {part!r}: seed must be >= 0, "
                f"got {seed}")
    return _Injection(site, prob, seed, 0)


def install_spec(spec: str) -> List[_Injection]:
    """Arm injections from a ``site:prob:seed[,...]`` spec (the
    VOLT_FAULT format; prob and seed optional).  Stays armed until
    ``clear()``.  The whole spec is validated BEFORE anything is armed
    — a bad component raises ``FaultSpecError`` naming it and leaves
    the harness untouched."""
    out = [_parse_component(part.strip())
           for part in spec.split(",") if part.strip()]
    _INJECTIONS.extend(out)
    _sync_active()
    return out


def clear() -> None:
    """Disarm every injection (including VOLT_FAULT ones)."""
    del _INJECTIONS[:]
    _sync_active()


_env_spec = os.environ.get("VOLT_FAULT")
if _env_spec:
    install_spec(_env_spec)
