"""Launch governor: deadlines, per-kernel circuit breakers, memory budgets.

PR 6 made launches *fault-isolated* (EngineFault demotion + rollback,
docs/robustness.md); this module bounds their *resources*.  Three
cooperating mechanisms, each independently disarmable:

  * **Deadlines** — ``Runtime.launch(..., deadline_ms=)`` arms a
    wall-clock budget.  Executors poll ``deadline_check()`` at their
    existing cheap checkpoints (block/chunk boundaries, barrier events,
    per-node fuel strides); on expiry it raises
    ``faults.DeadlineExceeded`` (a KernelFault — the chain never
    retries a timed-out launch on a slower rung) carrying the partial
    ExecStats, and the runtime rolls the transactional snapshot back so
    a timed-out launch is bit-invisible.  The hot-path cost mirrors
    ``faults.ACTIVE``: one module-attribute read per checkpoint when no
    deadline is armed, and a strided countdown (one ``perf_counter``
    per ``CHECK_STRIDE`` checkpoints) when one is.

  * **Per-kernel circuit breaker** — keyed by the kernel's decode-plan
    content hash, so a recompiled-but-identical kernel shares state and
    an edited kernel gets a fresh breaker.  N demoting launches open
    the breaker: subsequent launches are *pinned* directly at the
    last-good rung, skipping the doomed fast path and its snapshot.
    Every ``probe_every`` pinned launches the breaker half-opens and
    probes the full chain once — success re-promotes (closed), another
    demotion re-pins.

  * **Memory budget** — ``VOLT_MEM_BUDGET`` (bytes, ``k``/``m``/``g``
    suffixes) bounds both lazy device-memory allocation (shared tiles,
    zero-filled globals: overruns raise an ``EngineFault`` at site
    ``mem.alloc`` so the chain demotes to a smaller-footprint rung) and
    the transactional snapshot (an over-budget snapshot is skipped and
    the launch degrades to oracle-first execution, the floor that needs
    no retry snapshot — instead of OOMing mid-chain).

This module deliberately imports only ``faults`` — interp and runtime
import it, not the other way round.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from .faults import DeadlineExceeded

# --------------------------------------------------------------------------
# deadline arming (module-level, same hot-path pattern as faults.ACTIVE)
# --------------------------------------------------------------------------

#: hot-path guard: executors check this one module attribute before
#: calling deadline_check(), so an un-governed launch pays a single
#: attribute read per checkpoint
ACTIVE = False

#: checkpoints per wall-clock poll.  Checkpoints are block / chunk /
#: barrier / per-node grained, so the worst-case overshoot past the
#: deadline is CHECK_STRIDE x the hottest checkpoint's latency.
CHECK_STRIDE = 32

#: observability for tests and post-mortems (process-wide, like
#: runtime.LAUNCH_TELEMETRY)
TELEMETRY = {"deadline_polls": 0, "deadline_expired": 0}


class _Arm:
    __slots__ = ("deadline_t", "deadline_ms", "t0", "stats", "countdown")

    def __init__(self, deadline_t: float, deadline_ms: Optional[float],
                 stats: Optional[object]) -> None:
        self.deadline_t = deadline_t
        self.deadline_ms = deadline_ms
        self.t0 = perf_counter()
        self.stats = stats
        # first checkpoint polls the clock immediately (a deadline that
        # already expired must not wait out a full stride), then every
        # CHECK_STRIDE-th
        self.countdown = 1


_ARMS: List[_Arm] = []


def arm_deadline(deadline_t: float, deadline_ms: Optional[float] = None,
                 stats: Optional[object] = None) -> None:
    """Arm a wall-clock deadline (absolute ``perf_counter`` time) for
    the current launch; ``stats`` is attached to the DeadlineExceeded
    as the partial progress at expiry.  Stack-shaped for safety, though
    launches do not nest today."""
    global ACTIVE
    _ARMS.append(_Arm(deadline_t, deadline_ms, stats))
    ACTIVE = True


def disarm_deadline() -> None:
    global ACTIVE
    if _ARMS:
        _ARMS.pop()
    ACTIVE = bool(_ARMS)


def deadline_check() -> None:
    """Strided wall-clock poll; raises DeadlineExceeded on expiry.
    Callers guard with ``if governor.ACTIVE:`` so this is never reached
    un-armed (a stale call is a no-op anyway)."""
    if not _ARMS:
        return
    arm = _ARMS[-1]
    arm.countdown -= 1
    if arm.countdown > 0:
        return
    arm.countdown = CHECK_STRIDE
    TELEMETRY["deadline_polls"] += 1
    now = perf_counter()
    if now >= arm.deadline_t:
        TELEMETRY["deadline_expired"] += 1
        elapsed_ms = (now - arm.t0) * 1e3
        budget = (f"{arm.deadline_ms:.3g} ms" if arm.deadline_ms
                  is not None else "deadline")
        raise DeadlineExceeded(
            f"launch exceeded its {budget} wall-clock budget "
            f"(elapsed {elapsed_ms:.3g} ms)",
            deadline_ms=arm.deadline_ms, elapsed_ms=elapsed_ms,
            stats=arm.stats)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_mem_budget(val: Optional[str],
                     name: str = "VOLT_MEM_BUDGET") -> Optional[int]:
    """``'65536'`` / ``'64k'`` / ``'16m'`` / ``'2g'`` -> bytes;
    ``None`` / ``''`` / ``'0'`` -> no budget.  ``name`` labels the
    source knob in error messages (VOLT_POOL_BUDGET reuses the parser)."""
    if val is None:
        return None
    s = val.strip().lower()
    if not s:
        return None
    mult = 1
    if s[-1] in _SUFFIX:
        mult = _SUFFIX[s[-1]]
        s = s[:-1]
    try:
        n = int(float(s) * mult)
    except ValueError:
        raise ValueError(
            f"{name} {val!r}: expected bytes with optional "
            f"k/m/g suffix (e.g. '64m')") from None
    if n < 0:
        raise ValueError(f"{name} {val!r}: must be >= 0")
    return n or None


def env_mem_budget() -> Optional[int]:
    return parse_mem_budget(os.environ.get("VOLT_MEM_BUDGET"))


def env_pool_budget() -> Optional[int]:
    """``VOLT_POOL_BUDGET`` — capacity of the Runtime's pooled device
    allocator (bytes retained across launches; same k/m/g syntax)."""
    return parse_mem_budget(os.environ.get("VOLT_POOL_BUDGET"),
                            name="VOLT_POOL_BUDGET")


@dataclass
class GovernorConfig:
    """Per-Runtime governor knobs (``Runtime(governor=...)``)."""
    #: default wall-clock budget per launch; per-call ``deadline_ms``
    #: overrides it
    deadline_ms: Optional[float] = None
    #: consecutive demoting launches before the breaker opens
    breaker_threshold: int = 3
    #: pinned launches between half-open probes
    breaker_probe_every: int = 8
    #: device-memory + snapshot byte budget; None -> VOLT_MEM_BUDGET
    mem_budget: Optional[int] = None
    #: pooled-allocator capacity (bytes of free-list backing retained
    #: across launches); None -> VOLT_POOL_BUDGET, else a 64 MiB default
    pool_budget: Optional[int] = None


# --------------------------------------------------------------------------
# per-kernel circuit breaker
# --------------------------------------------------------------------------


@dataclass
class BreakerEntry:
    """State machine per kernel content hash:

        closed --N demotions--> open (pinned at last-good rung)
        open --every probe_every pinned launches--> half_open (probe
            the full chain) --ok--> closed / --demotion--> open
    """
    key: str
    kernel: str
    state: str = "closed"
    trips: int = 0                 # consecutive demoting launches
    pinned_rung: Optional[str] = None
    pinned_launches: int = 0       # launches served at the pin
    probes: int = 0
    promotions: int = 0
    _probe_countdown: int = field(default=0, repr=False)


class CircuitBreaker:
    """Per-kernel breaker bank.  State transitions are serialized by an
    internal lock so concurrent tenants (the runtime's launch service
    drains from caller threads) can't interleave plan/record and lose a
    trip count or double-probe; the lock bounds nothing hot — breaker
    calls are one-per-launch, not per-node."""

    def __init__(self, threshold: int = 3, probe_every: int = 8) -> None:
        self.threshold = max(1, int(threshold))
        self.probe_every = max(1, int(probe_every))
        self.entries: Dict[str, BreakerEntry] = {}
        self._lock = threading.Lock()

    def _entry(self, key: str, kernel: str) -> BreakerEntry:
        # internal: caller holds self._lock
        st = self.entries.get(key)
        if st is None:
            st = self.entries[key] = BreakerEntry(key, kernel)
        return st

    def entry(self, key: str, kernel: str) -> BreakerEntry:
        with self._lock:
            return self._entry(key, kernel)

    def plan(self, key: str, kernel: str) -> Tuple[Optional[str], bool]:
        """Plan the next launch of ``key``: returns ``(pinned_rung,
        probing)``.  ``pinned_rung`` non-None means start the chain
        there (skip the doomed fast path); ``probing`` means this
        launch is a half-open probe of the full chain."""
        with self._lock:
            st = self._entry(key, kernel)
            if st.state == "open":
                st._probe_countdown -= 1
                if st._probe_countdown <= 0:
                    st.state = "half_open"
                    st.probes += 1
                    return None, True
                st.pinned_launches += 1
                return st.pinned_rung, False
            if st.state == "half_open":
                # the previous probe never reached a verdict (e.g. a
                # KernelFault mid-probe): probe again
                st.probes += 1
                return None, True
            return None, False

    def record(self, key: str, kernel: str, *, demoted: bool,
               final_rung: Optional[str], probing: bool) -> bool:
        """Record a completed launch; returns True if the breaker
        state changed (trip opened it or a probe re-promoted)."""
        with self._lock:
            st = self._entry(key, kernel)
            if demoted:
                st.trips += 1
                if probing or st.trips >= self.threshold:
                    st.state = "open"
                    st.pinned_rung = final_rung
                    st._probe_countdown = self.probe_every
                    return True
                return False
            if probing:
                st.state = "closed"
                st.trips = 0
                st.pinned_rung = None
                st.promotions += 1
                return True
            if st.state == "closed":
                st.trips = 0
            return False

    def abort(self, key: str, kernel: str, *, probing: bool) -> None:
        """The launch surfaced an error before an ok/demotion verdict
        (KernelFault, deadline, exhausted chain).  A probe falls back
        to the previous pin; an open/closed launch is unchanged —
        kernel-semantic failures are not the engine's trips."""
        with self._lock:
            st = self._entry(key, kernel)
            if probing and st.pinned_rung is not None:
                st.state = "open"
                st._probe_countdown = self.probe_every
