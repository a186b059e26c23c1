"""Persistent host worker pool for parallel grid-chunk dispatch.

The middle-end's execution licences (order-freedom + store privacy,
``docs/performance.md``) prove grid chunks mutually independent — the
precondition the grid executor already uses to run them contiguously
ahead of oracle order.  This module supplies the other half: a
persistent pool that runs those chunks CONCURRENTLY across host cores,
with results returned in task order so the dispatcher's merge is
deterministic at every worker count.

Backends:

  * ``thread`` (default) — a persistent ``ThreadPoolExecutor``.  numpy
    releases the GIL inside the hot batched handlers, so lockstep node
    walks over distinct chunks genuinely overlap.
  * ``serial`` — runs the tasks in submission order on the calling
    thread.  Same chunk plan, same merge path, zero concurrency: the
    metamorphic suite sweeps it against ``thread`` to prove results are
    schedule-invariant.
  * ``process`` — reserved seam.  ``WorkerPool.run`` is shaped so a
    process pool can slot in (tasks are index-addressed closures and
    results travel back by index), but shipping one needs picklable
    chunk state; requesting it today raises ``NotImplementedError``.

Pools are cached per (backend, workers) and reused across launches so
worker spin-up and the per-worker numpy/cache warm-up are amortized —
``VOLT_WORKERS`` resolution is one dict hit after the first launch.

Knobs:

  * ``VOLT_WORKERS``  — worker count; ``auto``/unset = host cores,
    ``1`` = today's exact sequential dispatch (no pool touched).
  * ``VOLT_PAR_BACKEND`` — ``thread`` (default) or ``serial``.

Test hook: ``SUBMIT_ORDER`` may hold a permutation function
``n_tasks -> sequence of task indices``; the pool SUBMITS in that order
(exercising arbitrary chunk interleavings) while results still return
in task order, so any permutation must be bit-invisible downstream.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

BACKENDS = ("thread", "serial")

#: hard cap so a fat VOLT_WORKERS cannot fork-bomb the host with
#: threads; far above any real core count this interpreter targets
MAX_WORKERS = 64

#: test hook — permutes SUBMISSION order (n_tasks -> index sequence);
#: results are always returned in task order regardless
SUBMIT_ORDER: Optional[Callable[[int], Sequence[int]]] = None


def resolve_workers(val: Optional[object] = None) -> int:
    """``VOLT_WORKERS`` knob -> worker count.  ``None``/``''``/
    ``'auto'`` = host cores (``os.cpu_count()``); explicit integers are
    clamped to [1, MAX_WORKERS].  A malformed value raises ValueError
    naming the knob rather than silently serializing."""
    if val is None:
        val = os.environ.get("VOLT_WORKERS")
    if val is None or (isinstance(val, str) and val.strip().lower()
                       in ("", "auto")):
        return max(1, min(MAX_WORKERS, os.cpu_count() or 1))
    try:
        n = int(val)
    except (TypeError, ValueError):
        raise ValueError(
            f"VOLT_WORKERS {val!r}: expected a positive integer or "
            f"'auto'") from None
    if n < 1:
        raise ValueError(f"VOLT_WORKERS {val!r}: must be >= 1")
    return min(n, MAX_WORKERS)


def resolve_backend(val: Optional[str] = None) -> str:
    if val is None:
        val = os.environ.get("VOLT_PAR_BACKEND")
    if val is None or not val.strip():
        return "thread"
    b = val.strip().lower()
    if b == "process":
        raise NotImplementedError(
            "VOLT_PAR_BACKEND=process: the process-pool backend is a "
            "reserved seam (chunk state is not picklable yet); use "
            "'thread' or 'serial'")
    if b not in BACKENDS:
        raise ValueError(f"VOLT_PAR_BACKEND {val!r}: expected one of "
                         f"{BACKENDS + ('process',)}")
    return b


class TaskError:
    """A task's exception, carried back by index so the dispatcher can
    pick the DETERMINISTIC one to surface (smallest task index) no
    matter which worker failed first on the wall clock."""

    __slots__ = ("index", "error")

    def __init__(self, index: int, error: BaseException) -> None:
        self.index = index
        self.error = error


class WorkerPool:
    """Index-ordered task runner over a persistent thread pool.

    ``run(tasks)`` executes every task and returns a list aligned with
    ``tasks``: each slot holds the task's return value or a
    ``TaskError``.  After the first observed failure, tasks that have
    not yet started are shed (their slots hold ``None``) — the
    in-flight chunk set is aborted, matching the degradation contract
    where one EngineFault dooms the whole launch attempt anyway.
    Tasks must therefore never legitimately return ``None``."""

    def __init__(self, workers: int, backend: str = "thread") -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown pool backend {backend!r}")
        self.workers = max(1, int(workers))
        self.backend = backend
        self._executor: Optional[ThreadPoolExecutor] = None
        if backend == "thread":
            self._executor = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="volt-par")

    def run(self, tasks: Sequence[Callable[[], Any]]) -> List[Any]:
        order = range(len(tasks))
        if SUBMIT_ORDER is not None:
            order = list(SUBMIT_ORDER(len(tasks)))
            assert sorted(order) == list(range(len(tasks))), \
                "SUBMIT_ORDER hook must return a permutation"
        results: List[Any] = [None] * len(tasks)
        abort = threading.Event()

        def _call(i: int, fn: Callable[[], Any]) -> Any:
            if abort.is_set():
                return None           # shed: the chunk set is aborted
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001
                abort.set()
                return TaskError(i, e)

        if self.backend == "serial" or self._executor is None:
            for i in order:
                results[i] = _call(i, tasks[i])
            return results
        futures = [(i, self._executor.submit(_call, i, tasks[i]))
                   for i in order]
        for i, fut in futures:
            results[i] = fut.result()
        return results

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None


_POOLS: Dict[Tuple[str, int], WorkerPool] = {}
_POOLS_LOCK = threading.Lock()


def get_pool(workers: int, backend: str = "thread") -> WorkerPool:
    """Persistent per-(backend, workers) pool — reused across launches
    so spin-up cost is paid once per process."""
    key = (backend, int(workers))
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = WorkerPool(workers, backend)
        return pool


def shutdown_pools() -> None:
    """Tear down every cached pool (test isolation / interpreter exit)."""
    with _POOLS_LOCK:
        for pool in _POOLS.values():
            pool.shutdown()
        _POOLS.clear()
