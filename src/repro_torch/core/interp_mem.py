"""Shared coalescing/statistics engine for every executor.

Before this module each executor counted coalesced cache lines with its
own per-access ``np.unique(a_ix // CACHE_LINE_ELEMS)`` — six-plus sites
across the instruction-at-a-time oracle, the per-warp decoded executor
and the (rows, W) batched executors, each paying ``np.unique``'s fixed
overhead (argument coercion, a flat sort, an allocated result array we
only ever ``len()``) on every dynamic LOAD/STORE/ATOMIC.  The middle-end
already centralizes SIMT analyses so they can be shared across executors
(paper §4.3); this module does the same for the cycle model's memory
statistics:

  * one **counting rule**, stated once: a memory access's line count is
    the number of distinct ``idx // CACHE_LINE_ELEMS`` values over the
    IN-BOUNDS indices of ACTIVE lanes, with each warp (row) counting its
    own lines.  Loads clamp out-of-bounds lanes to the buffer edge
    first (GPU semantics: an OOB load still occupies a line at the
    clamped address); stores and atomics have already validated their
    active indices in-bounds, so raw and clamped indices coincide.
    Every caller hands this module in-bounds indices — the executors can
    no longer drift apart on the clip-before-count question
    (regression-tested in tests/test_coalesce_engine.py).

  * a **vectorized generic kernel**: instead of ``np.unique``, inactive
    lanes are masked to a ``-1`` sentinel, rows are sorted in one
    ``np.sort(axis=-1)`` call, and the distinct count is a vectorized
    transition count — no Python-level per-warp loop, no result
    allocation, one call for all ``(rows, W)`` lanes of a batched
    access.

  * a **decode-time analytic fast path**: when the decoder proves an
    index *uniform* per warp (``out[group_id(0)]``, single-cell
    atomics) the count is the number of active rows — already tracked
    by the executor, zero per-access work, the index data is never
    touched.  When it proves the index *affine in the lane id* with a
    known stride sign (``buf[s*gid + c]`` chains through single-store
    entry-block slots — the ubiquitous guarded ``y[gid] = ...``
    pattern), the per-row keys are monotone along the lane axis, so the
    distinct count is a sort-free running-max transition count.  The
    licence is computed by ``passes.analysis.affine_mem_facts`` and
    checked against the launch layout at run time (``AffineFact.ok``):
    lane-affinity of ``global_id(0)``/``local_id(0)`` needs
    ``local_size % warp_size == 0`` (otherwise a warp wraps mid-row),
    and int32 wraparound must be impossible for the chain's
    statically-known stride/addend over the launch's index span.

Every path returns bit-identical counts to the ``np.unique`` reference
(property-tested against it across random masks, strides, dtypes and
OOB-clipped indices).  ``reference_counting()`` switches the whole
engine back to the historical per-access ``np.unique`` implementation —
the baseline ``benchmarks/interp_speed.py`` ``interp_speed_mem``
measures against, and a differential oracle for the parity tests.

This is a copy of the reference's module (``repro.core.interp_mem``),
unchanged: the port's executors count lines to the same rule, and the
torch rung (``core/backends/torchgen.py``) counts them on the device to it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np

from . import faults as _faults

#: 64-byte lines of 4-byte elements (the cycle model's coalescing grain)
CACHE_LINE_ELEMS = 16

#: True: vectorized + analytic counting.  False: the historical
#: per-access np.unique implementation (identical results, slower).
FAST = True


@contextmanager
def reference_counting():
    """Temporarily count with the pre-engine ``np.unique`` code paths
    (benchmark baseline / differential oracle)."""
    global FAST
    old = FAST
    FAST = False
    try:
        yield
    finally:
        FAST = old


# --------------------------------------------------------------------------
# Decode-time facts (produced by passes.analysis.affine_mem_facts)
# --------------------------------------------------------------------------

class AffineFact:
    """What the decoder proved about one memory access's index vector.

    ``kind``:
      * "uni"  — identical for every lane of a row (count = active rows);
      * "inc"  — affine in the lane id with stride > 0 (monotone
        nondecreasing keys per row);
      * "dec"  — stride < 0 (monotone nonincreasing).

    ``layout``   — the chain uses ``global_id(0)``/``local_id(0)``/
                   ``global_id(1)``/``local_id(1)``: only lane-affine /
                   row-uniform when ``local_size % warp_size == 0``
                   (checked per launch via ``_WarpCtx.affine_ok``).
    ``span_mul`` / ``span_add`` — |stride| and the summed |const addend|
                   of the chain; the monotone claim additionally needs
                   ``span_mul * launch_index_span + span_add`` to fit in
                   int32 (int32 wraparound would break monotonicity).
                   Chains containing runtime scalar params never get an
                   "inc"/"dec" fact (their addend is unbounded); they
                   may still be "uni" (a uniform wraps to a uniform).
    """
    __slots__ = ("kind", "layout", "span_mul", "span_add")

    def __init__(self, kind: str, layout: bool, span_mul: int = 0,
                 span_add: int = 0) -> None:
        self.kind = kind
        self.layout = layout
        self.span_mul = span_mul
        self.span_add = span_add

    def ok(self, ctx) -> bool:
        """Is the fact valid under this launch's thread layout?"""
        if self.layout and not ctx.affine_ok:
            return False
        if self.kind == "uni":
            return True
        return self.span_mul * ctx.affine_span + self.span_add < 2**31 - 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AffineFact({self.kind!r}, layout={self.layout}, "
                f"mul={self.span_mul}, add={self.span_add})")


# --------------------------------------------------------------------------
# Counting kernels.  All take IN-BOUNDS indices (the counting rule).
# --------------------------------------------------------------------------

def count_lines_ref(a_ix: np.ndarray) -> int:
    """The reference oracle: distinct lines of a gathered in-bounds
    active-lane index vector, via ``np.unique`` (tests only)."""
    return len(np.unique(np.asarray(a_ix, dtype=np.int64)
                         // CACHE_LINE_ELEMS))


#: per-row key bias, cached by row count: shifting row r's line ids by
#: r << 36 keeps rows in disjoint key ranges (indices are < 2^31, so
#: line ids are < 2^27) while preserving per-row monotonicity — the
#: flattened active-lane key vector then has equal values adjacent
#: exactly where one row repeats a line
_ROW_BIAS: dict = {}


def _row_bias(rows: int) -> np.ndarray:
    b = _ROW_BIAS.get(rows)
    if b is None:
        b = (np.arange(rows, dtype=np.int64) << 36)[:, None]
        _ROW_BIAS[rows] = b
    return b


def _run_count(a: np.ndarray) -> int:
    """Number of runs of equal adjacent values = distinct count for any
    per-row-monotone, row-separated key vector."""
    n = len(a)
    if n <= 1:
        return n
    return int((a[1:] != a[:-1]).sum()) + 1


def count_warp(safe: np.ndarray, mask: np.ndarray,
               fact: Optional[AffineFact] = None, ctx=None) -> int:
    """Line count for one warp access: ``safe`` (W,) in-bounds indices,
    ``mask`` (W,) with at least one active lane."""
    if _faults.ACTIVE:
        _faults.maybe_fault("handler.mem")
    if FAST:
        if fact is not None and ctx is not None and fact.ok(ctx):
            if fact.kind == "uni":
                return 1           # row-uniform: one line
            # monotone along the lane axis (either direction): a gather
            # preserves lane order, so equal keys are adjacent and the
            # run count IS the distinct count — no sort
            return _run_count(safe[mask] // CACHE_LINE_ELEMS)
        a = safe[mask] // CACHE_LINE_ELEMS
        if len(a) <= 1:
            return len(a)
        a.sort()
        return _run_count(a)
    return len(np.unique(safe[mask] // CACHE_LINE_ELEMS))


def count_rows(safe: np.ndarray, mask: np.ndarray, n_act: int,
               buflen: int, fact: Optional[AffineFact] = None,
               ctx=None) -> int:
    """Line count for a batched access: ``safe`` (rows, W) in-bounds
    indices, ``mask`` (rows, W); each row counts its own lines
    (``n_act`` = rows with a live mask, already tracked by the
    executor).  ``buflen`` is only consulted by the reference mode,
    which reproduces the historical row-offset ``np.unique``."""
    if _faults.ACTIVE:
        _faults.maybe_fault("handler.mem")
    if FAST:
        if fact is not None and ctx is not None and fact.ok(ctx):
            if fact.kind == "uni":
                return n_act       # one line per row with live lanes
            keys = safe // CACHE_LINE_ELEMS
            keys += _row_bias(mask.shape[0])
            return _run_count(keys[mask])
        keys = safe // CACHE_LINE_ELEMS
        keys += _row_bias(mask.shape[0])
        a = keys[mask]
        if len(a) <= 1:
            return len(a)
        a.sort()
        return _run_count(a)
    # historical computation: offset each row into its own line-id
    # space, one global unique
    nlines = buflen // CACHE_LINE_ELEMS + 1
    rowoff = np.arange(mask.shape[0], dtype=np.int64)[:, None]
    keys = safe // CACHE_LINE_ELEMS + rowoff * nlines
    return len(np.unique(keys[mask]))


def _run_starts(a: np.ndarray) -> np.ndarray:
    """Boolean run-start marks of a row-separated key vector (first
    element of every run of equal adjacent values)."""
    starts = np.empty(len(a), dtype=bool)
    starts[0] = True
    np.not_equal(a[1:], a[:-1], out=starts[1:])
    return starts


def count_rows_split(safe: np.ndarray, mask: np.ndarray, buflen: int,
                     fact: Optional[AffineFact] = None,
                     ctx=None) -> np.ndarray:
    """Per-row line counts for a batched access — the same counting rule
    as :func:`count_rows`, returned as an ``(rows,)`` vector instead of
    a sum.  The coalesced multi-launch path uses this to de-mix memory
    statistics per tenant; ``out.sum()`` is bit-identical to
    ``count_rows`` for the same access in every mode (the row bias keeps
    rows in disjoint key ranges, so runs never cross rows and each
    run-start's row is recoverable from its key)."""
    if _faults.ACTIVE:
        _faults.maybe_fault("handler.mem")
    rows = mask.shape[0]
    if FAST:
        if fact is not None and ctx is not None and fact.ok(ctx):
            if fact.kind == "uni":
                return mask.any(axis=1).astype(np.int64)
            keys = safe // CACHE_LINE_ELEMS
            keys = keys + _row_bias(rows)
            a = keys[mask]
            if not len(a):
                return np.zeros(rows, dtype=np.int64)
            return np.bincount(a[_run_starts(a)] >> 36, minlength=rows)
        keys = safe // CACHE_LINE_ELEMS
        keys = keys + _row_bias(rows)
        a = np.sort(keys[mask])
        if not len(a):
            return np.zeros(rows, dtype=np.int64)
        return np.bincount(a[_run_starts(a)] >> 36, minlength=rows)
    # reference mode: the historical row-offset unique, attributed back
    # to rows by dividing the distinct keys by the per-row line span
    nlines = buflen // CACHE_LINE_ELEMS + 1
    rowoff = np.arange(rows, dtype=np.int64)[:, None]
    keys = safe // CACHE_LINE_ELEMS + rowoff * nlines
    uq = np.unique(keys[mask])
    if not len(uq):
        return np.zeros(rows, dtype=np.int64)
    return np.bincount(uq // nlines, minlength=rows)


def count_gathered(a_ix: np.ndarray, fact: Optional[AffineFact] = None,
                   ctx=None) -> int:
    """Line count over an already-gathered in-bounds active-lane index
    vector (stores, atomics and the instruction-at-a-time oracle).  A
    gather preserves lane order, so monotone facts count runs without a
    sort."""
    if _faults.ACTIVE:
        _faults.maybe_fault("handler.mem")
    if FAST:
        n = len(a_ix)
        if fact is not None and ctx is not None and fact.ok(ctx):
            if fact.kind == "uni":
                return 1 if n else 0
            return _run_count(a_ix // CACHE_LINE_ELEMS)
        a = a_ix // CACHE_LINE_ELEMS
        if n <= 1:
            return n
        a.sort()
        return _run_count(a)
    return len(np.unique(a_ix // CACHE_LINE_ELEMS))
