"""Warp-level VIR interpreter with a hardware-faithful IPDOM stack.

This is the repo's SimX stand-in (paper §5): deterministic execution of the
*transformed* IR (post divergence-management), per-warp dynamic instruction
counts, and memory-coalescing statistics that feed the cycle model in
simx.py.

Execution model (mirrors Fig 1/Fig 2 semantics):
  * a warp is W lanes executing in lockstep under a thread mask;
  * ``vx_split``/``vx_join`` drive a two-phase IPDOM stack: split pushes
    {saved mask, else-PC, else-mask}, the taken side runs first, the join
    re-materializes the else side, the second join pop restores the mask;
  * ``vx_pred`` masks out lanes whose loop predicate fails; when no lane
    remains the entry mask (saved by ``tmc_save``) is restored and control
    leaves the loop without taking the back edge;
  * uniform branches are taken by active-lane consensus — if the lanes
    disagree, the uniformity analysis was wrong and we raise (this is the
    soundness oracle the property tests rely on);
  * barriers suspend the warp until all warps of the workgroup arrive
    (generator-based co-routines, deterministic round-robin).

A separate *scalar reference executor* runs the untransformed IR one thread
at a time — the oracle for SIMT-semantics tests.

This is a copy of the reference's module (``repro.core.interp``): the
oracle, the decoded, wg-batched and grid executors, ``DevicePool``,
``ExecStats`` and ``ExecError`` are unchanged.  Only the codegen rung
differs: ``launch(torch=...)`` engages the port's torch rung
(``core/backends/torchgen.py``, on the device given by ``device=``) where
the reference's ``launch(jax=...)`` engages its JAX rung, and its
certification verdicts go through ``TORCH_CERT_HOOKS``.
"""
from __future__ import annotations

import itertools
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np

from . import faults as _faults
from . import governor as _gov
from . import interp_mem as _mem
from . import parallel as _parallel
from .passes.analysis import affine_mem_facts
from .vir import (AddrSpace, BINOPS, Block, Const, Function, GlobalVar,
                  Instr, Module, Op, Param, Reg, Slot, Ty, UNOPS, Value)


class ExecError(_faults.KernelFault):
    """Semantic kernel error (a KernelFault): deterministic, surfaced
    to the caller identically by every executor."""


class UniformityViolation(ExecError):
    """A branch the compiler claimed uniform diverged at run time."""


def _add_ctx(e: ExecError, **kv: Any) -> ExecError:
    """Annotate an ExecError with kernel/workgroup/warp context exactly
    once per field (the innermost — most specific — annotation wins).
    The base message is kept and the context rendered as a bracketed
    suffix, e.g. ``out of fuel ... [in @saxpy, workgroup (2, 0),
    warp 1]``, matching the barrier-divergence error's prose."""
    ctx = getattr(e, "ctx", None)
    if ctx is None:
        ctx = {}
        e.ctx = ctx                                # type: ignore[attr-defined]
        e._base_msg = e.args[0] if e.args else ""  # type: ignore[attr-defined]
    for k, v in kv.items():
        if v is not None and k not in ctx:
            ctx[k] = v
    shown = getattr(e, "ctx_in_msg", ())   # fields the base message
    parts = []                             # already spells out
    if "kernel" in ctx and "kernel" not in shown:
        parts.append(f"in @{ctx['kernel']}")
    if "workgroup" in ctx and "workgroup" not in shown:
        parts.append(f"workgroup {ctx['workgroup']}")
    if "warp" in ctx and "warp" not in shown:
        parts.append(f"warp {ctx['warp']}")
    if parts:
        e.args = (f"{e._base_msg} [{', '.join(parts)}]",) + e.args[1:]
    return e


#: executor label actually selected by the most recent launch() call
#: ("grid" / "wg" / "decoded" / "oracle"; None before selection) — the
#: runtime's degradation chain demotes relative to the executor that
#: really ran, not the one it asked for (a gate-refused grid request
#: silently falls back before any fault can fire)
LAST_EXECUTOR: List[Optional[str]] = [None]


#: re-exported from the shared coalescing engine (interp_mem) — the one
#: definition every executor and the cycle model agree on
CACHE_LINE_ELEMS = _mem.CACHE_LINE_ELEMS


@dataclass
class LaunchParams:
    grid: int = 1                 # workgroups (x)
    local_size: int = 32          # threads per workgroup (x)
    warp_size: int = 32
    grid_y: int = 1
    local_size_y: int = 1
    fuel: int = 20_000_000
    # GPU semantics: out-of-bounds LOADS read garbage without trapping
    # (which is what makes CMOV speculation legal on real hardware);
    # set strict_oob_loads for debugging kernels.
    strict_oob_loads: bool = False

    @property
    def wg_threads(self) -> int:
        return self.local_size * self.local_size_y

    @property
    def warps_per_wg(self) -> int:
        return max(1, (self.wg_threads + self.warp_size - 1) // self.warp_size)


def fold_warps(params: LaunchParams, factor: int = 4) -> LaunchParams:
    """Refold a 1D launch into ``factor``-warp workgroups (shared by the
    benchmarks and the executor-conformance tests so every consumer
    folds identically).  The folded launch covers AT LEAST the original
    thread range; when the workgroup count is not divisible by
    ``factor`` the last workgroup rounds up, so kernels must guard their
    tail (every bench does — the suite launches already over-provision
    threads).  Fuel and OOB-load strictness carry over."""
    total = params.grid * params.local_size
    local = min(params.local_size * factor, total)
    return LaunchParams(grid=(total + local - 1) // local,
                        local_size=local, warp_size=params.warp_size,
                        fuel=params.fuel,
                        strict_oob_loads=params.strict_oob_loads)


@dataclass
class ExecStats:
    instrs: int = 0                       # dynamic, per-warp issue count
    by_op: Counter = field(default_factory=Counter)
    mem_requests: int = 0                 # coalesced line requests
    mem_insts: int = 0                    # load/store instructions issued
    shared_requests: int = 0
    atomic_serial: int = 0                # contended-RMW serialization depth
    prints: List[str] = field(default_factory=list)
    max_ipdom_depth: int = 0

    def merge(self, o: "ExecStats") -> None:
        self.instrs += o.instrs
        self.by_op.update(o.by_op)
        self.mem_requests += o.mem_requests
        self.mem_insts += o.mem_insts
        self.shared_requests += o.shared_requests
        self.atomic_serial += o.atomic_serial
        self.prints.extend(o.prints)
        self.max_ipdom_depth = max(self.max_ipdom_depth, o.max_ipdom_depth)


# --------------------------------------------------------------------------
# numpy op dispatch — one table entry per opcode (the decoded interpreter
# binds these at decode time; the legacy path looks them up per
# instruction).  dtype-dependent behavior stays a *runtime* check so the
# two paths are numerically identical.
# --------------------------------------------------------------------------

def _div_fn(a, b):
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.where(b != 0, a // np.where(b == 0, 1, b), 0)
    return np.where(b != 0, a / np.where(b == 0, 1, b), 0.0)


def _and_fn(a, b):
    return a & b if a.dtype != np.float32 else a.astype(bool) & b.astype(bool)


_BIN_FNS = {
    Op.ADD: lambda a, b: a + b,
    Op.SUB: lambda a, b: a - b,
    Op.MUL: lambda a, b: a * b,
    Op.DIV: _div_fn,
    Op.MOD: lambda a, b: np.where(b != 0, a % np.where(b == 0, 1, b), 0),
    Op.AND: _and_fn,
    Op.OR: lambda a, b: a | b,
    Op.XOR: lambda a, b: a ^ b,
    Op.SHL: lambda a, b: a << b,
    Op.SHR: lambda a, b: a >> b,
    Op.MIN: np.minimum,
    Op.MAX: np.maximum,
    Op.POW: lambda a, b: np.power(a.astype(np.float32), b),
    Op.EQ: lambda a, b: a == b,
    Op.NE: lambda a, b: a != b,
    Op.LT: lambda a, b: a < b,
    Op.LE: lambda a, b: a <= b,
    Op.GT: lambda a, b: a > b,
    Op.GE: lambda a, b: a >= b,
}


def _ffs_fn(a):
    # 1-based index of least-significant set bit; 0 if none
    au = a.astype(np.uint32)
    low = (au & (~au + np.uint32(1))).astype(np.uint64)
    out = np.zeros_like(a, dtype=np.int32)
    nz = au != 0
    out[nz] = np.log2(low[nz]).astype(np.int32) + 1
    return out


_UN_FNS = {
    Op.NEG: lambda a: -a,
    Op.NOT: lambda a: ~a,
    Op.ABS: np.abs,
    Op.SQRT: lambda a: np.sqrt(np.maximum(a, 0)).astype(np.float32),
    Op.EXP: lambda a: np.exp(a).astype(np.float32),
    Op.LOG: lambda a: np.log(np.where(a > 0, a, 1)).astype(np.float32),
    Op.SIN: lambda a: np.sin(a).astype(np.float32),
    Op.COS: lambda a: np.cos(a).astype(np.float32),
    Op.ITOF: lambda a: a.astype(np.float32),
    Op.FTOI: lambda a: a.astype(np.int32),
    Op.POPC: lambda a: np.bitwise_count(a.astype(np.uint32)).astype(np.int32),
    Op.FFS: _ffs_fn,
}


def _np_binop(op: Op, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fn = _BIN_FNS.get(op)
    if fn is None:
        raise ExecError(f"bad binop {op}")
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return fn(a, b)


def _np_unop(op: Op, a: np.ndarray) -> np.ndarray:
    fn = _UN_FNS.get(op)
    if fn is None:
        raise ExecError(f"bad unop {op}")
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return fn(a)


_TY_DTYPE = {Ty.I32: np.int32, Ty.F32: np.float32, Ty.BOOL: np.bool_}


def _atomic_rmw(kind: str, buf: np.ndarray, ix: np.ndarray,
                lanes: np.ndarray, v: np.ndarray,
                old: np.ndarray) -> None:
    """The contended-RMW serialization ladder, shared by every executor
    (like the _BIN_FNS/_UN_FNS tables): lane-ordered, deterministic."""
    if _faults.ACTIVE:
        _faults.maybe_fault("handler.atomic")
    for ln in lanes:
        a = int(ix[ln])
        old[ln] = buf[a]
        if kind == "add":
            buf[a] += v[ln]
        elif kind == "max":
            buf[a] = max(buf[a], v[ln])
        elif kind == "min":
            buf[a] = min(buf[a], v[ln])
        elif kind == "xchg":
            buf[a] = v[ln]
        elif kind == "cas":
            pass  # cas(ptr, cmp, val) simplified: no-op compare
        else:
            raise ExecError(f"unknown atomic {kind}")


def _const_vec(c: Const, w: int) -> np.ndarray:
    return np.full((w,), c.value, dtype=_TY_DTYPE.get(c.ty, np.float32))


# --------------------------------------------------------------------------
# Device memory
# --------------------------------------------------------------------------

class DevicePool:
    """Size-class-keyed free lists of device allocations (the tinygrad
    ``CLBuffer``-cache idea): steady-state streaming traffic re-runs the
    same kernels with the same footprints, so shared tiles, tile tables
    and coalesced staging tables can be served from a bounded cache of
    pow2-rounded byte arrays instead of fresh ``np.zeros`` every launch.

    * ``take(shape, dtype)`` pops a free backing array of the rounded
      size class (or allocates on miss) and returns a zero-filled view —
      pooled reuse is invisible to kernels: zero-fill semantics are
      preserved and stale bytes from a previous tenant are never
      observable (tested in tests/test_launch_service.py).
    * ``release(arr)`` walks ``arr.base`` back to the pool backing and
      returns it to its free list, bounded by ``capacity`` bytes (the
      ``VOLT_MEM_BUDGET`` governor's pool share); beyond capacity the
      array is dropped to the gc.  Arrays that are never released are
      ordinary garbage-collected numpy arrays — the pool keeps no
      reference, so forgetting to release leaks nothing.

    Thread-safe: the launch service drains queues from concurrent
    submitters.
    """

    __slots__ = ("capacity", "held_bytes", "hits", "misses", "dropped",
                 "_free", "_pooled_ids", "_lock")

    def __init__(self, capacity: int = 64 << 20) -> None:
        self.capacity = capacity
        self.held_bytes = 0
        self.hits = 0
        self.misses = 0
        self.dropped = 0
        self._free: Dict[int, List[np.ndarray]] = {}
        self._pooled_ids: set = set()
        self._lock = threading.Lock()

    @staticmethod
    def _size_class(nbytes: int) -> int:
        """Round up to the pow2 size class (64-byte floor)."""
        return 1 << max(6, (int(nbytes) - 1).bit_length()) if nbytes > 64 \
            else 64

    def take(self, shape, dtype, zero: bool = True) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        cls = self._size_class(nbytes)
        with self._lock:
            lst = self._free.get(cls)
            if lst:
                raw = lst.pop()
                self._pooled_ids.discard(id(raw))
                self.held_bytes -= cls
                self.hits += 1
            else:
                raw = None
                self.misses += 1
        if raw is None:
            raw = np.empty(cls, dtype=np.uint8)
        view = raw[:nbytes].view(dtype).reshape(shape)
        if zero:
            view.fill(0)
        return view

    def release(self, arr: np.ndarray) -> bool:
        """Return ``arr``'s backing to the pool.  The caller must drop
        every live view of it — reuse hands the same bytes to the next
        ``take``."""
        raw = arr
        while raw.base is not None:
            raw = raw.base
        if (raw.dtype != np.uint8 or not raw.flags["OWNDATA"]
                or raw.nbytes != self._size_class(raw.nbytes)):
            return False          # not a pool backing — leave to the gc
        cls = raw.nbytes
        with self._lock:
            if id(raw) in self._pooled_ids:
                return False      # already pooled (double release)
            if self.held_bytes + cls > self.capacity:
                self.dropped += 1
                return False
            self._free.setdefault(cls, []).append(raw)
            self._pooled_ids.add(id(raw))
            self.held_bytes += cls
            return True

    def telemetry(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "dropped": self.dropped, "held_bytes": self.held_bytes}


class DeviceMemory:
    """Buffers for params (by name), module globals, and per-wg shared."""

    def __init__(self, buffers: Dict[str, np.ndarray],
                 globals_mem: Optional[Dict[str, np.ndarray]] = None,
                 budget: Optional[int] = None,
                 pool: Optional[DevicePool] = None) -> None:
        self.buffers = buffers
        self.globals_mem = globals_mem or {}
        self.shared: Dict[int, np.ndarray] = {}   # id(GlobalVar) -> array
        # grid-level batching of private-shared-memory kernels: when set
        # (per chunk, by launch), shared vars allocate a (n_wgs, size)
        # TILE TABLE — one private row slice per batched workgroup —
        # instead of one workgroup's array
        self.grid_wgs: Optional[int] = None
        # VOLT_MEM_BUDGET governance (core/governor.py): lazy allocs
        # are charged against ``budget``; overruns raise an EngineFault
        # at site "mem.alloc" BEFORE allocating, so the chain retries
        # on a smaller-footprint rung (per-wg tiles instead of a grid
        # tile table) or surfaces at the oracle floor
        self.budget = budget
        self.allocated = 0
        # pooled allocator: shared arrays / tile tables come from the
        # size-class cache instead of fresh np.zeros (zero-filled either
        # way — pooling is semantically invisible); reset_shared returns
        # them for the next chunk/launch to reuse
        self.pool = pool

    def _alloc(self, shape, elem_ty, what: str) -> np.ndarray:
        if _faults.ACTIVE:
            _faults.maybe_fault("mem.alloc")
        dtype = _TY_DTYPE[elem_ty]
        if self.budget is not None:
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if self.allocated + nbytes > self.budget:
                raise _faults.EngineFault(
                    f"device memory budget exceeded allocating {what} "
                    f"({self.allocated} + {nbytes} > {self.budget} "
                    f"bytes)", site="mem.alloc")
            self.allocated += nbytes
        if self.pool is not None:
            return self.pool.take(shape, dtype, zero=True)
        return np.zeros(shape, dtype=dtype)

    def __del__(self) -> None:
        # end-of-launch pool return: the final chunk/workgroup's tiles
        # are only dropped when the launch's DeviceMemory dies, so hand
        # them back to the free list here (guarded: interpreter
        # shutdown may have torn the pool down already)
        if getattr(self, "pool", None) is not None and self.shared:
            try:
                self.reset_shared()
            except Exception:
                pass

    def reset_shared(self) -> None:
        """Fresh shared memory for the next workgroup / grid chunk;
        releases the previous allocations' budget charge.  Safe release
        point for the pool: it is only reached once every state of the
        previous chunk/workgroup is finished with its arrays."""
        if self.budget is not None and self.shared:
            self.allocated -= sum(a.nbytes for a in self.shared.values())
        if self.pool is not None:
            for a in self.shared.values():
                self.pool.release(a)
        self.shared = {}

    def resolve(self, ptr: Value, argmap: Dict[int, Any]) -> Tuple[np.ndarray, bool]:
        """-> (array, is_shared)"""
        if isinstance(ptr, Param):
            v = argmap.get(id(ptr))
            if isinstance(v, np.ndarray):
                return v, False
            if isinstance(v, (Param, GlobalVar)):
                return self.resolve(v, argmap)
            raise ExecError(f"pointer param {ptr.name} not bound")
        if isinstance(ptr, GlobalVar):
            if ptr.space is AddrSpace.SHARED:
                arr = self.shared.get(id(ptr))
                if arr is None:
                    if self.grid_wgs is not None:
                        arr = self._alloc((self.grid_wgs, ptr.size),
                                          ptr.elem_ty,
                                          f"shared tile table {ptr.name}")
                    else:
                        arr = self._alloc((ptr.size,), ptr.elem_ty,
                                          f"shared {ptr.name}")
                    self.shared[id(ptr)] = arr
                return arr, True
            arr = self.globals_mem.get(ptr.name)
            if arr is None:
                arr = self._alloc((ptr.size,), ptr.elem_ty,
                                  f"global {ptr.name}")
                self.globals_mem[ptr.name] = arr
            return arr, False
        raise ExecError(f"cannot resolve pointer {ptr!r}")


class _SharedBudget:
    """Cross-worker view of one launch's memory budget: per-chunk
    scratch (shared tiles / tile tables) allocated by concurrent
    workers charges ONE launch-wide ledger under a lock, so
    ``VOLT_MEM_BUDGET`` bounds the true concurrent footprint rather
    than each worker's private slice of it."""

    __slots__ = ("limit", "used", "lock")

    def __init__(self, limit: Optional[int], used0: int) -> None:
        self.limit = limit
        self.used = used0
        self.lock = threading.Lock()

    def charge(self, nbytes: int, what: str) -> None:
        if self.limit is None:
            return
        with self.lock:
            if self.used + nbytes > self.limit:
                raise _faults.EngineFault(
                    f"device memory budget exceeded allocating {what} "
                    f"({self.used} + {nbytes} > {self.limit} bytes)",
                    site="mem.alloc")
            self.used += nbytes

    def release(self, nbytes: int) -> None:
        if self.limit is None:
            return
        with self.lock:
            self.used -= nbytes


class _WorkerMemory(DeviceMemory):
    """One worker's DeviceMemory for a parallel grid chunk.

    Shares the launch's buffers / globals / pool (safe: the
    store-privacy licence keeps cell writes disjoint, non-shared
    globals are pre-resolved on the main thread, and the pool carries
    its own lock) but keeps a PRIVATE ``shared`` dict — each chunk gets
    its own tile table, exactly like the sequential per-chunk
    ``reset_shared()`` — and charges the launch-wide
    :class:`_SharedBudget` instead of a per-instance counter."""

    def __init__(self, base: DeviceMemory, budget: _SharedBudget) -> None:
        super().__init__(base.buffers, base.globals_mem,
                         budget=None, pool=base.pool)
        self.shared_budget = budget

    def _alloc(self, shape, elem_ty, what: str) -> np.ndarray:
        if _faults.ACTIVE:
            _faults.maybe_fault("mem.alloc")
        dtype = _TY_DTYPE[elem_ty]
        self.shared_budget.charge(
            int(np.prod(shape)) * np.dtype(dtype).itemsize, what)
        if self.pool is not None:
            return self.pool.take(shape, dtype, zero=True)
        return np.zeros(shape, dtype=dtype)

    def reset_shared(self) -> None:
        if self.shared:
            self.shared_budget.release(
                sum(a.nbytes for a in self.shared.values()))
            if self.pool is not None:
                for a in self.shared.values():
                    self.pool.release(a)
            self.shared = {}


# --------------------------------------------------------------------------
# Warp executor (generator; yields at barriers)
# --------------------------------------------------------------------------

class _WarpCtx:
    def __init__(self, W: int, intr: Dict[Tuple[str, int], np.ndarray],
                 strict_loads: bool = False, affine_ok: bool = False,
                 affine_span: int = 0) -> None:
        self.W = W
        self.intr = intr
        self.strict_loads = strict_loads
        # launch-layout licence for the coalescing engine's analytic
        # fast path (interp_mem.AffineFact.ok): global_id(0)/local_id(0)
        # are lane-affine only when no warp wraps a local_size boundary
        # mid-row, and the monotone claim needs the chain's int32
        # arithmetic to be wrap-free over the launch's index span
        self.affine_ok = affine_ok
        self.affine_span = affine_span


def _exec_warp(fn: Function, argmap: Dict[int, Any], mask0: np.ndarray,
               ctx: _WarpCtx, mem: DeviceMemory, stats: ExecStats,
               fuel: List[int]) -> Generator[str, None, np.ndarray]:
    W = ctx.W
    strict_loads = ctx.strict_loads
    env: Dict[int, np.ndarray] = {}
    slots: Dict[int, np.ndarray] = {}
    tokens: Dict[int, np.ndarray] = {}
    mask = mask0.copy()
    stack: List[Dict[str, Any]] = []
    pending_split: Optional[Instr] = None

    def val(v: Value) -> np.ndarray:
        if isinstance(v, Const):
            return _const_vec(v, W)
        if isinstance(v, Reg):
            return env[id(v)]
        if isinstance(v, Param):
            a = argmap.get(id(v))
            if isinstance(a, np.ndarray) and a.ndim == 1 and len(a) == W:
                return a
            raise ExecError(f"unbound param {v.name}")
        raise ExecError(f"cannot evaluate {v!r}")

    block = fn.entry
    idx = 0
    while True:
        fuel[0] -= 1
        if fuel[0] <= 0:
            raise ExecError("out of fuel (possible infinite loop)")
        if _gov.ACTIVE:
            _gov.deadline_check()
        i = block.instrs[idx]
        op = i.op
        if mask.any():
            stats.instrs += 1
            stats.by_op[op.value] += 1

        # ---- terminators -------------------------------------------------
        if op is Op.BR:
            block, idx = i.operands[0], 0
            pending_split = None
            continue
        if op is Op.CBR:
            c = val(i.operands[0]).astype(bool)
            then_bb, else_bb = i.operands[1], i.operands[2]
            if pending_split is not None:
                sp = pending_split
                pending_split = None
                neg = sp.attrs.get("negate", False)
                # hardware partitions lanes by the SPLIT's own predicate —
                # if a late pass inverted the branch without repairing the
                # split (Fig 5a hazard), the wrong lanes activate here.
                sp_val = val(sp.operands[0]).astype(bool)
                cc = ~sp_val if neg else sp_val
                then_mask = mask & cc
                else_mask = mask & ~cc
                entry = {"tok": id(sp.result), "saved": mask.copy(),
                         "else_pc": None, "else_mask": None}
                if then_mask.any() and else_mask.any():
                    entry["else_pc"] = else_bb
                    entry["else_mask"] = else_mask
                    stack.append(entry)
                    stats.max_ipdom_depth = max(stats.max_ipdom_depth,
                                                len(stack))
                    mask = then_mask
                    block, idx = then_bb, 0
                elif then_mask.any():
                    stack.append(entry)
                    mask = then_mask
                    block, idx = then_bb, 0
                else:
                    stack.append(entry)
                    mask = else_mask
                    block, idx = else_bb, 0
                continue
            # un-split branch: must be uniform over active lanes
            if mask.any():
                act = c[mask]
                if act.any() != act.all():
                    raise UniformityViolation(
                        f"divergent un-managed branch in %{block.label} "
                        f"of @{fn.name}")
                taken = bool(act[0])
            else:
                taken = True
            block, idx = (then_bb if taken else else_bb), 0
            continue
        if op is Op.PRED:
            c = val(i.operands[0]).astype(bool)
            if i.attrs.get("negate", False):
                c = ~c
            tok = i.operands[1]
            inside, outside = i.operands[2], i.operands[3]
            new_mask = mask & c
            if new_mask.any():
                mask = new_mask
                block, idx = inside, 0
            else:
                mask = tokens[id(tok)].copy()
                block, idx = outside, 0
            continue
        if op is Op.RET:
            if stack:
                raise ExecError("RET with non-empty IPDOM stack")
            if i.operands:
                return val(i.operands[0])
            return np.zeros(W, dtype=np.float32)

        # ---- divergence-management non-terminators -------------------------
        if op is Op.SPLIT:
            pending_split = i
            idx += 1
            continue
        if op is Op.JOIN:
            tok = i.operands[0]
            if not stack or stack[-1]["tok"] != id(tok):
                raise ExecError("vx_join token mismatch at runtime")
            top = stack.pop()
            if top["else_pc"] is not None:
                stack.append({"tok": top["tok"], "saved": top["saved"],
                              "else_pc": None, "else_mask": None})
                mask = top["else_mask"]
                block, idx = top["else_pc"], 0
            else:
                mask = top["saved"]
                idx += 1
            continue
        if op is Op.TMC_SAVE:
            tokens[id(i.result)] = mask.copy()
            idx += 1
            continue
        if op is Op.TMC_RESTORE:
            mask = tokens[id(i.operands[0])].copy()
            idx += 1
            continue

        # ---- ordinary instructions (execute under mask) ---------------------
        if op is Op.BARRIER:
            yield "barrier"
            idx += 1
            continue
        if op is Op.SLOT_LOAD:
            s = i.operands[0]
            arr = slots.get(id(s))
            if arr is None:
                arr = np.zeros(W, dtype=_TY_DTYPE[s.ty])
                slots[id(s)] = arr
            env[id(i.result)] = arr.copy()
            idx += 1
            continue
        if op is Op.SLOT_STORE:
            s, v = i.operands
            arr = slots.get(id(s))
            nv = val(v)
            if arr is None:
                arr = np.zeros(W, dtype=nv.dtype)
            slots[id(s)] = np.where(mask, nv, arr)
            idx += 1
            continue
        if op is Op.LOAD:
            buf, _shared = mem.resolve(i.operands[0], argmap)
            ix = val(i.operands[1]).astype(np.int64)
            if mask.any():
                a_ix = ix[mask]
                if strict_loads and ((a_ix < 0).any()
                                     or (a_ix >= len(buf)).any()):
                    raise ExecError(
                        f"OOB load in @{fn.name}: idx={a_ix} size={len(buf)}")
                a_ix = np.clip(a_ix, 0, len(buf) - 1)
                uniq = _mem.count_gathered(a_ix)
                if _shared:
                    stats.shared_requests += uniq
                else:
                    stats.mem_requests += uniq
                stats.mem_insts += 1
            safe = np.clip(ix, 0, len(buf) - 1)
            env[id(i.result)] = buf[safe]
            idx += 1
            continue
        if op is Op.STORE:
            buf, _shared = mem.resolve(i.operands[0], argmap)
            ix = val(i.operands[1]).astype(np.int64)
            v = val(i.operands[2])
            if mask.any():
                a_ix = ix[mask]
                if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                    raise ExecError(
                        f"OOB store in @{fn.name}: idx={a_ix} size={len(buf)}")
                uniq = _mem.count_gathered(a_ix)
                if _shared:
                    stats.shared_requests += uniq
                else:
                    stats.mem_requests += uniq
                stats.mem_insts += 1
                buf[a_ix] = v[mask].astype(buf.dtype)
            idx += 1
            continue
        if op is Op.ATOMIC:
            kind = i.operands[0]
            buf, _shared = mem.resolve(i.operands[1], argmap)
            ix = val(i.operands[2]).astype(np.int64)
            v = val(i.operands[3])
            old = np.zeros(W, dtype=buf.dtype)
            if mask.any():
                lanes = np.nonzero(mask)[0]
                a_ix = ix[lanes]
                if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                    raise ExecError(f"OOB atomic in @{fn.name}")
                stats.mem_requests += _mem.count_gathered(a_ix)
                stats.mem_insts += 1
                # contended RMW serializes per address (hardware behavior)
                stats.atomic_serial += len(lanes)
                _atomic_rmw(kind, buf, ix, lanes, v, old)
            env[id(i.result)] = old
            idx += 1
            continue
        if op is Op.INTR:
            name, dim = i.operands[0], i.operands[1]
            key = (name, dim)
            if key not in ctx.intr:
                raise ExecError(f"intrinsic {name}.{dim} not provided")
            env[id(i.result)] = ctx.intr[key]
            idx += 1
            continue
        if op is Op.VOTE:
            mode = i.operands[0]
            v = val(i.operands[1]).astype(bool)
            act = v & mask
            if mode == "any":
                r = np.full(W, bool(act.any()))
            elif mode == "all":
                r = np.full(W, bool((v | ~mask)[mask].all()) if mask.any()
                            else True)
            elif mode == "ballot":
                bits = 0
                for ln in range(W):
                    if mask[ln] and v[ln]:
                        bits |= (1 << ln)
                r = np.full(W, bits, dtype=np.int64).astype(np.int32)
            else:
                raise ExecError(f"unknown vote mode {mode}")
            env[id(i.result)] = r
            idx += 1
            continue
        if op is Op.SHFL:
            v = val(i.operands[0])
            src = val(i.operands[1]).astype(np.int64) % W
            env[id(i.result)] = v[src]
            idx += 1
            continue
        if op is Op.PRINT:
            vals = [val(o)[mask] for o in i.operands if isinstance(o, Value)]
            stats.prints.append(" ".join(str(x) for x in vals))
            idx += 1
            continue
        if op is Op.CALL:
            callee: Function = i.operands[0]
            if not mask.any():     # hardware would not issue the call body
                if i.result is not None:
                    env[id(i.result)] = np.zeros(
                        W, dtype=_TY_DTYPE.get(callee.ret_ty, np.float32))
                idx += 1
                continue
            cargs: Dict[int, Any] = {}
            for p, a in zip(callee.params, i.operands[1:]):
                if p.ty is Ty.PTR:
                    # pointer pass-through (params/globals)
                    if isinstance(a, (Param, GlobalVar)):
                        arr, _ = mem.resolve(a, argmap)
                        cargs[id(p)] = arr
                    else:
                        raise ExecError("pointer arg must be param/global")
                else:
                    cargs[id(p)] = val(a)
            r = yield from _exec_warp(callee, cargs, mask, ctx, mem, stats,
                                      fuel)
            if i.result is not None:
                env[id(i.result)] = r
            idx += 1
            continue
        if op is Op.CMOV:
            c = val(i.operands[0]).astype(bool)
            a = val(i.operands[1])
            b2 = val(i.operands[2])
            env[id(i.result)] = np.where(c, a, b2)
            idx += 1
            continue
        if op is Op.SELECT:
            c = val(i.operands[0]).astype(bool)
            env[id(i.result)] = np.where(c, val(i.operands[1]),
                                         val(i.operands[2]))
            idx += 1
            continue

        # generic pure ops
        from .vir import BINOPS, UNOPS
        if op in BINOPS:
            env[id(i.result)] = _np_binop(op, val(i.operands[0]),
                                          val(i.operands[1]))
            idx += 1
            continue
        if op in UNOPS:
            env[id(i.result)] = _np_unop(op, val(i.operands[0]))
            idx += 1
            continue
        raise ExecError(f"unhandled op {op}")


# --------------------------------------------------------------------------
# Pre-decoded warp executor
#
# ``_exec_warp`` above re-discovers everything about an instruction on every
# dynamic visit: a long ``if op is ...`` cascade, ``isinstance`` checks and
# ``id()`` dict probes per operand, a ``np.errstate`` context per arithmetic
# op.  The decoder below compiles a Function ONCE into a flat, table-driven
# program:
#
#   * registers / slots / params get dense indices into plain lists;
#   * every instruction becomes a specialized closure bound to its numpy
#     handler and pre-resolved operand accessors;
#   * straight-line runs (during which the thread mask cannot change) are
#     batched: one fuel decrement, one bulk ExecStats update, then a bare
#     ``for h in handlers`` loop;
#   * each block ends in a terminator descriptor driving the IPDOM
#     split/join machinery; vx_join / tmc_restore / barriers / calls are
#     their own control nodes since they can change the mask or suspend;
#   * pointer operands are resolved to device arrays once per activation
#     (warp start / call entry), not per memory access.
#
# The decoded program is cached on the Function, keyed by its IR version
# counter (vir.Function.ir_version), the warp width and the OOB-load mode —
# mutating the IR invalidates the cache automatically.  Semantics, dynamic
# instruction counts and memory statistics are bit-identical to
# ``_exec_warp`` (tested in tests/test_perf_caches.py).
# --------------------------------------------------------------------------

_PLAIN_OPS = (BINOPS | UNOPS |
              {Op.SELECT, Op.CMOV, Op.SLOT_LOAD, Op.SLOT_STORE, Op.LOAD,
               Op.STORE, Op.ATOMIC, Op.INTR, Op.VOTE, Op.SHFL, Op.PRINT,
               Op.SPLIT, Op.TMC_SAVE})


# --------------------------------------------------------------------------
# Decode-level slot fusion.
#
# The front-ends build LLVM-before-mem2reg style IR: every mutable kernel
# variable round-trips through a stack slot, so straight-line runs are full
# of slot_store -> slot_load chains.  Within one run the thread mask cannot
# change, which makes three rewrites exact:
#
#   * stores to slots that are never loaded anywhere in the function are
#     dead traffic — dropped;
#   * a store overwritten by a later store in the same run with no
#     intervening load of that slot is dead — dropped (the masked merge
#     where(mask, v2, where(mask, v1, old)) == where(mask, v2, old));
#   * an adjacent store;load pair collapses into one handler, and repeated
#     loads of an unmodified slot alias the first load's register.
#
# ExecStats / fuel keep counting the ORIGINAL instruction mix (n, by_op are
# computed before fusion), so the decoded and legacy executors stay
# bit-identical; only the handler table shrinks.  The fused program lives
# in the same ir_version-keyed decode cache, so any IR mutation re-fuses.
# --------------------------------------------------------------------------

def _fuse_run(instrs: Sequence[Instr], loaded_slots) -> Tuple[list, int, dict]:
    n = len(instrs)
    bo: Counter = Counter()
    for i in instrs:
        bo[i.op.value] += 1
    items: List[Any] = []
    last_store: Dict[int, int] = {}   # slot id -> items idx of unconsumed store
    last_load: Dict[int, Reg] = {}    # slot id -> result reg of live load
    for i in instrs:
        op = i.op
        if op is Op.SLOT_STORE:
            sid = id(i.operands[0])
            if sid not in loaded_slots:
                continue                      # dead slot: never loaded at all
            prev = last_store.get(sid)
            if prev is not None:
                items[prev] = None            # dead store: overwritten unread
            last_store[sid] = len(items)
            last_load.pop(sid, None)
            items.append(("store", i))
        elif op is Op.SLOT_LOAD:
            sid = id(i.operands[0])
            src = last_load.get(sid)
            if src is not None:
                items.append(("alias", i, src))
            else:
                prev = last_store.get(sid)
                if (prev is not None and prev == len(items) - 1
                        and items[prev] is not None
                        and items[prev][0] == "store"):
                    items[prev] = ("store_load", items[prev][1], i)
                else:
                    items.append(("load", i))
                last_store.pop(sid, None)     # store observed: no longer dead
            last_load[sid] = i.result
        else:
            items.append(("instr", i))
    return [it for it in items if it is not None], n, dict(bo)


class _SplitDesc:
    """Decoded vx_split: consulted by the following CBR."""
    __slots__ = ("gcond", "attrs", "tok")

    def __init__(self, gcond, attrs, tok) -> None:
        self.gcond = gcond
        self.attrs = attrs   # the Instr's live attrs dict (negate flag)
        self.tok = tok       # dense reg index of the token


class _DState:
    """Per-activation mutable state (one warp, one device-fn call, or —
    with a (n_warps, W) mask — one batched workgroup activation)."""
    __slots__ = ("env", "slots", "args", "argmap", "mem_arrs", "mask",
                 "active", "act_rows", "stack", "pending", "ret", "intr",
                 "ctx", "mem", "stats", "fuel", "warp_ctxs",
                 "shared_row", "stripe")

    def __init__(self, prog: "_DProgram", argmap: Dict[int, Any],
                 mask: np.ndarray, ctx: _WarpCtx, mem: DeviceMemory,
                 stats: ExecStats, fuel: List[int]) -> None:
        self.env: List[Any] = [None] * prog.n_regs
        self.slots: List[Any] = [None] * prog.n_slots
        self.args = [argmap.get(id(p)) for p in prog.params]
        self.argmap = argmap
        self.mem_arrs = [mem.resolve(v, argmap) for v in prog.memrefs]
        self.mask = mask
        if mask.ndim == 2:             # batched workgroup activation:
            ar = mask.any(axis=1)      # active = #warps with a live mask,
            self.act_rows = ar         # kept in sync by the batched nodes
            self.active = int(ar.sum())
        else:
            self.act_rows = None
            self.active = bool(mask.any())
        self.stack: List[Any] = []     # IPDOM entries: (tok, saved, else_bi, else_mask)
        self.pending: Optional[_SplitDesc] = None
        self.ret: Any = None
        self.intr = ctx.intr
        self.ctx = ctx
        self.mem = mem
        self.stats = stats
        self.fuel = fuel
        self.warp_ctxs: Optional[List[_WarpCtx]] = None
        # grid-mode per-warp slices: which (n_wgs, size) tile row this
        # state's workgroup owns (set by _slice_state)
        self.shared_row: Optional[int] = None
        # multi-launch coalescing: the per-tenant accounting stripe
        # (_Stripe) when this batch packs rows of several launches
        self.stripe: Optional["_Stripe"] = None


class _CoalesceAbort(Exception):
    """A coalesced multi-launch chunk cannot proceed as a group (fault,
    desync, per-tenant fuel/deadline trip, OOB, …).  The staging tables
    are dropped — tenant buffers were never touched — and every tenant
    re-runs solo through the normal degradation chain, which is the
    authority for exact per-launch errors and demotion."""


class _Stripe:
    """Per-tenant accounting for a coalesced multi-launch batch.

    Rows of the batch belong to ``k`` different launches ("tenants");
    ``row_tenant`` maps each row of the current chunk to its tenant.
    Stats must de-mix bit-identically to running each launch alone, but
    per-node per-tenant bincounts would swamp the hot path — so charges
    accrue in *epochs*: between mask changes the active-row set is
    constant, per-node charges accumulate as scalars
    (``epoch_n``/``epoch_ops``), and one vector multiply per mask change
    distributes them over tenants via the cached active-row tenant
    counts.  Per-node cost stays ~identical to the solo ExecStats code.
    """
    __slots__ = ("k", "row_tenant", "row_col", "counts", "epoch_n",
                 "epoch_ops", "instrs", "by_op", "mem_requests",
                 "mem_insts", "shared_requests", "depth", "fuel_used",
                 "fuel_budget")

    def __init__(self, k: int, fuel_budgets) -> None:
        self.k = k
        self.instrs = np.zeros(k, np.int64)
        self.by_op: Dict[int, np.ndarray] = {}
        self.mem_requests = np.zeros(k, np.int64)
        self.mem_insts = np.zeros(k, np.int64)
        self.shared_requests = np.zeros(k, np.int64)
        self.depth = np.zeros(k, np.int64)
        self.fuel_used = np.zeros(k, np.int64)
        self.fuel_budget = np.asarray(fuel_budgets, np.int64)
        self.row_tenant: Optional[np.ndarray] = None
        self.row_col: Optional[np.ndarray] = None
        self.counts = np.zeros(k, np.int64)
        self.epoch_n = 0
        self.epoch_ops: Dict[int, int] = {}

    def begin_chunk(self, row_tenant: np.ndarray,
                    act_rows: np.ndarray) -> None:
        self.flush()
        self.row_tenant = row_tenant
        self.row_col = row_tenant[:, None]
        self.counts = np.bincount(row_tenant[act_rows], minlength=self.k)

    def flush(self) -> None:
        """Distribute the pending epoch over tenants (called at every
        mask change and at chunk end)."""
        n = self.epoch_n
        if not n and not self.epoch_ops:
            return
        c = self.counts
        self.instrs += n * c
        self.fuel_used += n * c
        byop = self.by_op
        for opv, cnt in self.epoch_ops.items():
            vec = byop.get(opv)
            if vec is None:
                vec = byop[opv] = np.zeros(self.k, np.int64)
            vec += cnt * c
        self.epoch_n = 0
        self.epoch_ops.clear()
        # early-abort heuristic only: the batch-level fuel counter (the
        # summed budget) remains the hard backstop, and the solo rerun
        # after an abort is the authority for the exact fuel error
        if (self.fuel_used > self.fuel_budget).any():
            raise _CoalesceAbort("per-tenant fuel budget exhausted")

    def set_counts(self, act_rows: np.ndarray) -> None:
        """Epoch boundary: flush against the OLD counts, then rebuild
        the per-tenant active-row counts from the new mask."""
        self.flush()
        self.counts = np.bincount(self.row_tenant[act_rows],
                                  minlength=self.k)

    def charge_rows(self, dest: np.ndarray, per_row: np.ndarray) -> None:
        """Aggregate a per-ROW charge vector (e.g. count_rows_split) into
        the per-TENANT accumulator ``dest``."""
        np.add.at(dest, self.row_tenant, per_row)

    def demix(self, j: int) -> ExecStats:
        """Tenant ``j``'s exact solo ExecStats."""
        s = ExecStats()
        s.instrs = int(self.instrs[j])
        s.mem_requests = int(self.mem_requests[j])
        s.mem_insts = int(self.mem_insts[j])
        s.shared_requests = int(self.shared_requests[j])
        s.max_ipdom_depth = int(self.depth[j])
        for opv, vec in self.by_op.items():
            v = int(vec[j])
            if v:                  # solo Counters never hold zeros
                s.by_op[opv] = v
        return s

    def merge(self, o: "_Stripe") -> None:
        """Fold a chunk-private stripe in (parallel coalesced dispatch;
        called on the main thread in chunk order).  Sums mirror the
        sequential accumulation on one stripe; ``depth`` is a running
        per-tenant max.  Re-checks the per-tenant fuel budgets after
        folding — a chunk-private stripe only sees its own usage, so
        the cumulative early-abort check moves to the merge."""
        self.instrs += o.instrs
        self.mem_requests += o.mem_requests
        self.mem_insts += o.mem_insts
        self.shared_requests += o.shared_requests
        self.fuel_used += o.fuel_used
        np.maximum(self.depth, o.depth, out=self.depth)
        for opv, vec in o.by_op.items():
            mine = self.by_op.get(opv)
            if mine is None:
                self.by_op[opv] = vec.copy()
            else:
                mine += vec
        if (self.fuel_used > self.fuel_budget).any():
            raise _CoalesceAbort("per-tenant fuel budget exhausted")


class _DBlock:
    __slots__ = ("nodes", "label")

    def __init__(self, nodes, label) -> None:
        self.nodes = nodes
        self.label = label


def _decode(fn: Function, W: int, strict: bool) -> "_DProgram":
    """Decode ``fn`` (memoized on the function, keyed by IR version)."""
    if _faults.ACTIVE:
        _faults.maybe_fault("decode")
    cache = getattr(fn, "_decode_cache", None)
    if cache is None:
        cache = {}
        fn._decode_cache = cache  # type: ignore[attr-defined]
    key = (fn.ir_version, W, bool(strict))
    prog = cache.get(key)
    if prog is None:
        for k in [k for k in cache if k[0] != fn.ir_version]:
            del cache[k]          # stale IR versions can never hit again
        prog = _DProgram(fn, W, bool(strict))
        cache[key] = prog
    return prog


class _DProgram:
    # ops fused into straight-line runs; _BProgram shrinks this set because
    # warp-ordering-sensitive ops must sit at batched node boundaries
    FUSEABLE = _PLAIN_OPS

    def __init__(self, fn: Function, W: int, strict: bool) -> None:
        self.fn = fn
        self.W = W
        self.strict = strict
        # decode-time affine index facts: licence for the coalescing
        # engine's analytic fast path (closed-form / sort-free counts);
        # served by the (optionally disk-persistent) decode plan
        self.mem_facts = _decode_plan(fn)["facts_obj"]
        self.params = list(fn.params)
        # dense indices -------------------------------------------------
        self.reg_idx: Dict[int, int] = {}
        self.slot_idx: Dict[int, int] = {}
        self.memrefs: List[Value] = []
        self._memref_idx: Dict[int, int] = {}
        self.slot_meta: List[Slot] = []
        self.loaded_slots: set = set()
        for i in fn.instructions():
            if i.result is not None:
                self.reg_idx.setdefault(id(i.result), len(self.reg_idx))
            if i.op is Op.SLOT_LOAD:
                self.loaded_slots.add(id(i.operands[0]))
            for o in i.operands:
                if isinstance(o, Reg):
                    self.reg_idx.setdefault(id(o), len(self.reg_idx))
                elif isinstance(o, Slot):
                    if id(o) not in self.slot_idx:
                        self.slot_idx[id(o)] = len(self.slot_idx)
                        self.slot_meta.append(o)
        self.n_regs = len(self.reg_idx)
        self.n_slots = len(self.slot_idx)
        # fusion telemetry (benchmarks / tests): dynamic-table shrinkage
        self.n_run_instrs = 0
        self.n_run_handlers = 0
        self._bidx = {id(b): k for k, b in enumerate(fn.blocks)}
        self.blocks: List[_DBlock] = [self._decode_block(b)
                                      for b in fn.blocks]

    # -- run partition -----------------------------------------------------
    def _partition(self, b: Block) -> List[Tuple[str, Any]]:
        """Split a block into fused straight-line runs and control points."""
        parts: List[Tuple[str, Any]] = []
        run: List[Instr] = []
        for i in b.instrs:
            if i.op in self.FUSEABLE:
                run.append(i)
            else:
                if run:
                    parts.append(("run", run))
                    run = []
                parts.append(("ctrl", i))
        if run:
            parts.append(("run", run))
        return parts

    # -- decode helpers ----------------------------------------------------
    def _memref(self, v: Value) -> int:
        j = self._memref_idx.get(id(v))
        if j is None:
            j = len(self.memrefs)
            self._memref_idx[id(v)] = j
            self.memrefs.append(v)
        return j

    def _getter(self, v: Value):
        W = self.W
        if isinstance(v, Const):
            vec = _const_vec(v, W)
            return lambda st, vec=vec: vec
        if isinstance(v, Reg):
            ri = self.reg_idx[id(v)]
            return lambda st, ri=ri: st.env[ri]
        if isinstance(v, Param):
            if v.ty is Ty.PTR:
                raise ExecError(f"pointer param {v.name} used as value")
            k = self.params.index(v)

            def getp(st, k=k, name=v.name):
                a = st.args[k]
                if a is None:
                    raise ExecError(f"unbound param {name}")
                return a
            return getp
        raise ExecError(f"cannot evaluate {v!r}")

    # -- block decode ------------------------------------------------------
    def _decode_block(self, b: Block) -> _DBlock:
        nodes: List[Any] = []
        for kind, payload in self._partition(b):
            if kind == "run":
                items, n, bo = _fuse_run(payload, self.loaded_slots)
                hs = tuple(self._emit_item(it) for it in items)
                self.n_run_instrs += n
                self.n_run_handlers += len(hs)

                def run_node(st, hs=hs, n=n, bo=bo):
                    f = st.fuel
                    f[0] -= n
                    if f[0] <= 0:
                        raise ExecError(
                            "out of fuel (possible infinite loop)")
                    if st.active:
                        stt = st.stats
                        stt.instrs += n
                        stt.by_op.update(bo)
                    for h in hs:
                        h(st)
                    return None
                nodes.append(run_node)
            else:
                nodes.append(self._control(payload, b))
        return _DBlock(tuple(nodes), b.label)

    # -- fused-item dispatch ----------------------------------------------
    def _emit_item(self, item):
        kind = item[0]
        if kind in ("instr", "store", "load"):
            return self._plain(item[1])
        if kind == "alias":
            ri = self.reg_idx[id(item[1].result)]
            rj = self.reg_idx[id(item[2])]

            def h(st, ri=ri, rj=rj):
                st.env[ri] = st.env[rj]
            return h
        if kind == "store_load":
            s_i, l_i = item[1], item[2]
            si = self.slot_idx[id(s_i.operands[0])]
            gv = self._getter(s_i.operands[1])
            ri = self.reg_idx[id(l_i.result)]
            W = self.W

            def h(st, si=si, gv=gv, ri=ri, W=W):
                nv = gv(st)
                arr = st.slots[si]
                if arr is None:
                    arr = np.zeros(W, dtype=nv.dtype)
                arr = np.where(st.mask, nv, arr)
                st.slots[si] = arr
                st.env[ri] = arr
            return h
        raise ExecError(f"unknown fused item {kind}")

    # -- plain (straight-line) handlers -----------------------------------
    def _plain(self, i: Instr):
        op = i.op
        W = self.W
        g = self._getter
        if op in BINOPS:
            fn = _BIN_FNS[op]
            ga, gb = g(i.operands[0]), g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, fn=fn, ga=ga, gb=gb, ri=ri):
                st.env[ri] = fn(ga(st), gb(st))
            return h
        if op in UNOPS:
            fn = _UN_FNS[op]
            ga = g(i.operands[0])
            ri = self.reg_idx[id(i.result)]

            def h(st, fn=fn, ga=ga, ri=ri):
                st.env[ri] = fn(ga(st))
            return h
        if op in (Op.SELECT, Op.CMOV):
            gc_, ga, gb = (g(o) for o in i.operands[:3])
            ri = self.reg_idx[id(i.result)]

            def h(st, gc_=gc_, ga=ga, gb=gb, ri=ri):
                st.env[ri] = np.where(gc_(st).astype(bool), ga(st), gb(st))
            return h
        if op is Op.SLOT_LOAD:
            si = self.slot_idx[id(i.operands[0])]
            dt = _TY_DTYPE[i.operands[0].ty]
            ri = self.reg_idx[id(i.result)]

            def h(st, si=si, dt=dt, ri=ri, W=W):
                arr = st.slots[si]
                if arr is None:
                    arr = np.zeros(W, dtype=dt)
                    st.slots[si] = arr
                st.env[ri] = arr
            return h
        if op is Op.SLOT_STORE:
            si = self.slot_idx[id(i.operands[0])]
            gv = g(i.operands[1])

            def h(st, si=si, gv=gv, W=W):
                nv = gv(st)
                arr = st.slots[si]
                if arr is None:
                    arr = np.zeros(W, dtype=nv.dtype)
                st.slots[si] = np.where(st.mask, nv, arr)
            return h
        if op is Op.LOAD:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]
            strict = self.strict
            fname = self.fn.name
            fact = self.mem_facts.index_fact.get(id(i))

            def h(st, mi=mi, gi_=gi_, ri=ri, strict=strict, fname=fname,
                  fact=fact):
                buf, shared = st.mem_arrs[mi]
                ix = gi_(st).astype(np.int64)
                safe = np.clip(ix, 0, len(buf) - 1)
                if st.active:
                    if strict:
                        a_ix = ix[st.mask]
                        if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                            raise ExecError(
                                f"OOB load in @{fname}: idx={a_ix} "
                                f"size={len(buf)}")
                    uniq = _mem.count_warp(safe, st.mask, fact, st.ctx)
                    stt = st.stats
                    if shared:
                        stt.shared_requests += uniq
                    else:
                        stt.mem_requests += uniq
                    stt.mem_insts += 1
                st.env[ri] = buf[safe]
            return h
        if op is Op.STORE:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            gv = g(i.operands[2])
            fname = self.fn.name
            fact = self.mem_facts.index_fact.get(id(i))

            def h(st, mi=mi, gi_=gi_, gv=gv, fname=fname, fact=fact):
                buf, shared = st.mem_arrs[mi]
                ix = gi_(st).astype(np.int64)
                v = gv(st)
                if st.active:
                    a_ix = ix[st.mask]
                    if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                        raise ExecError(
                            f"OOB store in @{fname}: idx={a_ix} "
                            f"size={len(buf)}")
                    uniq = _mem.count_gathered(a_ix, fact, st.ctx)
                    stt = st.stats
                    if shared:
                        stt.shared_requests += uniq
                    else:
                        stt.mem_requests += uniq
                    stt.mem_insts += 1
                    buf[a_ix] = v[st.mask].astype(buf.dtype)
            return h
        if op is Op.ATOMIC:
            kind = i.operands[0]
            mi = self._memref(i.operands[1])
            gi_ = g(i.operands[2])
            gv = g(i.operands[3])
            ri = self.reg_idx[id(i.result)]
            fname = self.fn.name
            fact = self.mem_facts.index_fact.get(id(i))

            def h(st, kind=kind, mi=mi, gi_=gi_, gv=gv, ri=ri, fname=fname,
                  W=W, fact=fact):
                buf, _shared = st.mem_arrs[mi]
                ix = gi_(st).astype(np.int64)
                v = gv(st)
                old = np.zeros(W, dtype=buf.dtype)
                if st.active:
                    lanes = np.nonzero(st.mask)[0]
                    a_ix = ix[lanes]
                    if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                        raise ExecError(f"OOB atomic in @{fname}")
                    stt = st.stats
                    stt.mem_requests += _mem.count_gathered(a_ix, fact,
                                                            st.ctx)
                    stt.mem_insts += 1
                    stt.atomic_serial += len(lanes)
                    _atomic_rmw(kind, buf, ix, lanes, v, old)
                st.env[ri] = old
            return h
        if op is Op.INTR:
            key = (i.operands[0], i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, key=key, ri=ri):
                a = st.intr.get(key)
                if a is None:
                    raise ExecError(
                        f"intrinsic {key[0]}.{key[1]} not provided")
                st.env[ri] = a
            return h
        if op is Op.VOTE:
            mode = i.operands[0]
            gv = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, mode=mode, gv=gv, ri=ri, W=W):
                v = gv(st).astype(bool)
                mask = st.mask
                act = v & mask
                if mode == "any":
                    r = np.full(W, bool(act.any()))
                elif mode == "all":
                    r = np.full(W, bool((v | ~mask)[mask].all())
                                if st.active else True)
                elif mode == "ballot":
                    bits = 0
                    for ln in range(W):
                        if mask[ln] and v[ln]:
                            bits |= (1 << ln)
                    r = np.full(W, bits, dtype=np.int64).astype(np.int32)
                else:
                    raise ExecError(f"unknown vote mode {mode}")
                st.env[ri] = r
            return h
        if op is Op.SHFL:
            gv = g(i.operands[0])
            gl = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, gv=gv, gl=gl, ri=ri, W=W):
                src = gl(st).astype(np.int64) % W
                st.env[ri] = gv(st)[src]
            return h
        if op is Op.PRINT:
            gs = tuple(g(o) for o in i.operands if isinstance(o, Value))

            def h(st, gs=gs):
                vals = [gg(st)[st.mask] for gg in gs]
                st.stats.prints.append(" ".join(str(x) for x in vals))
            return h
        if op is Op.SPLIT:
            desc = _SplitDesc(g(i.operands[0]), i.attrs,
                              self.reg_idx[id(i.result)])

            def h(st, desc=desc):
                st.pending = desc
            return h
        if op is Op.TMC_SAVE:
            ri = self.reg_idx[id(i.result)]

            def h(st, ri=ri):
                st.env[ri] = st.mask.copy()
            return h
        raise ExecError(f"unhandled op {op}")

    # -- control / terminator nodes ----------------------------------------
    def _control(self, i: Instr, b: Block):
        op = i.op
        opv = op.value
        W = self.W
        g = self._getter
        fname = self.fn.name
        if op is Op.BR:
            tb = self._bidx[id(i.operands[0])]

            def br_node(st, tb=tb, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                st.pending = None
                return tb
            return br_node
        if op is Op.CBR:
            gc_ = g(i.operands[0])
            then_i = self._bidx[id(i.operands[1])]
            else_i = self._bidx[id(i.operands[2])]
            label = b.label

            def cbr_node(st, gc_=gc_, then_i=then_i, else_i=else_i,
                         opv=opv, label=label, fname=fname):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                stt = st.stats
                if st.active:
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                c = gc_(st).astype(bool)
                sp = st.pending
                if sp is not None:
                    st.pending = None
                    neg = sp.attrs.get("negate", False)
                    sp_val = sp.gcond(st).astype(bool)
                    cc = ~sp_val if neg else sp_val
                    mask = st.mask
                    then_mask = mask & cc
                    else_mask = mask & ~cc
                    ta = bool(then_mask.any())
                    if ta and else_mask.any():
                        st.stack.append((sp.tok, mask.copy(), else_i,
                                         else_mask))
                        stt.max_ipdom_depth = max(stt.max_ipdom_depth,
                                                  len(st.stack))
                        st.mask = then_mask
                        st.active = True
                        return then_i
                    st.stack.append((sp.tok, mask.copy(), -1, None))
                    if ta:
                        st.mask = then_mask
                        st.active = True
                        return then_i
                    st.mask = else_mask
                    st.active = bool(else_mask.any())
                    return else_i
                # un-split branch: must be uniform over active lanes
                if st.active:
                    act = c[st.mask]
                    if act.any() != act.all():
                        raise UniformityViolation(
                            f"divergent un-managed branch in %{label} "
                            f"of @{fname}")
                    taken = bool(act[0])
                else:
                    taken = True
                return then_i if taken else else_i
            return cbr_node
        if op is Op.PRED:
            gc_ = g(i.operands[0])
            tok_i = self.reg_idx[id(i.operands[1])]
            inside_i = self._bidx[id(i.operands[2])]
            outside_i = self._bidx[id(i.operands[3])]
            attrs = i.attrs

            def pred_node(st, gc_=gc_, tok_i=tok_i, inside_i=inside_i,
                          outside_i=outside_i, attrs=attrs, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                c = gc_(st).astype(bool)
                if attrs.get("negate", False):
                    c = ~c
                new_mask = st.mask & c
                if new_mask.any():
                    st.mask = new_mask
                    st.active = True
                    return inside_i
                st.mask = st.env[tok_i].copy()
                st.active = bool(st.mask.any())
                return outside_i
            return pred_node
        if op is Op.RET:
            gv = g(i.operands[0]) if i.operands else None

            def ret_node(st, gv=gv, opv=opv, W=W):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                if st.stack:
                    raise ExecError("RET with non-empty IPDOM stack")
                st.ret = gv(st) if gv is not None \
                    else np.zeros(W, dtype=np.float32)
                return -1
            return ret_node
        if op is Op.JOIN:
            tok_i = self.reg_idx[id(i.operands[0])]

            def join_node(st, tok_i=tok_i, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                stack = st.stack
                if not stack or stack[-1][0] != tok_i:
                    raise ExecError("vx_join token mismatch at runtime")
                tok, saved, else_bi, else_mask = stack.pop()
                if else_bi >= 0:
                    stack.append((tok, saved, -1, None))
                    st.mask = else_mask
                    st.active = bool(else_mask.any())
                    return else_bi
                st.mask = saved
                st.active = bool(saved.any())
                return None
            return join_node
        if op is Op.TMC_RESTORE:
            tok_i = self.reg_idx[id(i.operands[0])]

            def restore_node(st, tok_i=tok_i, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                st.mask = st.env[tok_i].copy()
                st.active = bool(st.mask.any())
                return None
            return restore_node
        if op is Op.BARRIER:
            def barrier_node(st, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                yield "barrier"
            return barrier_node
        if op is Op.CALL:
            callee: Function = i.operands[0]
            ret_dtype = _TY_DTYPE.get(callee.ret_ty, np.float32)
            ri = self.reg_idx[id(i.result)] if i.result is not None else -1
            binders = []
            for p, a in zip(callee.params, i.operands[1:]):
                if p.ty is Ty.PTR:
                    if isinstance(a, (Param, GlobalVar)):
                        binders.append((p, "ptr", a))
                    else:
                        binders.append((p, "bad", a))
                else:
                    binders.append((p, "val", g(a)))
            binders = tuple(binders)
            strict = self.strict

            def call_node(st, callee=callee, binders=binders, ri=ri,
                          ret_dtype=ret_dtype, opv=opv, W=W, strict=strict):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if not st.active:    # hardware would not issue the call body
                    if ri >= 0:
                        st.env[ri] = np.zeros(W, dtype=ret_dtype)
                    return
                stt = st.stats
                stt.instrs += 1
                stt.by_op[opv] += 1
                cargs: Dict[int, Any] = {}
                for p, kind, payload in binders:
                    if kind == "ptr":
                        arr, _ = st.mem.resolve(payload, st.argmap)
                        cargs[id(p)] = arr
                    elif kind == "val":
                        cargs[id(p)] = payload(st)
                    else:
                        raise ExecError("pointer arg must be param/global")
                cprog = _decode(callee, W, strict)   # lazy: handles recursion
                sub = _DState(cprog, cargs, st.mask.copy(), st.ctx, st.mem,
                              st.stats, st.fuel)
                r = yield from _run_decoded(cprog, sub)
                if ri >= 0:
                    st.env[ri] = r
            return call_node
        raise ExecError(f"unhandled op {op}")


def _run_decoded(prog: "_DProgram", st: _DState
                 ) -> Generator[str, None, np.ndarray]:
    """Drive a decoded program.  Yields "barrier" events like _exec_warp."""
    blocks = prog.blocks
    bi = 0
    while True:
        if _faults.ACTIVE:
            _faults.maybe_fault("decoded.exec")
        if _gov.ACTIVE:
            _gov.deadline_check()
        nodes = blocks[bi].nodes
        jump: Optional[int] = None
        for node in nodes:
            r = node(st)
            if r is None:
                continue
            if type(r) is int:
                jump = r
                break
            yield from r           # barrier / call sub-generator
        if jump is None:
            raise ExecError(f"block %{blocks[bi].label} fell through")
        if jump < 0:
            return st.ret
        bi = jump


# --------------------------------------------------------------------------
# Workgroup-batched lockstep executor
#
# When a workgroup has several warps, the per-warp coroutines above repeat
# every interpreter dispatch n_warps times even though the warps usually
# execute the same straight-line code.  The batched executor runs ALL warps
# of a workgroup through ONE node walk over (n_warps, W)-shaped ndarrays —
# one fuel decrement, one bulk ExecStats update and one numpy call per
# instruction for the whole workgroup — as long as the warps stay in
# *lockstep*: same decoded position, same IPDOM stack shape, same branch
# decisions.
#
# The state machine:
#
#   lockstep --(atomic | print | impure call | cross-warp branch/pred
#               disagreement)--> desync --(all warps reach the same
#               top-level barrier with congruent stacks)--> lockstep
#
# On desync the 2D state is sliced row-wise into ordinary per-warp _DState
# objects and execution continues on the SAME decoded program's per-warp
# node lists (shared node numbering), scheduled warp-by-warp exactly like
# the oracle.  That makes the fallback trivially parity-correct — and it
# makes ordering-sensitive ops exact: the oracle runs warp 0's whole
# barrier segment before warp 1's, so desyncing at the *first* atomic or
# print of a segment reproduces the oracle's warp-major order for the rest
# of the segment.  Pure device functions (no barrier/print/atomic
# transitively) are called in lockstep; a desync inside one is contained:
# each warp finishes the callee independently and the CALLER resumes in
# lockstep right after the call.
#
# ExecStats stay bit-identical to ``decoded=False``: per instruction the
# batched nodes count one issue per warp with a live mask (``instrs`` /
# ``by_op`` scale by the number of active rows), memory statistics count
# per-warp coalesced lines via a row-offset unique, and the IPDOM depth
# update mirrors the per-warp rule.
#
# FUEL is the one counter that is an UPPER BOUND rather than an exact
# mirror: batched nodes charge one unit per ACTIVE row (with a floor of
# one so the infinite-loop guard stays armed when every row rides along
# empty), so the burn tracks the per-warp oracle closely — the slack is
# the all-rows-empty floor plus desync re-walks, not a factor of the
# batch width.  Fuel is an infinite-loop guard, not a reported
# statistic; a kernel running within a hair of ``params.fuel`` under
# ``batched=False`` may still need a slightly larger budget.
# --------------------------------------------------------------------------

_DESYNC = object()    # batched control node: cannot continue in lockstep
_BARRIER = object()   # per-warp node (batched program): top-level barrier


def _decode_batched(fn: Function, W: int, strict: bool, n_warps: int,
                    grid_mode: bool = False,
                    ride_along: bool = True,
                    wg_rows: int = 1,
                    coalesced: bool = False) -> "_BProgram":
    """Decode ``fn`` for workgroup-batched execution (memoized like
    _decode, in the same ir_version-keyed cache).  ``grid_mode`` batches
    independent workgroups (rows are warps grouped ``wg_rows`` per
    workgroup; a barrier synchronizes only the rows of its own
    workgroup); ``ride_along=False`` restores the stricter
    desync-on-mixed-loop-exit behavior (used as a benchmark baseline).
    ``coalesced`` decodes for the multi-launch coalescing path: global
    LOAD/STORE handlers index per-tenant staging tables and statistics
    route through the per-tenant stripe."""
    if _faults.ACTIVE:
        _faults.maybe_fault("decode")
    cache = getattr(fn, "_decode_cache", None)
    if cache is None:
        cache = {}
        fn._decode_cache = cache  # type: ignore[attr-defined]
    key = (fn.ir_version, W, bool(strict), "wg", n_warps, bool(grid_mode),
           bool(ride_along), int(wg_rows), bool(coalesced))
    prog = cache.get(key)
    if prog is None:
        for k in [k for k in cache if k[0] != fn.ir_version]:
            del cache[k]
        prog = _BProgram(fn, W, bool(strict), n_warps, grid_mode=grid_mode,
                         ride_along=ride_along, wg_rows=wg_rows,
                         coalesced=coalesced)
        cache[key] = prog
    return prog


def _lockstep_pure(fn: Function, _seen: Optional[set] = None) -> bool:
    """True if ``fn`` contains no barrier / print / atomic transitively —
    i.e. it may be called in lockstep (warp-order effects impossible)."""
    if _seen is None:
        _seen = set()
    if id(fn) in _seen:
        return True               # optimistic on recursion: ops are checked
    _seen.add(id(fn))             # on every function of the cycle anyway
    for i in fn.instructions():
        if i.op in (Op.BARRIER, Op.PRINT, Op.ATOMIC):
            return False
        if i.op is Op.CALL and not _lockstep_pure(i.operands[0], _seen):
            return False
    return True


def _cyclic_blocks(fn: Function) -> set:
    """ids of blocks that can reach themselves (loop bodies)."""
    succ = {id(b): [id(s) for s in b.successors()] for b in fn.blocks}
    cyclic: set = set()
    for b in fn.blocks:
        seen: set = set()
        work = list(succ[id(b)])
        while work:
            x = work.pop()
            if x == id(b):
                cyclic.add(x)
                break
            if x in seen:
                continue
            seen.add(x)
            work.extend(succ.get(x, ()))
    return cyclic


def _contains_store(fn: Function, _seen: Optional[set] = None) -> bool:
    """True if ``fn`` contains a memory STORE transitively."""
    if _seen is None:
        _seen = set()
    if id(fn) in _seen:
        return False
    _seen.add(id(fn))
    for i in fn.instructions():
        if i.op is Op.STORE:
            return True
        if i.op is Op.CALL and _contains_store(i.operands[0], _seen):
            return True
    return False


def _shared_ptr(v: Value) -> bool:
    """Is this pointer operand statically a __shared__ tile?"""
    return isinstance(v, GlobalVar) and v.space is AddrSpace.SHARED


def _store_privacy(fn: Function) -> Optional[str]:
    """Weakest store-privacy level over the top-level STOREs of ``fn``
    (per the affine index facts of ``passes.analysis``):

      * "2d"  — every store index is an affine chain
        ``s*(global_id(0) + global_id(1)*global_size(0))`` or
        ``s*(group_id(0) + group_id(1)*num_groups(0))`` plus uniforms:
        injective per thread / per workgroup across the WHOLE launch,
         1-D or 2-D;
      * "1d"  — at least one store relies on a bare
        ``s*global_id(0)`` / ``s*group_id(0)`` chain, which is injective
        only when the launch is 1-D (a second grid dimension repeats
        global_id(0) across gy);
      * None — some store is unrecognized (uniform indices, modulo
        wraps, select/cmov mixes) and cross-workgroup store order may
        be observable.

    Either level keeps store cells pairwise disjoint across workgroups
    (a workgroup's own rows never decouple from each other, so intra-wg
    clashes keep their row-major = warp order), making cross-wg store
    ORDER unobservable — the licence for row compaction and for
    re-merging a batch some of whose workgroups already ran ahead.
    __shared__-tile stores are exempt: in grid mode every workgroup owns
    a private tile slice, so their cross-workgroup order is never
    observable regardless of the index shape."""
    facts = affine_mem_facts(fn)
    level = "2d"
    for i in fn.instructions():
        if i.op is not Op.STORE:
            continue
        if _shared_ptr(i.operands[0]):
            continue
        p = facts.store_privacy.get(id(i))
        if p is None:
            return None
        if p == "1d":
            level = "1d"
    return level


def _ordering_sensitive(fn: Function, _seen: Optional[set] = None) -> bool:
    """True if ``fn`` can produce effects whose ORDER across workgroups
    is observable: prints (stats.prints is ordered), atomics (the
    returned old values depend on the global interleaving) or stores
    hidden inside callees (the caller's flat site count cannot attribute
    them, so any caller store may clash with them out of order).
    Top-level non-hazard stores and barriers are NOT ordering-sensitive —
    the grid gate already guarantees their effects commute."""
    if _seen is None:
        _seen = set()
    if id(fn) in _seen:
        return False
    _seen.add(id(fn))
    for i in fn.instructions():
        if i.op in (Op.PRINT, Op.ATOMIC):
            return True
        if i.op is Op.CALL:
            callee: Function = i.operands[0]
            if _contains_store(callee) or _ordering_sensitive(callee,
                                                              _seen):
                return True
    return False


# --------------------------------------------------------------------------
# Decode plans — the decoder's per-function STATIC analysis (affine index
# facts, store privacy, cyclic blocks, ordering sensitivity, callee
# purity) bundled into one serializable record.  Computed once per
# (function, ir_version) and memoized on the function; when core.runtime
# installs DECODE_PLAN_HOOKS, plans also persist on disk next to the
# compile cache, keyed by a content hash of the function (plus transitive
# callees), so a second process decoding an identical kernel skips the
# whole static scan.  The decoded HANDLER TABLES are closures and never
# persist — only the analysis does.  Stale entries are impossible (any
# IR change changes the content hash); corrupt entries fall back to a
# fresh computation.
# --------------------------------------------------------------------------

#: (loader(fn) -> plan | None, saver(fn, plan)) installed by core.runtime
DECODE_PLAN_HOOKS: Optional[Tuple[Any, Any]] = None

#: (loader(fn) -> {shape-sig: "pass"|"fail"} | None, saver(fn, certs))
#: installed by core.runtime for the torch rung's differential
#: certification verdicts (.vtc files, next to .vck/.vdp)
TORCH_CERT_HOOKS: Optional[Tuple[Any, Any]] = None

#: zero-arg callable installed by core.runtime: the torch rung's dispatch
#: router calls it when a certified launch is sent to the grid rung
#: because the measured grid time beats the torch rung's
#: (LAUNCH_TELEMETRY["routed_small"])
ROUTED_SMALL_HOOK: Optional[Any] = None

_DECODE_PLAN_SCHEMA = 1


def _compute_decode_plan(fn: Function) -> Tuple[Dict[str, Any], Any]:
    """-> (serializable plan, materialized _MemFacts)."""
    if _faults.ACTIVE:
        _faults.maybe_fault("decode.plan")
    facts = affine_mem_facts(fn)
    fact_rows: List[Tuple] = []
    cyclic = _cyclic_blocks(fn)
    cyclic_bis: List[int] = []
    for bi, b in enumerate(fn.blocks):
        if id(b) in cyclic:
            cyclic_bis.append(bi)
        for ii, i in enumerate(b.instrs):
            if i.op not in (Op.LOAD, Op.STORE, Op.ATOMIC):
                continue
            f = facts.index_fact.get(id(i))
            priv = facts.store_privacy.get(id(i)) \
                if i.op is Op.STORE else None
            if f is not None or i.op is Op.STORE:
                fact_rows.append(
                    (bi, ii,
                     None if f is None else (f.kind, f.layout,
                                             f.span_mul, f.span_add),
                     priv))
    plan = {
        "schema": _DECODE_PLAN_SCHEMA,
        "facts": fact_rows,
        "privacy": _store_privacy(fn),
        "cyclic": cyclic_bis,
        "ordering_sensitive": _ordering_sensitive(fn),
        "callee_stores": any(
            i.op is Op.CALL and _contains_store(i.operands[0])
            for i in fn.instructions()),
        "lockstep_pure": _lockstep_pure(fn),
        "contains_store": _contains_store(fn),
    }
    return plan, facts


def _materialize_facts(fn: Function, plan: Dict[str, Any]):
    """Rebuild the id-keyed _MemFacts of a deserialized plan against
    THIS process's instruction objects (positional mapping)."""
    from .passes.analysis import _MemFacts
    facts = _MemFacts()
    blocks = fn.blocks
    for bi, ii, f, priv in plan["facts"]:
        i = blocks[bi].instrs[ii]
        if i.op not in (Op.LOAD, Op.STORE, Op.ATOMIC):
            raise ValueError("decode plan out of sync with IR")
        if f is not None:
            facts.index_fact[id(i)] = _mem.AffineFact(*f)
        if i.op is Op.STORE:
            facts.store_privacy[id(i)] = priv
    # seed the affine_mem_facts memo so every consumer agrees
    fn._mem_facts = (fn.ir_version, facts)  # type: ignore[attr-defined]
    return facts


def _decode_plan(fn: Function) -> Dict[str, Any]:
    """The function's decode plan (memoized by ir_version; disk-backed
    when DECODE_PLAN_HOOKS is installed)."""
    cached = getattr(fn, "_decode_plan", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    plan = None
    facts = None
    if DECODE_PLAN_HOOKS is not None:
        try:
            plan = DECODE_PLAN_HOOKS[0](fn)
            if plan is not None:
                if plan.get("schema") != _DECODE_PLAN_SCHEMA:
                    raise ValueError("decode plan schema mismatch")
                facts = _materialize_facts(fn, plan)
        except Exception:
            plan = None            # corrupt/stale payload: recompute
            facts = None
    if plan is None:
        plan, facts = _compute_decode_plan(fn)
        if DECODE_PLAN_HOOKS is not None:
            try:
                DECODE_PLAN_HOOKS[1](fn, plan)
            except Exception:
                pass
    plan = dict(plan)
    plan["facts_obj"] = facts
    fn._decode_plan = (fn.ir_version, plan)  # type: ignore[attr-defined]
    return plan


class _BProgram(_DProgram):
    """Decoded program with two parallel node tables sharing one numbering:
    ``blocks`` (per-warp handlers, the desync fallback) and ``bblocks``
    (batched (n_warps, W) handlers)."""

    # atomics and prints are warp-order-sensitive: they must be batched
    # node boundaries so a desync can re-execute them per warp
    FUSEABLE = _PLAIN_OPS - {Op.ATOMIC, Op.PRINT}

    def __init__(self, fn: Function, W: int, strict: bool,
                 n_warps: int, *, grid_mode: bool = False,
                 ride_along: bool = True, wg_rows: int = 1,
                 coalesced: bool = False) -> None:
        self.n_warps = n_warps
        self.grid_mode = grid_mode
        self.ride_along = ride_along
        # multi-launch coalescing decode: rows belong to different
        # launches (tenants); global LOAD/STOREs index (k, size) staging
        # tables by the stripe's per-row tenant column and statistics
        # accumulate into the per-tenant stripe vectors
        self.coalesced = coalesced
        # rows per workgroup: 1 except in multi-warp grid mode, where a
        # batch stacks (n_wg x wg_rows) rows and a barrier synchronizes
        # only the rows belonging to the same workgroup
        self.wg_rows = wg_rows if grid_mode else n_warps
        if grid_mode and n_warps % wg_rows:
            raise ExecError("grid batch rows must be whole workgroups")
        # The mixed-split and vx_pred-loop ride-alongs (see the CBR/PRED
        # nodes) walk single-sided / loop-exited warps through code their
        # oracle counterparts never reach, under an empty mask.  That is
        # stats- and state-exact EXCEPT for barriers: an empty-mask warp
        # would "arrive" at a barrier its oracle counterpart never
        # reaches.  Functions containing barriers therefore desync on
        # mixed split/loop-exit decisions instead (calls cannot hide
        # barriers from lockstep: a barrier-containing callee is impure
        # and desyncs).  In grid mode with SINGLE-warp workgroups a
        # barrier synchronizes only the one warp of its own workgroup,
        # so an empty ride-along row crossing it has no cross-warp
        # effect and ride-along stays safe; with multi-warp workgroups
        # an empty row crossing a barrier would fabricate an arrival for
        # its workgroup's barrier group, so the wg-mode rule applies.
        self.has_barrier = any(i.op is Op.BARRIER
                               for i in fn.instructions())
        barrier_safe = ((grid_mode and wg_rows == 1)
                        or not self.has_barrier)
        # mixed vx_split ride-along: PR 2 behavior, always on where safe.
        self.split_ride_ok = barrier_safe
        # vx_pred loop ride-along: the PR 3 extension; ride_along=False
        # restores the PR 2 desync-on-mixed-loop-exit baseline WITHOUT
        # touching the split ride-along (benchmark comparisons would be
        # inflated otherwise).
        self.pred_ride_ok = ride_along and barrier_safe
        # Grid mode interleaves INDEPENDENT workgroups per instruction.
        # Within one DYNAMIC execution of a store the row-major scatter
        # reproduces the oracle's last-workgroup-wins order on a cell
        # clash; it cannot across two different dynamic executions —
        # whether those come from two static store sites (static
        # instruction order vs workgroup order) or from one site inside
        # a loop executed at different trips (trip order vs workgroup
        # order).  Both classes therefore become desync nodes in grid
        # mode: stores to buffers with more than one static site, and
        # stores in blocks that sit on a CFG cycle.  Rows drain to
        # completion in workgroup order from the first such store, which
        # is oracle-exact.  (The wg-batched mode keeps the PR 2
        # contract: cross-warp store clashes are excluded by the curated
        # bench lists instead.)
        plan = _decode_plan(fn)
        self._hazard_stores: set = set()
        if grid_mode:
            # __shared__-tile stores are exempt from every hazard rule:
            # in grid mode each workgroup writes its own private tile
            # slice, so cross-workgroup clashes are impossible, and
            # intra-workgroup clashes keep exactly the wg-batched
            # lockstep semantics (rows of one workgroup never decouple)
            sites: Counter = Counter()
            for i in fn.instructions():
                if i.op is Op.STORE and not _shared_ptr(i.operands[0]):
                    sites[id(i.operands[0])] += 1
            cyclic = {id(fn.blocks[bi]) for bi in plan["cyclic"]}
            # a store-containing callee is a store site this flat count
            # cannot attribute to a buffer (its pointer params bind at
            # the call, and module globals are shared objects), so its
            # presence makes EVERY caller store order-hazardous — the
            # call itself already desyncs (see the CALL node)
            callee_stores = plan["callee_stores"]
            self._hazard_stores = {
                id(i) for b in fn.blocks for i in b.instrs
                if i.op is Op.STORE and not _shared_ptr(i.operands[0])
                and (callee_stores
                     or sites[id(i.operands[0])] > 1
                     or id(b) in cyclic)}
        # Ordering freedom (grid mode): order_free = no prints/atomics,
        # no callee stores, no hazard stores; private_stores adds that
        # every store writes cross-workgroup-disjoint cells.  Together
        # (plus a matching launch shape) NO effect's cross-workgroup
        # order is observable, which licences the paths that let
        # workgroups RUN AHEAD of each other: parking at a barrier for
        # re-merge while later workgroups drain past, and row
        # compaction.  ``private_stores`` is the 1-D-launch licence
        # (bare global_id(0)/group_id(0) chains); ``private_stores_2d``
        # additionally requires full 2-D linear-id chains, so 2-D
        # launches may run ahead too.  launch() picks the bit matching
        # the grid shape.  Everything else takes the exact wg-order
        # drain-to-completion path.
        privacy = plan["privacy"] if grid_mode else None
        self.order_free = bool(grid_mode and not self._hazard_stores
                               and not plan["ordering_sensitive"])
        self.private_stores = bool(self.order_free
                                   and privacy is not None)
        self.private_stores_2d = bool(self.order_free
                                      and privacy == "2d")
        super().__init__(fn, W, strict)
        self.bblocks: List[_DBlock] = [self._decode_block_batched(b)
                                       for b in fn.blocks]

    # -- run partition: order-hazardous grid-mode stores leave the runs ----
    def _partition(self, b: Block) -> List[Tuple[str, Any]]:
        if not self._hazard_stores:
            return super()._partition(b)
        parts: List[Tuple[str, Any]] = []
        run: List[Instr] = []
        for i in b.instrs:
            if i.op in self.FUSEABLE and id(i) not in self._hazard_stores:
                run.append(i)
            else:
                if run:
                    parts.append(("run", run))
                    run = []
                parts.append(("ctrl", i))
        if run:
            parts.append(("run", run))
        return parts

    # -- per-warp side: __shared__ accesses bind the row's private tile
    # slice in grid mode (rows are whole workgroups; the launch-wide
    # tile table is (n_wgs, size) and _slice_state pins shared_row) ----
    def _plain(self, i: Instr):
        if self.grid_mode:
            if i.op in (Op.LOAD, Op.STORE) and _shared_ptr(i.operands[0]):
                return self._plain_tile(i)
            if i.op is Op.ATOMIC and _shared_ptr(i.operands[1]):
                return self._plain_tile(i)
        return super()._plain(i)

    def _plain_tile(self, i: Instr):
        """Per-warp (desync-fallback) handlers for grid-mode __shared__
        accesses: identical to the _DProgram handlers except the buffer
        is the state's own workgroup row of the (n_wgs, size) tile
        table.  Bounds and coalescing counts use TILE-LOCAL indices, so
        ExecStats and error behavior match the per-workgroup oracle
        bit for bit."""
        op = i.op
        W = self.W
        g = self._getter
        fname = self.fn.name
        fact = self.mem_facts.index_fact.get(id(i))
        if op is Op.LOAD:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]
            strict = self.strict

            def h(st, mi=mi, gi_=gi_, ri=ri, strict=strict, fname=fname,
                  fact=fact):
                buf = st.mem_arrs[mi][0][st.shared_row]
                ix = gi_(st).astype(np.int64)
                safe = np.clip(ix, 0, len(buf) - 1)
                if st.active:
                    if strict:
                        a_ix = ix[st.mask]
                        if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                            raise ExecError(
                                f"OOB load in @{fname}: idx={a_ix} "
                                f"size={len(buf)}")
                    st.stats.shared_requests += _mem.count_warp(
                        safe, st.mask, fact, st.ctx)
                    st.stats.mem_insts += 1
                st.env[ri] = buf[safe]
            return h
        if op is Op.STORE:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            gv = g(i.operands[2])

            def h(st, mi=mi, gi_=gi_, gv=gv, fname=fname, fact=fact):
                buf = st.mem_arrs[mi][0][st.shared_row]
                ix = gi_(st).astype(np.int64)
                v = gv(st)
                if st.active:
                    a_ix = ix[st.mask]
                    if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                        raise ExecError(
                            f"OOB store in @{fname}: idx={a_ix} "
                            f"size={len(buf)}")
                    st.stats.shared_requests += _mem.count_gathered(
                        a_ix, fact, st.ctx)
                    st.stats.mem_insts += 1
                    buf[a_ix] = v[st.mask].astype(buf.dtype)
            return h
        if op is Op.ATOMIC:
            kind = i.operands[0]
            mi = self._memref(i.operands[1])
            gi_ = g(i.operands[2])
            gv = g(i.operands[3])
            ri = self.reg_idx[id(i.result)]

            def h(st, kind=kind, mi=mi, gi_=gi_, gv=gv, ri=ri,
                  fname=fname, W=W, fact=fact):
                buf = st.mem_arrs[mi][0][st.shared_row]
                ix = gi_(st).astype(np.int64)
                v = gv(st)
                old = np.zeros(W, dtype=buf.dtype)
                if st.active:
                    lanes = np.nonzero(st.mask)[0]
                    a_ix = ix[lanes]
                    if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                        raise ExecError(f"OOB atomic in @{fname}")
                    stt = st.stats
                    stt.mem_requests += _mem.count_gathered(a_ix, fact,
                                                            st.ctx)
                    stt.mem_insts += 1
                    stt.atomic_serial += len(lanes)
                    _atomic_rmw(kind, buf, ix, lanes, v, old)
                st.env[ri] = old
            return h
        raise ExecError(f"no tile handler for {op}")

    # -- per-warp side: atomics/prints (and order-hazardous grid-mode
    # stores) become standalone nodes --------------------------------------
    def _control(self, i: Instr, b: Block):
        if i.op in (Op.ATOMIC, Op.PRINT) or (
                i.op is Op.STORE and id(i) in self._hazard_stores):
            h = self._plain(i)
            opv = i.op.value

            def solo_node(st, h=h, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                h(st)
                return None
            return solo_node
        if i.op is Op.BARRIER:
            opv = i.op.value

            def barrier_node(st, opv=opv):
                f = st.fuel
                f[0] -= 1
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if st.active:
                    stt = st.stats
                    stt.instrs += 1
                    stt.by_op[opv] += 1
                return _BARRIER
            return barrier_node
        return super()._control(i, b)

    # -- batched side ------------------------------------------------------
    def _decode_block_batched(self, b: Block) -> _DBlock:
        nw = self.n_warps
        nodes: List[Any] = []
        for kind, payload in self._partition(b):
            if kind == "run":
                items, n, bo = _fuse_run(payload, self.loaded_slots)
                hs = tuple(self._emit_bitem(it) for it in items)
                bo_items = tuple(bo.items())

                def brun_node(st, hs=hs, n=n, bo_items=bo_items, nw=nw):
                    n_act = st.active
                    f = st.fuel
                    f[0] -= n * (n_act or 1)
                    if f[0] <= 0:
                        raise ExecError(
                            "out of fuel (possible infinite loop)")
                    sp = st.stripe
                    if sp is not None:
                        # per-tenant accounting: defer to the stripe's
                        # epoch (mask-constant between control nodes, so
                        # scalar accumulation here, one vector multiply
                        # per mask change)
                        sp.epoch_n += n
                        eo = sp.epoch_ops
                        for k, v in bo_items:
                            eo[k] = eo.get(k, 0) + v
                    elif n_act:
                        stt = st.stats
                        stt.instrs += n * n_act
                        byop = stt.by_op
                        for k, v in bo_items:
                            byop[k] += v * n_act
                    for h in hs:
                        h(st)
                    return None
                nodes.append(brun_node)
            else:
                nodes.append(self._bcontrol(payload, b))
        return _DBlock(tuple(nodes), b.label)

    def _emit_bitem(self, item):
        kind = item[0]
        if kind in ("instr", "store", "load"):
            op = item[1].op
            if op in (Op.LOAD, Op.STORE, Op.VOTE, Op.SHFL):
                return self._bplain(item[1])
        # every other handler (arith, select, slot traffic, intr, split,
        # tmc_save, fused items) is shape-agnostic: (W,) operands broadcast
        # against the (n_warps, W) mask/env rows
        return self._emit_item(item)

    def _bplain(self, i: Instr):
        op = i.op
        W = self.W
        nw = self.n_warps
        g = self._getter
        if self.grid_mode and op in (Op.LOAD, Op.STORE) \
                and _shared_ptr(i.operands[0]):
            return self._bplain_tile(i)
        if self.coalesced and op in (Op.LOAD, Op.STORE):
            return self._bplain_coal(i)
        if op is Op.LOAD:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]
            fact = self.mem_facts.index_fact.get(id(i))

            def h(st, mi=mi, gi_=gi_, ri=ri, nw=nw, fact=fact, W=W):
                buf, shared = st.mem_arrs[mi]
                n_act = st.active
                if not n_act:
                    # every row is an empty ride-along: values loaded
                    # here are unobservable (stats skipped, stores
                    # masked), so skip the gather entirely
                    st.env[ri] = np.zeros((nw, W), buf.dtype)
                    return
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                stt = st.stats
                if n_act * 4 <= nw:
                    # mostly-dead batch (ragged ride-along tail): gather
                    # and count only the live rows; dead rows read zeros
                    # (unobservable, as above).  Per-row line counts are
                    # row-local, so the compacted count is bit-identical.
                    ar = st.act_rows
                    sub = np.clip(ix[ar], 0, len(buf) - 1)
                    uniq = _mem.count_rows(sub, st.mask[ar], n_act,
                                           len(buf), fact, st.ctx)
                    out = np.zeros((nw, ix.shape[1]), buf.dtype)
                    out[ar] = buf[sub]
                    if shared:
                        stt.shared_requests += uniq
                    else:
                        stt.mem_requests += uniq
                    stt.mem_insts += n_act
                    st.env[ri] = out
                    return
                safe = np.clip(ix, 0, len(buf) - 1)
                # each row counts its own coalesced lines
                uniq = _mem.count_rows(safe, st.mask, n_act,
                                       len(buf), fact, st.ctx)
                if shared:
                    stt.shared_requests += uniq
                else:
                    stt.mem_requests += uniq
                stt.mem_insts += n_act
                st.env[ri] = buf[safe]
            return h
        if op is Op.STORE:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            gv = g(i.operands[2])
            fname = self.fn.name
            fact = self.mem_facts.index_fact.get(id(i))

            def h(st, mi=mi, gi_=gi_, gv=gv, fname=fname, nw=nw,
                  fact=fact):
                if not st.active:
                    return            # all rows masked: nothing observable
                buf, shared = st.mem_arrs[mi]
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                v = gv(st)
                if v.ndim == 1:
                    v = np.broadcast_to(v, ix.shape)
                mask = st.mask
                if st.active:
                    a_ix = ix[mask]
                    if (a_ix < 0).any() or (a_ix >= len(buf)).any():
                        raise ExecError(
                            f"OOB store in @{fname}: idx={a_ix} "
                            f"size={len(buf)}")
                    # active lanes are validated in-bounds, so the raw
                    # indices already satisfy the engine's
                    # clipped-count rule
                    uniq = _mem.count_rows(ix, mask, st.active,
                                           len(buf), fact, st.ctx)
                    stt = st.stats
                    if shared:
                        stt.shared_requests += uniq
                    else:
                        stt.mem_requests += uniq
                    stt.mem_insts += st.active
                    # row-major scatter: on a same-instruction address
                    # clash the highest warp wins, matching the oracle's
                    # warp-ordered scheduling
                    buf[a_ix] = v[mask].astype(buf.dtype)
            return h
        if op is Op.VOTE:
            mode = i.operands[0]
            gv = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, mode=mode, gv=gv, ri=ri, W=W):
                mask = st.mask
                v = np.broadcast_to(gv(st), mask.shape).astype(bool)
                act = v & mask
                if mode == "any":
                    r = np.broadcast_to(act.any(axis=1)[:, None],
                                        mask.shape)
                elif mode == "all":
                    rows = (v | ~mask).all(axis=1)   # empty row -> True
                    r = np.broadcast_to(rows[:, None], mask.shape)
                elif mode == "ballot":
                    powers = np.int64(1) << np.arange(W, dtype=np.int64)
                    bits = (act.astype(np.int64) * powers).sum(axis=1)
                    r = np.broadcast_to(bits[:, None],
                                        mask.shape).astype(np.int32)
                else:
                    raise ExecError(f"unknown vote mode {mode}")
                st.env[ri] = r
            return h
        if op is Op.SHFL:
            gv = g(i.operands[0])
            gl = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, gv=gv, gl=gl, ri=ri, W=W, nw=nw):
                shape = st.mask.shape
                src = np.broadcast_to(gl(st), shape).astype(np.int64) % W
                v = np.broadcast_to(gv(st), shape)
                st.env[ri] = v[np.arange(nw)[:, None], src]
            return h
        raise ExecError(f"no batched handler for {op}")

    def _bplain_tile(self, i: Instr):
        """Batched (lockstep) handlers for grid-mode __shared__
        accesses.  The tile table is (n_wgs, size); row r of the batch
        belongs to workgroup r // wg_rows, a decode-time constant map.
        Bounds checks and per-row coalescing counts use TILE-LOCAL
        indices (each warp coalesces within its own workgroup's tile,
        exactly like the per-workgroup oracle), and the 2-D scatter is
        row-major so intra-workgroup clashes keep the oracle's
        last-warp-wins order."""
        op = i.op
        nw = self.n_warps
        g = self._getter
        fname = self.fn.name
        fact = self.mem_facts.index_fact.get(id(i))
        rowwg = (np.arange(nw, dtype=np.int64)
                 // self.wg_rows)[:, None]
        if op is Op.LOAD:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, mi=mi, gi_=gi_, ri=ri, nw=nw, rowwg=rowwg,
                  fact=fact):
                tile = st.mem_arrs[mi][0]
                tn = tile.shape[1]
                if not st.active:
                    st.env[ri] = np.zeros((nw, st.ctx.W), tile.dtype)
                    return
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                safe = np.clip(ix, 0, tn - 1)
                sp = st.stripe
                if sp is None:
                    st.stats.shared_requests += _mem.count_rows(
                        safe, st.mask, st.active, tn, fact, st.ctx)
                    st.stats.mem_insts += st.active
                else:
                    sp.charge_rows(sp.shared_requests,
                                   _mem.count_rows_split(
                                       safe, st.mask, tn, fact, st.ctx))
                    sp.mem_insts += sp.counts
                st.env[ri] = tile[rowwg, safe]
            return h
        if op is Op.STORE:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            gv = g(i.operands[2])

            def h(st, mi=mi, gi_=gi_, gv=gv, fname=fname, nw=nw,
                  rowwg=rowwg, fact=fact):
                if not st.active:
                    return
                tile = st.mem_arrs[mi][0]
                tn = tile.shape[1]
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                v = gv(st)
                if v.ndim == 1:
                    v = np.broadcast_to(v, ix.shape)
                mask = st.mask
                a_ix = ix[mask]
                if (a_ix < 0).any() or (a_ix >= tn).any():
                    raise ExecError(
                        f"OOB store in @{fname}: idx={a_ix} "
                        f"size={tn}")
                sp = st.stripe
                if sp is None:
                    st.stats.shared_requests += _mem.count_rows(
                        ix, mask, st.active, tn, fact, st.ctx)
                    st.stats.mem_insts += st.active
                else:
                    sp.charge_rows(sp.shared_requests,
                                   _mem.count_rows_split(
                                       ix, mask, tn, fact, st.ctx))
                    sp.mem_insts += sp.counts
                rows = np.broadcast_to(rowwg, ix.shape)[mask]
                tile[rows, a_ix] = v[mask].astype(tile.dtype)
            return h
        raise ExecError(f"no batched tile handler for {op}")

    def _bplain_coal(self, i: Instr):
        """Batched handlers for COALESCED global LOAD/STOREs: several
        launches' buffers for one pointer param are stacked into a
        (k, size) staging table and row r of the batch belongs to tenant
        ``stripe.row_tenant[r]`` — the ``_bplain_tile`` pattern with a
        runtime per-row tenant column instead of the decode-time
        workgroup map.  Bounds checks and per-row coalescing counts use
        table-LOCAL indices (each tenant's row slice is its own buffer,
        same length for every tenant in the group), and statistics
        accumulate into the per-tenant stripe vectors so the drain can
        de-mix ExecStats bit-identically to solo runs."""
        op = i.op
        W = self.W
        nw = self.n_warps
        g = self._getter
        fname = self.fn.name
        fact = self.mem_facts.index_fact.get(id(i))
        if op is Op.LOAD:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            ri = self.reg_idx[id(i.result)]

            def h(st, mi=mi, gi_=gi_, ri=ri, nw=nw, fact=fact, W=W):
                table = st.mem_arrs[mi][0]
                tn = table.shape[1]
                if not st.active:
                    st.env[ri] = np.zeros((nw, W), table.dtype)
                    return
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                safe = np.clip(ix, 0, tn - 1)
                sp = st.stripe
                sp.charge_rows(sp.mem_requests,
                               _mem.count_rows_split(
                                   safe, st.mask, tn, fact, st.ctx))
                sp.mem_insts += sp.counts
                st.env[ri] = table[sp.row_col, safe]
            return h
        if op is Op.STORE:
            mi = self._memref(i.operands[0])
            gi_ = g(i.operands[1])
            gv = g(i.operands[2])

            def h(st, mi=mi, gi_=gi_, gv=gv, fname=fname, nw=nw,
                  fact=fact):
                if not st.active:
                    return
                table = st.mem_arrs[mi][0]
                tn = table.shape[1]
                ix = gi_(st).astype(np.int64)
                if ix.ndim == 1:
                    ix = np.broadcast_to(ix, (nw, len(ix)))
                v = gv(st)
                if v.ndim == 1:
                    v = np.broadcast_to(v, ix.shape)
                mask = st.mask
                a_ix = ix[mask]
                if (a_ix < 0).any() or (a_ix >= tn).any():
                    raise ExecError(
                        f"OOB store in @{fname}: idx={a_ix} "
                        f"size={tn}")
                sp = st.stripe
                sp.charge_rows(sp.mem_requests,
                               _mem.count_rows_split(
                                   ix, mask, tn, fact, st.ctx))
                sp.mem_insts += sp.counts
                rows = np.broadcast_to(sp.row_col, ix.shape)[mask]
                table[rows, a_ix] = v[mask].astype(table.dtype)
            return h
        raise ExecError(f"no coalesced handler for {op}")

    # -- batched control nodes ---------------------------------------------
    def _bcontrol(self, i: Instr, b: Block):
        op = i.op
        opv = op.value
        W = self.W
        nw = self.n_warps
        g = self._getter
        fname = self.fn.name
        if op in (Op.ATOMIC, Op.PRINT) or (
                op is Op.STORE and id(i) in self._hazard_stores):
            # warp-order-sensitive: always fall back to per-warp execution
            return lambda st: _DESYNC
        if op is Op.BR:
            tb = self._bidx[id(i.operands[0])]

            def bbr_node(st, tb=tb, opv=opv, nw=nw):
                _bcount(st, opv, nw)
                st.pending = None
                return tb
            return bbr_node
        if op is Op.CBR:
            gc_ = g(i.operands[0])
            then_i = self._bidx[id(i.operands[1])]
            else_i = self._bidx[id(i.operands[2])]
            label = b.label

            ride_ok = self.split_ride_ok

            def bcbr_node(st, gc_=gc_, then_i=then_i, else_i=else_i,
                          opv=opv, label=label, fname=fname, nw=nw,
                          ride_ok=ride_ok):
                mask = st.mask
                sp = st.pending
                if sp is not None:
                    neg = sp.attrs.get("negate", False)
                    sp_val = np.broadcast_to(sp.gcond(st),
                                             mask.shape).astype(bool)
                    cc = ~sp_val if neg else sp_val
                    then_mask = mask & cc
                    else_mask = mask & ~cc
                    ta = then_mask.any(axis=1)
                    ea = else_mask.any(axis=1)
                    if not ea.any():
                        # every warp takes (at most) the then side
                        st.pending = None
                        _bcount(st, opv, nw)
                        st.stack.append((sp.tok, mask, -1, None))
                        _bset_mask(st, then_mask, ta)
                        return then_i
                    if not ta.any():
                        st.pending = None
                        _bcount(st, opv, nw)
                        st.stack.append((sp.tok, mask, -1, None))
                        _bset_mask(st, else_mask, ea)
                        return else_i
                    if not ride_ok and not (ta & ea).all():
                        return _DESYNC   # ride-along is barrier-unsafe
                    # mixed / both-sided: push a both-style entry for ALL
                    # warps.  A single-sided warp rides through the other
                    # side with an empty mask row: empty rows issue zero
                    # stats and masked stores preserve their lanes, so
                    # ExecStats and memory state match the per-warp
                    # schedule bit-for-bit while the workgroup stays in
                    # lockstep.
                    st.pending = None
                    _bcount(st, opv, nw)
                    st.stack.append((sp.tok, mask, else_i, else_mask))
                    div = ta & ea
                    if div.any():
                        # oracle bumps the depth only for warps that truly
                        # diverge; the depth value is the shared stack len
                        spr = st.stripe
                        if spr is None:
                            stt = st.stats
                            stt.max_ipdom_depth = max(stt.max_ipdom_depth,
                                                      len(st.stack))
                        else:
                            # only the tenants owning a diverging row get
                            # the bump (a solo run of the others never
                            # sees this split as two-sided)
                            np.maximum.at(spr.depth, spr.row_tenant[div],
                                          len(st.stack))
                    _bset_mask(st, then_mask, ta)
                    return then_i
                # un-split branch: per-warp consensus, cross-warp agreement
                c = np.broadcast_to(gc_(st), mask.shape).astype(bool)
                act = mask.any(axis=1)
                anyc = (c & mask).any(axis=1)
                allc = (c | ~mask).all(axis=1)
                if bool(((anyc != allc) & act).any()):
                    raise UniformityViolation(
                        f"divergent un-managed branch in %{label} "
                        f"of @{fname}")
                # consensus over rows that still have live lanes; empty
                # ride-along rows follow the consensus side (they issue
                # zero stats wherever they walk, and both sides reach the
                # construct's join/merge point)
                if not act.any():
                    t = True
                else:
                    tk = anyc[act]
                    if tk.all():
                        t = True
                    elif not tk.any():
                        t = False
                    else:
                        return _DESYNC
                _bcount(st, opv, nw)
                return then_i if t else else_i
            return bcbr_node
        if op is Op.PRED:
            gc_ = g(i.operands[0])
            tok_i = self.reg_idx[id(i.operands[1])]
            inside_i = self._bidx[id(i.operands[2])]
            outside_i = self._bidx[id(i.operands[3])]
            attrs = i.attrs

            ride_ok = self.pred_ride_ok

            def bpred_node(st, gc_=gc_, tok_i=tok_i, inside_i=inside_i,
                           outside_i=outside_i, attrs=attrs, opv=opv,
                           nw=nw, ride_ok=ride_ok):
                mask = st.mask
                c = np.broadcast_to(gc_(st), mask.shape).astype(bool)
                if attrs.get("negate", False):
                    c = ~c
                new_mask = mask & c
                nz = new_mask.any(axis=1)
                if nz.all():
                    _bcount(st, opv, nw)
                    _bset_mask(st, new_mask, nz)
                    return inside_i
                if not nz.any():
                    # no warp has live lanes left: every row leaves the
                    # loop, restoring its own tmc_save'd entry mask —
                    # rows that exited earlier (and rode along under an
                    # empty mask) restore the exact mask their per-warp
                    # counterparts restored at their own exit trip, since
                    # the token is loop-invariant
                    _bcount(st, opv, nw)
                    tok = st.env[tok_i]
                    if tok.ndim == 1:
                        tok = np.broadcast_to(tok, mask.shape)
                    _bset_mask(st, tok.copy())
                    return outside_i
                if ride_ok:
                    # vx_pred loop ride-along: warps whose lanes all
                    # failed the loop predicate keep walking the loop
                    # body under an empty mask row instead of desyncing
                    # the whole workgroup.  Empty rows issue zero stats
                    # and all their stores are masked out, so ExecStats
                    # and memory traffic stay bit-identical to the
                    # per-warp schedule; the rows re-activate when the
                    # last warp exits and the entry masks are restored.
                    _bcount(st, opv, nw)
                    _bset_mask(st, new_mask, nz)
                    return inside_i
                return _DESYNC              # warps disagree on the loop exit
            return bpred_node
        if op is Op.RET:
            gv = g(i.operands[0]) if i.operands else None

            def bret_node(st, gv=gv, opv=opv, W=W, nw=nw):
                _bcount(st, opv, nw)
                if st.stack:
                    raise ExecError("RET with non-empty IPDOM stack")
                st.ret = gv(st) if gv is not None \
                    else np.zeros(W, dtype=np.float32)
                return -1
            return bret_node
        if op is Op.JOIN:
            tok_i = self.reg_idx[id(i.operands[0])]

            def bjoin_node(st, tok_i=tok_i, opv=opv, nw=nw):
                _bcount(st, opv, nw)
                stack = st.stack
                if not stack or stack[-1][0] != tok_i:
                    raise ExecError("vx_join token mismatch at runtime")
                tok, saved, else_bi, else_mask = stack.pop()
                if else_bi >= 0:
                    stack.append((tok, saved, -1, None))
                    _bset_mask(st, else_mask)
                    return else_bi
                _bset_mask(st, saved)
                return None
            return bjoin_node
        if op is Op.TMC_RESTORE:
            tok_i = self.reg_idx[id(i.operands[0])]

            def brestore_node(st, tok_i=tok_i, opv=opv, nw=nw):
                _bcount(st, opv, nw)
                tok = st.env[tok_i]
                if tok.ndim == 1:
                    tok = np.broadcast_to(tok, st.mask.shape)
                _bset_mask(st, tok.copy())
                return None
            return brestore_node
        if op is Op.BARRIER:
            def bbarrier_node(st, opv=opv, nw=nw):
                # in lockstep every warp arrives at the barrier together:
                # it synchronizes trivially and execution continues
                _bcount(st, opv, nw)
                return None
            return bbarrier_node
        if op is Op.CALL:
            callee: Function = i.operands[0]
            cplan = _decode_plan(callee)
            if not cplan["lockstep_pure"] or (
                    self.grid_mode and cplan["contains_store"]):
                # grid mode: a callee store could be one of several
                # sites writing a buffer (undetectable from the caller's
                # flat site count) — drain rows in workgroup order
                return lambda st: _DESYNC
            ret_dtype = _TY_DTYPE.get(callee.ret_ty, np.float32)
            ri = self.reg_idx[id(i.result)] if i.result is not None else -1
            binders = []
            for p, a in zip(callee.params, i.operands[1:]):
                if p.ty is Ty.PTR:
                    if isinstance(a, (Param, GlobalVar)):
                        binders.append((p, "ptr", a))
                    else:
                        binders.append((p, "bad", a))
                else:
                    binders.append((p, "val", g(a)))
            binders = tuple(binders)
            strict = self.strict
            grid_mode = self.grid_mode
            ride_along = self.ride_along
            wg_rows = self.wg_rows if grid_mode else 1
            coalesced = self.coalesced

            def bcall_node(st, callee=callee, binders=binders, ri=ri,
                           ret_dtype=ret_dtype, opv=opv, W=W, nw=nw,
                           strict=strict, grid_mode=grid_mode,
                           ride_along=ride_along, wg_rows=wg_rows,
                           coalesced=coalesced):
                mask = st.mask
                act = st.act_rows
                n_act = st.active
                f = st.fuel
                f[0] -= max(n_act, 1)
                if f[0] <= 0:
                    raise ExecError("out of fuel (possible infinite loop)")
                if n_act == 0:
                    if ri >= 0:
                        st.env[ri] = np.zeros(W, dtype=ret_dtype)
                    return None
                stt = st.stats
                spr = st.stripe
                if spr is not None:
                    spr.epoch_n += 1
                    eo = spr.epoch_ops
                    eo[opv] = eo.get(opv, 0) + 1
                else:
                    stt.instrs += n_act
                    stt.by_op[opv] += n_act
                cargs: Dict[int, Any] = {}
                for p, kind, payload in binders:
                    if kind == "ptr":
                        arr, _ = st.mem.resolve(payload, st.argmap)
                        cargs[id(p)] = arr
                    elif kind == "val":
                        cargs[id(p)] = payload(st)
                    else:
                        raise ExecError("pointer arg must be param/global")
                cprog = _decode_batched(callee, W, strict, nw,
                                        grid_mode=grid_mode,
                                        ride_along=ride_along,
                                        wg_rows=wg_rows,
                                        coalesced=coalesced)
                sub = _DState(cprog, cargs, mask.copy(), st.ctx, st.mem,
                              stt, st.fuel)
                sub.warp_ctxs = st.warp_ctxs
                sub.stripe = spr
                r = _run_lockstep_fn(cprog, sub)
                if spr is not None:
                    # the callee's mask changes updated the stripe's
                    # active-row counts through the sub-state; restore
                    # them to the caller's rows (structured callees
                    # return with the entry mask, but don't rely on it)
                    spr.set_counts(st.act_rows)
                r = np.broadcast_to(r, (nw, W)) if r.ndim == 1 else r
                if not act.all():
                    # warps that did not issue the call get zeros (oracle:
                    # an inactive warp skips the call body entirely)
                    out = np.array(r)
                    out[~act] = 0
                    r = out
                if ri >= 0:
                    st.env[ri] = r
                return None
            return bcall_node
        raise ExecError(f"unhandled op {op}")


def _bcount(st: _DState, opv: str, nw: int) -> None:
    """Fuel + dynamic-issue accounting for one batched control node: one
    fuel unit and one issue per warp with a live mask.  Charging only
    ACTIVE rows keeps the batched fuel burn aligned with the per-warp
    oracle even when most rows are empty ride-alongs (a grid batch of 64
    rows where one long ragged loop keeps the chunk alive must not
    exhaust a budget the oracle finishes within); the max(..., 1) floor
    keeps the infinite-loop guard armed when every row is empty."""
    f = st.fuel
    f[0] -= max(st.active, 1)
    if f[0] <= 0:
        raise ExecError("out of fuel (possible infinite loop)")
    sp = st.stripe
    if sp is not None:
        sp.epoch_n += 1
        eo = sp.epoch_ops
        eo[opv] = eo.get(opv, 0) + 1
        return
    n_act = st.active
    if n_act:
        stt = st.stats
        stt.instrs += n_act
        stt.by_op[opv] += n_act


def _bset_mask(st: _DState, m: np.ndarray,
               ar: Optional[np.ndarray] = None) -> None:
    """Assign a batched mask, keeping the active-row cache in sync.
    With a stripe attached this is the epoch boundary: accumulated
    per-node charges are flushed against the OLD per-tenant active-row
    counts, then the counts re-derive from the new mask."""
    st.mask = m
    if ar is None:
        ar = m.any(axis=1)
    st.act_rows = ar
    st.active = int(ar.sum())
    if st.stripe is not None:
        st.stripe.set_counts(ar)


def _slice_state(bst: _DState, w: int, ctx: _WarpCtx,
                 wg_rows: int = 0) -> _DState:
    """Row ``w`` of a batched state as an ordinary per-warp _DState.
    ``wg_rows`` (grid mode) pins the row's workgroup tile slice."""
    st = _DState.__new__(_DState)
    st.stripe = None
    st.shared_row = (w // wg_rows) if wg_rows else None
    st.env = [v if (v is None or v.ndim == 1) else v[w] for v in bst.env]
    st.slots = [v if (v is None or v.ndim == 1) else v[w]
                for v in bst.slots]
    st.args = bst.args
    st.argmap = bst.argmap
    st.mem_arrs = bst.mem_arrs
    st.mask = bst.mask[w].copy()
    st.active = bool(st.mask.any())
    st.act_rows = None
    st.stack = [(tok,
                 saved[w].copy() if saved.ndim == 2 else saved.copy(),
                 ebi,
                 None if em is None else
                 (em[w].copy() if em.ndim == 2 else em.copy()))
                for (tok, saved, ebi, em) in bst.stack]
    st.pending = bst.pending
    st.ret = None
    st.intr = ctx.intr
    st.ctx = ctx
    st.mem = bst.mem
    st.stats = bst.stats
    st.fuel = bst.fuel
    st.warp_ctxs = None
    return st


def _merge_states(bprog: "_BProgram", wstates: List[_DState],
                  proto: _DState) -> Optional[_DState]:
    """Re-merge per-warp states into a batched state, or None if the warps
    are not congruent (different IPDOM shape / pending split).  The
    all-rows-live case of the grid-mode `_merge_rows`."""
    return _merge_rows(bprog, wstates, [True] * len(wstates), proto)


def _resume_decoded(prog: "_BProgram", st: _DState, bi: int, ni: int
                    ) -> Generator[Any, None, np.ndarray]:
    """Per-warp execution of a batched program's per-warp node lists,
    starting at node ``ni`` of block ``bi``.  Top-level barriers yield
    ``("barrier", bi, ni_after)`` so the workgroup driver can attempt a
    lockstep re-merge; barriers inside device-function calls yield the
    plain "barrier" event (never merged)."""
    blocks = prog.blocks
    while True:
        if _gov.ACTIVE:
            _gov.deadline_check()
        nodes = blocks[bi].nodes
        nn = len(nodes)
        jump: Optional[int] = None
        while ni < nn:
            node = nodes[ni]
            ni += 1
            r = node(st)
            if r is None:
                continue
            if type(r) is int:
                jump = r
                break
            if r is _BARRIER:
                yield ("barrier", bi, ni)
                continue
            yield from r           # call sub-generator
        if jump is None:
            raise ExecError(f"block %{blocks[bi].label} fell through")
        if jump < 0:
            return st.ret
        bi, ni = jump, 0


def _finish_warp(prog: "_BProgram", st: _DState, bi: int, ni: int
                 ) -> np.ndarray:
    """Run one warp of a PURE device function to completion (no barriers
    possible); used when a lockstep callee desyncs."""
    blocks = prog.blocks
    while True:
        nodes = blocks[bi].nodes
        nn = len(nodes)
        jump: Optional[int] = None
        while ni < nn:
            node = nodes[ni]
            ni += 1
            r = node(st)
            if r is None:
                continue
            if type(r) is int:
                jump = r
                break
            if r is _BARRIER:
                raise ExecError(
                    "vx_barrier inside a lockstep device function")
            for _ in r:            # drain nested pure calls
                raise ExecError(
                    "vx_barrier inside a lockstep device function")
        if jump is None:
            raise ExecError(f"block %{blocks[bi].label} fell through")
        if jump < 0:
            return st.ret
        bi, ni = jump, 0


def _run_lockstep_fn(prog: "_BProgram", bst: _DState) -> np.ndarray:
    """Lockstep execution of a pure device function.  A desync inside is
    contained: each warp finishes the callee independently and the caller
    resumes in lockstep."""
    bi, ni = 0, 0
    while True:
        nodes = prog.bblocks[bi].nodes
        nn = len(nodes)
        jump: Optional[int] = None
        while ni < nn:
            r = nodes[ni](bst)
            if r is None:
                ni += 1
                continue
            if type(r) is int:
                jump = r
                break
            rets = []              # desync: per-warp completion
            for w in range(prog.n_warps):
                stw = _slice_state(bst, w, bst.warp_ctxs[w])
                rets.append(np.broadcast_to(
                    _finish_warp(prog, stw, bi, ni), (prog.W,)))
            return np.stack(rets)
        if jump is None:
            raise ExecError(f"block %{prog.bblocks[bi].label} fell through")
        if jump < 0:
            return bst.ret
        bi, ni = jump, 0


def _barrier_divergence_error(wg: Tuple[int, int], waiting: Sequence[int],
                              exited: Sequence[int]) -> ExecError:
    e = ExecError(
        f"barrier divergence in workgroup {wg}: warp(s) "
        f"{sorted(waiting)} wait at a barrier but warp(s) "
        f"{sorted(exited)} already returned — every warp of the "
        f"workgroup must reach the same barriers")
    # the message already names its workgroup (and lists the warps):
    # pre-fill the context so later _add_ctx annotations only add the
    # missing kernel name instead of repeating the workgroup
    e.ctx = {"workgroup": wg}                    # type: ignore[attr-defined]
    e.ctx_in_msg = ("workgroup",)                # type: ignore[attr-defined]
    e._base_msg = e.args[0]                      # type: ignore[attr-defined]
    return e


def _run_wg_batched(bprog: "_BProgram", bst: _DState,
                    wg: Tuple[int, int]) -> None:
    """Drive one whole workgroup: lockstep until a desync event, then
    per-warp coroutines with oracle scheduling, re-merging into lockstep
    when all warps reach the same top-level barrier congruently."""
    n = bprog.n_warps
    bi, ni = 0, 0
    while True:
        # ---- lockstep ------------------------------------------------
        desync_at: Optional[Tuple[int, int]] = None
        while desync_at is None:
            if _faults.ACTIVE:
                _faults.maybe_fault("wg.exec")
            if _gov.ACTIVE:
                _gov.deadline_check()
            nodes = bprog.bblocks[bi].nodes
            nn = len(nodes)
            jump: Optional[int] = None
            while ni < nn:
                r = nodes[ni](bst)
                if r is None:
                    ni += 1
                    continue
                if type(r) is int:
                    jump = r
                    break
                desync_at = (bi, ni)
                break
            if desync_at is not None:
                break
            if jump is None:
                raise ExecError(
                    f"block %{bprog.bblocks[bi].label} fell through")
            if jump < 0:
                return             # all warps returned in lockstep
            bi, ni = jump, 0
        # ---- desync: per-warp fallback with oracle scheduling --------
        bi, ni = desync_at
        wstates = [_slice_state(bst, w, bst.warp_ctxs[w])
                   for w in range(n)]
        warps = [_resume_decoded(bprog, wstates[w], bi, ni)
                 for w in range(n)]
        alive = list(range(n))
        exited: List[int] = []
        merged: Optional[Tuple[int, int]] = None
        while alive:
            events: Dict[int, Any] = {}
            done: List[int] = []
            for wi in alive:
                try:
                    events[wi] = next(warps[wi])
                except StopIteration:
                    done.append(wi)
                except ExecError as e:
                    raise _add_ctx(e, workgroup=wg, warp=wi)
            exited.extend(done)
            if events and done:
                raise _barrier_divergence_error(wg, sorted(events),
                                                exited)
            if not events:
                return             # all warps finished independently
            alive = sorted(events)
            if len(alive) == n:
                evs = list(events.values())
                if all(type(e) is tuple for e in evs) and len(set(evs)) == 1:
                    m = _merge_states(bprog, wstates, bst)
                    if m is not None:
                        bst = m
                        merged = (evs[0][1], evs[0][2])
                        break
        if merged is None:
            return
        bi, ni = merged


# --------------------------------------------------------------------------
# Grid-level batching
#
# spmv/bfs-style launches are many SMALL workgroups: the workgroup
# batcher amortizes nothing across them (single-warp workgroups never
# even engage it) and every workgroup pays a full Python node walk.
# Grid-level batching packs up to ``_GRID_BATCH_MAX`` ROWS — whole
# workgroups of ``wg_rows`` warps each, so (n_wg x n_warps, W) — of one
# launch into a single activation and reuses the _BProgram machinery:
#
#   * rows are warps, grouped ``wg_rows`` consecutive rows per
#     workgroup.  In lockstep every row reaches a barrier together, so
#     each PER-WORKGROUP barrier group is trivially satisfied and the
#     lockstep barrier node (trivial continue) is exact for any
#     ``wg_rows``; the mixed-decision ride-alongs stay barrier-safe only
#     for single-warp workgroups (an empty multi-warp row crossing a
#     barrier would fabricate an arrival for its workgroup's group), so
#     multi-warp grids fall back to the wg-mode desync rule in barrier
#     functions;
#   * on a desync event (atomic / print / impure call / un-rideable
#     cross-row disagreement) the rows are sliced into ordinary per-warp
#     states and DRAINED workgroup by workgroup in workgroup order —
#     exactly the oracle's schedule — with the rows of one workgroup
#     synchronizing at barrier events among themselves (_drive_wg);
#   * when run-ahead is licenced (``private_stores`` + 1-D launch: no
#     effect's cross-workgroup order is observable) a drained workgroup
#     may instead PARK at its first top-level barrier; when every
#     surviving workgroup parks at the same congruent barrier the rows
#     RE-MERGE into one batch and lockstep resumes (_drain_grid),
#     instead of the desync permanently ending batched execution for
#     the chunk;
#   * when ride-along leaves most rows of a batch empty (pareto-tail
#     ragged loops: a few workgroups loop on while the rest wait at the
#     collective exit), the live rows COMPACT into a dense sub-batch and
#     the exited workgroups drain their epilogues immediately
#     (_compact_grid, same licence) — dead rows stop paying batched
#     work.
#
# Eligibility is decided per launch by a static scan (``_grid_batchable``):
#
#   * no __shared__ memory anywhere in the call graph — rows would alias
#     one workgroup-private allocation;
#   * no buffer both read and written (transitively, resolved against the
#     actual launch bindings, with an np.shares_memory check so
#     overlapping views of one base array do not slip through) —
#     interleaving rows per-instruction instead of workgroup-by-workgroup
#     could change what a load observes (the old top-down ``bfs``
#     kernel's visited[] is the canonical offender).  This is
#     conservative: kernels like saxpy (y read+written, but each thread
#     touches only its own element) fall back to the per-workgroup loop
#     rather than risk a schedule-dependent result;
# Buffers with MORE THAN ONE static store site (common from tail
# duplication: a single source store can compile to several) are handled
# at decode time instead of refused: those stores become grid-mode desync
# nodes (``_BProgram._hazard_stores``) so clashing writes always execute
# in workgroup order — within one store instruction the row-major scatter
# already reproduces the oracle's last-workgroup-wins order, but across
# two different store sites static instruction order would contradict
# workgroup order.
# --------------------------------------------------------------------------

_GRID_BATCH_MAX = 64

#: parallel-dispatch chunk widening cap, in batch ROWS (warps).  With
#: VOLT_WORKERS > 1 the dispatcher widens chunks to
#: ``_GRID_BATCH_MAX * workers`` rows (bounded here) before farming
#: them out: on a licensed launch chunk width is semantics-invisible
#: (tests/test_grid_metamorphic.py::test_chunk_size_invariance), and a
#: wider chunk pays the per-node Python dispatch of the lockstep walk
#: over fewer walks — the dominant term of the parallel win on hosts
#: where numpy's GIL-released regions are short.  Bounded so one chunk
#: never balloons per-chunk scratch past what the governor budgeted.
_GRID_PAR_ROWS_MAX = 512


def _grid_batchable(fn: Function, argmap: Dict[int, Any],
                    globals_mem: Optional[Dict[str, np.ndarray]] = None
                    ) -> bool:
    """True if a grid of ``fn`` may run row-batched: no buffer both
    loaded and stored/RMW'd (resolved through calls against the actual
    launch bindings, including overlapping-view detection).  __shared__
    tiles used directly by the kernel body are allowed — grid mode
    gives every batched workgroup its own PRIVATE (n_wgs, size) tile
    row, so tile traffic can never alias across rows and is exempt from
    the read-write-hazard rule; shared vars reached through callees or
    passed as call arguments stay refused (the tile-slice plumbing only
    covers top-level accesses).  Multi-site stores through ONE root
    pointer do not refuse — they desync at decode time instead
    (``_BProgram._hazard_stores``); stores reaching one buffer through
    DISTINCT root pointers (aliased params, a param aliasing a global,
    caller + callee sites) are invisible to that per-pointer site count
    and are refused here."""
    loads: set = set()
    writes: set = set()
    arrays: Dict[Any, np.ndarray] = {}  # buffer key -> bound ndarray
    write_roots: Dict[Any, set] = {}    # buffer key -> distinct ptr ids
    ok = [True]

    def resolve(ptr: Any, binding: Dict[int, Any], depth: int) -> Any:
        if isinstance(ptr, GlobalVar):
            if ptr.space is AddrSpace.SHARED:
                if depth > 0:
                    # a tile touched inside a device function: the
                    # per-row slice plumbing only specializes top-level
                    # accesses — refuse, fall back to per-wg dispatch
                    ok[0] = False
                    return None
                return ("s", id(ptr))   # private per-row tile
            key = ("g", ptr.name)
            if globals_mem is not None and ptr.name in globals_mem:
                arrays[key] = globals_mem[ptr.name]
            return key
        if isinstance(ptr, Param):
            return binding.get(id(ptr))
        return None

    def _tile(key: Any) -> bool:
        return isinstance(key, tuple) and key[0] == "s"

    def scan(f: Function, binding: Dict[int, Any], depth: int) -> None:
        if depth > 8:              # runaway recursion: give up, stay safe
            ok[0] = False
            return
        for i in f.instructions():
            op = i.op
            if op is Op.LOAD:
                r = resolve(i.operands[0], binding, depth)
                if not _tile(r):
                    loads.add(r)
            elif op is Op.STORE:
                r = resolve(i.operands[0], binding, depth)
                if not _tile(r):
                    writes.add(r)
                    write_roots.setdefault(r, set()).add(
                        id(i.operands[0]))
            elif op is Op.ATOMIC:
                r = resolve(i.operands[1], binding, depth)
                if not _tile(r):
                    loads.add(r)
                    writes.add(r)
            elif op is Op.CALL:
                callee: Function = i.operands[0]
                sub: Dict[int, Any] = {}
                for p, a in zip(callee.params, i.operands[1:]):
                    if _shared_ptr(a):
                        ok[0] = False   # tile escaping into a callee
                        return
                    if p.ty is Ty.PTR and isinstance(a, (Param, GlobalVar)):
                        sub[id(p)] = resolve(a, binding, depth)
                scan(callee, sub, depth + 1)
            if not ok[0]:
                return

    top: Dict[int, Any] = {}
    for p in fn.params:
        if p.ty is Ty.PTR:
            a = argmap.get(id(p))
            if isinstance(a, np.ndarray):
                key = ("a", id(a))
                top[id(p)] = key
                arrays[key] = a
            else:
                top[id(p)] = None
    scan(fn, top, 0)
    if not ok[0]:
        return False
    if None in loads or None in writes:
        return False               # unresolvable pointer: be conservative
    if loads & writes:
        return False
    # one buffer stored through several distinct root pointers (aliased
    # params, caller+callee sites): the decode-time per-pointer site
    # count cannot see the clash, so refuse outright
    if any(len(roots) > 1 for roots in write_roots.values()):
        return False
    # distinct ndarray objects can still be views of one base array
    la = [arrays[k] for k in loads if k in arrays]
    wa = [arrays[k] for k in writes if k in arrays]
    for w in wa:
        for l in la:
            if np.shares_memory(w, l):
                return False
    for i_ in range(len(wa)):          # two stored views of one base
        for j_ in range(i_ + 1, len(wa)):   # array = cross-instruction
            if np.shares_memory(wa[i_], wa[j_]):   # write-write hazard
                return False
    return True


def write_root_buffers(fn: Function
                       ) -> Optional[Tuple[set, set]]:
    """Names of the buffers a launch of ``fn`` may WRITE — the
    transactional-snapshot set (docs/robustness.md): ``(param names,
    global names)`` reached by a STORE/ATOMIC root, resolved through
    calls like the launch gate's ``write_roots`` scan but binding-free
    (names, not arrays, so the result caches on the function).
    __shared__ tiles are excluded (fresh per launch).  Returns None
    when some store root cannot be resolved to a top-level name — the
    caller must then snapshot every bound buffer."""
    cached = getattr(fn, "_write_roots", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    params_w: set = set()
    globals_w: set = set()
    ok = [True]

    def resolve(ptr: Any, binding: Dict[int, Any]) -> None:
        if isinstance(ptr, GlobalVar):
            if ptr.space is not AddrSpace.SHARED:
                globals_w.add(ptr.name)
            return
        if isinstance(ptr, Param):
            root = binding.get(id(ptr))
            if isinstance(root, GlobalVar):
                resolve(root, binding)
            elif isinstance(root, Param):
                params_w.add(root.name)
            else:
                ok[0] = False
            return
        ok[0] = False

    def scan(f: Function, binding: Dict[int, Any], depth: int) -> None:
        if depth > 8:
            ok[0] = False
            return
        for i in f.instructions():
            if i.op is Op.STORE:
                resolve(i.operands[0], binding)
            elif i.op is Op.ATOMIC:
                resolve(i.operands[1], binding)
            elif i.op is Op.CALL:
                callee: Function = i.operands[0]
                sub: Dict[int, Any] = {}
                for p, a in zip(callee.params, i.operands[1:]):
                    if p.ty is Ty.PTR:
                        if isinstance(a, Param):
                            sub[id(p)] = binding.get(id(a))
                        elif isinstance(a, GlobalVar):
                            sub[id(p)] = a
                scan(callee, sub, depth + 1)
            if not ok[0]:
                return

    top = {id(p): p for p in fn.params if p.ty is Ty.PTR}
    scan(fn, top, 0)
    result = (params_w, globals_w) if ok[0] else None
    fn._write_roots = (fn.ir_version, result)  # type: ignore[attr-defined]
    return result


def _stack_intrs(ctxs: Sequence[_WarpCtx], W: int,
                 strict: bool) -> _WarpCtx:
    """Batch per-row/_per-warp intrinsic contexts: row-varying values
    stack into 2D rows, invariant ones stay 1D and broadcast."""
    intr2: Dict[Tuple[str, int], np.ndarray] = {}
    for key in ctxs[0].intr:
        vals = [c.intr[key] for c in ctxs]
        if all(v is vals[0] for v in vals):
            intr2[key] = vals[0]
        else:
            intr2[key] = np.stack(vals)
    return _WarpCtx(W, intr2, strict, ctxs[0].affine_ok,
                    ctxs[0].affine_span)


class _LazyRowCtxs:
    """Per-row ``_WarpCtx`` sequence for a grid chunk, built on demand.

    Lockstep execution only reads the stacked 2-D chunk context; the
    per-row contexts are needed by the desync fallback alone
    (``_slice_state`` / ``_split_batch``).  Building ``rows`` dicts of
    ``np.full`` vectors per chunk was the dominant cost of small
    streaming launches (the PR 5 profile's hot spot), so the vectorized
    chunk template defers them: each row's dict materializes on first
    index and is cached."""

    __slots__ = ("n", "_build", "_cache")

    def __init__(self, n: int, build) -> None:
        self.n = n
        self._build = build
        self._cache: Dict[int, _WarpCtx] = {}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, r: int) -> _WarpCtx:
        if not 0 <= r < self.n:
            raise IndexError(r)
        c = self._cache.get(r)
        if c is None:
            c = self._cache[r] = self._build(r)
        return c


#: live-workgroup fraction at or below which a private-store grid batch
#: compacts its live rows into a dense sub-batch at a loop back-edge
#: (0.0 disables compaction, 1.0 compacts whenever any row is dead)
_COMPACT_FRACTION = 0.25
#: don't bother compacting batches smaller than this many workgroups
_COMPACT_MIN_WGS = 8


class _GridTelemetry:
    """Per-process counters for the batch-preserving grid-mode paths.

    NOT part of ExecStats (stats stay bit-identical across executors by
    contract); tests reset and read these to prove re-merge / compaction
    actually fire on crafted workloads."""
    __slots__ = ("remerges", "compactions", "desyncs", "batches")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.remerges = 0
        self.compactions = 0
        self.desyncs = 0
        self.batches = 0


GRID_TELEMETRY = _GridTelemetry()

#: thread-local redirect for the grid telemetry: parallel worker tasks
#: install a PRIVATE _GridTelemetry here (core/parallel.py dispatch in
#: launch) which the main thread folds into GRID_TELEMETRY in chunk
#: order after the join — the process-global counters stay
#: deterministic at every worker count and pool backend
_TEL_TLS = threading.local()


def _tel() -> _GridTelemetry:
    t = getattr(_TEL_TLS, "tel", None)
    return GRID_TELEMETRY if t is None else t


def _drive_wg(bprog: "_BProgram", gens: List[Any], rows: Sequence[int],
              wg: Tuple[int, int], park: bool
              ) -> Optional[Tuple[int, int]]:
    """Advance one workgroup's row-generators with intra-workgroup
    barrier synchronization (the oracle's co-routine schedule).  With
    ``park=True`` (run-ahead licenced) the workgroup stops at the first
    top-level barrier ALL its rows reach congruently and returns that
    (block, node) position — a re-merge candidate; otherwise runs to
    completion and returns None.  Barrier divergence (some rows return
    while others wait) raises exactly like the per-warp scheduler."""
    alive = list(rows)
    exited: List[int] = []
    base = rows[0]
    while alive:
        if _gov.ACTIVE:
            _gov.deadline_check()
        events: Dict[int, Any] = {}
        done: List[int] = []
        for r in alive:
            try:
                events[r] = next(gens[r])
            except StopIteration:
                done.append(r)
            except ExecError as e:
                raise _add_ctx(e, workgroup=wg, warp=r - base)
        exited.extend(done)
        if events and done:
            raise _barrier_divergence_error(
                wg, [r - base for r in events],
                [r - base for r in exited])
        if not events:
            return None            # every row of the workgroup returned
        alive = sorted(events)
        if park and len(alive) == len(rows):
            evs = list(events.values())
            if all(type(e) is tuple for e in evs) and len(set(evs)) == 1:
                return evs[0][1], evs[0][2]
    return None


def _merge_rows(bprog: "_BProgram", wstates: List[_DState],
                live: Sequence[bool], proto: _DState
                ) -> Optional[_DState]:
    """Re-merge per-row states into one batched state; rows with
    ``live[r]`` False (workgroups that already returned) become empty
    rows: all-zero mask, zero env/slot/stack rows, so every mask source
    they could restore from (tmc tokens, IPDOM saves) keeps them dead.
    Returns None if the live rows are not congruent (different IPDOM
    shape / pending split)."""
    lives = [st for st, lv in zip(wstates, live) if lv]
    s0 = lives[0]
    depth = len(s0.stack)
    for st in lives:
        if st.pending is not None or len(st.stack) != depth:
            return None
    for lvl in range(depth):
        if (len({st.stack[lvl][0] for st in lives}) != 1
                or len({st.stack[lvl][2] for st in lives}) != 1):
            return None

    def stack_col(vals: List[Any]) -> Any:
        first = None
        for v, lv in zip(vals, live):
            if lv and v is not None:
                first = v
                break
        if first is None:
            return None
        if all(live) and all(v is vals[0] for v in vals):
            return vals[0]        # still the shared row-invariant array
        rows = [np.zeros_like(first) if (not lv or v is None) else v
                for v, lv in zip(vals, live)]
        return np.stack(rows)

    bst = _DState.__new__(_DState)
    bst.env = [stack_col([st.env[i] for st in wstates])
               for i in range(bprog.n_regs)]
    bst.slots = [stack_col([st.slots[i] for st in wstates])
                 for i in range(bprog.n_slots)]
    bst.args = proto.args
    bst.argmap = proto.argmap
    bst.mem_arrs = proto.mem_arrs
    W = bprog.W
    bst.mask = np.stack([st.mask if lv else np.zeros(W, dtype=bool)
                         for st, lv in zip(wstates, live)])
    ar = bst.mask.any(axis=1)
    bst.act_rows = ar
    bst.active = int(ar.sum())
    bst.stack = [
        (s0.stack[lvl][0],
         np.stack([st.stack[lvl][1] if lv else np.zeros(W, dtype=bool)
                   for st, lv in zip(wstates, live)]),
         s0.stack[lvl][2],
         None if s0.stack[lvl][3] is None else
         np.stack([st.stack[lvl][3] if lv else np.zeros(W, dtype=bool)
                   for st, lv in zip(wstates, live)]))
        for lvl in range(depth)]
    bst.pending = None
    bst.ret = None
    bst.shared_row = None
    bst.stripe = None
    bst.intr = proto.intr
    bst.ctx = proto.ctx
    bst.mem = proto.mem
    bst.stats = proto.stats
    bst.fuel = proto.fuel
    bst.warp_ctxs = proto.warp_ctxs
    return bst


def _drain_grid(bprog: "_BProgram", bst: _DState, bi: int, ni: int,
                wg_ids: Sequence[Tuple[int, int]], runahead: bool
                ) -> Optional[Tuple[_DState, int, int]]:
    """Grid-mode desync: slice the batch and drive each workgroup's rows
    per-warp in workgroup order (the oracle's schedule).  When run-ahead
    is licenced (``runahead``: store privacy matching the launch shape,
    computed once in launch() — parking workgroup g while g+1 drains
    past it then reorders nothing observable), workgroups park at
    their first congruent top-level barrier; if every workgroup that did
    not return parks at the SAME position with congruent stacks, the
    rows re-merge and the caller resumes lockstep there — returns
    (merged state, block, node).  Returns None when everything drained
    to completion."""
    wg_rows = bprog.wg_rows
    n_rows = bprog.n_warps
    n_wgs = n_rows // wg_rows
    _tel().desyncs += 1
    wstates = [_slice_state(bst, r, bst.warp_ctxs[r], wg_rows)
               for r in range(n_rows)]
    gens = [_resume_decoded(bprog, wstates[r], bi, ni)
            for r in range(n_rows)]
    park = runahead            # the full licence, computed at launch
    parked: Dict[int, Tuple[int, int]] = {}
    for g in range(n_wgs):
        rows = range(g * wg_rows, (g + 1) * wg_rows)
        loc = _drive_wg(bprog, gens, rows, wg_ids[g], park)
        if loc is not None:
            parked[g] = loc
    if not parked:
        return None
    merged: Optional[_DState] = None
    locs = set(parked.values())
    if len(locs) == 1:
        live = [False] * n_rows
        for g in parked:
            for r in range(g * wg_rows, (g + 1) * wg_rows):
                live[r] = True
        merged = _merge_rows(bprog, wstates, live, bst)
    if merged is None:
        # no congruent merge point: finish the parked workgroups (their
        # stores are private, so completing them after their peers
        # already ran ahead is oracle-exact)
        for g in sorted(parked):
            _drive_wg(bprog, gens,
                      range(g * wg_rows, (g + 1) * wg_rows),
                      wg_ids[g], False)
        return None
    _tel().remerges += 1
    pbi, pni = next(iter(locs))
    return merged, pbi, pni


def _gather_rows(subprog: "_BProgram", bst: _DState,
                 idx: Sequence[int], row_ctxs: List[_WarpCtx],
                 W: int, strict: bool) -> _DState:
    """Dense sub-batch of ``bst`` keeping rows ``idx`` (in order); rows
    beyond len(idx) up to the sub-program's width are zero padding —
    all-zero masks and states, so they stay dead forever."""
    n_sub = subprog.n_warps
    k = len(idx)

    def take(v: Any) -> Any:
        if v is None or v.ndim == 1:
            return v              # shared row-invariant array
        out = np.zeros((n_sub,) + v.shape[1:], v.dtype)
        out[:k] = v[idx]
        return out

    wg_rows = subprog.wg_rows

    def take_mem(entry):
        arr, shared = entry
        if shared and arr.ndim == 2:
            # gather the sub-batch workgroups' PRIVATE tile rows (tile
            # state travels with its workgroup; nothing outside the
            # batch ever reads a tile, so the copy is unobservable)
            n_sub_wgs = n_sub // wg_rows
            gsel = [idx[j] // wg_rows for j in range(0, len(idx),
                                                     wg_rows)]
            out = np.zeros((n_sub_wgs,) + arr.shape[1:], arr.dtype)
            out[:len(gsel)] = arr[gsel]
            return (out, True)
        return entry

    st = _DState.__new__(_DState)
    st.stripe = None
    st.shared_row = None
    st.env = [take(v) for v in bst.env]
    st.slots = [take(v) for v in bst.slots]
    st.args = bst.args
    st.argmap = bst.argmap
    st.mem_arrs = [take_mem(e) for e in bst.mem_arrs]
    mask = np.zeros((n_sub, W), dtype=bst.mask.dtype)
    mask[:k] = bst.mask[idx]
    st.mask = mask
    ar = mask.any(axis=1)
    st.act_rows = ar
    st.active = int(ar.sum())
    st.stack = [(tok, take(saved), ebi,
                 None if em is None else take(em))
                for (tok, saved, ebi, em) in bst.stack]
    st.pending = None             # compaction happens at block entry
    intr2: Dict[Tuple[str, int], np.ndarray] = {}
    for key, v in bst.intr.items():
        intr2[key] = take(v)
    st.ctx = _WarpCtx(W, intr2, strict, bst.ctx.affine_ok,
                      bst.ctx.affine_span)
    st.intr = intr2
    st.mem = bst.mem
    st.stats = bst.stats
    st.fuel = bst.fuel
    st.warp_ctxs = row_ctxs
    return st


def _split_batch(bprog: "_BProgram", bst: _DState,
                 wg_ids: Sequence[Tuple[int, int]], gs: List[int],
                 bi: int, runahead: bool) -> None:
    """Run the workgroups ``gs`` of ``bst`` as one dense sub-batch
    resuming at block ``bi`` (padded to a power of two so the decode
    cache sees a bounded set of widths)."""
    wg_rows = bprog.wg_rows
    W = bprog.W
    sub_wgs = 1
    while sub_wgs < len(gs):
        sub_wgs *= 2
    subprog = _decode_batched(bprog.fn, W, bprog.strict,
                              sub_wgs * wg_rows, grid_mode=True,
                              ride_along=bprog.ride_along,
                              wg_rows=wg_rows)
    idx = [r for g in gs
           for r in range(g * wg_rows, (g + 1) * wg_rows)]
    row_ctxs = [bst.warp_ctxs[r] for r in idx]
    while len(row_ctxs) < sub_wgs * wg_rows:
        row_ctxs.append(bst.warp_ctxs[idx[-1]])
    sub_ids = [wg_ids[g] for g in gs]
    while len(sub_ids) < sub_wgs:
        sub_ids.append((-1, -1))
    sub = _gather_rows(subprog, bst, idx, row_ctxs, W, bprog.strict)
    _run_grid_batched(subprog, sub, sub_ids, bi, 0, runahead)


def _compact_grid(bprog: "_BProgram", bst: _DState, bi: int,
                  wg_ids: Sequence[Tuple[int, int]],
                  runahead: bool) -> None:
    """Row compaction (private-store programs, at a loop back-edge): the
    batch splits into a DEAD sub-batch — workgroups whose rows all ride
    along empty; they collectively take the vx_pred exit at the next
    loop head, restore their tokens and run the epilogue in lockstep,
    finishing almost immediately — and a dense LIVE sub-batch that keeps
    looping without paying batched work on the dead rows.  Completes the
    whole batch."""
    wg_rows = bprog.wg_rows
    n_rows = bprog.n_warps
    n_wgs = n_rows // wg_rows
    live_wg = bst.act_rows.reshape(n_wgs, wg_rows).any(axis=1)
    _tel().compactions += 1
    dead_gs = [g for g in range(n_wgs) if not live_wg[g]]
    live_gs = [g for g in range(n_wgs) if live_wg[g]]
    _split_batch(bprog, bst, wg_ids, dead_gs, bi, runahead)
    _split_batch(bprog, bst, wg_ids, live_gs, bi, runahead)


def _run_grid_batched(bprog: "_BProgram", bst: _DState,
                      wg_ids: Sequence[Tuple[int, int]],
                      bi: int = 0, ni: int = 0,
                      runahead: bool = True) -> None:
    """Drive one (n_wg x wg_rows, W) batch of independent workgroups:
    lockstep until a desync event, then drain workgroup by workgroup in
    workgroup order — re-merging at a congruent top-level barrier when
    the program's stores are private at the launch's shape
    (``runahead`` = private_stores for 1-D launches, private_stores_2d
    for 2-D, picked in launch()).  At loop back-edges, mostly-empty
    such batches compact their live rows into a dense sub-batch."""
    _tel().batches += 1
    n_rows = bprog.n_warps
    n_wgs = n_rows // bprog.wg_rows
    compact_ok = (runahead and n_wgs >= _COMPACT_MIN_WGS
                  and _COMPACT_FRACTION > 0.0)
    while True:
        if _faults.ACTIVE:
            _faults.maybe_fault("grid.exec")
        if _gov.ACTIVE:
            _gov.deadline_check()
        nodes = bprog.bblocks[bi].nodes
        nn = len(nodes)
        jump: Optional[int] = None
        desync = False
        while ni < nn:
            r = nodes[ni](bst)
            if r is None:
                ni += 1
                continue
            if type(r) is int:
                jump = r
                break
            desync = True
            break
        if desync:
            m = _drain_grid(bprog, bst, bi, ni, wg_ids, runahead)
            if m is None:
                return
            bst, bi, ni = m
            continue
        if jump is None:
            raise ExecError(
                f"block %{bprog.bblocks[bi].label} fell through")
        if jump < 0:
            return
        if (compact_ok and jump <= bi
                and 0 < bst.active <= _COMPACT_FRACTION * n_rows):
            live_wg = bst.act_rows.reshape(
                n_wgs, bprog.wg_rows).any(axis=1)
            n_live = int(live_wg.sum())
            sub_wgs = 1
            while sub_wgs < n_live:
                sub_wgs *= 2
            # the padded sub-batch must be strictly smaller, or a
            # permissive threshold (tests sweep 1.0) would recurse on a
            # same-width batch forever
            if 0 < n_live <= _COMPACT_FRACTION * n_wgs \
                    and sub_wgs < n_wgs:
                _compact_grid(bprog, bst, jump, wg_ids, runahead)
                return
        bi, ni = jump, 0


# --------------------------------------------------------------------------
# Cross-launch coalescing: several pending launches of ONE kernel run as
# shared grid chunks, rows tagged with a launch id ("tenant"), stats and
# fuel de-mixed per tenant (core/runtime.py's LaunchService drives this)
# --------------------------------------------------------------------------

def _coalesce_struct(fn: Function
                     ) -> Optional[Tuple[frozenset, frozenset]]:
    """Binding-free structural licence for cross-launch coalescing:
    ``(param names read, param names written)``, or None when ``fn``
    can never coalesce.  Rules beyond the grid batcher's own licence:

      * every global memory effect must resolve to a TOP-LEVEL pointer
        param — the staging tables stack one row per tenant, and only
        param-bound buffers are per-tenant.  Non-shared ``GlobalVar``
        memory is one array shared by every tenant, so any touch
        refuses; ``__shared__`` tiles stay private per workgroup row
        and are exempt (top-level accesses only, like the grid gate).
      * no atomics or prints (cross-tenant interleaving would be
        observable; also excluded by ``order_free``, but refusing here
        avoids a wasted staging round-trip).
      * no structural read-write hazard: a param name both loaded and
        stored anywhere in the call tree refuses (the grid gate's
        loads & writes rule, at name level).

    Cached on the function, keyed by IR version."""
    cached = getattr(fn, "_coalesce_struct", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    reads: set = set()
    writes: set = set()
    ok = [True]

    def resolve(ptr: Any, binding: Dict[int, Any],
                depth: int) -> Optional[str]:
        if isinstance(ptr, GlobalVar):
            if ptr.space is AddrSpace.SHARED:
                if depth > 0:
                    ok[0] = False   # tile inside a callee: no slicing
                return None         # private per-row tile: exempt
            ok[0] = False           # module global: shared across tenants
            return None
        if isinstance(ptr, Param):
            root = binding.get(id(ptr))
            if isinstance(root, Param):
                return root.name
            if isinstance(root, GlobalVar):
                return resolve(root, binding, depth)
            ok[0] = False
            return None
        ok[0] = False
        return None

    def scan(f: Function, binding: Dict[int, Any], depth: int) -> None:
        if depth > 8:
            ok[0] = False
            return
        for i in f.instructions():
            op = i.op
            if op is Op.LOAD:
                r = resolve(i.operands[0], binding, depth)
                if r is not None:
                    reads.add(r)
            elif op is Op.STORE:
                r = resolve(i.operands[0], binding, depth)
                if r is not None:
                    writes.add(r)
            elif op in (Op.ATOMIC, Op.PRINT):
                ok[0] = False
            elif op is Op.CALL:
                callee: Function = i.operands[0]
                sub: Dict[int, Any] = {}
                for p, a in zip(callee.params, i.operands[1:]):
                    if _shared_ptr(a):
                        ok[0] = False      # tile escaping into a callee
                        return
                    if p.ty is Ty.PTR:
                        if isinstance(a, Param):
                            sub[id(p)] = binding.get(id(a))
                        elif isinstance(a, GlobalVar):
                            sub[id(p)] = a
                scan(callee, sub, depth + 1)
            if not ok[0]:
                return

    top: Dict[int, Any] = {id(p): p for p in fn.params if p.ty is Ty.PTR}
    scan(fn, top, 0)
    result = None
    if ok[0] and not (reads & writes):
        result = (frozenset(reads), frozenset(writes))
    fn._coalesce_struct = (fn.ir_version, result)  # type: ignore[attr-defined]
    return result


def _run_coalesced(gprog: "_BProgram", bst: _DState) -> None:
    """Lockstep-only driver for one coalesced chunk: the grid batcher's
    main loop minus every desync path.  Any event that would leave
    lockstep (divergent unstructured control flow, per-warp fallback,
    barrier divergence) aborts the GROUP instead of draining — the
    desync drains re-enter per-row solo contexts that don't exist for
    stacked tenants, and the abort protocol (rerun each tenant solo) is
    both simpler and exact."""
    bi = ni = 0
    while True:
        if _faults.ACTIVE:
            _faults.maybe_fault("coalesce.exec")
        if _gov.ACTIVE:
            _gov.deadline_check()
        nodes = gprog.bblocks[bi].nodes
        nn = len(nodes)
        jump: Optional[int] = None
        while ni < nn:
            r = nodes[ni](bst)
            if r is None:
                ni += 1
                continue
            if type(r) is int:
                jump = r
                break
            raise _CoalesceAbort("desync in coalesced chunk")
        if jump is None:
            raise ExecError(
                f"block %{gprog.bblocks[bi].label} fell through")
        if jump < 0:
            return
        bi, ni = jump, 0


def launch_coalesced(module_fn: Function,
                     tenants: Sequence[Tuple[Dict[str, np.ndarray],
                                             Dict[str, Any],
                                             LaunchParams]],
                     *, pool: Optional[DevicePool] = None,
                     mem_budget: Optional[int] = None,
                     workers: Optional[object] = None
                     ) -> List[ExecStats]:
    """Execute several pending launches of ONE kernel as shared grid
    chunks.  ``tenants`` is a sequence of ``(buffers, scalar_args,
    params)`` triples; returns one ``ExecStats`` per tenant, de-mixed
    to be bit-identical to running each launch alone (the conformance
    sweep in tests/test_launch_service.py proves it per kernel).

    ``workers`` composes host-parallel chunk dispatch with coalescing
    (multiplicative: fewer lockstep walks per launch x fewer launches
    per walk).  Parallel mode needs the store-privacy licence on top of
    order-freedom — concurrent chunks write disjoint staging-table
    cells — and otherwise falls back to this exact sequential drain.
    Any worker failure aborts the whole group exactly like a sequential
    failure would (same ``_CoalesceAbort`` funnel, solo regains
    authority).

    Transactional group-abort model: tenants run against stacked
    STAGING tables (one row per tenant, pooled), so any condition the
    group cannot handle — licence refusal, desync, a kernel error, a
    fault-injection hit, a deadline or per-tenant fuel trip — raises
    :class:`_CoalesceAbort` with every tenant buffer untouched.  The
    caller (``runtime.LaunchService``) then reruns each tenant solo
    through the normal degradation chain, which is the authority for
    exact per-launch errors, demotion and breaker accounting.  Only a
    fully successful group writes back."""
    fn = module_fn
    k = len(tenants)
    par_n = _parallel.resolve_workers(workers)
    par_backend = _parallel.resolve_backend() if par_n > 1 else "thread"
    p0 = tenants[0][2]
    W = p0.warp_size
    n_warps = p0.warps_per_wg
    for (_, _, pt) in tenants:
        if (pt.warp_size != W or pt.warps_per_wg != n_warps
                or pt.local_size != p0.local_size
                or pt.local_size_y != 1 or pt.grid_y != 1
                or pt.strict_oob_loads):
            raise _CoalesceAbort("launch-shape mismatch")
    struct = _coalesce_struct(fn)
    if struct is None:
        raise _CoalesceAbort(f"@{fn.name} is not coalescible")
    roots = write_root_buffers(fn)
    if roots is None or roots[1]:
        raise _CoalesceAbort("unresolvable or global write roots")
    writes = roots[0]

    # buffer signatures must agree across tenants (the service's group
    # key includes them; re-checked here because this is the licence)
    sigs: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
    ptr_params = [p for p in fn.params if p.ty is Ty.PTR]
    for p in ptr_params:
        b0 = tenants[0][0].get(p.name)
        if not isinstance(b0, np.ndarray) or b0.ndim != 1:
            raise _CoalesceAbort(f"no flat buffer bound for {p.name}")
        for (bt, _, _) in tenants[1:]:
            b = bt.get(p.name)
            if (not isinstance(b, np.ndarray) or b.shape != b0.shape
                    or b.dtype != b0.dtype):
                raise _CoalesceAbort(
                    f"buffer signature mismatch for {p.name}")
        sigs[p.name] = (b0.shape, b0.dtype)
    for (bt, _, _) in tenants:     # within-tenant views of one base
        arrs = [bt[p.name] for p in ptr_params]
        for i_ in range(len(arrs)):
            for j_ in range(i_ + 1, len(arrs)):
                if np.shares_memory(arrs[i_], arrs[j_]):
                    raise _CoalesceAbort("aliasing buffers in a tenant")

    # scalars: launch-uniform values stay 1-D (exactly the solo vector);
    # tenant-varying ones materialize per chunk as row-uniform 2-D
    argmap: Dict[int, Any] = {}
    per_scal: List[Tuple[int, np.ndarray]] = []
    for p in fn.params:
        if p.ty is Ty.PTR:
            continue
        vs = []
        for (_, sa, _) in tenants:
            v = (sa or {}).get(p.name)
            if v is None:
                raise _CoalesceAbort(f"no scalar bound for {p.name}")
            vs.append(v)
        dt = _TY_DTYPE[p.ty]
        if all(v == vs[0] for v in vs[1:]) or k == 1:
            argmap[id(p)] = np.full(W, vs[0], dtype=dt)
        else:
            per_scal.append((id(p), np.asarray(vs, dtype=dt)))

    grids = [pt.grid for (_, _, pt) in tenants]
    wg_tenant = np.repeat(np.arange(k, dtype=np.int64), grids)
    wg_gx = np.concatenate(
        [np.arange(g, dtype=np.int64) for g in grids])
    total_wgs = int(len(wg_tenant))
    budgets = [pt.fuel for (_, _, pt) in tenants]
    stripe = _Stripe(k, budgets)
    fuel = [int(sum(budgets))]     # hard backstop: summed budgets
    stats = ExecStats()            # batch sink (demix is authoritative)
    mem = DeviceMemory({}, {}, budget=mem_budget, pool=pool)

    # staging tables: one (k, n) row-per-tenant table per pointer param
    tables: Dict[str, np.ndarray] = {}
    if mem_budget is not None:
        need = sum(k * int(np.prod(s)) * np.dtype(d).itemsize
                   for (s, d) in sigs.values())
        if need > mem_budget:
            raise _CoalesceAbort("staging tables exceed memory budget")
        mem.allocated += need
    for p in ptr_params:
        s, d = sigs[p.name]
        t = (pool.take((k,) + s, d, zero=False) if pool is not None
             else np.empty((k,) + s, dtype=d))
        for j, (bt, _, _) in enumerate(tenants):
            t[j] = bt[p.name]
        tables[p.name] = t
        argmap[id(p)] = t

    try:
        # per-warp template, identical to the solo grid path's
        base_intr = {
            ("local_size", 0): np.full(W, p0.local_size, np.int32),
            ("local_size", 1): np.full(W, 1, np.int32),
            ("num_groups", 1): np.full(W, 1, np.int32),
            ("global_size", 1): np.full(W, 1, np.int32),
            ("num_threads", 0): np.full(W, W, np.int32),
            ("num_warps", 0): np.full(W, n_warps, np.int32),
        }
        # grid-dependent intrinsics: uniform across tenants stays 1-D
        # (what _stack_intrs produced), mixed grids go row-uniform 2-D
        grid_uni = all(g == grids[0] for g in grids[1:])
        gridv = np.asarray(grids, dtype=np.int64)
        if grid_uni:
            base_intr[("num_groups", 0)] = np.full(W, grids[0], np.int32)
            base_intr[("grid_dim", 0)] = np.full(W, grids[0], np.int32)
            base_intr[("global_size", 0)] = np.full(
                W, grids[0] * p0.local_size, np.int32)
        lanes = np.arange(W)
        warp_tmpl = []
        for wrp in range(n_warps):
            tid_lin = wrp * W + lanes
            wactive = tid_lin < p0.wg_threads
            lx = (tid_lin % p0.local_size).astype(np.int32)
            wbase = dict(base_intr)
            wbase[("local_id", 0)] = lx
            wbase[("local_id", 1)] = np.zeros(W, np.int32)
            wbase[("lane_id", 0)] = lanes.astype(np.int32)
            wbase[("warp_id", 0)] = np.full(W, wrp, np.int32)
            warp_tmpl.append((wactive, lx, wbase))
        wact_stack = np.stack([t_[0] for t_ in warp_tmpl])
        lx_stack = np.stack([t_[1] for t_ in warp_tmpl]).astype(np.int64)
        warp_2d: Dict[Tuple[str, int], np.ndarray] = {}
        if n_warps > 1:
            for key in (("local_id", 0), ("local_id", 1),
                        ("lane_id", 0), ("warp_id", 0)):
                warp_2d[key] = np.stack(
                    [t_[2][key] for t_ in warp_tmpl])
            chunk_base = base_intr
        else:
            # single warp per wg: per-warp keys stay 1-D, like the solo
            # grid path (_stack_intrs identity-stacking)
            chunk_base = warp_tmpl[0][2]
        affine_ok = p0.local_size % W == 0
        affine_span = int(max(
            g * p0.local_size * 1 * 1 + p0.local_size + W
            for g in grids))

        # whole-workgroup chunks: full chunks of the grid batcher's
        # width, then power-of-two remainder chunks — NO dead-row
        # padding (an all-dead padding row would force a desync at the
        # first vx_pred loop), and the decode cache still sees a
        # bounded set of widths
        wg_chunk = max(1, _GRID_BATCH_MAX // n_warps)
        spans: List[Tuple[int, int]] = []
        c0 = 0
        while total_wgs - c0 >= wg_chunk:
            spans.append((c0, wg_chunk))
            c0 += wg_chunk
        rem = total_wgs - c0
        pw = wg_chunk
        while rem:
            while pw > rem:
                pw //= 2
            spans.append((c0, pw))
            c0 += pw
            rem -= pw

        # full-batch intrinsic templates, hoisted exactly like the solo
        # grid path: built once over all tenants' workgroups, each
        # chunk slices contiguous row views (slices at workgroup
        # boundaries reproduce the historical per-chunk builds bit for
        # bit)
        rows_tot = total_wgs * n_warps
        row_tenant_all = np.repeat(wg_tenant, n_warps)
        gx_rep_all = np.repeat(wg_gx, n_warps)
        co_intr: Dict[Tuple[str, int], np.ndarray] = {
            ("group_id", 0): np.broadcast_to(
                gx_rep_all.astype(np.int32)[:, None],
                (rows_tot, W)).copy(),
            ("group_id", 1): np.zeros((rows_tot, W), np.int32),
            ("core_id", 0): np.broadcast_to(
                (gx_rep_all % 4).astype(np.int32)[:, None],
                (rows_tot, W)).copy(),
            ("global_id", 0): (
                wg_gx[:, None, None] * p0.local_size
                + lx_stack[None]).reshape(rows_tot, W).astype(np.int32),
            ("global_id", 1): np.zeros((rows_tot, W), np.int32),
        }
        if not grid_uni:
            gv = gridv[row_tenant_all]
            co_intr[("num_groups", 0)] = np.broadcast_to(
                gv.astype(np.int32)[:, None], (rows_tot, W)).copy()
            co_intr[("grid_dim", 0)] = co_intr[("num_groups", 0)]
            co_intr[("global_size", 0)] = np.broadcast_to(
                (gv * p0.local_size).astype(np.int32)[:, None],
                (rows_tot, W)).copy()
        for key, stk in warp_2d.items():
            co_intr[key] = np.tile(stk, (total_wgs, 1))
        am_all = argmap
        if per_scal:
            am_all = dict(argmap)
            for pid, vals in per_scal:
                am_all[pid] = np.broadcast_to(
                    vals[row_tenant_all][:, None], (rows_tot, W)).copy()

        def _exec_cochunk(c0: int, nc: int, gprog, cmem: DeviceMemory,
                          cstats: ExecStats, cfuel: List[int],
                          cstripe: _Stripe) -> None:
            rows = nc * n_warps
            r0 = c0 * n_warps
            gintr = dict(chunk_base)
            for key, arr in co_intr.items():
                gintr[key] = arr[r0:r0 + rows]
            am = am_all
            if per_scal:
                am = dict(am_all)
                for pid, _vals in per_scal:
                    am[pid] = am_all[pid][r0:r0 + rows]
            gctx = _WarpCtx(W, gintr, False, affine_ok, affine_span)
            cmem.reset_shared()
            cmem.grid_wgs = nc
            gst = _DState(gprog, am,
                          np.tile(wact_stack, (nc, 1)), gctx, cmem,
                          cstats, cfuel)
            cmem.grid_wgs = None
            gst.stripe = cstripe
            cstripe.begin_chunk(row_tenant_all[r0:r0 + rows],
                                gst.act_rows)
            _run_coalesced(gprog, gst)

        def _parallel_coalesced() -> bool:
            """Concurrent coalesced chunks: each worker runs against a
            private ``_WorkerMemory`` / ``_Stripe`` / fuel box, merged
            on the main thread in chunk order via ``_Stripe.merge``.
            True = completed.  False = the group runs the sequential
            drain (licence missing, injection armed, or nothing to
            overlap).  Worker failures re-raise into the surrounding
            ``_CoalesceAbort`` funnel — identical abort authority to a
            sequential failure."""
            if _faults.ACTIVE and not _faults.parallel_safe():
                return False
            wide = max(wg_chunk,
                       min(wg_chunk * par_n,
                           max(1, _GRID_PAR_ROWS_MAX // n_warps)))
            pspans: List[Tuple[int, int]] = []
            pc = 0
            while total_wgs - pc >= wide:
                pspans.append((pc, wide))
                pc += wide
            prem = total_wgs - pc
            ppw = wg_chunk
            while prem:
                while ppw > prem:
                    ppw //= 2
                pspans.append((pc, ppw))
                pc += ppw
                prem -= ppw
            if len(pspans) < 2:
                return False
            plans: Dict[int, Any] = {}
            for _, nc in pspans:
                if nc not in plans:
                    gp = _decode_batched(fn, W, False, nc * n_warps,
                                         grid_mode=True,
                                         ride_along=True,
                                         wg_rows=n_warps,
                                         coalesced=True)
                    if not (gp.order_free and gp.private_stores):
                        # concurrent chunks need store privacy on top
                        # of order-freedom: disjoint staging-table
                        # cells per row, no cross-chunk ordering to
                        # replay
                        return False
                    plans[nc] = gp
            for v in _kernel_globals(fn):
                if v.space is not AddrSpace.SHARED:
                    mem.resolve(v, argmap)
            fuel0 = fuel[0]
            sbudget = _SharedBudget(mem.budget, mem.allocated)
            flagged: List[bool] = []
            for _ in pspans:
                if _faults.ACTIVE:
                    _faults.maybe_fault("parallel.submit")
                    flagged.append(
                        _faults.decide("parallel.worker.exec"))
                else:
                    flagged.append(False)

            def _mk_task(ci: int, c0: int, nc: int):
                gprog = plans[nc]
                inj = flagged[ci]

                def _task():
                    wmem = _WorkerMemory(mem, sbudget)
                    cstats = ExecStats()
                    cfuel = [fuel0]
                    cstripe = _Stripe(k, budgets)
                    try:
                        if inj:
                            raise _faults.InjectedFault(
                                f"injected fault at site "
                                f"'parallel.worker.exec' (chunk {ci})",
                                site="parallel.worker.exec",
                                rung="grid")
                        with np.errstate(divide="ignore",
                                         invalid="ignore",
                                         over="ignore"):
                            _exec_cochunk(c0, nc, gprog, wmem,
                                          cstats, cfuel, cstripe)
                        cstripe.flush()
                        return cstripe, fuel0 - cfuel[0]
                    finally:
                        wmem.reset_shared()
                return _task

            wpool = _parallel.get_pool(par_n, par_backend)
            res = wpool.run([_mk_task(ci, c0, nc)
                             for ci, (c0, nc) in enumerate(pspans)])
            err = next((r for r in res
                        if isinstance(r, _parallel.TaskError)), None)
            if err is not None:
                raise err.error
            if _faults.ACTIVE:
                _faults.maybe_fault("parallel.merge")
            used = [r[1] for r in res]
            for cstripe, _ in res:
                stripe.merge(cstripe)
            if sum(used) > fuel0:
                raise _CoalesceAbort("summed fuel backstop exhausted")
            fuel[0] = fuel0 - sum(used)
            return True

        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            if not (par_n > 1 and _parallel_coalesced()):
                for (c0, nc) in spans:
                    gprog = _decode_batched(fn, W, False, nc * n_warps,
                                            grid_mode=True,
                                            ride_along=True,
                                            wg_rows=n_warps,
                                            coalesced=True)
                    if not gprog.order_free:
                        # hazard stores decode to desync nodes (which
                        # abort at run time anyway) — refuse up front.
                        # order_free suffices: the coalesced driver
                        # replays the solo grid batcher's row-major
                        # lockstep order exactly, and each tenant's
                        # rows only touch its own table row, so
                        # single-site last-wins scatters reproduce the
                        # per-tenant solo result
                        raise _CoalesceAbort(
                            f"@{fn.name}: not order-free at this shape")
                    _exec_cochunk(c0, nc, gprog, mem, stats, fuel,
                                  stripe)
        stripe.flush()
        # full group success: write back the written params per tenant
        for name in writes:
            t = tables.get(name)
            if t is None:
                continue
            for j, (bt, _, _) in enumerate(tenants):
                bt[name][...] = t[j]
        return [stripe.demix(j) for j in range(k)]
    except _CoalesceAbort:
        raise
    except Exception as e:
        # ANY failure aborts the group — staging tables are dropped,
        # tenant buffers are untouched (nothing to roll back), and the
        # solo reruns reproduce the exact per-tenant error / demotion /
        # deadline behavior
        raise _CoalesceAbort(f"{type(e).__name__}: {e}") from e
    finally:
        mem.reset_shared()
        if pool is not None:
            for t in tables.values():
                pool.release(t)


def _kernel_globals(fn: Function) -> List[GlobalVar]:
    """Every GlobalVar referenced anywhere in ``fn``'s call tree, in
    deterministic first-appearance order (cached per IR version).  The
    parallel dispatcher pre-resolves the non-shared ones on the main
    thread: the lazy zero-fill in ``DeviceMemory.resolve`` is a
    check-then-insert on the launch-shared ``globals_mem`` dict, which
    two workers must never race (the loser's array would swallow
    writes); the cell writes themselves are licence-disjoint."""
    cached = getattr(fn, "_kernel_globals", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    out: Dict[int, GlobalVar] = {}
    seen: set = set()

    def walk(f: Function) -> None:
        if id(f) in seen:
            return
        seen.add(id(f))
        for i in f.instructions():
            for v in i.operands:
                if isinstance(v, GlobalVar):
                    out.setdefault(id(v), v)
            if i.op is Op.CALL:
                walk(i.operands[0])

    walk(fn)
    res = list(out.values())
    fn._kernel_globals = (fn.ir_version, res)  # type: ignore[attr-defined]
    return res


# --------------------------------------------------------------------------
# Kernel launch (grid scheduling = the thread-schedule code VOLT's
# front-end inserts; here it lives in the host runtime)
# --------------------------------------------------------------------------

def launch(module_fn: Function, buffers: Dict[str, np.ndarray],
           params: LaunchParams,
           scalar_args: Optional[Dict[str, Any]] = None,
           globals_mem: Optional[Dict[str, np.ndarray]] = None,
           *, decoded: bool = True, batched: bool = True,
           ride_along: bool = True,
           grid: Optional[bool] = None,
           torch: Optional[Any] = None,
           device: Optional[Any] = None,
           deadline_t: Optional[float] = None,
           deadline_ms: Optional[float] = None,
           mem_budget: Optional[int] = None,
           pool: Optional[DevicePool] = None,
           workers: Optional[object] = None) -> ExecStats:
    """Execute a compiled kernel over the launch grid; returns stats.
    Buffers are mutated in place (device memory semantics).

    ``workers`` (default: the ``VOLT_WORKERS`` knob; ``1`` = exact
    sequential dispatch) engages the host-parallel grid dispatcher on
    store-privacy-licensed grid launches: mutually independent chunks
    widen to ``_GRID_PAR_ROWS_MAX`` rows and run concurrently on the
    persistent ``core/parallel.py`` pool, per-chunk ExecStats /
    telemetry / fuel merging back deterministically in chunk order, so
    results are bit-identical to sequential dispatch at every worker
    count.  Unlicensed launches keep the exact sequential wg-order
    drain.  A worker EngineFault / deadline surfaces exactly like its
    sequential counterpart (the runtime chain demotes with rollback);
    any other worker failure falls back to a full sequential pass,
    which reproduces the exact sequential error (chunk writes are
    idempotent under the licence).

    ``decoded=True`` (default) runs the pre-decoded table-driven executor;
    ``decoded=False`` keeps the original instruction-at-a-time loop — the
    semantics oracle the parity tests and benchmarks/interp_speed.py
    compare against.  ``batched=True`` (default) additionally runs
    multi-warp workgroups through the workgroup-batched lockstep executor
    (one (n_warps, W) node walk per workgroup while the warps agree on
    control flow, transparent per-warp fallback otherwise) and packs
    eligible grids — single-warp AND multi-warp workgroups — into
    (n_wg x n_warps, W) grid-level batches with per-workgroup barrier
    groups; both engage only when ``decoded`` is on and OOB-load checking
    is off.  ``grid`` pins the grid-level batcher: ``True`` attempts it
    even when ``ride_along`` is off, ``False`` never engages it (the
    per-workgroup dispatch the benchmarks baseline against), ``None``
    (default) engages it whenever the launch is eligible.
    ``ride_along=False`` disables the vx_pred-loop ride-along and (unless
    ``grid=True``) grid-level batching (the PR 2 executor, kept as a
    benchmark baseline).

    ``torch`` engages the torch codegen rung (core/backends/torchgen.py)
    ABOVE grid batching: ``True`` makes a torch-rung failure an
    ``EngineFault`` (the runtime chain demotes it), ``"fallback"``
    silently falls through to the normal executor selection, ``None``
    (default) never engages it.  The rung self-licenses (order-free +
    store-private + supported ops) and self-certifies (a differential
    pass against the normal chain per (kernel, launch shape class,
    device), recorded via ``TORCH_CERT_HOOKS``); unlicensed or
    uncertified launches fall through.  ``device`` is where the rung
    runs: ``None`` means the card (``repro_torch.device``), and asking
    for the card where there is none raises before anything runs.

    Error taxonomy (docs/robustness.md): semantic kernel errors raise
    ``ExecError`` (a ``faults.KernelFault``), annotated with kernel /
    workgroup / warp context; any OTHER exception escaping a demotable
    fast path is re-raised as ``faults.EngineFault`` so the runtime's
    degradation chain can retry one executor rung down.  The executor
    actually selected is recorded in ``LAST_EXECUTOR[0]``.

    Governor hooks (core/governor.py): ``deadline_ms`` (relative) or
    ``deadline_t`` (absolute ``perf_counter`` time — the runtime's
    chain shares one across retries) arms cooperative preemption —
    executors poll at their block/chunk/barrier checkpoints and raise
    ``faults.DeadlineExceeded`` (a KernelFault carrying the partial
    stats) on expiry.  ``mem_budget`` bounds lazy device-memory
    allocation (overruns are ``EngineFault``s at site "mem.alloc")."""
    fn = module_fn
    LAST_EXECUTOR[0] = None
    # resolve the parallel-dispatch config BEFORE entering the demotable
    # region: a malformed VOLT_WORKERS is a caller error that must
    # surface as-is, not an engine fault to demote on
    par_n = _parallel.resolve_workers(workers)
    par_backend = _parallel.resolve_backend() if par_n > 1 else "thread"
    if torch:
        # likewise the torch rung's device: no card where one is asked
        # for is the caller's error, never a demotion
        from ..device import resolve_device
        device = resolve_device(device)
    depth = _faults.rung_depth()
    stats = ExecStats()
    governed = deadline_t is not None or deadline_ms is not None
    if governed:
        if deadline_t is None:
            deadline_t = _gov.perf_counter() + deadline_ms * 1e-3
        _gov.arm_deadline(deadline_t, deadline_ms, stats)
    try:
        return _launch_impl(fn, buffers, params, scalar_args,
                            globals_mem, stats=stats, decoded=decoded,
                            batched=batched, ride_along=ride_along,
                            grid=grid, torch=torch, device=device,
                            mem_budget=mem_budget,
                            pool=pool, workers=par_n,
                            par_backend=par_backend)
    except ExecError as e:
        raise _add_ctx(e, kernel=fn.name)
    except _faults.KernelFault:
        raise    # DeadlineExceeded: the caller's verdict, never demoted
    except _faults.EngineFault:
        raise
    except Exception as e:
        rung = LAST_EXECUTOR[0]
        if rung in _faults.DEMOTABLE:
            raise _faults.EngineFault(
                f"internal error in {rung} executor: "
                f"{type(e).__name__}: {e}", rung=rung) from e
        raise
    finally:
        if governed:
            _gov.disarm_deadline()
        _faults.trim_rungs(depth)


def _launch_impl(module_fn: Function, buffers: Dict[str, np.ndarray],
                 params: LaunchParams,
                 scalar_args: Optional[Dict[str, Any]] = None,
                 globals_mem: Optional[Dict[str, np.ndarray]] = None,
                 *, stats: Optional[ExecStats] = None,
                 decoded: bool = True, batched: bool = True,
                 ride_along: bool = True,
                 grid: Optional[bool] = None,
                 torch: Optional[Any] = None,
                 device: Optional[Any] = None,
                 mem_budget: Optional[int] = None,
                 pool: Optional[DevicePool] = None,
                 workers: int = 1,
                 par_backend: str = "thread") -> ExecStats:
    fn = module_fn
    scalar_args = scalar_args or {}
    mem = DeviceMemory(buffers, globals_mem, budget=mem_budget, pool=pool)
    if stats is None:
        stats = ExecStats()
    W = params.warp_size
    fuel = [params.fuel]
    n_wg = params.grid * params.grid_y
    n_warps = params.warps_per_wg

    # launch-invariant pieces, hoisted out of the grid loops: kernel
    # argument vectors and the constant CSR-backed intrinsics (all arrays
    # are read-only to the executors)
    argmap: Dict[int, Any] = {}
    for p in fn.params:
        if p.ty is Ty.PTR:
            if p.name in buffers:
                argmap[id(p)] = buffers[p.name]
            else:
                raise ExecError(f"no buffer bound for {p.name}")
        else:
            v = scalar_args.get(p.name)
            if v is None:
                raise ExecError(f"no scalar bound for {p.name}")
            argmap[id(p)] = np.full(W, v, dtype=_TY_DTYPE[p.ty])

    if (torch and decoded and batched and n_wg > 1
            and not params.strict_oob_loads):
        # torch codegen rung (core/backends/torchgen.py): licence-gated,
        # certification-gated.  orchestrate() returns True only when it
        # produced this launch's results (the certified primary on the
        # device, or a differential certification run that drove the
        # normal chain itself); anything it cannot take falls through
        # unchanged.
        LAST_EXECUTOR[0] = "torch"
        _faults.push_rung("torch")
        from .backends import torchgen as _torchgen

        def _run_normal(st: ExecStats) -> None:
            _launch_impl(fn, buffers, params, scalar_args, globals_mem,
                         stats=st, decoded=decoded, batched=batched,
                         ride_along=ride_along, grid=grid, torch=None,
                         mem_budget=mem_budget, pool=pool,
                         workers=workers, par_backend=par_backend)

        if _torchgen.orchestrate(fn, buffers, params, scalar_args, mem,
                                 argmap, stats,
                                 "fallback" if torch == "fallback"
                                 else True,
                                 _run_normal, route=(torch == "route"),
                                 device=device):
            return stats

    want_grid = ride_along if grid is None else grid
    eligible = bool(decoded and batched and want_grid
                    and n_wg > 1 and not params.strict_oob_loads)
    if eligible:
        # a crash inside the gate itself is a grid-rung engine fault
        # (the launch wrapper demotes it), not a launch-killing error
        LAST_EXECUTOR[0] = "grid"
        use_grid = _grid_batchable(fn, argmap, mem.globals_mem)
    else:
        use_grid = False
    use_batched = bool(decoded and batched and n_warps > 1
                       and not params.strict_oob_loads
                       and not use_grid)
    rung_label = ("grid" if use_grid else
                  "wg" if use_batched else
                  "decoded" if decoded else "oracle")
    LAST_EXECUTOR[0] = rung_label
    # scoped fault sites fire only under a demotable rung ("oracle"
    # suppresses them), and the wrapper classifies escaping exceptions
    # by this label; the wrapper trims the rung stack on exit
    _faults.push_rung(rung_label)
    prog = _decode(fn, W, params.strict_oob_loads) \
        if decoded and not use_batched and not use_grid else None
    bprog = _decode_batched(fn, W, params.strict_oob_loads, n_warps,
                            ride_along=ride_along) \
        if use_batched else None
    base_intr = {
        ("local_size", 0): np.full(W, params.local_size, np.int32),
        ("local_size", 1): np.full(W, params.local_size_y, np.int32),
        ("num_groups", 0): np.full(W, params.grid, np.int32),
        ("num_groups", 1): np.full(W, params.grid_y, np.int32),
        ("global_size", 0): np.full(W, params.grid * params.local_size,
                                    np.int32),
        ("global_size", 1): np.full(W, params.grid_y *
                                    params.local_size_y, np.int32),
        ("num_threads", 0): np.full(W, W, np.int32),
        ("num_warps", 0): np.full(W, params.warps_per_wg, np.int32),
        ("grid_dim", 0): np.full(W, params.grid, np.int32),
    }
    warp_ids = [np.full(W, wrp, np.int32)
                for wrp in range(params.warps_per_wg)]
    # coalescing-engine analytic licence (see _WarpCtx): a warp never
    # wraps a local_size boundary mid-row, and the wrap-free span bound
    # covers every SIMT id of this launch
    affine_ok = params.local_size % W == 0
    affine_span = (params.grid * params.local_size * params.grid_y
                   * params.local_size_y + params.local_size + W)

    if use_grid:
        # grid-level batching: pack whole workgroups into
        # (n_wg x n_warps, W) activations — rows are warps, grouped
        # n_warps consecutive rows per workgroup; per-row intrinsics
        # (group_id, global_id, warp/local/lane ids) stack into rows,
        # the launch-invariant ones stay 1D and broadcast
        lanes = np.arange(W)
        warp_tmpl: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                              Dict]] = []
        for wrp in range(n_warps):
            tid_lin = wrp * W + lanes
            wactive = tid_lin < params.wg_threads
            lx = (tid_lin % params.local_size).astype(np.int32)
            ly = (tid_lin // params.local_size).astype(np.int32)
            wbase = dict(base_intr)
            wbase[("local_id", 0)] = lx
            wbase[("local_id", 1)] = ly
            wbase[("lane_id", 0)] = lanes.astype(np.int32)
            wbase[("warp_id", 0)] = warp_ids[wrp]
            warp_tmpl.append((wactive, lx, ly, wbase))
        # vectorized chunk templates (the PR 5 profile hot spot): the
        # per-warp pieces stack once per launch, each chunk's per-row
        # intrinsics are then whole-array broadcasts/products instead of
        # nc * n_warps Python dict builds + np.full calls per chunk
        wact_stack = np.stack([t[0] for t in warp_tmpl])   # (n_warps, W)
        lx_stack = np.stack([t[1] for t in warp_tmpl]).astype(np.int64)
        ly_stack = np.stack([t[2] for t in warp_tmpl]).astype(np.int64)
        warp_2d: Dict[Tuple[str, int], np.ndarray] = {}
        if n_warps > 1:
            # row-varying per-warp intrinsics, tiled per chunk below
            for key in (("local_id", 0), ("local_id", 1),
                        ("lane_id", 0), ("warp_id", 0)):
                warp_2d[key] = np.stack(
                    [t[3][key] for t in warp_tmpl])
            chunk_base = base_intr
        else:
            # one warp per wg: the per-warp keys are launch-invariant
            # and stay 1-D, exactly what _stack_intrs produced
            # (identical objects stay unstacked)
            chunk_base = warp_tmpl[0][3]

        def _mk_row_ctx(r: int, c0: int) -> _WarpCtx:
            # desync fallback only: one row's solo context, identical to
            # the historical per-row construction
            k, wrp = divmod(r, n_warps)
            gx = (c0 + k) % params.grid
            gy = (c0 + k) // params.grid
            _, lx, ly, wbase = warp_tmpl[wrp]
            intr = dict(wbase)
            intr[("group_id", 0)] = np.full(W, gx, np.int32)
            intr[("group_id", 1)] = np.full(W, gy, np.int32)
            intr[("core_id", 0)] = np.full(W, gx % 4, np.int32)
            intr[("global_id", 0)] = (gx * params.local_size
                                      + lx).astype(np.int32)
            intr[("global_id", 1)] = (gy * params.local_size_y
                                      + ly).astype(np.int32)
            return _WarpCtx(W, intr, params.strict_oob_loads,
                            affine_ok, affine_span)

        wg_chunk = max(1, _GRID_BATCH_MAX // n_warps)
        # run-ahead licence (re-merge past returned workgroups, row
        # compaction) depends on the launch shape: bare
        # global_id(0)/group_id(0) store chains are injective only in
        # 1-D launches (``private_stores``), while full 2-D linear-id
        # chains keep the licence on 2-D grids too
        # (``private_stores_2d``)
        shape_1d = params.grid_y == 1 and params.local_size_y == 1

        # full-grid intrinsic templates: built ONCE per launch, each
        # chunk slices a contiguous row view — the per-chunk broadcast
        # + dict rebuild was the remaining PR 5 --profile hot spot, and
        # parallel dispatch would multiply it by the chunk count.
        # int64 products truncated to int32 match the historical int32
        # arithmetic bit-for-bit (two's-complement wrap)
        ks_all = np.arange(n_wg, dtype=np.int64)
        gxs_all = ks_all % params.grid
        gys_all = ks_all // params.grid
        rows_all = n_wg * n_warps
        gx_rep_all = np.repeat(gxs_all, n_warps)
        gy_rep_all = np.repeat(gys_all, n_warps)
        grid_intr: Dict[Tuple[str, int], np.ndarray] = {
            ("group_id", 0): np.broadcast_to(
                gx_rep_all.astype(np.int32)[:, None],
                (rows_all, W)).copy(),
            ("group_id", 1): np.broadcast_to(
                gy_rep_all.astype(np.int32)[:, None],
                (rows_all, W)).copy(),
            ("core_id", 0): np.broadcast_to(
                (gx_rep_all % 4).astype(np.int32)[:, None],
                (rows_all, W)).copy(),
            ("global_id", 0): (
                gxs_all[:, None, None] * params.local_size
                + lx_stack[None]).reshape(rows_all, W).astype(np.int32),
            ("global_id", 1): (
                gys_all[:, None, None] * params.local_size_y
                + ly_stack[None]).reshape(rows_all, W).astype(np.int32),
        }
        for key, stk in warp_2d.items():
            # period-n_warps tiling: any slice starting at a workgroup
            # boundary reproduces the per-chunk np.tile exactly
            grid_intr[key] = np.tile(stk, (n_wg, 1))

        def _exec_chunk(c0: int, nc: int, gprog: "_BProgram",
                        runahead: bool, cmem: DeviceMemory,
                        cstats: ExecStats, cfuel: List[int]) -> None:
            rows = nc * n_warps
            r0 = c0 * n_warps
            gintr = dict(chunk_base)
            for key, arr in grid_intr.items():
                gintr[key] = arr[r0:r0 + rows]
            chunk_ids = list(zip(gxs_all[c0:c0 + nc].tolist(),
                                 gys_all[c0:c0 + nc].tolist()))
            gctx = _WarpCtx(W, gintr, params.strict_oob_loads,
                            affine_ok, affine_span)
            cmem.reset_shared()    # fresh private tile table per
            cmem.grid_wgs = nc     # chunk: (nc, size) shared arrays
            gst = _DState(gprog, argmap, np.tile(wact_stack, (nc, 1)),
                          gctx, cmem, cstats, cfuel)
            cmem.grid_wgs = None
            gst.warp_ctxs = _LazyRowCtxs(
                rows, lambda r, c0=c0: _mk_row_ctx(r, c0))
            try:
                _run_grid_batched(gprog, gst, chunk_ids,
                                  runahead=runahead)
            except ExecError as e:
                # lockstep-phase errors span the chunk; desync-phase
                # errors already carry their exact workgroup (the
                # innermost annotation wins)
                raise _add_ctx(
                    e, workgroup=f"{chunk_ids[0]}..{chunk_ids[-1]}")

        def _parallel_grid() -> bool:
            """Host-parallel dispatch attempt (core/parallel.py):
            store-privacy-licensed chunks widen to _GRID_PAR_ROWS_MAX
            rows and run concurrently, each against a private
            _WorkerMemory / ExecStats / fuel box / telemetry, merged on
            the main thread in chunk order.  True = completed (results
            bit-identical to sequential dispatch — chunk width is
            semantics-invisible under the licence, proven by the
            chunk-size-invariance metamorphic suite).  False = run the
            exact sequential loop instead; nothing observable happened
            (chunk state was private; any partial buffer writes are
            rewritten idempotently — the licence makes each cell's
            writer unique and deterministic).  A worker EngineFault or
            DeadlineExceeded re-raises: the runtime chain demotes /
            surfaces it with bit-exact rollback, like any sequential
            engine fault."""
            if _faults.ACTIVE and not _faults.parallel_safe():
                return False       # injection order must stay exact
            wide = max(wg_chunk,
                       min(wg_chunk * workers,
                           max(1, _GRID_PAR_ROWS_MAX // n_warps)))
            spans = [(c0, min(wide, n_wg - c0))
                     for c0 in range(0, n_wg, wide)]
            # pre-decode every distinct width on the main thread (warm
            # plan cache; the licence is re-read from the widened plan)
            plans: Dict[int, "_BProgram"] = {}
            for _, nc in spans:
                if nc not in plans:
                    gp = _decode_batched(fn, W, params.strict_oob_loads,
                                         nc * n_warps, grid_mode=True,
                                         ride_along=ride_along,
                                         wg_rows=n_warps)
                    if not (gp.private_stores if shape_1d
                            else gp.private_stores_2d):
                        # unlicensed: keep the exact sequential
                        # wg-order drain
                        return False
                    plans[nc] = gp
            for v in _kernel_globals(fn):
                if v.space is not AddrSpace.SHARED:
                    mem.resolve(v, argmap)
            fuel0 = fuel[0]
            sbudget = _SharedBudget(mem.budget, mem.allocated)
            flagged: List[bool] = []
            for _ in spans:
                if _faults.ACTIVE:
                    _faults.maybe_fault("parallel.submit")
                    flagged.append(
                        _faults.decide("parallel.worker.exec"))
                else:
                    flagged.append(False)

            def _mk_task(ci: int, c0: int, nc: int):
                gprog = plans[nc]
                inj = flagged[ci]

                def _task():
                    tel = _GridTelemetry()
                    _TEL_TLS.tel = tel
                    wmem = _WorkerMemory(mem, sbudget)
                    cstats = ExecStats()
                    cfuel = [fuel0]   # prefix-checked at the merge
                    try:
                        if inj:
                            raise _faults.InjectedFault(
                                f"injected fault at site "
                                f"'parallel.worker.exec' (chunk {ci})",
                                site="parallel.worker.exec",
                                rung="grid")
                        # np.errstate is thread-local: each worker
                        # re-enters the launch's suppression scope
                        with np.errstate(divide="ignore",
                                         invalid="ignore",
                                         over="ignore"):
                            _exec_chunk(c0, nc, gprog, True, wmem,
                                        cstats, cfuel)
                        return cstats, fuel0 - cfuel[0], tel
                    finally:
                        _TEL_TLS.tel = None
                        wmem.reset_shared()
                return _task

            wpool = _parallel.get_pool(workers, par_backend)
            res = wpool.run([_mk_task(ci, c0, nc)
                             for ci, (c0, nc) in enumerate(spans)])
            err = next((r for r in res
                        if isinstance(r, _parallel.TaskError)), None)
            if err is not None:
                # best-effort partial stats (the deadline error's
                # governor arm carries the launch stats object)
                for r in res:
                    if type(r) is tuple:
                        stats.merge(r[0])
                if isinstance(err.error, (_faults.EngineFault,
                                          _faults.DeadlineExceeded)):
                    raise err.error
                return False       # exact sequential rerun
            if _faults.ACTIVE:
                _faults.maybe_fault("parallel.merge")
            used = [r[1] for r in res]
            if sum(used) > fuel0:
                # a cumulative budget no single chunk saw alone ran out
                # mid-grid: the sequential rerun reproduces the exact
                # out-of-fuel error, context and partial stats
                return False
            for cstats, _, tel in res:
                stats.merge(cstats)
                GRID_TELEMETRY.desyncs += tel.desyncs
                GRID_TELEMETRY.remerges += tel.remerges
                GRID_TELEMETRY.compactions += tel.compactions
                GRID_TELEMETRY.batches += tel.batches
            fuel[0] = fuel0 - sum(used)
            return True

        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if workers > 1 and n_wg > wg_chunk and _parallel_grid():
                return stats
            for c0 in range(0, n_wg, wg_chunk):
                if _faults.ACTIVE:
                    _faults.maybe_fault("chunk.dispatch")
                nc = min(wg_chunk, n_wg - c0)
                gprog = _decode_batched(fn, W, params.strict_oob_loads,
                                        nc * n_warps, grid_mode=True,
                                        ride_along=ride_along,
                                        wg_rows=n_warps)
                runahead = (gprog.private_stores if shape_1d
                            else gprog.private_stores_2d)
                _exec_chunk(c0, nc, gprog, runahead, mem, stats, fuel)
        return stats

    for wg_lin in range(n_wg):
        gx = wg_lin % params.grid
        gy = wg_lin // params.grid
        mem.reset_shared()   # fresh shared memory per workgroup
        wg_intr = dict(base_intr)
        wg_intr[("group_id", 0)] = np.full(W, gx, np.int32)
        wg_intr[("group_id", 1)] = np.full(W, gy, np.int32)
        wg_intr[("core_id", 0)] = np.full(W, gx % 4, np.int32)
        warp_ctxs: List[_WarpCtx] = []
        warp_masks: List[np.ndarray] = []
        for wrp in range(n_warps):
            lanes = np.arange(W)
            tid_lin = wrp * W + lanes
            active = tid_lin < params.wg_threads
            lx = tid_lin % params.local_size
            ly = tid_lin // params.local_size
            intr = dict(wg_intr)
            intr[("local_id", 0)] = lx.astype(np.int32)
            intr[("local_id", 1)] = ly.astype(np.int32)
            intr[("lane_id", 0)] = lanes.astype(np.int32)
            intr[("global_id", 0)] = (gx * params.local_size
                                      + lx).astype(np.int32)
            intr[("global_id", 1)] = (gy * params.local_size_y
                                      + ly).astype(np.int32)
            intr[("warp_id", 0)] = warp_ids[wrp]
            warp_ctxs.append(_WarpCtx(W, intr, params.strict_oob_loads,
                                      affine_ok, affine_span))
            warp_masks.append(active)

        if bprog is not None:
            # workgroup-batched lockstep execution: one 2D activation for
            # the whole workgroup; per-warp intrinsics stack into rows,
            # warp-invariant ones stay 1D and broadcast
            bctx = _stack_intrs(warp_ctxs, W, params.strict_oob_loads)
            bst = _DState(bprog, argmap, np.stack(warp_masks), bctx, mem,
                          stats, fuel)
            bst.warp_ctxs = warp_ctxs
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                try:
                    _run_wg_batched(bprog, bst, (gx, gy))
                except ExecError as e:
                    raise _add_ctx(e, workgroup=(gx, gy))
            continue

        warps: List[Generator[str, None, np.ndarray]] = []
        for wrp in range(n_warps):
            if prog is not None:
                warp_st = _DState(prog, argmap, warp_masks[wrp].copy(),
                                  warp_ctxs[wrp], mem, stats, fuel)
                warps.append(_run_decoded(prog, warp_st))
            else:
                warps.append(_exec_warp(fn, argmap, warp_masks[wrp],
                                        warp_ctxs[wrp], mem, stats, fuel))

        # co-routine scheduling: run each warp to its next barrier; barriers
        # synchronize all warps of the workgroup (vx_barrier local scope)
        # (errstate hoisted out of the instruction loop: the decoded
        # executor binds raw numpy handlers with no per-op context)
        alive = list(range(len(warps)))
        exited: List[int] = []
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            while alive:
                if _gov.ACTIVE:
                    _gov.deadline_check()
                at_barrier: List[int] = []
                done: List[int] = []
                for wi in alive:
                    try:
                        ev = next(warps[wi])
                        assert ev == "barrier"
                        at_barrier.append(wi)
                    except StopIteration:
                        done.append(wi)
                    except ExecError as e:
                        raise _add_ctx(e, workgroup=(gx, gy), warp=wi)
                exited.extend(done)
                if at_barrier and done:
                    raise _barrier_divergence_error((gx, gy), at_barrier,
                                                    exited)
                alive = at_barrier
    return stats


# --------------------------------------------------------------------------
# Scalar reference executor (per-thread oracle on untransformed IR)
# --------------------------------------------------------------------------

def reference_launch(fn: Function, buffers: Dict[str, np.ndarray],
                     params: LaunchParams,
                     scalar_args: Optional[Dict[str, Any]] = None,
                     globals_mem: Optional[Dict[str, np.ndarray]] = None
                     ) -> None:
    """Run each thread as an independent scalar program (CPU-reference
    semantics, paper §5 'outputs compared against reference CPU
    implementations'). Threads in a workgroup synchronize at barriers."""
    scalar_args = scalar_args or {}
    mem = DeviceMemory(buffers, globals_mem)

    def thread_gen(gx: int, gy: int, lx: int, ly: int
                   ) -> Generator[str, None, Any]:
        env: Dict[int, Any] = {}
        slots: Dict[int, Any] = {}

        def val(v: Value) -> Any:
            if isinstance(v, Const):
                return v.value
            if isinstance(v, Reg):
                return env[id(v)]
            if isinstance(v, Param):
                return argmap[id(v)]
            raise ExecError(f"cannot evaluate {v!r}")

        argmap: Dict[int, Any] = {}
        for p in fn.params:
            if p.ty is Ty.PTR:
                argmap[id(p)] = buffers[p.name]
            else:
                argmap[id(p)] = scalar_args[p.name]

        intr = {
            ("local_id", 0): lx, ("local_id", 1): ly,
            ("lane_id", 0): (ly * params.local_size + lx) % params.warp_size,
            ("group_id", 0): gx, ("group_id", 1): gy,
            ("global_id", 0): gx * params.local_size + lx,
            ("global_id", 1): gy * params.local_size_y + ly,
            ("local_size", 0): params.local_size,
            ("local_size", 1): params.local_size_y,
            ("num_groups", 0): params.grid, ("num_groups", 1): params.grid_y,
            ("global_size", 0): params.grid * params.local_size,
            ("global_size", 1): params.grid_y * params.local_size_y,
            ("num_threads", 0): params.warp_size,
            ("num_warps", 0): params.warps_per_wg,
            ("warp_id", 0): (ly * params.local_size + lx) // params.warp_size,
            ("core_id", 0): gx % 4,
            ("grid_dim", 0): params.grid,
        }

        import math
        block = fn.entry
        idx = 0
        fuel = params.fuel
        while True:
            fuel -= 1
            if fuel <= 0:
                raise ExecError("reference out of fuel")
            i = block.instrs[idx]
            op = i.op
            if op is Op.BR:
                block, idx = i.operands[0], 0
                continue
            if op is Op.CBR:
                block = i.operands[1] if val(i.operands[0]) else i.operands[2]
                idx = 0
                continue
            if op is Op.RET:
                return val(i.operands[0]) if i.operands else None
            if op is Op.BARRIER:
                yield "barrier"
                idx += 1
                continue
            if op is Op.SLOT_LOAD:
                env[id(i.result)] = slots.get(id(i.operands[0]), 0)
                idx += 1
                continue
            if op is Op.SLOT_STORE:
                slots[id(i.operands[0])] = val(i.operands[1])
                idx += 1
                continue
            if op is Op.LOAD:
                buf, _ = mem.resolve(i.operands[0], argmap)
                a = int(val(i.operands[1]))
                if a < 0 or a >= len(buf):
                    raise ExecError(f"OOB reference load idx={a}")
                env[id(i.result)] = buf[a].item()
                idx += 1
                continue
            if op is Op.STORE:
                buf, _ = mem.resolve(i.operands[0], argmap)
                a = int(val(i.operands[1]))
                if a < 0 or a >= len(buf):
                    raise ExecError(f"OOB reference store idx={a}")
                buf[a] = val(i.operands[2])
                idx += 1
                continue
            if op is Op.ATOMIC:
                kind = i.operands[0]
                buf, _ = mem.resolve(i.operands[1], argmap)
                a = int(val(i.operands[2]))
                v = val(i.operands[3])
                old = buf[a].item()
                if kind == "add": buf[a] += v
                elif kind == "max": buf[a] = max(old, v)
                elif kind == "min": buf[a] = min(old, v)
                elif kind == "xchg": buf[a] = v
                env[id(i.result)] = old
                idx += 1
                continue
            if op is Op.INTR:
                env[id(i.result)] = intr[(i.operands[0], i.operands[1])]
                idx += 1
                continue
            if op in (Op.VOTE, Op.SHFL):
                raise ExecError("warp-collective ops have no scalar "
                                "reference semantics")
            if op is Op.PRINT:
                idx += 1
                continue
            if op is Op.CALL:
                callee: Function = i.operands[0]
                sub_args: Dict[int, Any] = {}
                for p, a in zip(callee.params, i.operands[1:]):
                    if p.ty is Ty.PTR and isinstance(a, (Param, GlobalVar)):
                        arr, _ = mem.resolve(a, argmap)
                        sub_args[id(p)] = arr
                    else:
                        sub_args[id(p)] = val(a)
                # scalar call: inline-interpret with a fresh env
                r = yield from _ref_call(callee, sub_args, mem, intr, params)
                if i.result is not None:
                    env[id(i.result)] = r
                idx += 1
                continue
            if op in (Op.SELECT, Op.CMOV):
                env[id(i.result)] = (val(i.operands[1]) if val(i.operands[0])
                                     else val(i.operands[2]))
                idx += 1
                continue
            from .vir import BINOPS, UNOPS
            if op in BINOPS:
                a, b2 = val(i.operands[0]), val(i.operands[1])
                arr = _np_binop(op, np.asarray(a), np.asarray(b2))
                env[id(i.result)] = arr.item() if arr.ndim == 0 else arr
                idx += 1
                continue
            if op in UNOPS:
                arr = _np_unop(op, np.asarray(val(i.operands[0])))
                env[id(i.result)] = arr.item() if arr.ndim == 0 else arr
                idx += 1
                continue
            raise ExecError(f"unhandled reference op {op}")

    def _ref_call(callee, sub_args, mem_, intr_, params_):
        # reference scalar call helper (shares thread context)
        saved = dict(_REF_TLS)
        _REF_TLS.update({})
        gen = _ref_exec(callee, sub_args, mem_, intr_, params_)
        r = yield from gen
        _REF_TLS.clear()
        _REF_TLS.update(saved)
        return r

    _REF_TLS: Dict = {}

    def _ref_exec(callee, sub_args, mem_, intr_, params_):
        # A reduced scalar interpreter for device functions (no barriers).
        env: Dict[int, Any] = {}
        slots: Dict[int, Any] = {}

        def val(v: Value) -> Any:
            if isinstance(v, Const):
                return v.value
            if isinstance(v, Reg):
                return env[id(v)]
            if isinstance(v, Param):
                return sub_args[id(v)]
            raise ExecError(f"cannot evaluate {v!r}")

        block = callee.entry
        idx = 0
        fuel = params_.fuel
        while True:
            fuel -= 1
            if fuel <= 0:
                raise ExecError("reference out of fuel")
            i = block.instrs[idx]
            op = i.op
            if op is Op.BR:
                block, idx = i.operands[0], 0
                continue
            if op is Op.CBR:
                block = i.operands[1] if val(i.operands[0]) else i.operands[2]
                idx = 0
                continue
            if op is Op.RET:
                return val(i.operands[0]) if i.operands else None
            if op is Op.SLOT_LOAD:
                env[id(i.result)] = slots.get(id(i.operands[0]), 0)
                idx += 1
                continue
            if op is Op.SLOT_STORE:
                slots[id(i.operands[0])] = val(i.operands[1])
                idx += 1
                continue
            if op is Op.LOAD:
                buf = sub_args.get(id(i.operands[0]))
                if buf is None:
                    buf, _ = mem_.resolve(i.operands[0], sub_args)
                a = int(val(i.operands[1]))
                env[id(i.result)] = buf[a].item()
                idx += 1
                continue
            if op is Op.STORE:
                buf = sub_args.get(id(i.operands[0]))
                if buf is None:
                    buf, _ = mem_.resolve(i.operands[0], sub_args)
                buf[int(val(i.operands[1]))] = val(i.operands[2])
                idx += 1
                continue
            if op is Op.INTR:
                env[id(i.result)] = intr_[(i.operands[0], i.operands[1])]
                idx += 1
                continue
            if op in (Op.SELECT, Op.CMOV):
                env[id(i.result)] = (val(i.operands[1]) if val(i.operands[0])
                                     else val(i.operands[2]))
                idx += 1
                continue
            if op is Op.CALL:
                callee2: Function = i.operands[0]
                sa: Dict[int, Any] = {}
                for p, a in zip(callee2.params, i.operands[1:]):
                    sa[id(p)] = val(a)
                r = yield from _ref_exec(callee2, sa, mem_, intr_, params_)
                if i.result is not None:
                    env[id(i.result)] = r
                idx += 1
                continue
            from .vir import BINOPS, UNOPS
            if op in BINOPS:
                arr = _np_binop(op, np.asarray(val(i.operands[0])),
                                np.asarray(val(i.operands[1])))
                env[id(i.result)] = arr.item() if arr.ndim == 0 else arr
                idx += 1
                continue
            if op in UNOPS:
                arr = _np_unop(op, np.asarray(val(i.operands[0])))
                env[id(i.result)] = arr.item() if arr.ndim == 0 else arr
                idx += 1
                continue
            raise ExecError(f"unhandled reference op {op}")

    n_wg = params.grid * params.grid_y
    for wg_lin in range(n_wg):
        gx = wg_lin % params.grid
        gy = wg_lin // params.grid
        mem.reset_shared()
        gens = []
        for t in range(params.wg_threads):
            lx = t % params.local_size
            ly = t // params.local_size
            gens.append(thread_gen(gx, gy, lx, ly))
        alive = list(range(len(gens)))
        while alive:
            at_barrier: List[int] = []
            for ti in alive:
                try:
                    ev = next(gens[ti])
                    at_barrier.append(ti)
                except StopIteration:
                    pass
                except ExecError as e:
                    raise _add_ctx(e, kernel=fn.name,
                                   workgroup=(gx, gy),
                                   warp=ti // params.warp_size)
            alive = at_barrier
