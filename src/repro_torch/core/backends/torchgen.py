"""Torch codegen executor — the top rung of the port's launch chain.

The port's counterpart of the reference's JAX rung
(``repro.core.backends.jaxgen``).  The decoder already proves, per
kernel, everything a code generator needs: order-freedom (no
cross-workgroup read/write hazard), store privacy (every store index
injective across the launch), structured control flow (post-``structurize``
every loop is a ``vx_pred``/uniform header loop and every divergent
branch a ``vx_split``/``vx_join`` diamond).  This module consumes those
licences and runs the kernel as torch operations over ``(rows, W)``
tensors on one device — rows are warps, ``n_warps`` consecutive rows per
workgroup, exactly the grid executor's row layout — instead of walking
one Python handler per decoded node and warp:

  * masks become ``torch.where`` / masked scatters into a padded buffer
    whose last cell takes the inactive lanes' writes;
  * ``vx_split`` diamonds run both sides sequentially under sub-masks
    (the oracle's own execution order for a warp that takes both);
  * ``vx_pred`` and uniform header loops become a Python loop that asks
    the device once an iteration whether any row is still live (one
    host sync an iteration, counted in ``TORCH_TELEMETRY["host_syncs"]``);
  * lockstep barriers are no-ops (the rung only licenses barriers at
    ``n_warps == 1``, where a row IS the whole workgroup);
  * loads/stores lower to gathers/scatters; store injectivity comes
    from ``passes.analysis.export_codegen_facts`` (the same
    ``affine_mem_facts`` privacy classes that license run-ahead).

``ExecStats`` are not sampled — they are *computed on the device*, to
the oracle's exact counting rules (per-op counts under ``mask.any()``,
distinct-cache-line requests per access, IPDOM depth at two-sided
splits), so certification can demand bit-identical stats, not just
bit-identical buffers.

Arithmetic follows the oracle's numpy tables bit for bit (``_tg_binop``,
``_tg_unop``): floor integer division and modulo with a zero divisor
giving 0, shifts by 32 or more (or a negative count) as numpy gives them,
``POPC``/``FFS`` in int64 bit arithmetic, ``FTOI`` of NaN or an
out-of-range value giving INT32_MIN.  Eager torch runs one kernel per
operation and never contracts a multiply and an add into an FMA, so the
reference's two tiers (an optimized one and an FMA-free one) are one
here: a verdict is "pass" or "fail".

Certification gate (the promotion state machine, docs/performance.md
"Execute side 5"): a (kernel ir_version, launch shape class, device)
pair starts UNKNOWN.  The first licensed launch runs BOTH the torch
program and the normal executor chain, compares buffers byte-for-byte
and stats field-for-field, and records "pass"/"fail" — in memory and,
when the runtime installed ``interp.TORCH_CERT_HOOKS``, in a ``.vtc``
file next to the ``.vck``/``.vdp`` caches.  Only a recorded "pass" lets
later launches run the rung as the primary; any recorded "fail" pins
the pair to the normal chain (until the kernel IR changes).

Failure model: the program never raises mid-chunk.  Semantic errors the
oracle would raise (OOB store, uniformity violation, fuel exhaustion)
set bits in an ``err`` scalar on the device; any nonzero bit after the
chunk loop raises ``EngineFault(site="torch.exec")`` with the buffers
untouched (results are staged on the device and only copied back on
full success), so the runtime chain demotes to the grid rung, which
reproduces the exact ``ExecError`` with full context.
``DeadlineExceeded`` and injected faults at ``torch.trace`` /
``torch.exec`` / ``torch.cache.load`` follow the reference's contracts.
"""
from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from ..vir import (AddrSpace, BINOPS, Const, Function, GlobalVar, Instr,
                   Op, Param, Reg, Ty, UNOPS, Value)
from .. import graph
from .. import faults as _faults
from .. import governor as _gov
from .. import interp as _interp
from ..interp_mem import CACHE_LINE_ELEMS
from ..passes.analysis import export_codegen_facts

_TY_DTYPE = {Ty.I32: torch.int32, Ty.F32: torch.float32, Ty.BOOL: torch.bool}
_TY_NP = {Ty.I32: np.int32, Ty.F32: np.float32, Ty.BOOL: np.bool_}

#: workgroups per chunk on the host (module attribute so a test can vary
#: it; the shape signature includes the chunk width)
_CHUNK_WGS = 256
#: workgroups per chunk on the card: 2^17 single-warp workgroups are 4 Mi
#: lanes, 16 MiB a (rows, W) int32 tensor
_CHUNK_WGS_CUDA = 1 << 17

#: sorts-after-everything sentinel for masked-out line keys (valid line
#: keys are element_index // CACHE_LINE_ELEMS <= 2**27)
_SENT = 2**31 - 1
_I32_MIN = -2**31

#: error bits accumulated in the device-side err scalar — any nonzero bit
#: demotes; the grid rung then reproduces the oracle's exact exception
ERR_OOB_STORE = 1
ERR_UNIFORM = 2
ERR_FUEL = 4

#: host-libm vs device transcendentals differ in ulps — certification
#: would catch the mismatch anyway, but refusing up front keeps the
#: cert cache free of foreseeable "fail" entries
_REFUSED_OPS = {Op.EXP, Op.LOG, Op.SIN, Op.COS, Op.POW}

TORCH_TELEMETRY = {
    "engaged": 0,        # launches served by the torch program
    "certified": 0,      # (kernel, shape) pairs newly certified "pass"
    "cert_runs": 0,      # differential certification launches
    "refusals": 0,       # licence/trace refusals (silent fallthrough)
    "demotions": 0,      # certified launches that faulted -> grid
    "trace_cache_hits": 0,
    "routed_small": 0,   # certified but sent to the grid rung: the
                         # measured grid time beats the torch rung's at
                         # this launch-shape class
    "host_syncs": 0,     # loop iterations that asked the device
}

#: route a certified launch to the grid rung when the measured grid
#: time is below this fraction of the measured torch time — the margin
#: keeps borderline shape classes on the certified primary (timing
#: noise must not flap the route)
_ROUTE_MARGIN = 0.9


def reset_torch_telemetry() -> None:
    for k in TORCH_TELEMETRY:
        TORCH_TELEMETRY[k] = 0


class LowerError(Exception):
    """Kernel/launch outside this rung's licence — silent fallthrough
    (NOT a demotion: nothing was attempted, nothing can have failed)."""


# --------------------------------------------------------------------------
# transitive static scan (memoized per ir_version)
# --------------------------------------------------------------------------

def _scan_fn(fn: Function) -> dict:
    cached = getattr(fn, "_torchgen_scan", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    out = {"refused": set(), "barrier": False, "shared": False,
           "global": False, "recursive": False}

    def visit(f: Function, stack: tuple) -> None:
        if f in stack:
            out["recursive"] = True
            return
        for i in f.instructions():
            op = i.op
            if op in _REFUSED_OPS or op in (Op.ATOMIC, Op.PRINT):
                out["refused"].add(op)
            if op is Op.BARRIER:
                out["barrier"] = True
            for o in i.operands:
                if isinstance(o, GlobalVar):
                    if o.space is AddrSpace.SHARED:
                        out["shared"] = True
                    else:
                        out["global"] = True
            if op is Op.CALL:
                visit(i.operands[0], stack + (f,))

    visit(fn, ())
    fn._torchgen_scan = (fn.ir_version, out)  # type: ignore[attr-defined]
    return out


def _static(fn: Function) -> tuple:
    """(instr -> (block, index), natural loops by header id, postdominator
    tree), memoized per ir_version: every chunk re-walks the function."""
    cached = getattr(fn, "_torchgen_static", None)
    if cached is not None and cached[0] == fn.ir_version:
        return cached[1]
    iidx = {id(i): (bi, ii) for bi, b in enumerate(fn.blocks)
            for ii, i in enumerate(b.instrs)}
    headers = {id(lp.header): lp for lp in graph.natural_loops(fn)}
    out = (iidx, headers, graph.postdominators(fn))
    fn._torchgen_static = (fn.ir_version, out)  # type: ignore[attr-defined]
    return out


# --------------------------------------------------------------------------
# device-side counters: stats and error bits as device scalars
# --------------------------------------------------------------------------

class _Ctx:
    """Counter state of one launch: per-op counts, memory requests, IPDOM
    depth, fuel and error bits, all int64 tensors on the device.

    Charges are kept on the host as per-mask multiplicities and folded
    into the device counters at ``flush`` (each loop iteration and the
    end of each chunk): one reduction per distinct mask instead of one
    per charged instruction."""

    __slots__ = ("kidx", "dev", "cnt", "mem", "shm", "minst", "maxd",
                 "fuel", "err", "fuel_limit", "_live", "_pend")

    def __init__(self, cnt_keys: tuple, fuel_limit: int,
                 dev: torch.device) -> None:
        self.kidx = {k: j for j, k in enumerate(cnt_keys)}
        self.dev = dev
        z = torch.zeros(7, dtype=torch.int64, device=dev)
        self.cnt = torch.zeros(len(cnt_keys), dtype=torch.int64,
                               device=dev)
        (self.mem, self.shm, self.minst, self.maxd, self.fuel,
         self.err, _) = z.unbind()
        self.fuel_limit = int(fuel_limit)
        self._live: dict = {}    # id(mask) -> (mask, active-row count)
        self._pend: dict = {}    # id(mask) -> [mask, per-key multiplicity]

    def live(self, mask):
        """Rows with any active lane — the oracle's per-warp
        ``mask.any()`` stat gate, batched.  Memoized per mask object
        until the next flush (strong refs held so ids cannot recycle)."""
        hit = self._live.get(id(mask))
        if hit is not None and hit[0] is mask:
            return hit[1]
        n = mask.any(dim=1).sum()
        self._live[id(mask)] = (mask, n)
        return n

    def charge(self, opval: str, mask) -> None:
        ent = self._pend.get(id(mask))
        if ent is None or ent[0] is not mask:
            ent = [mask, [0] * len(self.kidx)]
            self._pend[id(mask)] = ent
        ent[1][self.kidx[opval]] += 1

    def flush(self) -> None:
        if self._pend:
            ents = list(self._pend.values())
            lives = torch.stack([self.live(e[0]) for e in ents])
            mult = torch.tensor([e[1] for e in ents], dtype=torch.int64,
                                device=self.dev)
            add = (lives[:, None] * mult).sum(dim=0)
            self.cnt = self.cnt + add
            self.fuel = self.fuel + add.sum()
            self._pend = {}
        self._live = {}

    def set_err(self, cond, bit: int) -> None:
        self.err = self.err | (cond.to(torch.int64) * bit)


class _State:
    """Functional slice of executor state threaded through the walk."""

    __slots__ = ("slots", "bufs", "mask")

    def __init__(self, slots: dict, bufs: dict, mask) -> None:
        self.slots = slots   # id(Slot) -> (R, W)
        self.bufs = bufs     # name -> padded (N + 1,) global | (R, S + 1)
        self.mask = mask     # (R, W) bool

    def copy(self) -> "_State":
        return _State(dict(self.slots), dict(self.bufs), self.mask)


# --------------------------------------------------------------------------
# arithmetic: bit-exact versions of the oracle's numpy op tables
# --------------------------------------------------------------------------

def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) & 1) * 2**32).to(torch.int32)


def _u32(a: torch.Tensor) -> torch.Tensor:
    """numpy's ``astype(np.uint32)`` as int64 in [0, 2^32)."""
    return a.to(torch.int64) & 0xFFFFFFFF


def _popc(a: torch.Tensor) -> torch.Tensor:
    x = _u32(a)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _ffs(a: torch.Tensor) -> torch.Tensor:
    """1-based index of the lowest set bit, 0 for 0."""
    x = _u32(a)
    idx = _popc((x & -x) - 1) + 1
    return torch.where(x == 0, torch.zeros_like(idx), idx)


def _ftoi(a: torch.Tensor) -> torch.Tensor:
    """numpy's float32 -> int32 ``astype`` on x86: truncation toward zero,
    and INT32_MIN for NaN and for values outside the int32 range (the
    card's own conversion saturates and sends NaN to 0)."""
    if not a.is_floating_point():
        return a.to(torch.int32)
    bad = torch.isnan(a) | (a >= 2.0**31) | (a < -2.0**31)
    out = torch.where(bad, torch.zeros_like(a), a).to(torch.int32)
    return torch.where(bad, torch.full_like(out, _I32_MIN), out)


def _np_min(a, b):
    # numpy's float rule: (a < b || isnan(a)) ? a : b — so a NaN on
    # either side wins and min(0.0, -0.0) is the second operand
    if a.is_floating_point() or b.is_floating_point():
        return torch.where((a < b) | torch.isnan(a), a, b)
    return torch.minimum(a, b)


def _np_max(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.where((a > b) | torch.isnan(a), a, b)
    return torch.maximum(a, b)


def _np_fmod(a, b):
    """numpy's float ``%``: fmod, moved to the divisor's sign, and a zero
    result carrying the divisor's sign."""
    m = torch.fmod(a, b)
    adj = (m != 0) & ((b < 0) != (m < 0))
    m = torch.where(adj, m + b, m)
    return torch.where(m == 0, torch.copysign(torch.zeros_like(m), b), m)


def _tg_binop(op: Op, a, b):
    if op is Op.ADD: return a + b
    if op is Op.SUB: return a - b
    if op is Op.MUL: return a * b
    if op is Op.DIV:
        if not (a.is_floating_point() or b.is_floating_point()):
            safe = torch.where(b == 0, torch.ones_like(b), b)
            q = torch.div(a, safe, rounding_mode="floor")
            return torch.where(b != 0, q, torch.zeros_like(q))
        safe = torch.where(b == 0, torch.ones_like(b), b)
        q = a / safe
        return torch.where(b != 0, q, torch.zeros_like(q))
    if op is Op.MOD:
        safe = torch.where(b == 0, torch.ones_like(b), b)
        if a.is_floating_point() or b.is_floating_point():
            r = _np_fmod(a, safe)
        else:
            r = torch.remainder(a, safe)
        return torch.where(b != 0, r, torch.zeros_like(r))
    if op is Op.AND:
        # oracle _and_fn: float32 operands compare as booleans
        if a.dtype == torch.float32:
            return a.to(torch.bool) & b.to(torch.bool)
        return a & b
    if op is Op.OR: return a | b
    if op is Op.XOR: return a ^ b
    if op is Op.SHL:
        # numpy: a count outside [0, 32) shifts every bit out
        big = (b < 0) | (b >= 32)
        return torch.where(big, torch.zeros_like(a),
                           torch.bitwise_left_shift(a, b.clamp(0, 31)))
    if op is Op.SHR:
        # numpy arithmetic shift: a count outside [0, 32) leaves the sign
        big = (b < 0) | (b >= 32)
        fill = torch.where(a < 0, torch.full_like(a, -1),
                           torch.zeros_like(a))
        return torch.where(big, fill,
                           torch.bitwise_right_shift(a, b.clamp(0, 31)))
    if op is Op.MIN: return _np_min(a, b)
    if op is Op.MAX: return _np_max(a, b)
    if op is Op.EQ: return a == b
    if op is Op.NE: return a != b
    if op is Op.LT: return a < b
    if op is Op.LE: return a <= b
    if op is Op.GT: return a > b
    if op is Op.GE: return a >= b
    raise LowerError(f"binop {op} unsupported on the torch rung")


def _tg_unop(op: Op, a):
    if op is Op.NEG: return -a
    if op is Op.NOT: return ~a
    if op is Op.ABS: return torch.abs(a)
    if op is Op.SQRT:
        if a.is_floating_point():
            # np.maximum(a, 0): -0.0 becomes 0.0, NaN stays
            nz = torch.where((a > 0) | torch.isnan(a), a,
                             torch.zeros_like(a))
            return torch.sqrt(nz).to(torch.float32)
        # numpy takes an integer's root in float64
        nz = torch.where(a >= 0, a, torch.zeros_like(a))
        return torch.sqrt(nz.to(torch.float64)).to(torch.float32)
    if op is Op.ITOF: return a.to(torch.float32)
    if op is Op.FTOI: return _ftoi(a)
    if op is Op.POPC: return _popc(a)
    if op is Op.FFS: return _ffs(a)
    raise LowerError(f"unop {op} unsupported on the torch rung")


def count_lines(clip, mask, W: int):
    """Oracle line counting, batched: distinct cache lines among ACTIVE
    lanes, summed over rows (``interp_mem.count_gathered`` per warp).
    ``clip`` is an (R, W) int32 index tensor (in bounds), ``mask`` the
    matching activation mask."""
    key = torch.where(mask, torch.div(clip, CACHE_LINE_ELEMS,
                                      rounding_mode="floor"),
                      torch.full_like(clip, _SENT))
    skey = torch.sort(key, dim=1).values
    distinct = (skey[:, 0] != _SENT).to(torch.int64)
    if W > 1:
        neq = skey[:, 1:] != skey[:, :-1]
        distinct = distinct + (neq & (skey[:, 1:] != _SENT)).sum(dim=1)
    return distinct.sum()


# --------------------------------------------------------------------------
# the (rows, W) walker
# --------------------------------------------------------------------------

class _Walker:
    """Runs one function over (R, W) activations with oracle-exact stat
    counting.  ``walk`` mirrors ``interp._exec_warp``'s control loop;
    all R rows take all paths under row sub-masks, which the order-free
    / store-private licences make equivalent to the oracle's per-warp
    sequential order.

    ``trace=True`` is the static walk of the licence check: every path
    is lowered once (each loop body exactly once, whatever its mask),
    so every ``LowerError`` surfaces before anything runs."""

    def __init__(self, fn: Function, R: int, W: int, intr: dict,
                 argmap: dict, tc: _Ctx, tiles: dict, sizes: dict,
                 shape_1d: bool, facts: dict | None, consts: dict,
                 trace: bool) -> None:
        self.fn = fn
        self.R = R
        self.W = W
        self.intr = intr       # (name, dim) -> (R, W) int32
        self.argmap = argmap   # id(Param) -> buffer name | (R, W) value
        self.tc = tc
        self.tiles = tiles     # buffer names that are (R, S + 1) tiles
        self.sizes = sizes     # buffer name -> logical length
        self.shape_1d = shape_1d
        self.facts = facts     # export_codegen_facts or None (callees)
        self.consts = consts   # (value, dtype) -> expanded (R, W) view
        self.trace = trace
        self.dev = tc.dev
        self.iidx, self.headers, self.pdom = _static(fn)
        self.env: dict = {}
        self.tokens: dict = {}          # id(token Reg) -> (R, W) mask
        self.depth = 0                  # static enclosing-split count
        self.pending = None             # SPLIT awaiting its CBR
        self.ret_val = None

    def full(self, value, dtype):
        key = (value, dtype)
        a = self.consts.get(key)
        if a is None:
            a = torch.full((), value, dtype=dtype,
                           device=self.dev).expand(self.R, self.W)
            self.consts[key] = a
        return a

    # -- values ------------------------------------------------------------
    def val(self, v: Value):
        if isinstance(v, Const):
            return self.full(v.value, _TY_DTYPE.get(v.ty, torch.float32))
        if isinstance(v, Reg):
            a = self.env.get(id(v))
            if a is None:
                raise LowerError(f"undefined reg %{v.name}")
            return a
        if isinstance(v, Param):
            a = self.argmap.get(id(v))
            if a is None:
                raise LowerError(f"unbound param {v.name}")
            if isinstance(a, str):
                raise LowerError(f"pointer param {v.name} used as value")
            return a
        raise LowerError(f"cannot lower value {v!r}")

    def buf_name(self, ptr: Value) -> str:
        if isinstance(ptr, Param):
            a = self.argmap.get(id(ptr))
            if isinstance(a, str):
                return a
            raise LowerError(f"pointer param {ptr.name} not bound")
        if isinstance(ptr, GlobalVar):
            if ptr.space is AddrSpace.SHARED:
                return f"@{ptr.name}"
            raise LowerError(f"non-shared global @{ptr.name}")
        raise LowerError(f"bad pointer {ptr!r}")

    # -- walk --------------------------------------------------------------
    def walk(self, block, pos: int, st: _State, stop_block):
        """Returns ("ret", None, st) | ("join", (block, pos), st) |
        ("stop", (block, 0), st)."""
        tc = self.tc
        while True:
            if stop_block is not None and block is stop_block and pos == 0:
                return ("stop", (block, 0), st)
            i = block.instrs[pos]
            op = i.op
            if op is Op.BR:
                tc.charge(op.value, st.mask)
                self.pending = None
                block, pos = i.operands[0], 0
                continue
            if op is Op.RET:
                tc.charge(op.value, st.mask)
                if i.operands:
                    self.ret_val = self.val(i.operands[0])
                return ("ret", None, st)
            if op is Op.JOIN:
                # charged by the enclosing _lower_split under the
                # side-exit mask
                return ("join", (block, pos), st)
            if op is Op.SPLIT:
                tc.charge(op.value, st.mask)
                self.pending = i
                pos += 1
                continue
            if op is Op.PRED:
                st, block = self._lower_pred_loop(block, i, st)
                pos = 0
                continue
            if op is Op.CBR:
                if self.pending is not None:
                    st, block, pos = self._lower_split(i, st)
                    continue
                loop = self.headers.get(id(block))
                if loop is not None and any(
                        not loop.contains(s) for s in block.successors()):
                    st, block = self._lower_uniform_loop(block, i, st,
                                                         loop)
                else:
                    st, block = self._lower_uniform_branch(block, i, st)
                pos = 0
                continue
            st = self._lower_straight(i, st)
            pos += 1

    # -- straight-line ops -------------------------------------------------
    def _lower_straight(self, i: Instr, st: _State) -> _State:
        op = i.op
        tc = self.tc
        tc.charge(op.value, st.mask)
        if op is Op.TMC_SAVE:
            self.tokens[id(i.result)] = st.mask
            return st
        if op is Op.TMC_RESTORE:
            tok = self.tokens.get(id(i.operands[0]))
            if tok is None:
                raise LowerError("tmc_restore of unsaved token")
            st = st.copy()
            st.mask = tok
            return st
        if op is Op.BARRIER:
            return st      # licensed only at n_warps == 1: trivially met
        if op is Op.SLOT_LOAD:
            s = i.operands[0]
            arr = st.slots.get(id(s))
            if arr is None:
                arr = self.full(0, _TY_DTYPE[s.ty])
            self.env[id(i.result)] = arr
            return st
        if op is Op.SLOT_STORE:
            s, v = i.operands
            nv = self.val(v)
            arr = st.slots.get(id(s))
            if arr is None:
                arr = self.full(0, nv.dtype)
            st = st.copy()
            st.slots[id(s)] = torch.where(st.mask, nv, arr)
            return st
        if op is Op.LOAD:
            return self._lower_load(i, st)
        if op is Op.STORE:
            return self._lower_store(i, st)
        if op is Op.INTR:
            key = (i.operands[0], i.operands[1])
            a = self.intr.get(key)
            if a is None:
                raise LowerError(f"intrinsic {key} not provided")
            self.env[id(i.result)] = a
            return st
        if op is Op.VOTE:
            return self._lower_vote(i, st)
        if op is Op.SHFL:
            v = self.val(i.operands[0])
            src = torch.remainder(self.val(i.operands[1]).to(torch.int32),
                                  self.W)
            self.env[id(i.result)] = torch.gather(v, 1, src.long())
            return st
        if op is Op.CALL:
            return self._lower_call(i, st)
        if op in (Op.CMOV, Op.SELECT):
            c = self.val(i.operands[0]).to(torch.bool)
            self.env[id(i.result)] = torch.where(
                c, self.val(i.operands[1]), self.val(i.operands[2]))
            return st
        if op in _REFUSED_OPS:
            raise LowerError(f"op {op} refused on the torch rung")
        if op in BINOPS:
            self.env[id(i.result)] = _tg_binop(
                op, self.val(i.operands[0]), self.val(i.operands[1]))
            return st
        if op in UNOPS:
            self.env[id(i.result)] = _tg_unop(op, self.val(i.operands[0]))
            return st
        raise LowerError(f"op {op} unsupported on the torch rung")

    # -- memory ------------------------------------------------------------
    def _buffer(self, nm: str, st: _State):
        buf = st.bufs.get(nm)
        if buf is None:
            raise LowerError(f"no buffer {nm}")
        return buf, self.sizes[nm]

    def _lower_load(self, i: Instr, st: _State) -> _State:
        nm = self.buf_name(i.operands[0])
        buf, n = self._buffer(nm, st)
        ix = self.val(i.operands[1]).to(torch.int32)
        clip = ix.clamp(0, n - 1)
        tc = self.tc
        lines = count_lines(clip, st.mask, self.W)
        if nm in self.tiles:
            tc.shm = tc.shm + lines
            v = torch.gather(buf, 1, clip.long())
        else:
            tc.mem = tc.mem + lines
            v = buf[clip]
        tc.minst = tc.minst + tc.live(st.mask)
        self.env[id(i.result)] = v
        return st

    def _lower_store(self, i: Instr, st: _State) -> _State:
        nm = self.buf_name(i.operands[0])
        buf, n = self._buffer(nm, st)
        ix = self.val(i.operands[1]).to(torch.int32)
        v = self.val(i.operands[2])
        m = st.mask
        tc = self.tc
        oob = (ix < 0) | (ix >= n)
        tc.set_err((m & oob).any(), ERR_OOB_STORE)
        clip = ix.clamp(0, n - 1)
        lines = count_lines(clip, m, self.W)
        tile = nm in self.tiles
        if tile:
            tc.shm = tc.shm + lines
        else:
            tc.mem = tc.mem + lines
        tc.minst = tc.minst + tc.live(m)
        wm = m & ~oob
        vv = v.to(buf.dtype).expand(self.R, self.W)
        if tile:
            # enforce numpy's last-active-lane-wins within each row; the
            # inactive lanes write the pad column n
            eq = clip[:, :, None] == clip[:, None, :]
            dup = (wm[:, None, :] & eq & _later(self.W, self.dev)).any(
                dim=2)
            wm = wm & ~dup
            safe = torch.where(wm, clip, torch.full_like(clip, n))
            rows = torch.arange(self.R, device=self.dev)[:, None].expand(
                self.R, self.W)
            buf.index_put_((rows, safe.long()), vv)
        else:
            # global stores need NO dedup: the launch runs this rung
            # only under the store-privacy licence, and this per-site
            # check confirms THIS store's index chain is injective
            # across the whole launch (no within-row or cross-row
            # collisions exist to order)
            if self.facts is None:
                raise LowerError("store inside a callee")
            priv = self.facts["store_private"].get(self.iidx[id(i)])
            if not (priv == "2d" or (priv == "1d" and self.shape_1d)):
                raise LowerError("store not proven injective at this "
                                 "launch shape")
            safe = torch.where(wm, clip, torch.full_like(clip, n))
            buf.index_put_((safe.reshape(-1),), vv.reshape(-1))
        # the buffer is updated in place: one version of it is live at
        # any point of the walk, which runs every path in program order
        return st

    # -- collectives -------------------------------------------------------
    def _lower_vote(self, i: Instr, st: _State) -> _State:
        mode = i.operands[0]
        v = self.val(i.operands[1]).to(torch.bool)
        m = st.mask
        act = v & m
        R, W = self.R, self.W
        if mode == "any":
            r = act.any(dim=1, keepdim=True).expand(R, W)
        elif mode == "all":
            # oracle: all(v | ~mask) over active lanes; True when empty
            r = (v | ~m).all(dim=1, keepdim=True).expand(R, W)
        elif mode == "ballot":
            if W > 32:
                raise LowerError("ballot with W > 32")
            lanes = torch.arange(W, dtype=torch.int64, device=self.dev)
            bits = (act.to(torch.int64) << lanes[None, :]).sum(dim=1)
            r = _wrap_i32(bits)[:, None].expand(R, W)
        else:
            raise LowerError(f"unknown vote mode {mode}")
        self.env[id(i.result)] = r
        return st

    def _lower_call(self, i: Instr, st: _State) -> _State:
        callee: Function = i.operands[0]
        cargs: dict = {}
        for p, a in zip(callee.params, i.operands[1:]):
            if p.ty is Ty.PTR:
                if not isinstance(a, (Param, GlobalVar)):
                    raise LowerError("pointer arg must be param/global")
                cargs[id(p)] = self.buf_name(a)
            else:
                cargs[id(p)] = self.val(a)
        sub = _Walker(callee, self.R, self.W, self.intr, cargs, self.tc,
                      self.tiles, self.sizes, self.shape_1d, facts=None,
                      consts=self.consts, trace=self.trace)
        sst = _State({}, st.bufs, st.mask)
        kind, _, out = sub.walk(callee.entry, 0, sst, None)
        if kind != "ret":
            raise LowerError(f"callee @{callee.name} did not return")
        st = st.copy()
        st.bufs = out.bufs
        if i.result is not None:
            rv = sub.ret_val
            if rv is None:
                rv = self.full(0, _TY_DTYPE.get(callee.ret_ty,
                                                torch.float32))
            # oracle short-circuits empty-mask warps to typed zeros
            live = st.mask.any(dim=1, keepdim=True)
            self.env[id(i.result)] = torch.where(live, rv,
                                                 torch.zeros_like(rv))
        return st

    # -- split diamonds ----------------------------------------------------
    def _lower_split(self, cbr: Instr, st: _State):
        """Handle the CBR that consumes ``self.pending``.  Both sides run
        sequentially under sub-masks (the oracle's own order); resumes
        after the else side's JOIN under the entry mask."""
        tc = self.tc
        split = self.pending
        self.pending = None
        tc.charge(cbr.op.value, st.mask)
        sp = self.val(split.operands[0]).to(torch.bool)
        if split.attrs.get("negate", False):
            sp = ~sp
        m = st.mask
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]
        tok = split.result
        # oracle: max_ipdom_depth updates only at TWO-SIDED pushes, at
        # len(stack) == the static split-nesting depth (every split
        # pushes exactly one entry)
        d = self.depth + 1
        two = ((m & sp).any(dim=1) & (m & ~sp).any(dim=1)).any()
        tc.maxd = torch.maximum(tc.maxd, two.to(torch.int64) * d)
        self.depth = d
        st1 = st.copy()
        st1.mask = m & sp
        kind, where1, st1 = self.walk(then_bb, 0, st1, None)
        self._expect_join(kind, where1, tok)
        tc.charge(Op.JOIN.value, st1.mask)
        st2 = st1.copy()
        st2.mask = m & ~sp
        kind, where2, st2 = self.walk(else_bb, 0, st2, None)
        self._expect_join(kind, where2, tok)
        tc.charge(Op.JOIN.value, st2.mask)
        self.depth = d - 1
        out = st2.copy()
        out.mask = m
        # resume past the else side's JOIN: the next instr is the BR to
        # the ipdom block, charged by the walk under the restored mask
        jb, jp = where2
        return out, jb, jp + 1

    def _expect_join(self, kind, where, tok) -> None:
        if kind != "join":
            raise LowerError("split side did not reach a join")
        jb, jp = where
        if jb.instrs[jp].operands[0] is not tok:
            raise LowerError("vx_join token mismatch in trace")

    # -- uniform branches --------------------------------------------------
    def _uniform_err(self, m, c) -> None:
        viol = ((m & c).any(dim=1) & (m & ~c).any(dim=1)).any()
        self.tc.set_err(viol, ERR_UNIFORM)

    def _lower_uniform_branch(self, block, cbr: Instr, st: _State):
        tc = self.tc
        tc.charge(cbr.op.value, st.mask)
        merge = self.pdom.immediate(block)
        if merge is None:
            raise LowerError("uniform branch without a post-dominator")
        c = self.val(cbr.operands[0]).to(torch.bool)
        m = st.mask
        # rows where active lanes disagree would raise
        # UniformityViolation in the oracle
        self._uniform_err(m, c)
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]
        st1 = st.copy()
        st1.mask = m & c
        kind, _, st1 = self.walk(then_bb, 0, st1, merge)
        if kind != "stop":
            raise LowerError("then side escaped its merge block")
        st2 = st1.copy()
        # oracle sends empty-mask warps down the THEN side; both sides
        # count zero under an empty row, so routing them to the else
        # side here changes nothing
        st2.mask = m & ~c
        kind, _, st2 = self.walk(else_bb, 0, st2, merge)
        if kind != "stop":
            raise LowerError("else side escaped its merge block")
        out = st2.copy()
        out.mask = m
        return out, merge

    # -- loops -------------------------------------------------------------
    def _loop_carried(self, loop):
        """What survives the loop besides slots and buffers:
        header-defined regs (the only regs that may dominate the exit)
        and tokens saved in the loop.  Refuses a storing callee in the
        loop, as the reference's carry analysis does."""
        tok_ids: list = []
        for b in self.fn.blocks:
            if not loop.contains(b):
                continue
            for i in b.instrs:
                if i.op is Op.STORE:
                    self.buf_name(i.operands[0])
                elif i.op is Op.TMC_SAVE:
                    tok_ids.append(id(i.result))
                elif i.op is Op.CALL:
                    # callees are store-free under the licence; their
                    # slots/tokens are call-local
                    if _interp._contains_store(i.operands[0]):
                        raise LowerError("storing callee in loop")
        hdr_regs = [i.result for i in loop.header.instrs[:-1]
                    if i.result is not None]
        return hdr_regs, tok_ids

    def _lower_pred_loop(self, block, pred: Instr, st: _State):
        loop = self.headers.get(id(block))
        if loop is None:
            raise LowerError("vx_pred outside a natural-loop header")
        tok = pred.operands[1]
        exit_mask = self.tokens.get(id(tok))
        if exit_mask is None:
            raise LowerError("vx_pred token not saved")
        inside, outside = pred.operands[2], pred.operands[3]
        neg = bool(pred.attrs.get("negate", False))
        final = self._lower_loop(block, pred, st, loop, inside,
                                 pred_mode=True, negate=neg)
        final.mask = exit_mask
        return final, outside

    def _lower_uniform_loop(self, block, cbr: Instr, st: _State, loop):
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]
        if loop.contains(then_bb):
            inside, outside, neg = then_bb, else_bb, False
        else:
            inside, outside, neg = else_bb, then_bb, True
        final = self._lower_loop(block, cbr, st, loop, inside,
                                 pred_mode=False, negate=neg)
        # every row leaves a uniform loop with its entry mask intact
        final.mask = st.mask
        return final, outside

    def _lower_loop(self, header, term: Instr, st: _State, loop,
                    inside, pred_mode: bool, negate: bool) -> _State:
        """Shared per-row loop lowering.  Called AT the header
        terminator of the already-walked entry visit (visit #0: the
        header prefix was charged by the normal walk).  Charges the
        terminator, narrows each row's mask by its continue-condition,
        then runs [body walk + next counted header visit + narrow] while
        any row stays live and fuel remains — one host sync an
        iteration.  Count-exact per row: the visit where a row exits was
        charged under its then-live mask, and an exited row's mask is
        empty ever after."""
        tc = self.tc

        def cond_val(s):
            c = self.val(term.operands[0]).to(torch.bool)
            if negate:
                c = ~c
            if not pred_mode:
                self._uniform_err(s.mask, c)
            return c

        tc.charge(term.op.value, st.mask)
        c0 = cond_val(st)
        s = st.copy()
        s.mask = st.mask & c0

        hdr_regs, tok_ids = self._loop_carried(loop)
        snap_env = dict(self.env)
        snap_tokens = dict(self.tokens)
        first = True
        while True:
            if self.trace:
                if not first:
                    break
            else:
                tc.flush()
                TORCH_TELEMETRY["host_syncs"] += 1
                go = s.mask.any() & (tc.fuel < tc.fuel_limit)
                if not bool(go):
                    break
            first = False
            kind, _, s = self.walk(inside, 0, s, header)
            if kind != "stop":
                raise LowerError("loop body escaped its header")
            # the next counted header visit (the back-edge BR was
            # charged by the walk)
            for hi in header.instrs[:-1]:
                if hi.op in (Op.SPLIT, Op.CBR, Op.PRED, Op.BR, Op.RET,
                             Op.JOIN):
                    raise LowerError("control op in loop-header prefix")
                s = self._lower_straight(hi, s)
            tc.charge(term.op.value, s.mask)
            c = cond_val(s)
            s = s.copy()
            s.mask = s.mask & c
        # after the loop only the header's regs and the loop's tokens
        # (zero masks where the body never ran) are visible, as in the
        # reference's loop carry
        env = dict(snap_env)
        for r in hdr_regs:
            env[id(r)] = self.env[id(r)]
        tokens = dict(snap_tokens)
        for t in tok_ids:
            tokens[t] = self.tokens.get(t, torch.zeros_like(st.mask))
        self.env, self.tokens = env, tokens
        return s


_LATER: dict = {}


def _later(W: int, dev: torch.device):
    """(1, W, W) bool: lane j comes after lane i."""
    key = (W, str(dev))
    a = _LATER.get(key)
    if a is None:
        a = torch.ones(W, W, dtype=torch.bool, device=dev).triu(1)[None]
        _LATER[key] = a
    return a


# --------------------------------------------------------------------------
# licence and launch preparation
# --------------------------------------------------------------------------

def _licence(fn: Function, params, n_wg: int, argmap: dict,
             globals_mem) -> None:
    """Static gates — raises LowerError on any licence miss (the
    reference rung's gates, unchanged)."""
    if params.warp_size > 32:
        raise LowerError("warp size > 32")
    if params.strict_oob_loads:
        raise LowerError("strict OOB loads")
    if n_wg <= 1:
        raise LowerError("single-workgroup launch")
    plan = _interp._decode_plan(fn)
    if plan["ordering_sensitive"]:
        raise LowerError("ordering-sensitive kernel")
    if plan["callee_stores"]:
        raise LowerError("callee stores")
    n_warps = params.warps_per_wg
    cw = min(_CHUNK_WGS, n_wg)
    gprog = _interp._decode_batched(fn, params.warp_size, False,
                                    cw * n_warps, grid_mode=True,
                                    wg_rows=n_warps)
    if not gprog.order_free:
        raise LowerError("not order-free")
    shape_1d = params.grid_y == 1 and params.local_size_y == 1
    if not (gprog.private_stores if shape_1d
            else gprog.private_stores_2d):
        raise LowerError("stores not private at this launch shape")
    if not _interp._grid_batchable(fn, argmap, globals_mem):
        raise LowerError("not grid-batchable under these bindings")
    scan = _scan_fn(fn)
    if scan["recursive"]:
        raise LowerError("recursive call")
    if scan["refused"]:
        raise LowerError(
            f"refused ops {sorted(o.value for o in scan['refused'])}")
    if scan["global"]:
        raise LowerError("non-shared module global")
    if n_warps > 1 and (scan["barrier"] or scan["shared"]):
        raise LowerError("barrier/shared tile with multi-warp rows")


def _chunk_wgs(dev: torch.device) -> int:
    return int(_CHUNK_WGS_CUDA if dev.type == "cuda" else _CHUNK_WGS)


def _shape_sig(params, buffers: dict, scalar_args: dict, cw: int,
               dev: torch.device) -> str:
    """The launch SHAPE CLASS a certification verdict covers: every
    static input of the program (grid, warp geometry, fuel, chunk width,
    device type, buffer shapes/dtypes, scalar names) — buffer/scalar
    VALUES excluded."""
    return repr((params.grid, params.grid_y, params.local_size,
                 params.local_size_y, params.warp_size, params.fuel,
                 bool(params.strict_oob_loads), cw, dev.type,
                 tuple(sorted((nm, tuple(b.shape), b.dtype.name)
                              for nm, b in buffers.items())),
                 tuple(sorted(scalar_args))))


def _collect_ops(fn: Function, acc: set, seen: set) -> None:
    if id(fn) in seen:
        return
    seen.add(id(fn))
    for i in fn.instructions():
        acc.add(i.op.value)
        if i.op is Op.CALL:
            _collect_ops(i.operands[0], acc, seen)


class _Prepared:
    """Everything the chunk loop needs for one (kernel, shape class,
    device): the licence passed and the static walk lowered every path."""

    __slots__ = ("sig", "dev", "cw", "n_warps", "cnt_keys", "buf_names",
                 "written", "scalars", "tiles", "facts", "shape_1d",
                 "_layout")

    def layout(self, R: int, params) -> dict:
        """The launch-invariant intrinsics of an R-row chunk."""
        hit = self._layout.get(R)
        if hit is not None:
            return hit
        W = params.warp_size
        dev = self.dev
        lanes = torch.arange(W, dtype=torch.int32, device=dev)
        rows_w = torch.arange(R, dtype=torch.int32,
                              device=dev) % self.n_warps
        tid = rows_w[:, None] * W + lanes[None, :]
        out = {"wact": tid < params.wg_threads,
               "lx": tid % params.local_size,
               "ly": torch.div(tid, params.local_size,
                               rounding_mode="floor"),
               "lanes": lanes[None, :].expand(R, W),
               "rows_w": rows_w[:, None].expand(R, W)}
        if len(self._layout) >= 4:
            self._layout.clear()
        self._layout[R] = out
        return out


def _prepare(fn: Function, params, buffers: dict, scalar_args: dict,
             argmap: dict, globals_mem, dev: torch.device) -> _Prepared:
    if _faults.ACTIVE:
        _faults.maybe_fault("torch.trace")
    n_wg = params.grid * params.grid_y
    cw = min(_chunk_wgs(dev), n_wg)
    sig = _shape_sig(params, buffers, scalar_args, cw, dev)
    cache = getattr(fn, "_torchgen_cache", None)
    if cache is None or cache[0] != fn.ir_version:
        cache = (fn.ir_version, {})
        fn._torchgen_cache = cache  # type: ignore[attr-defined]
    hit = cache[1].get(sig)
    if hit is not None:
        if isinstance(hit, str):
            raise LowerError(hit)
        TORCH_TELEMETRY["trace_cache_hits"] += 1
        return hit
    try:
        _licence(fn, params, n_wg, argmap, globals_mem)
        rec = _build(fn, params, buffers, scalar_args, cw, dev)
        _static_walk(rec, fn, params, buffers, scalar_args)
    except _faults.KernelFault:
        raise
    except _faults.InjectedFault:
        raise
    except Exception as e:
        reason = (str(e) if isinstance(e, LowerError)
                  else f"trace failed: {type(e).__name__}: {e}")
        cache[1][sig] = reason
        raise LowerError(reason) from e
    rec.sig = sig
    cache[1][sig] = rec
    return rec


def _build(fn: Function, params, buffers: dict, scalar_args: dict,
           cw: int, dev: torch.device) -> _Prepared:
    rec = _Prepared()
    rec.dev = dev
    rec.cw = cw
    rec.n_warps = params.warps_per_wg
    rec.shape_1d = params.grid_y == 1 and params.local_size_y == 1
    rec.facts = export_codegen_facts(fn)
    ops: set = set()
    _collect_ops(fn, ops, set())
    rec.cnt_keys = tuple(sorted(ops))
    ptrs = [p for p in fn.params if p.ty is Ty.PTR]
    rec.buf_names = tuple(sorted({p.name for p in ptrs}))
    for nm in rec.buf_names:
        if np.ndim(buffers[nm]) != 1:
            raise LowerError(f"buffer {nm} is not one-dimensional")
    stored = {id(i.operands[0]) for i in fn.instructions()
              if i.op is Op.STORE}
    rec.written = tuple(sorted({p.name for p in ptrs if id(p) in stored}))
    rec.scalars = {}
    for p in fn.params:
        if p.ty is not Ty.PTR:
            if p.name not in scalar_args:
                raise LowerError(f"no scalar bound for {p.name}")
            rec.scalars[id(p)] = (p.name, _TY_NP[p.ty], _TY_DTYPE[p.ty])
    rec.tiles = {f"@{g.name}": (g.size, _TY_DTYPE[g.elem_ty])
                 for g in fn.shared}
    rec._layout = {}
    return rec


def _run_chunk(rec: _Prepared, fn: Function, params, scalar_args: dict,
               tc: _Ctx, staged: dict, sizes: dict, c0: int, cwe: int,
               valid: bool, trace: bool) -> None:
    """Run workgroups [c0, c0 + cwe) in place on ``staged``."""
    W = params.warp_size
    R = cwe * rec.n_warps
    dev = rec.dev
    lay = rec.layout(R, params)
    consts: dict = {}

    def full(v):
        key = (v, torch.int32)
        a = consts.get(key)
        if a is None:
            a = torch.full((), v, dtype=torch.int32,
                           device=dev).expand(R, W)
            consts[key] = a
        return a

    ks = torch.arange(c0, c0 + cwe, dtype=torch.int32, device=dev)
    if rec.n_warps > 1:
        ks = ks.repeat_interleave(rec.n_warps)
    gx2 = (ks % params.grid)[:, None].expand(R, W)
    gy2 = torch.div(ks, params.grid, rounding_mode="floor")[:, None].expand(
        R, W)
    intr = {
        ("local_id", 0): lay["lx"],
        ("local_id", 1): lay["ly"],
        ("lane_id", 0): lay["lanes"],
        ("warp_id", 0): lay["rows_w"],
        ("group_id", 0): gx2,
        ("group_id", 1): gy2,
        ("core_id", 0): gx2 % 4,
        ("global_id", 0): gx2 * params.local_size + lay["lx"],
        ("global_id", 1): gy2 * params.local_size_y + lay["ly"],
        ("local_size", 0): full(params.local_size),
        ("local_size", 1): full(params.local_size_y),
        ("num_groups", 0): full(params.grid),
        ("num_groups", 1): full(params.grid_y),
        ("global_size", 0): full(params.grid * params.local_size),
        ("global_size", 1): full(params.grid_y * params.local_size_y),
        ("num_threads", 0): full(W),
        ("num_warps", 0): full(rec.n_warps),
        ("grid_dim", 0): full(params.grid),
    }
    argmap = {}
    for p in fn.params:
        if p.ty is Ty.PTR:
            argmap[id(p)] = p.name
        else:
            nm, np_dt, dt = rec.scalars[id(p)]
            v = np.asarray(scalar_args[nm], dtype=np_dt).item()
            argmap[id(p)] = torch.full((), v, dtype=dt,
                                       device=dev).expand(R, W)
    bufd = dict(staged)
    tsizes = dict(sizes)
    for nm, (size, dt) in rec.tiles.items():
        bufd[nm] = torch.zeros((R, size + 1), dtype=dt, device=dev)
        tsizes[nm] = size
    mask0 = lay["wact"] if valid else torch.zeros_like(lay["wact"])
    walker = _Walker(fn, R, W, intr, argmap, tc, tiles=set(rec.tiles),
                     sizes=tsizes, shape_1d=rec.shape_1d, facts=rec.facts,
                     consts=consts, trace=trace)
    kind, _, _ = walker.walk(fn.entry, 0, _State({}, bufd, mask0), None)
    if kind != "ret":
        raise LowerError("kernel did not return")
    tc.flush()


def _static_walk(rec: _Prepared, fn: Function, params, buffers: dict,
                 scalar_args: dict) -> None:
    """Lower every path once on one workgroup's rows with every lane
    inactive and one-cell stand-ins for the buffers: surfaces every
    LowerError (and any operation the device refuses) at licence time,
    before anything runs or any verdict is recorded."""
    staged, sizes = {}, {}
    for nm in rec.buf_names:
        dt = _torch_dtype(buffers[nm].dtype)
        staged[nm] = torch.zeros(2, dtype=dt, device=rec.dev)
        sizes[nm] = 1
    tc = _Ctx(rec.cnt_keys, params.fuel, rec.dev)
    _run_chunk(rec, fn, params, scalar_args, tc, staged, sizes, 0, 1,
               valid=False, trace=True)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


# --------------------------------------------------------------------------
# host loop
# --------------------------------------------------------------------------

def _run(rec: _Prepared, fn: Function, buffers: dict, scalar_args: dict,
         params) -> tuple:
    """Run every chunk; returns (host_bufs, tstats dict).  Never mutates
    ``buffers`` — results are staged on the device and copied back at
    the end, so a faulted launch costs nothing to roll back.
    ``host_bufs`` holds the buffers the kernel stores to."""
    dev = rec.dev
    n_wg = params.grid * params.grid_y
    staged, sizes = {}, {}
    for nm in rec.buf_names:
        arr = buffers[nm]
        n = arr.shape[-1]
        t = torch.empty(n + 1, dtype=_torch_dtype(arr.dtype), device=dev)
        t[:n].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        staged[nm] = t
        sizes[nm] = n
    tc = _Ctx(rec.cnt_keys, params.fuel, dev)
    for c0 in range(0, n_wg, rec.cw):
        if _gov.ACTIVE:
            _gov.deadline_check()
        if _faults.ACTIVE:
            _faults.maybe_fault("torch.exec")
        _run_chunk(rec, fn, params, scalar_args, tc, staged, sizes, c0,
                   min(rec.cw, n_wg - c0), valid=True, trace=False)
    tc.set_err(tc.fuel >= tc.fuel_limit, ERR_FUEL)
    head = torch.stack([tc.mem, tc.shm, tc.minst, tc.maxd, tc.err])
    vals = torch.cat([head, tc.cnt]).tolist()
    mem_, shm, minst, maxd, err_v = vals[:5]
    if err_v:
        names = [nm for bit, nm in ((ERR_OOB_STORE, "oob-store"),
                                    (ERR_UNIFORM, "uniformity"),
                                    (ERR_FUEL, "fuel")) if err_v & bit]
        raise _faults.EngineFault(
            f"torch rung semantic-error bits [{', '.join(names)}] in "
            f"@{fn.name} — demoting so the grid rung reproduces the "
            f"exact kernel error", site="torch.exec", rung="torch")
    host_bufs = {nm: staged[nm][:sizes[nm]].cpu().numpy()
                 for nm in rec.written}
    by_op = {k: int(v) for k, v in zip(rec.cnt_keys, vals[5:]) if v}
    tstats = {
        "instrs": sum(by_op.values()),
        "by_op": by_op,
        "mem_requests": int(mem_),
        "mem_insts": int(minst),
        "shared_requests": int(shm),
        "max_ipdom_depth": int(maxd),
    }
    return host_bufs, tstats


def _apply(host_bufs: dict, tstats: dict, buffers: dict, stats) -> None:
    for nm, arr in host_bufs.items():
        np.copyto(buffers[nm], arr)
    stats.instrs += tstats["instrs"]
    stats.by_op.update(tstats["by_op"])
    stats.mem_requests += tstats["mem_requests"]
    stats.mem_insts += tstats["mem_insts"]
    stats.shared_requests += tstats["shared_requests"]
    stats.max_ipdom_depth = max(stats.max_ipdom_depth,
                                tstats["max_ipdom_depth"])


def _stats_match(tstats: dict, stats) -> bool:
    return (tstats["instrs"] == stats.instrs
            and tstats["by_op"] == {k: v for k, v in stats.by_op.items()
                                    if v}
            and tstats["mem_requests"] == stats.mem_requests
            and tstats["mem_insts"] == stats.mem_insts
            and tstats["shared_requests"] == stats.shared_requests
            and tstats["max_ipdom_depth"] == stats.max_ipdom_depth
            and stats.atomic_serial == 0
            and not stats.prints)


# --------------------------------------------------------------------------
# certification store
# --------------------------------------------------------------------------

def _certs(fn: Function) -> dict:
    c = getattr(fn, "_torch_certs", None)
    if c is not None and c[0] == fn.ir_version:
        return c[1]
    d = None
    hooks = _interp.TORCH_CERT_HOOKS
    if hooks is not None:
        try:
            d = hooks[0](fn)
        except Exception:
            d = None
    if not isinstance(d, dict):
        d = {}
    fn._torch_certs = (fn.ir_version, d)  # type: ignore[attr-defined]
    return d


def _verdict_of(entry) -> tuple:
    """Normalize a cert-store entry to ``(verdict, torch_ms, grid_ms)``:
    the differential certification run measures the normal chain anyway,
    so its wall time rides along with the verdict, and the first
    certified primary fills in the warm torch time — together they let
    the dispatch router send launches whose grid time beats the torch
    rung's straight to the grid rung."""
    if isinstance(entry, tuple):
        return entry
    return (entry, None, None)


def recorded(fn: Function, sig: str) -> tuple:
    """The recorded ``(verdict, torch_ms, grid_ms)`` of one shape class
    (``(None, None, None)`` while unknown)."""
    return _verdict_of(_certs(fn).get(sig))


def _record(fn: Function, sig: str, verdict: str,
            torch_ms: float | None = None,
            grid_ms: float | None = None) -> None:
    certs = _certs(fn)
    certs[sig] = (verdict, torch_ms, grid_ms)
    hooks = _interp.TORCH_CERT_HOOKS
    if hooks is not None:
        try:
            hooks[1](fn, certs)
        except Exception:
            pass


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def licence_check(fn: Function, params, buffers: dict,
                  scalar_args: dict | None = None,
                  globals_mem: dict | None = None,
                  device=None) -> tuple:
    """(admitted, reason) — does this (kernel, launch) pass the static
    licence AND lower cleanly?  Performs no execution of the launch and
    records no verdicts."""
    from ...device import resolve_device
    scalar_args = scalar_args or {}
    argmap: dict = {}
    for p in fn.params:
        if p.ty is Ty.PTR:
            if p.name not in buffers:
                return (False, f"no buffer bound for {p.name}")
            argmap[id(p)] = buffers[p.name]
        else:
            if p.name not in scalar_args:
                return (False, f"no scalar bound for {p.name}")
            argmap[id(p)] = np.full(params.warp_size, scalar_args[p.name],
                                    dtype=_TY_NP[p.ty])
    try:
        _prepare(fn, params, buffers, scalar_args, argmap,
                 globals_mem or {}, resolve_device(device))
    except LowerError as e:
        return (False, str(e))
    return (True, "")


def shape_sig(fn: Function, params, buffers: dict,
              scalar_args: dict | None = None, device=None) -> str:
    """The shape-class key a launch's verdict is recorded under."""
    from ...device import resolve_device
    dev = resolve_device(device)
    n_wg = params.grid * params.grid_y
    return _shape_sig(params, buffers, scalar_args or {},
                      min(_chunk_wgs(dev), n_wg), dev)


def orchestrate(fn: Function, buffers: dict, params, scalar_args: dict,
                mem, argmap: dict, stats, mode, run_normal,
                route: bool = False, device=None) -> bool:
    """The torch rung's launch entry, called from ``interp._launch_impl``
    with the "torch" rung pushed.  Returns True when THIS call produced
    the launch's results (either the torch program ran as the certified
    primary, or a certification run drove ``run_normal``); False means
    nothing happened and the caller falls through to the normal executor
    selection.

    ``mode``: True (chain rung — failures raise EngineFault so the
    runtime demotes + rolls back) or "fallback" (standalone — failures
    silently fall through, buffers untouched either way).

    ``route``: enable the small-launch dispatch router (the Runtime
    chain's ``torch="route"`` mode) — pairs whose measured grid time
    beats the torch rung's are declined so they land on the grid rung.
    Direct ``torch=True`` calls (conformance sweeps, benchmarks) keep
    unconditional engagement.
    """
    from ...device import resolve_device
    dev = resolve_device(device)
    try:
        rec = _prepare(fn, params, buffers, scalar_args, argmap,
                       mem.globals_mem, dev)
    except LowerError:
        TORCH_TELEMETRY["refusals"] += 1
        return False
    except _faults.KernelFault:
        raise
    except _faults.EngineFault:
        TORCH_TELEMETRY["demotions"] += 1
        if mode == "fallback":
            return False
        raise

    if _faults.ACTIVE:
        try:
            _faults.maybe_fault("torch.cache.load")
        except _faults.InjectedFault:
            TORCH_TELEMETRY["demotions"] += 1
            if mode == "fallback":
                return False
            raise
    verdict, v_torch_ms, v_grid_ms = _verdict_of(_certs(fn).get(rec.sig))

    if verdict == "fail":
        return False

    # ---- small-launch dispatch router --------------------------------
    # A certified pair whose measured grid time beats the measured torch
    # time is SERVED BY THE GRID RUNG: falling through here lands exactly
    # there, with the verdict untouched — a bigger shape class of the
    # same kernel still takes the torch primary.
    if (route and verdict is not None and v_torch_ms is not None
            and v_grid_ms is not None
            and v_grid_ms < v_torch_ms * _ROUTE_MARGIN):
        TORCH_TELEMETRY["routed_small"] += 1
        hook = getattr(_interp, "ROUTED_SMALL_HOOK", None)
        if hook is not None:
            hook()
        return False

    if verdict is None:
        # ---- differential certification run -------------------------
        TORCH_TELEMETRY["cert_runs"] += 1
        tok = True
        host_bufs = tstats = None
        try:
            # reads buffers before run_normal can mutate them; never
            # writes them
            host_bufs, tstats = _run(rec, fn, buffers, scalar_args, params)
        except _faults.KernelFault:
            raise                       # deadline: the caller's verdict
        except _faults.InjectedFault:
            # an INFRA fault interrupted the certification — record no
            # verdict (the pair stays unknown and re-certifies later)
            TORCH_TELEMETRY["demotions"] += 1
            if mode == "fallback":
                return False
            raise
        except Exception:
            tok = False
        try:
            t0 = perf_counter()
            run_normal(stats)
            grid_ms = (perf_counter() - t0) * 1e3
        except Exception:
            # outcome parity: the caller sees exactly the normal
            # chain's exception; the pair is pinned to it from now on
            _record(fn, rec.sig, "fail")
            raise
        ok = (tok and _stats_match(tstats, stats)
              and all(host_bufs[nm].tobytes() == buffers[nm].tobytes()
                      for nm in rec.written))
        # grid_ms rides along with the verdict; torch_ms stays None
        # until the first certified primary measures a warm run
        _record(fn, rec.sig, "pass" if ok else "fail",
                grid_ms=grid_ms if ok else None)
        if ok:
            TORCH_TELEMETRY["certified"] += 1
        return True

    # ---- certified primary ------------------------------------------
    t0 = perf_counter()
    try:
        host_bufs, tstats = _run(rec, fn, buffers, scalar_args, params)
    except _faults.KernelFault:
        raise
    except _faults.EngineFault:
        TORCH_TELEMETRY["demotions"] += 1
        if mode == "fallback":
            return False
        raise
    except Exception as e:
        TORCH_TELEMETRY["demotions"] += 1
        if mode == "fallback":
            return False
        raise _faults.EngineFault(
            f"torch executor failure: {type(e).__name__}: {e}",
            site="torch.exec", rung="torch") from e
    _apply(host_bufs, tstats, buffers, stats)
    TORCH_TELEMETRY["engaged"] += 1
    if v_torch_ms is None:
        # first warm primary at this shape class: measure the torch
        # rung's wall (transfers and syncs included) so the router has
        # both sides
        _record(fn, rec.sig, verdict,
                torch_ms=(perf_counter() - t0) * 1e3, grid_ms=v_grid_ms)
    return True
