"""Torch back-end: lowers divergence-managed VIR to masked, eager torch.

Port of ``repro.core.backends.jax_backend``. The compile-time walker below
is the IPDOM stack, as in the reference; what differs is that it runs
eagerly on ``(R, W)`` lane tensors (R rows = workgroups, W lanes) instead
of tracing a JAX program:

  * ``vx_split``/``vx_join`` regions are linearized: the then side runs
    under ``mask & p``, the else side continues on its state under
    ``mask & ~p`` (so it sees the then side's writes), then the mask is
    restored;
  * ``vx_pred`` and uniform loops are host loops ``while (c & mask).any()``
    (the reference's ``lax.while_loop``); with several rows a row whose
    loop has ended rides along under an empty mask, so every row sees
    exactly the trips it would run alone;
  * ``scalarize_uniform`` takes a uniform branch with a host ``if`` on the
    consensus predicate (the reference's ``lax.cond``);
  * collectives are workgroup-wide: vote -> masked reductions over the
    lane axis, shfl -> lane gather, atomics -> lane-ordered prefix
    combines that return the old value.

Ballot builds the oracle's bitmask (``interp.launch``) and refuses W > 32;
the reference backend sums the active lanes at W >= 32 instead.

``compile_torch`` runs one workgroup per step of a Python loop (the
reference's ``fori_loop``); ``kernels/simt_exec`` drives the same walker
over all workgroups at once with tile windows (``buf_offsets``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..vir import (Block, Const, Function, GlobalVar, Instr, Module, Op,
                   Param, Reg, Ty, Value, BINOPS, UNOPS)
from .. import graph
from ..interp import LaunchParams

_TY_DTYPE = {Ty.I32: torch.int32, Ty.F32: torch.float32, Ty.BOOL: torch.bool}

_I32_MAX = 2**31 - 1


class LowerError(Exception):
    pass


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and
    there is none: the port never falls back to the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the host")
    return dev


# --------------------------------------------------------------------------
# state: slots / buffers / mask (functional)
# --------------------------------------------------------------------------

@dataclass
class _State:
    slots: Dict[int, torch.Tensor]         # id(Slot) -> (R, W)
    bufs: Dict[str, torch.Tensor]          # buffer name -> (R, L) row view
    mask: torch.Tensor                     # (R, W) bool

    def copy(self) -> "_State":
        return _State(dict(self.slots), dict(self.bufs), self.mask)


def _popc(a: torch.Tensor) -> torch.Tensor:
    """Population count of the uint32 reinterpretation of ``a``."""
    x = a.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _ffs(a: torch.Tensor) -> torch.Tensor:
    """1-based index of the lowest set bit, 0 for 0 (``__ffs``)."""
    x = a.to(torch.int64) & 0xFFFFFFFF
    idx = _popc((x & -x) - 1) + 1
    return torch.where(x == 0, torch.zeros_like(idx), idx)


def _ftoi(a: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: truncate, saturate, NaN -> 0."""
    if not a.is_floating_point():
        return a.to(torch.int32)
    t = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    t = t.clamp(-2.0**31, 2.0**31 - 128)     # largest float32 below 2^31
    out = t.to(torch.int32)
    return torch.where(a >= 2.0**31, torch.full_like(out, _I32_MAX), out)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) & 1) * 2**32).to(torch.int32)


def _torch_binop(op: Op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op is Op.ADD: return a + b
    if op is Op.SUB: return a - b
    if op is Op.MUL: return a * b
    if op is Op.DIV:
        one = torch.ones_like(b)
        zero = torch.zeros_like(b)
        if a.is_floating_point() or b.is_floating_point():
            return torch.where(b != 0, a / torch.where(b == 0, one, b),
                               zero.to(torch.float32))
        # jnp `//` is floor division
        return torch.where(b != 0, torch.div(a, torch.where(b == 0, one, b),
                                             rounding_mode="floor"), zero)
    if op is Op.MOD:
        one = torch.ones_like(b)
        return torch.where(b != 0, torch.remainder(a, torch.where(b == 0, one,
                                                                  b)),
                           torch.zeros_like(b))
    if op is Op.AND: return a & b
    if op is Op.OR: return a | b
    if op is Op.XOR: return a ^ b
    if op is Op.SHL:
        # XLA: a shift count outside [0, 32) gives 0
        big = (b < 0) | (b >= 32)
        return torch.where(big, torch.zeros_like(a),
                           torch.bitwise_left_shift(a, b.clamp(0, 31)))
    if op is Op.SHR:
        # XLA arithmetic shift: a count outside [0, 32) fills with the sign
        big = (b < 0) | (b >= 32)
        fill = torch.where(a < 0, torch.full_like(a, -1), torch.zeros_like(a))
        return torch.where(big, fill,
                           torch.bitwise_right_shift(a, b.clamp(0, 31)))
    if op is Op.MIN: return torch.minimum(a, b)
    if op is Op.MAX: return torch.maximum(a, b)
    if op is Op.POW: return torch.pow(a.to(torch.float32), b)
    if op is Op.EQ: return a == b
    if op is Op.NE: return a != b
    if op is Op.LT: return a < b
    if op is Op.LE: return a <= b
    if op is Op.GT: return a > b
    if op is Op.GE: return a >= b
    raise LowerError(f"binop {op}")


def _torch_unop(op: Op, a: torch.Tensor) -> torch.Tensor:
    if op is Op.NEG: return -a
    if op is Op.NOT: return ~a
    if op is Op.ABS: return torch.abs(a)
    if op is Op.SQRT:
        return torch.sqrt(torch.maximum(a, torch.zeros_like(a))
                          ).to(torch.float32)
    if op is Op.EXP: return torch.exp(a).to(torch.float32)
    if op is Op.LOG:
        return torch.log(torch.where(a > 0, a, torch.ones_like(a))
                         ).to(torch.float32)
    if op is Op.SIN: return torch.sin(a).to(torch.float32)
    if op is Op.COS: return torch.cos(a).to(torch.float32)
    if op is Op.ITOF: return a.to(torch.float32)
    if op is Op.FTOI: return _ftoi(a)
    if op is Op.POPC: return _popc(a)
    if op is Op.FFS: return _ffs(a)
    raise LowerError(f"unop {op}")


# --------------------------------------------------------------------------
# The walker
# --------------------------------------------------------------------------

class _FnLowering:
    """Runs one function body on (R, W) lane tensors (recursive walker)."""

    def __init__(self, fn: Function, R: int, W: int,
                 intr: Dict[Tuple[str, int], torch.Tensor],
                 argmap: Dict[int, Any], device: torch.device,
                 scalarize_uniform: bool = False,
                 buf_offsets: Optional[Dict[str, torch.Tensor]] = None
                 ) -> None:
        self.fn = fn
        self.R = R
        self.W = W
        self.intr = intr
        self.argmap = argmap   # id(Param) -> (R, W) tensor | buffer-name
        self.device = device
        self.env: Dict[int, torch.Tensor] = {}
        self.scalarize_uniform = scalarize_uniform
        # tile-windowed buffers (simt_exec): name -> (R, 1) offset
        # subtracted from every access index
        self.buf_offsets = buf_offsets or {}
        self.loops = graph.natural_loops(fn)
        self.headers = {id(l.header): l for l in self.loops}
        self.pdom = graph.postdominators(fn)
        self.ret_val: Optional[torch.Tensor] = None

    def full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.R, self.W), value, dtype=dtype,
                          device=self.device)

    # -- values --------------------------------------------------------------
    def val(self, v: Value) -> torch.Tensor:
        if isinstance(v, Const):
            return self.full(v.value, _TY_DTYPE.get(v.ty, torch.float32))
        if isinstance(v, Reg):
            return self.env[id(v)]
        if isinstance(v, Param):
            a = self.argmap.get(id(v))
            if a is None:
                raise LowerError(f"unbound param {v.name}")
            if isinstance(a, (str, GlobalVar)):
                raise LowerError(f"pointer param {v.name} used as value")
            return a
        raise LowerError(f"cannot lower value {v!r}")

    def buf_name(self, ptr: Value) -> str:
        if isinstance(ptr, Param):
            a = self.argmap.get(id(ptr))
            if isinstance(a, str):
                return a
            if isinstance(a, GlobalVar):
                return f"@{a.name}"
            raise LowerError(f"pointer param {ptr.name} not bound to buffer")
        if isinstance(ptr, GlobalVar):
            return f"@{ptr.name}"
        raise LowerError(f"bad pointer {ptr!r}")

    # -- the walker ------------------------------------------------------------
    def walk(self, block: Block, pos: int, st: _State,
             stop_block: Optional[Block]) -> Tuple[str, Any, _State]:
        """Run until RET ('ret'), a foreign JOIN ('join', (block,pos)), or
        the stop block ('stop', (block,0))."""
        while True:
            if stop_block is not None and block is stop_block and pos == 0:
                return ("stop", (block, 0), st)
            i = block.instrs[pos]
            op = i.op

            if op is Op.BR:
                block, pos = i.operands[0], 0
                continue
            if op is Op.RET:
                if i.operands:
                    self.ret_val = self.val(i.operands[0])
                return ("ret", None, st)
            if op is Op.JOIN:
                return ("join", (block, pos), st)

            if op is Op.SPLIT:
                st = self._lower_split(block, pos, i, st)
                ip = i.attrs.get("ipdom")
                if ip is None:
                    raise LowerError("vx_split without ipdom annotation")
                block, pos = ip, 0
                continue

            if op is Op.PRED:
                st, exit_block = self._lower_pred_loop(block, pos, i, st)
                block, pos = exit_block, 0
                continue

            if op is Op.CBR:
                loop = self.headers.get(id(block))
                if loop is not None and any(
                        not loop.contains(s) for s in block.successors()):
                    st, exit_block = self._lower_uniform_loop(block, pos, i,
                                                              st, loop)
                    block, pos = exit_block, 0
                    continue
                st, cont = self._lower_uniform_branch(block, pos, i, st)
                block, pos = cont, 0
                continue

            if op is Op.TMC_SAVE:
                self.env[id(i.result)] = st.mask
                pos += 1
                continue
            if op is Op.TMC_RESTORE:
                st = st.copy()
                st.mask = self.env[id(i.operands[0])]
                pos += 1
                continue

            st = self._lower_simple(i, st)
            pos += 1

    # -- split/join diamond -----------------------------------------------------
    def _lower_split(self, block: Block, pos: int, split: Instr,
                     st: _State) -> _State:
        cbr = block.instrs[pos + 1]
        if cbr.op is not Op.CBR:
            raise LowerError("vx_split not followed by branch")
        sp = self.val(split.operands[0]).to(torch.bool)
        if split.attrs.get("negate", False):
            sp = ~sp
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]
        tok = id(split.result)

        # hardware serialization order: the taken side first under
        # mask & p, then the else side continues on its state under
        # mask & ~p (it observes the then side's writes)
        entry_mask = st.mask
        st1 = st.copy()
        st1.mask = entry_mask & sp
        kind, where_, st1 = self.walk(then_bb, 0, st1, None)
        self._expect_join(kind, where_, tok)

        st2 = st1.copy()
        st2.mask = entry_mask & ~sp
        kind, where_, st2 = self.walk(else_bb, 0, st2, None)
        self._expect_join(kind, where_, tok)

        out = st2.copy()
        out.mask = entry_mask          # vx_join: reconverge
        return out

    def _expect_join(self, kind: str, where_: Any, tok: int) -> None:
        if kind != "join":
            raise LowerError(f"side walk ended with {kind}, expected join")
        jb, jp = where_
        j = jb.instrs[jp]
        if id(j.operands[0]) != tok:
            raise LowerError("join token mismatch during lowering "
                             "(structurization bug)")

    # -- loops --------------------------------------------------------------------
    def _run_header(self, header: Block, st: _State
                    ) -> Tuple[torch.Tensor, _State]:
        """Execute the header prefix and return the branch/pred cond."""
        term = header.instrs[-1]
        for i in header.instrs[:-1]:
            if i.op in (Op.STORE, Op.ATOMIC, Op.BARRIER):
                raise LowerError("side-effecting op in loop header")
            if i.op is Op.SPLIT:
                continue
            st = self._lower_simple(i, st)
        return self.val(term.operands[0]).to(torch.bool), st

    def _lower_loop_common(self, header: Block, term: Instr, st: _State,
                           divergent: bool, inside: Block,
                           outside: Block) -> Tuple[_State, Block]:
        negate = term.attrs.get("negate", False)
        # a header that changes no state is run once per trip; otherwise
        # the exit test's run is thrown away, as the reference's cond_fn
        # is, and the trip re-runs it on the live rows
        pure = not any(i.op in (Op.SLOT_STORE, Op.CALL)
                       for i in header.instrs[:-1])
        entry_mask = st.mask
        snap_env = dict(self.env)
        while True:
            self.env = dict(snap_env)
            c, s = self._run_header(header, st)
            if negate:
                c = ~c
            live = (c & st.mask).any(dim=1, keepdim=True)
            if not bool(live.any()):
                break
            if pure:
                s = st.copy()
                s.mask = st.mask & live
            else:
                self.env = dict(snap_env)
                s = st.copy()
                s.mask = st.mask & live
                c, s = self._run_header(header, s)
                if negate:
                    c = ~c
                s = s.copy()
            if divergent:
                s.mask = s.mask & c
            kind, _, st = self.walk(inside, 0, s, header)
            if kind != "stop":
                raise LowerError(f"loop body walk ended with {kind}")
        self.env = dict(snap_env)
        final = st.copy()
        final.mask = entry_mask         # entry mask restored (vx_pred / exit)
        return final, outside

    def _lower_pred_loop(self, block: Block, pos: int, pred: Instr,
                         st: _State) -> Tuple[_State, Block]:
        if self.headers.get(id(block)) is None:
            raise LowerError("vx_pred outside loop header")
        inside, outside = pred.operands[2], pred.operands[3]
        return self._lower_loop_common(block, pred, st, True, inside, outside)

    def _lower_uniform_loop(self, block: Block, pos: int, cbr: Instr,
                            st: _State, loop: graph.Loop
                            ) -> Tuple[_State, Block]:
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]
        if loop.contains(then_bb):
            inside, outside = then_bb, else_bb
            neg = False
        else:
            inside, outside = else_bb, then_bb
            neg = True
        fake = Instr(cbr.op, cbr.operands, None,
                     {**cbr.attrs, "negate": neg})
        fake.parent = block
        return self._lower_loop_common(block, fake, st, False, inside,
                                       outside)

    # -- uniform (un-split) branch --------------------------------------------------
    def _lower_uniform_branch(self, block: Block, pos: int, cbr: Instr,
                              st: _State) -> Tuple[_State, Block]:
        merge = self.pdom.immediate(block)
        if merge is None:
            raise LowerError("uniform branch without IPDOM")
        c = self.val(cbr.operands[0]).to(torch.bool)
        then_bb, else_bb = cbr.operands[1], cbr.operands[2]

        if self.scalarize_uniform:
            return self._scalarized_branch(then_bb, else_bb, c, st,
                                           merge), merge

        # linearized with masks (the condition is uniform over active
        # lanes, so one side's effective mask is empty)
        entry_mask = st.mask
        st1 = st.copy()
        st1.mask = entry_mask & c
        kind, _, st1 = self.walk(then_bb, 0, st1, merge)
        if kind != "stop":
            raise LowerError(f"uniform-branch then side ended with {kind}")
        st2 = st1.copy()
        st2.mask = entry_mask & ~c
        kind, _, st2 = self.walk(else_bb, 0, st2, merge)
        if kind != "stop":
            raise LowerError(f"uniform-branch else side ended with {kind}")
        out = st2.copy()
        out.mask = entry_mask
        return out, merge

    def _scalarized_branch(self, then_bb, else_bb, c, st, merge) -> _State:
        """A uniform branch taken by a host ``if``: exactly one side runs,
        under the entry mask (the reference's ``lax.cond``)."""
        # consensus predicate over active lanes (analysis guarantees
        # agreement; inactive lanes may hold garbage)
        pred = (c & st.mask).any(dim=1)
        take = bool(pred.all())
        if not take and bool(pred.any()):
            raise LowerError("scalarized branch disagrees across workgroups")
        snap_env = dict(self.env)
        kind, _, out = self.walk(then_bb if take else else_bb, 0, st.copy(),
                                 merge)
        if kind != "stop":
            raise LowerError("scalarized side did not converge")
        self.env = dict(snap_env)
        return out

    # -- straight-line ops ----------------------------------------------------------
    def _lower_simple(self, i: Instr, st: _State) -> _State:
        op = i.op
        if op is Op.SLOT_LOAD:
            s = i.operands[0]
            v = st.slots.get(id(s))
            if v is None:
                v = self.full(0, _TY_DTYPE[s.ty])
            self.env[id(i.result)] = v
            return st
        if op is Op.SLOT_STORE:
            s, v = i.operands
            nv = self.val(v)
            st = st.copy()
            old = st.slots.get(id(s))
            if old is None:
                old = torch.zeros_like(nv)
            st.slots[id(s)] = torch.where(st.mask, nv, old)
            return st
        if op is Op.LOAD:
            nm = self.buf_name(i.operands[0])
            buf = st.bufs[nm]
            ix = self.val(i.operands[1]).to(torch.int32)
            if nm in self.buf_offsets:
                ix = ix - self.buf_offsets[nm]
            ix = ix.clamp(0, buf.shape[1] - 1)
            self.env[id(i.result)] = torch.gather(buf, 1, ix.long())
            return st
        if op is Op.STORE:
            nm = self.buf_name(i.operands[0])
            buf = st.bufs[nm]
            L = buf.shape[1]
            ix = self.val(i.operands[1]).to(torch.int32)
            if nm in self.buf_offsets:
                ix = ix - self.buf_offsets[nm]
            oob = (ix < 0) | (ix >= L)
            ix = ix.clamp(0, L - 1)
            v = self.val(i.operands[2]).to(buf.dtype)
            # mask-predicated scatter: inactive and out-of-window lanes
            # land in a spare column that is dropped
            safe = torch.where(st.mask & ~oob, ix, torch.full_like(ix, L))
            st = st.copy()
            st.bufs[nm] = self._scatter(buf, safe, v)
            return st
        if op is Op.ATOMIC:
            return self._lower_atomic(i, st)
        if op is Op.INTR:
            key = (i.operands[0], i.operands[1])
            if key not in self.intr:
                raise LowerError(f"intrinsic {key} not provided")
            self.env[id(i.result)] = self.intr[key]
            return st
        if op is Op.VOTE:
            mode = i.operands[0]
            v = self.val(i.operands[1]).to(torch.bool)
            act = v & st.mask
            if mode == "any":
                r = act.any(dim=1, keepdim=True)
            elif mode == "all":
                r = (v | ~st.mask).all(dim=1, keepdim=True)
            elif mode == "ballot":
                if self.W > 32:
                    raise LowerError(f"ballot needs W <= 32, got {self.W}")
                lanes = torch.arange(self.W, device=self.device)
                r = _wrap_i32((act.long() << lanes).sum(dim=1, keepdim=True))
            else:
                raise LowerError(f"vote {mode}")
            self.env[id(i.result)] = r.expand(self.R, self.W)
            return st
        if op is Op.SHFL:
            v = self.val(i.operands[0])
            src = torch.remainder(self.val(i.operands[1]).to(torch.int32),
                                  self.W)
            self.env[id(i.result)] = torch.gather(v, 1, src.long())
            return st
        if op in (Op.BARRIER, Op.PRINT):
            return st   # lockstep within the vectorized workgroup
        if op is Op.CALL:
            return self._lower_call(i, st)
        if op in (Op.SELECT, Op.CMOV):
            c = self.val(i.operands[0]).to(torch.bool)
            self.env[id(i.result)] = torch.where(c, self.val(i.operands[1]),
                                                 self.val(i.operands[2]))
            return st
        if op in BINOPS:
            self.env[id(i.result)] = _torch_binop(
                op, self.val(i.operands[0]), self.val(i.operands[1]))
            return st
        if op in UNOPS:
            self.env[id(i.result)] = _torch_unop(op, self.val(i.operands[0]))
            return st
        raise LowerError(f"unhandled op in torch lowering: {op}")

    @staticmethod
    def _scatter(buf: torch.Tensor, safe: torch.Tensor, v: torch.Tensor,
                 reduce: Optional[str] = None) -> torch.Tensor:
        """Out-of-place row scatter; index ``L`` is the dropped column."""
        padded = torch.cat([buf, buf[:, :1]], dim=1)
        if reduce is None:
            padded.scatter_(1, safe.long(), v)
        else:
            padded.scatter_reduce_(1, safe.long(), v, reduce)
        return padded[:, :buf.shape[1]]

    def _lower_atomic(self, i: Instr, st: _State) -> _State:
        kind = i.operands[0]
        nm = self.buf_name(i.operands[1])
        buf = st.bufs[nm]
        L = buf.shape[1]
        ix = self.val(i.operands[2]).to(torch.int32).clamp(0, L - 1)
        v = self.val(i.operands[3]).to(buf.dtype)
        mask = st.mask
        # returns-old with lane-ordered conflict resolution:
        # old_i = buf[ix_i] + sum_{j<i, ix_j==ix_i, active_j} v_j
        same = ix.unsqueeze(1) == ix.unsqueeze(2)          # [r, i, j]
        lower = torch.ones(self.W, self.W, dtype=torch.bool,
                           device=self.device).tril(-1)
        sel = same & lower & mask.unsqueeze(1)
        safe = torch.where(mask, ix, torch.full_like(ix, L))
        current = torch.gather(buf, 1, ix.long())
        st = st.copy()
        if kind == "add":
            contrib = torch.where(sel, v.unsqueeze(1),
                                  torch.zeros_like(v).unsqueeze(1))
            old = current + contrib.sum(dim=2).to(buf.dtype)
            st.bufs[nm] = self._scatter(buf, safe, v, "sum")
        elif kind in ("max", "min"):
            run = torch.where(sel, v.unsqueeze(1), current.unsqueeze(2))
            if kind == "max":
                old = torch.maximum(current, run.amax(dim=2))
            else:
                old = torch.minimum(current, run.amin(dim=2))
            old = torch.where(sel.any(dim=2), old, current)
            st.bufs[nm] = self._scatter(buf, safe, v,
                                        "amax" if kind == "max" else "amin")
        elif kind == "xchg":
            old = current
            st.bufs[nm] = self._scatter(buf, safe, v)
        else:
            raise LowerError(f"atomic {kind} unsupported in torch backend")
        if i.result is not None:
            self.env[id(i.result)] = old
        return st

    def _lower_call(self, i: Instr, st: _State) -> _State:
        callee: Function = i.operands[0]
        argmap: Dict[int, Any] = {}
        for p, a in zip(callee.params, i.operands[1:]):
            if p.ty is Ty.PTR:
                if self.buf_offsets:
                    # the reference lowers the callee without the tile
                    # offsets, so it would index the tile with a global
                    # index: refuse rather than copy that
                    raise LowerError(
                        f"pointer argument {p.name} of @{callee.name} "
                        "under tile windows")
                argmap[id(p)] = self.buf_name(a)
            else:
                argmap[id(p)] = self.val(a)
        sub = _FnLowering(callee, self.R, self.W, self.intr, argmap,
                          self.device, self.scalarize_uniform)
        sub_st = _State({}, st.bufs, st.mask)
        kind, _, out_st = sub.walk(callee.entry, 0, sub_st, None)
        if kind != "ret":
            raise LowerError(f"callee walk ended with {kind}")
        st = st.copy()
        st.bufs = out_st.bufs
        if i.result is not None:
            rv = sub.ret_val
            if rv is None:
                rv = self.full(0, torch.float32)
            self.env[id(i.result)] = rv
        return st


# --------------------------------------------------------------------------
# Intrinsics
# --------------------------------------------------------------------------

def intrinsics(params: LaunchParams, groups: torch.Tensor, W: int,
               tiled: bool = False) -> Dict[Tuple[str, int], torch.Tensor]:
    """Per-lane intrinsic values for the workgroups ``groups`` ((R, 1)
    int32). ``tiled`` selects the 1-D table of the tiled kernel
    (``local_id 1 = 0``), else the 2-D table of ``compile_torch``."""
    dev = groups.device
    R = groups.shape[0]
    lanes = torch.arange(W, dtype=torch.int32, device=dev).unsqueeze(0)
    lx = lanes % params.local_size
    ly = lanes // params.local_size

    def full(v):
        return torch.full((R, W), v, dtype=torch.int32, device=dev)

    g = groups.to(torch.int32) + full(0)
    intr = {
        ("local_id", 0): lx.expand(R, W),
        ("local_id", 1): full(0) if tiled else ly.expand(R, W),
        ("lane_id", 0): (lanes % params.warp_size).expand(R, W),
        ("group_id", 0): g,
        ("group_id", 1): full(0),
        ("global_id", 0): g * params.local_size + lx,
        ("global_id", 1): full(0) if tiled else ly.expand(R, W),
        ("local_size", 0): full(params.local_size),
        ("local_size", 1): full(1 if tiled else params.local_size_y),
        ("num_groups", 0): full(params.grid),
        ("num_groups", 1): full(1 if tiled else params.grid_y),
        ("global_size", 0): full(params.grid * params.local_size),
        ("global_size", 1): full(1 if tiled else
                                 params.grid_y * params.local_size_y),
        ("num_threads", 0): full(params.warp_size),
        ("num_warps", 0): full(params.warps_per_wg),
        ("warp_id", 0): (lanes // params.warp_size).expand(R, W),
        ("core_id", 0): g % 4,
        ("grid_dim", 0): full(params.grid),
    }
    return intr


def scalar_lanes(fn: Function, scalars: Dict[str, Any], R: int, W: int,
                 device: torch.device) -> Dict[int, Any]:
    """argmap of a kernel: pointer params by name, scalars broadcast."""
    argmap: Dict[int, Any] = {}
    for p in fn.params:
        if p.ty is Ty.PTR:
            argmap[id(p)] = p.name
        else:
            v = torch.as_tensor(scalars[p.name], device=device)
            argmap[id(p)] = v.to(_TY_DTYPE[p.ty]).expand(R, W)
    return argmap


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

@dataclass
class TorchKernel:
    fn: Callable            # (buffers: dict, scalars: dict) -> buffers dict
    wg_fn: Callable         # (group_id, buffers, scalars) -> buffers dict
    params: LaunchParams


def compile_torch(kernel_fn: Function, params: LaunchParams,
                  module: Optional[Module] = None,
                  scalarize_uniform: bool = False,
                  device=None) -> TorchKernel:
    """Compile a divergence-managed VIR kernel to an eager torch function.

    The vector width is one workgroup (``params.wg_threads`` lanes); the
    grid loop is a Python loop over workgroups, as the reference's
    ``fori_loop``. Buffers are 1-D tensors on ``device`` (``None`` means
    the card); the returned function leaves its inputs untouched and
    returns the updated buffers.
    """
    dev = resolve_device(device)
    W = params.wg_threads

    shared_bufs: Dict[str, Tuple[int, torch.dtype]] = {}
    for g in kernel_fn.shared:
        shared_bufs[f"@{g.name}"] = (g.size, _TY_DTYPE[g.elem_ty])
    if module is not None:
        for g in module.globals.values():
            shared_bufs.setdefault(f"@{g.name}",
                                   (g.size, _TY_DTYPE[g.elem_ty]))

    def wg_fn(gx: int, buffers: Dict[str, torch.Tensor],
              scalars: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        groups = torch.full((1, 1), gx, dtype=torch.int32, device=dev)
        intr = intrinsics(params, groups, W)
        argmap = scalar_lanes(kernel_fn, scalars, 1, W, dev)
        low = _FnLowering(kernel_fn, 1, W, intr, argmap, dev,
                          scalarize_uniform)
        bufs = {k: v.unsqueeze(0) for k, v in buffers.items()}
        for nm, (size, dt) in shared_bufs.items():
            bufs[nm] = torch.zeros((1, size), dtype=dt, device=dev)
        st = _State({}, bufs, torch.ones((1, W), dtype=torch.bool,
                                         device=dev))
        kind, _, out = low.walk(kernel_fn.entry, 0, st, None)
        if kind != "ret":
            raise LowerError(f"kernel walk ended with {kind}")
        return {k: v.squeeze(0) for k, v in out.bufs.items() if k in buffers}

    def run(buffers: Dict[str, torch.Tensor],
            scalars: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        for nm, t in buffers.items():
            if t.device.type != dev.type:
                raise ValueError(f"buffer {nm} is on {t.device}, kernel "
                                 f"compiled for {dev}")
        bufs = dict(buffers)
        for g in range(params.grid):
            bufs = wg_fn(g, bufs, scalars)
        return bufs

    return TorchKernel(run, wg_fn, params)
