"""CUDA C++ code generator for divergence-managed VIR.

Walks a kernel in the same order as ``torch_backend._FnLowering.walk``
(itself the reference's ``jax_backend._FnLowering.walk``) and emits one
``__global__`` function: one CTA per workgroup, one thread per lane.

The code is lockstep-predicated. Each thread carries its own ``bool m``
(its bit of the thread mask) and every thread executes every linearized
region, so control flow is uniform across the CTA and barriers and
block-wide votes are legal everywhere:

  * split diamonds run the then side under ``m && p``, then the else side
    under ``m && !p`` (it sees the then side's writes), then restore ``m``;
  * loops re-run their header on every trip and continue while any thread
    of the CTA has ``c && m`` (``__syncthreads_or``); ``vx_pred`` loops
    narrow ``m`` in the body and restore the entry mask on exit;
  * a STORE updates the whole tile before the next instruction runs, so
    it sits between two ``__syncthreads()`` (write-after-read before,
    read-after-write after), on global tiles and ``__shared__`` arrays
    alike;
  * scalars are kernel arguments, so a new ``n`` does not rebuild.

The helpers the emitted code calls are in ``csrc/simt_runtime.cuh``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core import graph
from ...core.backends.torch_backend import LowerError
from ...core.interp import LaunchParams
from ...core.vir import (BINOPS, CMPOPS, UNOPS, Block, Const, Function,
                         GlobalVar, Instr, Op, Param, Reg, Ty, Value)

_CTYPE = {Ty.I32: "int", Ty.F32: "float", Ty.BOOL: "bool"}
_ZERO = {"int": "0", "float": "0.0f", "bool": "false"}
_CMP_SYM = {Op.EQ: "==", Op.NE: "!=", Op.LT: "<", Op.LE: "<=", Op.GT: ">",
            Op.GE: ">="}

#: intrinsic (name, dim) -> C expression; the 1-D table of the tiled
#: kernel (reference ``simt_exec.py:77-96``), helpers in the header
_INTR = {
    ("local_id", 0): "vx_local_id<VX_LS>()",
    ("local_id", 1): "0",
    ("lane_id", 0): "vx_lane_id<VX_WS>()",
    ("group_id", 0): "vx_group_id()",
    ("group_id", 1): "0",
    ("global_id", 0): "vx_global_id<VX_LS>()",
    ("global_id", 1): "0",
    ("local_size", 0): "VX_LS",
    ("local_size", 1): "1",
    ("num_groups", 0): "vx_num_groups()",
    ("num_groups", 1): "1",
    ("global_size", 0): "vx_global_size<VX_LS>()",
    ("global_size", 1): "1",
    ("num_threads", 0): "VX_WS",
    ("num_warps", 0): "VX_NW",
    ("warp_id", 0): "vx_warp_id<VX_WS>()",
    ("core_id", 0): "vx_core_id()",
    ("grid_dim", 0): "vx_num_groups()",
}


def _promote(a: str, b: str) -> str:
    if "float" in (a, b):
        return "float"
    if "int" in (a, b):
        return "int"
    return "bool"


def _cast(expr: str, src: str, dst: str) -> str:
    """Convert as jnp's ``astype`` does."""
    if src == dst:
        return expr
    if dst == "bool":
        return f"({expr} != {_ZERO[src]})"
    if src == "bool":
        return f"({expr} ? 1.0f : 0.0f)" if dst == "float" else f"((int){expr})"
    if dst == "float":
        return f"vx_itof({expr})"
    return f"vx_ftoi({expr})"


def _literal(v: Const) -> Tuple[str, str]:
    ct = _CTYPE.get(v.ty, "float")
    if ct == "bool":
        return ("true" if v.value else "false"), ct
    if ct == "int":
        x = (int(v.value) + 2**31) % 2**32 - 2**31
        return (f"({x})" if x != -2**31 else "(-2147483647 - 1)"), ct
    f = float(np.float32(v.value))
    if math.isnan(f):
        return "__int_as_float(0x7fc00000)", ct
    if math.isinf(f):
        return ("__int_as_float(0x7f800000)" if f > 0
                else "__int_as_float((int)0xff800000)"), ct
    return f"({f.hex()}f)", ct


class _Emitter:
    """Emits the body of one function (the kernel or a device callee)."""

    def __init__(self, gen: "_Generator", fn: Function,
                 argexpr: Dict[int, Tuple[str, str]]) -> None:
        self.gen = gen
        self.fn = fn
        self.argexpr = argexpr          # id(Param) -> (C name, C type)
        self.lines: List[str] = []
        self.depth = 1
        self.regs: Dict[int, Tuple[str, str]] = {}
        self.decls: List[str] = []
        self.slots = {id(s): (f"sl{k}", _CTYPE[s.ty])
                      for k, s in enumerate(fn.slots)}
        self.ntmp = 0
        self.loops = graph.natural_loops(fn)
        self.headers = {id(l.header): l for l in self.loops}
        self.pdom = graph.postdominators(fn)
        self.ret: Optional[Tuple[str, str]] = None

    # -- output --------------------------------------------------------------
    def emit(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def tmp(self, stem: str) -> str:
        self.ntmp += 1
        return f"{stem}{self.ntmp}"

    def define(self, i: Instr, expr: str, ct: str) -> None:
        if i.result is None:
            return
        # a loop header's prefix is walked once on the way in and again
        # on every trip: the same register
        if id(i.result) not in self.regs:
            name = f"r{len(self.regs)}"
            self.regs[id(i.result)] = (name, ct)
            self.decls.append(f"{ct} {name} = {_ZERO[ct]};")
        self.emit(f"{self.regs[id(i.result)][0]} = {expr};")

    def body(self) -> List[str]:
        """Declarations of every register and slot, then the code."""
        pre = ["  " + d for d in self.decls]
        pre += [f"  {ct} {nm} = {_ZERO[ct]};"
                for nm, ct in self.slots.values()]
        return pre + self.lines

    # -- values --------------------------------------------------------------
    def val(self, v: Value) -> Tuple[str, str]:
        if isinstance(v, Const):
            return _literal(v)
        if isinstance(v, Reg):
            return self.regs[id(v)]
        if isinstance(v, Param):
            a = self.argexpr.get(id(v))
            if a is None:
                raise LowerError(f"unbound param {v.name}")
            if v.ty is Ty.PTR:
                raise LowerError(f"pointer param {v.name} used as value")
            return a
        raise LowerError(f"cannot lower value {v!r}")

    def val_as(self, v: Value, ct: str) -> str:
        e, t = self.val(v)
        return _cast(e, t, ct)

    def buffer(self, ptr: Value) -> Tuple[str, str, str, bool]:
        """(C pointer, C element type, window length, tiled?)"""
        if isinstance(ptr, Param):
            b = self.gen.tiles.get(ptr.name)
            if b is None or id(ptr) not in self.argexpr:
                raise LowerError(f"pointer param {ptr.name} not bound to "
                                 "a kernel buffer")
            return b[0], b[1], "VX_W", True
        if isinstance(ptr, GlobalVar):
            sh = self.gen.shared.get(ptr.name)
            if sh is None or self.fn is not self.gen.kernel:
                raise LowerError(f"@{ptr.name} is not a shared array of "
                                 "the kernel")
            return sh[0], sh[1], str(sh[2]), False
        raise LowerError(f"bad pointer {ptr!r}")

    # -- the walker ------------------------------------------------------------
    def walk(self, block: Block, pos: int,
             stop_block: Optional[Block]) -> Tuple[str, object]:
        while True:
            if stop_block is not None and block is stop_block and pos == 0:
                return ("stop", (block, 0))
            i = block.instrs[pos]
            op = i.op
            if op is Op.BR:
                block, pos = i.operands[0], 0
                continue
            if op is Op.RET:
                if i.operands:
                    self.ret = self.val(i.operands[0])
                return ("ret", None)
            if op is Op.JOIN:
                return ("join", (block, pos))
            if op is Op.SPLIT:
                self._split(block, pos, i)
                ip = i.attrs.get("ipdom")
                if ip is None:
                    raise LowerError("vx_split without ipdom annotation")
                block, pos = ip, 0
                continue
            if op is Op.PRED:
                if self.headers.get(id(block)) is None:
                    raise LowerError("vx_pred outside loop header")
                self._loop(block, i, True, i.operands[2])
                block, pos = i.operands[3], 0
                continue
            if op is Op.CBR:
                loop = self.headers.get(id(block))
                if loop is not None and any(
                        not loop.contains(s) for s in block.successors()):
                    then_bb, else_bb = i.operands[1], i.operands[2]
                    inside_then = loop.contains(then_bb)
                    fake = Instr(i.op, i.operands, None,
                                 {**i.attrs, "negate": not inside_then})
                    inside = then_bb if inside_then else else_bb
                    self._loop(block, fake, False, inside)
                    block, pos = (else_bb if inside_then else then_bb), 0
                    continue
                block, pos = self._uniform_branch(block, i), 0
                continue
            if op is Op.TMC_SAVE:
                self.define(i, "m", "bool")
                pos += 1
                continue
            if op is Op.TMC_RESTORE:
                self.emit(f"m = {self.val_as(i.operands[0], 'bool')};")
                pos += 1
                continue
            self._simple(i)
            pos += 1

    def _two_sides(self, cond: str, then_bb: Block, else_bb: Block,
                   stop: Optional[Block], expect: str, tok: int = 0) -> None:
        e, p = self.tmp("e"), self.tmp("p")
        self.emit(f"{{ const bool {e} = m; const bool {p} = {cond};")
        self.depth += 1
        for side, guard in ((then_bb, p), (else_bb, f"!{p}")):
            self.emit(f"m = {e} && {guard};")
            kind, where_ = self.walk(side, 0, stop)
            if kind != expect:
                raise LowerError(f"side walk ended with {kind}, "
                                 f"expected {expect}")
            if expect == "join":
                jb, jp = where_
                if id(jb.instrs[jp].operands[0]) != tok:
                    raise LowerError("join token mismatch during lowering "
                                     "(structurization bug)")
        self.emit(f"m = {e};")
        self.depth -= 1
        self.emit("}")

    def _split(self, block: Block, pos: int, split: Instr) -> None:
        cbr = block.instrs[pos + 1]
        if cbr.op is not Op.CBR:
            raise LowerError("vx_split not followed by branch")
        sp = self.val_as(split.operands[0], "bool")
        if split.attrs.get("negate", False):
            sp = f"!{sp}"
        self._two_sides(sp, cbr.operands[1], cbr.operands[2], None, "join",
                        id(split.result))

    def _uniform_branch(self, block: Block, cbr: Instr) -> Block:
        merge = self.pdom.immediate(block)
        if merge is None:
            raise LowerError("uniform branch without IPDOM")
        c = self.val_as(cbr.operands[0], "bool")
        self._two_sides(c, cbr.operands[1], cbr.operands[2], merge, "stop")
        return merge

    def _loop(self, header: Block, term: Instr, divergent: bool,
              inside: Block) -> None:
        e, c = self.tmp("e"), self.tmp("c")
        self.emit(f"{{ const bool {e} = m;")
        self.depth += 1
        self.emit("while (true) {")
        self.depth += 1
        for i in header.instrs[:-1]:
            if i.op in (Op.STORE, Op.ATOMIC, Op.BARRIER, Op.SLOT_STORE,
                        Op.CALL):
                raise LowerError("state-changing op in loop header")
            if i.op is Op.SPLIT:
                continue
            self._simple(i)
        cond = self.val_as(term.operands[0], "bool")
        if term.attrs.get("negate", False):
            cond = f"!{cond}"
        self.emit(f"const bool {c} = {cond};")
        self.emit(f"if (!__syncthreads_or({c} && m)) break;")
        if divergent:
            self.emit(f"m = m && {c};")
        kind, _ = self.walk(inside, 0, header)
        if kind != "stop":
            raise LowerError(f"loop body walk ended with {kind}")
        self.depth -= 1
        self.emit("}")
        self.emit(f"m = {e};")
        self.depth -= 1
        self.emit("}")

    # -- straight-line ops ----------------------------------------------------------
    def _simple(self, i: Instr) -> None:
        op = i.op
        if op is Op.SLOT_LOAD:
            self.define(i, *self.slots[id(i.operands[0])])
            return
        if op is Op.SLOT_STORE:
            nm, ct = self.slots[id(i.operands[0])]
            self.emit(f"if (m) {nm} = {self.val_as(i.operands[1], ct)};")
            return
        if op is Op.LOAD:
            ptr, ct, n, tiled = self.buffer(i.operands[0])
            ix = self.val_as(i.operands[1], "int")
            if tiled:
                ix = f"vx_isub({ix}, vx_off)"
            self.define(i, f"vx_load({ptr}, {ix}, {n})", ct)
            return
        if op is Op.STORE:
            ptr, ct, n, tiled = self.buffer(i.operands[0])
            ix = self.val_as(i.operands[1], "int")
            if tiled:
                ix = f"vx_isub({ix}, vx_off)"
            v = self.val_as(i.operands[2], ct)
            self.emit("__syncthreads();")
            self.emit(f"vx_store<{ct}>({ptr}, {ix}, {n}, m, {v});")
            self.emit("__syncthreads();")
            return
        if op is Op.ATOMIC:
            raise NotImplementedError(
                "atomic kernels are not tileable; use compile_torch")
        if op is Op.INTR:
            key = (i.operands[0], i.operands[1])
            if key not in _INTR:
                raise LowerError(f"intrinsic {key} not provided")
            self.define(i, _INTR[key], "int")
            return
        if op is Op.VOTE:
            mode = i.operands[0]
            v = self.val_as(i.operands[1], "bool")
            if mode == "any":
                self.define(i, f"vx_vote_any({v}, m)", "bool")
            elif mode == "all":
                self.define(i, f"vx_vote_all({v}, m)", "bool")
            elif mode == "ballot":
                if self.gen.W > 32:
                    raise LowerError(f"ballot needs W <= 32, got {self.gen.W}")
                self.define(i, f"vx_ballot<VX_W>({v}, m)", "int")
            else:
                raise LowerError(f"vote {mode}")
            return
        if op is Op.SHFL:
            self.gen.uses_shfl = True
            e, ct = self.val(i.operands[0])
            src = self.val_as(i.operands[1], "int")
            if ct == "float":
                self.define(i, f"vx_shfl_f<VX_W>({e}, {src}, vx_stage)", ct)
            else:
                r = f"vx_shfl_i<VX_W>({_cast(e, ct, 'int')}, {src}, vx_stage)"
                self.define(i, r if ct == "int" else f"({r} != 0)", ct)
            return
        if op is Op.BARRIER:
            self.emit("__syncthreads();")
            return
        if op is Op.PRINT:
            return
        if op is Op.CALL:
            callee: Function = i.operands[0]
            name, params, ret_ct = self.gen.device_fn(callee)
            args = ["m"] + [self.val_as(a, ct)
                            for a, ct in zip(i.operands[1:], params)]
            call = f"{name}({', '.join(args)})"
            if i.result is None:
                self.emit(f"{call};")
            else:
                self.define(i, call, ret_ct)
            return
        if op in (Op.SELECT, Op.CMOV):
            c = self.val_as(i.operands[0], "bool")
            (a, ta), (b, tb) = self.val(i.operands[1]), self.val(i.operands[2])
            ct = _promote(ta, tb)
            self.define(i, f"({c} ? {_cast(a, ta, ct)} : {_cast(b, tb, ct)})",
                        ct)
            return
        if op in BINOPS:
            self.define(i, *self._binop(op, *self.val(i.operands[0]),
                                        *self.val(i.operands[1])))
            return
        if op in UNOPS:
            self.define(i, *self._unop(op, *self.val(i.operands[0])))
            return
        raise LowerError(f"unhandled op in CUDA lowering: {op}")

    @staticmethod
    def _binop(op: Op, a: str, ta: str, b: str, tb: str) -> Tuple[str, str]:
        t = _promote(ta, tb)
        x, y = _cast(a, ta, t), _cast(b, tb, t)
        if op in CMPOPS:
            return f"({x} {_CMP_SYM[op]} {y})", "bool"
        if op is Op.POW:
            return (f"powf({_cast(a, ta, 'float')}, {_cast(b, tb, 'float')})",
                    "float")
        table = {
            "int": {Op.ADD: "vx_iadd({x}, {y})", Op.SUB: "vx_isub({x}, {y})",
                    Op.MUL: "vx_imul({x}, {y})", Op.DIV: "vx_idiv({x}, {y})",
                    Op.MOD: "vx_imod({x}, {y})", Op.AND: "({x} & {y})",
                    Op.OR: "({x} | {y})", Op.XOR: "({x} ^ {y})",
                    Op.SHL: "vx_shl({x}, {y})", Op.SHR: "vx_shr({x}, {y})",
                    Op.MIN: "min({x}, {y})", Op.MAX: "max({x}, {y})"},
            "float": {Op.ADD: "({x} + {y})", Op.SUB: "({x} - {y})",
                      Op.MUL: "({x} * {y})", Op.DIV: "vx_fdiv({x}, {y})",
                      Op.MOD: "vx_fmod({x}, {y})",
                      Op.MIN: "vx_fmin({x}, {y})",
                      Op.MAX: "vx_fmax({x}, {y})"},
            "bool": {Op.AND: "({x} && {y})", Op.OR: "({x} || {y})",
                     Op.XOR: "({x} != {y})", Op.MIN: "({x} && {y})",
                     Op.MAX: "({x} || {y})"},
        }[t]
        if op not in table:
            raise LowerError(f"binop {op} on {t}")
        return table[op].format(x=x, y=y), t

    @staticmethod
    def _unop(op: Op, a: str, t: str) -> Tuple[str, str]:
        f = _cast(a, t, "float")
        i = _cast(a, t, "int")
        if op is Op.NEG:
            if t == "bool":
                raise LowerError("neg on bool")
            return (f"vx_ineg({a})" if t == "int" else f"(-{a})"), t
        if op is Op.NOT:
            if t == "float":
                raise LowerError("not on float")
            return (f"(!{a})" if t == "bool" else f"(~{a})"), t
        if op is Op.ABS:
            if t == "bool":
                return a, t
            return (f"vx_iabs({a})" if t == "int" else f"fabsf({a})"), t
        fl = {Op.SQRT: "vx_sqrt", Op.EXP: "expf", Op.LOG: "vx_log",
              Op.SIN: "sinf", Op.COS: "cosf"}
        if op in fl:
            return f"{fl[op]}({f})", "float"
        if op is Op.ITOF:
            return f, "float"
        if op is Op.FTOI:
            return i, "int"
        if op is Op.POPC:
            return f"vx_popc({i})", "int"
        if op is Op.FFS:
            return f"vx_ffs({i})", "int"
        raise LowerError(f"unop {op}")


class _Generator:
    """Emits a whole translation unit: device callees, the kernel and its
    ``extern "C"`` launcher."""

    def __init__(self, fn: Function, params: LaunchParams,
                 buf_ctypes: Dict[str, str]) -> None:
        self.kernel = fn
        self.W = params.wg_threads
        self.params = params
        self.uses_shfl = False
        self.device_fns: Dict[str, Tuple[str, List[str], str]] = {}
        self.device_src: List[str] = []
        self.bufs = [p for p in fn.params if p.ty is Ty.PTR]
        self.scalars = [p for p in fn.params if p.ty is not Ty.PTR]
        self.tiles = {p.name: (f"t{k}", buf_ctypes[p.name])
                      for k, p in enumerate(self.bufs)}
        self.shared = {g.name: (f"sh{k}", _CTYPE[g.elem_ty], g.size)
                       for k, g in enumerate(fn.shared)}

    def device_fn(self, callee: Function) -> Tuple[str, List[str], str]:
        """Emit ``callee`` as a ``__device__`` function taking the mask."""
        if callee.name in self.device_fns:
            return self.device_fns[callee.name]
        argexpr, sig, cts = {}, ["bool m"], []
        for k, p in enumerate(callee.params):
            if p.ty is Ty.PTR:
                # the reference lowers callees without the tile offsets
                # (they would index a tile with a global index)
                raise LowerError(f"pointer argument {p.name} of "
                                 f"@{callee.name} under tile windows")
            ct = _CTYPE[p.ty]
            argexpr[id(p)] = (f"a{k}", ct)
            sig.append(f"{ct} a{k}")
            cts.append(ct)
        em = _Emitter(self, callee, argexpr)
        kind, _ = em.walk(callee.entry, 0, None)
        if kind != "ret":
            raise LowerError(f"callee walk ended with {kind}")
        ret_e, ret_ct = em.ret if em.ret is not None else ("0.0f", "float")
        name = f"f_{callee.name}"
        self.device_src += [f"// device function @{callee.name}",
                            f"__device__ {ret_ct} {name}({', '.join(sig)}) {{"]
        self.device_src += em.body()
        self.device_src += [f"  return {ret_e};", "}", ""]
        self.device_fns[callee.name] = (name, cts, ret_ct)
        return self.device_fns[callee.name]

    def source(self) -> str:
        fn, W, p = self.kernel, self.W, self.params
        argexpr = {id(s): (f"s{k}", _CTYPE[s.ty])
                   for k, s in enumerate(self.scalars)}
        argexpr.update({id(b): (self.tiles[b.name][0], "ptr")
                        for b in self.bufs})
        em = _Emitter(self, fn, argexpr)
        kind, _ = em.walk(fn.entry, 0, None)
        if kind != "ret":
            raise LowerError(f"kernel walk ended with {kind}")

        sig = [f"{ct}* b{k}" for k, (_, ct) in enumerate(self.tiles.values())]
        sig += [f"{_CTYPE[s.ty]} s{k}" for k, s in enumerate(self.scalars)]
        kname = f"volt_{fn.name}"
        out = [f"// VIR kernel @{fn.name}: one CTA per workgroup of {W} "
               "lanes, one thread per lane.",
               '#include "simt_runtime.cuh"', "",
               f"constexpr int VX_W = {W};",
               f"constexpr int VX_LS = {p.local_size};",
               f"constexpr int VX_WS = {p.warp_size};",
               f"constexpr int VX_NW = {p.warps_per_wg};", ""]
        if self.uses_shfl:
            out += ["__shared__ int vx_stage[VX_W];", ""]
        out += self.device_src
        for k, b in enumerate(self.bufs):
            out.append(f"// b{k}: buffer {b.name}")
        for k, s in enumerate(self.scalars):
            out.append(f"// s{k}: scalar {s.name}")
        out += [f'extern "C" __global__ void __launch_bounds__(VX_W) '
                f"{kname}({', '.join(sig)}) {{",
                "  const int vx_off = vx_imul((int)blockIdx.x, VX_W);"]
        for k, (t, ct) in enumerate(self.tiles.values()):
            out.append(f"  {ct}* {t} = b{k} + (size_t)blockIdx.x * VX_W;")
        for sh, ct, size in self.shared.values():
            out += [f"  __shared__ {ct} {sh}[{size}];",
                    f"  for (int k = threadIdx.x; k < {size}; k += VX_W) "
                    f"{sh}[k] = {_ZERO[ct]};"]
        if self.shared:
            out.append("  __syncthreads();")
        out.append("  bool m = true;")
        out += em.body()
        out += ["}", "",
                'extern "C" int launch(void** bufs, const void* scalars, '
                "int grid, void* stream) {",
                "  const char* sc = (const char*)scalars;"]
        args = [f"({ct}*)bufs[{k}]"
                for k, (_, ct) in enumerate(self.tiles.values())]
        for k, s in enumerate(self.scalars):
            ct = _CTYPE[s.ty]
            if ct == "bool":
                out.append(f"  int s{k}_i; memcpy(&s{k}_i, sc + {4 * k}, 4);")
                args.append(f"s{k}_i != 0")
            else:
                out.append(f"  {ct} s{k}; memcpy(&s{k}, sc + {4 * k}, 4);")
                args.append(f"s{k}")
        out += ["  (void)sc;",
                f"  {kname}<<<grid, VX_W, 0, (cudaStream_t)stream>>>"
                f"({', '.join(args)});",
                "  return (int)cudaGetLastError();", "}", ""]
        return "\n".join(out)


def emit_kernel(fn: Function, params: LaunchParams,
                buf_ctypes: Dict[str, str]) -> str:
    """CUDA C++ source for the tiled kernel ``fn``.

    ``buf_ctypes`` maps each pointer param to ``"float"`` or ``"int"``.
    The source exports ``extern "C" int launch(void** bufs, const void*
    scalars, int grid, void* stream)``: ``bufs`` holds the device pointers
    of the pointer params in order, ``scalars`` the scalar params packed
    as 4-byte values in order (int32, float32, or int32 0/1 for bool).
    """
    W = params.wg_threads
    if W > 1024:
        raise LowerError(f"a workgroup of {W} lanes exceeds 1024 threads")
    return _Generator(fn, params, buf_ctypes).source()
