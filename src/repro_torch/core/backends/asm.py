"""Vortex-flavored assembly emission + static instruction counting.

Produces the Fig 2-style machine text: RISC-V-ish mnemonics plus the Vortex
ISA extensions (vx_split/vx_join/vx_pred/vx_tmc/vx_barrier/vx_vote/vx_shfl/
vx_move).  Used for golden tests (the paper's Fig 2 shapes) and the static
instruction-count metric.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

from ..vir import Block, Const, Function, Instr, Op, Param, Reg, Slot, Value

_MNEMONIC = {
    Op.ADD: "add", Op.SUB: "sub", Op.MUL: "mul", Op.DIV: "div",
    Op.MOD: "rem", Op.AND: "and", Op.OR: "or", Op.XOR: "xor",
    Op.SHL: "sll", Op.SHR: "srl", Op.MIN: "min", Op.MAX: "max",
    Op.POW: "call @powf", Op.EQ: "seq", Op.NE: "sne", Op.LT: "slt",
    Op.LE: "sle", Op.GT: "sgt", Op.GE: "sge", Op.NEG: "neg",
    Op.NOT: "not", Op.ABS: "abs", Op.SQRT: "call @sqrtf",
    Op.EXP: "call @expf", Op.LOG: "call @logf", Op.SIN: "call @sinf",
    Op.COS: "call @cosf", Op.ITOF: "fcvt.s.w", Op.FTOI: "fcvt.w.s",
    Op.SELECT: "select", Op.CMOV: "vx_move", Op.LOAD: "lw",
    Op.STORE: "sw", Op.SLOT_LOAD: "lw.sp", Op.SLOT_STORE: "sw.sp",
    Op.ATOMIC: "amo", Op.INTR: "csrr", Op.VOTE: "vx_vote",
    Op.SHFL: "vx_shfl", Op.BARRIER: "vx_barrier", Op.PRINT: "call @print",
    Op.CALL: "call", Op.BR: "j", Op.CBR: "bnez", Op.RET: "ret",
    Op.POPC: "vx_popc", Op.FFS: "vx_ffs", Op.SPLIT: "vx_split", Op.JOIN: "vx_join", Op.PRED: "vx_pred",
    Op.TMC_SAVE: "vx_tmc.save", Op.TMC_RESTORE: "vx_tmc.restore",
}


def _opn(o) -> str:
    if isinstance(o, Block):
        return o.label
    if isinstance(o, Const):
        return str(o.value)
    if isinstance(o, Slot):
        return f"[{o.name}]"
    if isinstance(o, Function):
        return f"@{o.name}"
    if isinstance(o, Value):
        return o.short()
    return str(o)


def emit_asm(fn: Function) -> str:
    lines = [f".kernel {fn.name}"]
    for b in fn.blocks:
        lines.append(f"{b.label}:")
        for i in b.instrs:
            mn = _MNEMONIC.get(i.op, i.op.value)
            ops = ", ".join(_opn(o) for o in i.operands)
            res = f"{i.result.short()} = " if i.result is not None else ""
            neg = " !neg" if i.attrs.get("negate") else ""
            lines.append(f"    {res}{mn} {ops}{neg}")
    return "\n".join(lines)


def static_counts(fn: Function) -> Counter:
    c: Counter = Counter()
    for i in fn.instructions():
        c[i.op.value] += 1
    c["__total__"] = sum(v for k, v in c.items() if k != "__total__")
    return c
