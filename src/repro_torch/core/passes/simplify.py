"""Code and CFG simplification (paper §4.3.2, first stage).

  * constant folding + copy-style algebraic identities
  * dead code elimination (pure instrs with unused results)
  * cbr-on-constant folding, unreachable-block elimination
  * straight-line block merging
  * single-exit canonicalization (merge multiple returns into one exit
    block via a return-value slot -- the paper's "merge functions with
    multiple return instructions into one exit block")

min/max/select normalization lives in zicond.py because it depends on
uniformity results and the target's native-support flags.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..vir import (Block, Const, Function, Instr, Module, Op, Reg, Slot, Ty,
                   Value)
from .. import graph
from .analysis import AnalysisManager, ensure_manager

_PURE = {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD, Op.AND, Op.OR, Op.XOR,
         Op.SHL, Op.SHR, Op.MIN, Op.MAX, Op.POW, Op.EQ, Op.NE, Op.LT,
         Op.LE, Op.GT, Op.GE, Op.NEG, Op.NOT, Op.ABS, Op.SQRT, Op.EXP,
         Op.LOG, Op.SIN, Op.COS, Op.ITOF, Op.FTOI, Op.SELECT, Op.CMOV,
         Op.SLOT_LOAD, Op.INTR, Op.LOAD}
# LOAD is treated as removable-if-unused (no volatile semantics in VIR).


def _fold_binop(op: Op, a: Const, b: Const) -> Optional[Const]:
    x, y = a.value, b.value
    try:
        if op is Op.ADD: r = x + y
        elif op is Op.SUB: r = x - y
        elif op is Op.MUL: r = x * y
        elif op is Op.DIV:
            if y == 0: return None
            r = x / y if a.ty is Ty.F32 or b.ty is Ty.F32 else int(x / y)
        elif op is Op.MOD:
            if y == 0: return None
            r = x % y
        elif op is Op.AND: r = (x and y) if a.ty is Ty.BOOL else (x & y)
        elif op is Op.OR: r = (x or y) if a.ty is Ty.BOOL else (x | y)
        elif op is Op.XOR: r = (bool(x) != bool(y)) if a.ty is Ty.BOOL else (x ^ y)
        elif op is Op.SHL: r = x << y
        elif op is Op.SHR: r = x >> y
        elif op is Op.MIN: r = min(x, y)
        elif op is Op.MAX: r = max(x, y)
        elif op is Op.POW: r = float(x) ** float(y)
        elif op is Op.EQ: return Const(x == y, Ty.BOOL)
        elif op is Op.NE: return Const(x != y, Ty.BOOL)
        elif op is Op.LT: return Const(x < y, Ty.BOOL)
        elif op is Op.LE: return Const(x <= y, Ty.BOOL)
        elif op is Op.GT: return Const(x > y, Ty.BOOL)
        elif op is Op.GE: return Const(x >= y, Ty.BOOL)
        else: return None
    except Exception:
        return None
    ty = Ty.F32 if (a.ty is Ty.F32 or b.ty is Ty.F32) else a.ty
    if ty is Ty.I32:
        r = int(r)
    return Const(r, ty)


def _fold_unop(op: Op, a: Const) -> Optional[Const]:
    import math
    x = a.value
    try:
        if op is Op.NEG: return Const(-x, a.ty)
        if op is Op.NOT:
            return Const(not x, Ty.BOOL) if a.ty is Ty.BOOL else Const(~x, a.ty)
        if op is Op.ABS: return Const(abs(x), a.ty)
        if op is Op.SQRT: return Const(math.sqrt(x), Ty.F32)
        if op is Op.EXP: return Const(math.exp(x), Ty.F32)
        if op is Op.LOG: return Const(math.log(x), Ty.F32) if x > 0 else None
        if op is Op.SIN: return Const(math.sin(x), Ty.F32)
        if op is Op.COS: return Const(math.cos(x), Ty.F32)
        if op is Op.ITOF: return Const(float(x), Ty.F32)
        if op is Op.FTOI: return Const(int(x), Ty.I32)
    except Exception:
        return None
    return None


def constant_fold(fn: Function) -> int:
    """Fold constant expressions; propagate into uses. Returns #folds."""
    folds = 0
    replaced: Dict[int, Const] = {}

    def subst(v):
        while isinstance(v, Reg) and id(v) in replaced:
            v = replaced[id(v)]
        return v

    changed = True
    while changed:
        changed = False
        for b in fn.blocks:
            for i in b.instrs:
                if replaced:
                    i.operands = [subst(o) for o in i.operands]
                if i.result is None:
                    continue
                c: Optional[Const] = None
                from ..vir import BINOPS, UNOPS
                if i.op in BINOPS and all(isinstance(o, Const) for o in i.operands[:2]):
                    c = _fold_binop(i.op, i.operands[0], i.operands[1])
                elif i.op in UNOPS and isinstance(i.operands[0], Const):
                    c = _fold_unop(i.op, i.operands[0])
                elif i.op is Op.SELECT and isinstance(i.operands[0], Const):
                    c = i.operands[1] if i.operands[0].value else i.operands[2]
                    if not isinstance(c, Const):
                        # replace with the chosen value directly
                        replaced[id(i.result)] = c  # type: ignore[assignment]
                        i.op = Op.SLOT_LOAD  # tombstone; DCE will drop
                        i.operands = []
                        i.result = None
                        changed = True
                        folds += 1
                        continue
                # algebraic identities
                elif i.op is Op.AND and i.operands[0] is i.operands[1]:
                    pass
                if c is not None:
                    replaced[id(i.result)] = c
                    i.result = None
                    i.op = Op.SLOT_LOAD  # tombstone
                    i.operands = []
                    changed = True
                    folds += 1
        # strip tombstones
        for b in fn.blocks:
            b.instrs = [i for i in b.instrs
                        if not (i.op is Op.SLOT_LOAD and not i.operands)]
    if folds:
        fn.bump_version(cfg=False)   # instr rewrites only; edges unchanged
    return folds


def dce(fn: Function) -> int:
    """Remove pure instructions whose results are never used."""
    removed = 0
    changed = True
    while changed:
        changed = False
        used: set = set()
        for i in fn.instructions():
            for o in i.value_operands():
                if isinstance(o, Reg):
                    used.add(id(o))
        for b in fn.blocks:
            keep: List[Instr] = []
            for i in b.instrs:
                if (i.result is not None and id(i.result) not in used
                        and i.op in _PURE):
                    removed += 1
                    changed = True
                else:
                    keep.append(i)
            b.instrs = keep
    if removed:
        fn.bump_version(cfg=False)
    return removed


def dead_slot_elim(fn: Function) -> int:
    """Remove stores to slots that are never loaded."""
    loaded = set()
    for i in fn.instructions():
        if i.op is Op.SLOT_LOAD:
            loaded.add(id(i.operands[0]))
    removed = 0
    for b in fn.blocks:
        keep = []
        for i in b.instrs:
            if i.op is Op.SLOT_STORE and id(i.operands[0]) not in loaded:
                removed += 1
            else:
                keep.append(i)
        b.instrs = keep
    fn.slots = [s for s in fn.slots if id(s) in loaded]
    if removed:
        fn.bump_version(cfg=False)
    return removed


def fold_const_branches(fn: Function) -> int:
    n = 0
    for b in fn.blocks:
        t = b.terminator
        if t is not None and t.op is Op.CBR and isinstance(t.operands[0], Const):
            target = t.operands[1] if t.operands[0].value else t.operands[2]
            b.instrs[-1] = Instr(Op.BR, [target])
            b.instrs[-1].parent = b
            n += 1
    if n:
        fn.bump_version()           # edges changed
        fn.drop_unreachable()
    return n


def merge_straightline(fn: Function,
                       am: Optional[AnalysisManager] = None) -> int:
    """Merge B -> C when B's only succ is C and C's only pred is B."""
    am = ensure_manager(am)
    n = 0
    changed = True
    while changed:
        changed = False
        preds = am.predecessors(fn)
        for b in fn.blocks:
            t = b.terminator
            if t is None or t.op is not Op.BR:
                continue
            c = t.operands[0]
            if c is b or c is fn.entry:
                continue
            if len(preds.get(c, [])) != 1:
                continue
            # merge c into b
            b.instrs.pop()
            for i in c.instrs:
                i.parent = b
                b.instrs.append(i)
            fn.blocks.remove(c)
            fn.bump_version()
            n += 1
            changed = True
            break
    return n


def single_exit(fn: Function) -> bool:
    """Canonicalize multiple RETs into one exit block (paper §4.3.2)."""
    rets = [b for b in fn.blocks
            if b.terminator is not None and b.terminator.op is Op.RET]
    if len(rets) <= 1:
        return False
    exit_bb = fn.new_block("exit")
    retslot: Optional[Slot] = None
    if fn.ret_ty is not Ty.VOID:
        retslot = fn.new_slot("__retx", fn.ret_ty)
        load = Instr(Op.SLOT_LOAD, [retslot], Reg(fn.ret_ty))
        exit_bb.append(load)
        exit_bb.append(Instr(Op.RET, [load.result]))
    else:
        exit_bb.append(Instr(Op.RET, []))
    for b in rets:
        ret = b.instrs.pop()
        if retslot is not None and ret.operands:
            b.append(Instr(Op.SLOT_STORE, [retslot, ret.operands[0]]))
        b.append(Instr(Op.BR, [exit_bb]))
    return True


def run_simplify(fn: Function,
                 am: Optional[AnalysisManager] = None) -> Dict[str, int]:
    am = ensure_manager(am)
    stats = {
        "constfold": constant_fold(fn),
        "cbr_fold": fold_const_branches(fn),
        "unreachable": fn.drop_unreachable(),
        "single_exit": int(single_exit(fn)),
        "merged": merge_straightline(fn, am),
        "dce": dce(fn),
        "dead_slots": dead_slot_elim(fn),
    }
    stats["dce2"] = dce(fn)
    return stats
