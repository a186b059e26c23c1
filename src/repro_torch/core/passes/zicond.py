"""select/min/max normalization and the ZiCond/CMOV ISA-extension path
(paper §4.3.2 "Code and CFG Simplification" + Case Study 1).

Baseline target (no native conditional ops): every SELECT — and MIN/MAX
when the target lacks them — is rewritten into branch-based control flow.
Single-use pure/load operand chains are *sunk* into the branch arms, so a
divergent diamond only issues one arm's memory traffic per active mask
(this is what makes the CMOV-vs-branch memory-density trade-off of the
paper's pathfinder/transpose observation measurable).

ZiCond target: SELECT lowers to a single CMOV (``vx_move``).  Both operand
chains stay hoisted — i.e. both sides' loads execute — fewer control
instructions, more memory requests.  Exactly the paper's Fig 8 story.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..vir import (Block, Const, Function, Instr, Op, Reg, Slot, Ty, Value)
from .uniformity import UniformityInfo, VortexTTI


def _single_use_chain(fn: Function, block: Block, root: Value,
                      select: Instr) -> Optional[List[Instr]]:
    """Instrs (in block order) that exist solely to produce ``root`` for
    ``select`` — safe to sink into a branch arm.  None if not sinkable."""
    if not isinstance(root, Reg):
        return []
    # count uses of each reg in the whole function
    uses: Dict[int, int] = {}
    for i in fn.instructions():
        for o in i.value_operands():
            if isinstance(o, Reg):
                uses[id(o)] = uses.get(id(o), 0) + 1
    sinkable = {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD, Op.AND, Op.OR,
                Op.XOR, Op.SHL, Op.SHR, Op.MIN, Op.MAX, Op.POW, Op.EQ,
                Op.NE, Op.LT, Op.LE, Op.GT, Op.GE, Op.NEG, Op.NOT, Op.ABS,
                Op.SQRT, Op.EXP, Op.LOG, Op.SIN, Op.COS, Op.ITOF, Op.FTOI,
                Op.LOAD, Op.SLOT_LOAD}
    chain: List[Instr] = []
    work = [root]
    seen: Set[int] = set()
    while work:
        v = work.pop()
        if not isinstance(v, Reg) or id(v) in seen:
            continue
        seen.add(id(v))
        d = v.defining
        if d is None or d.parent is not block:
            continue  # defined elsewhere: stays hoisted
        if uses.get(id(v), 0) != 1:
            continue  # shared with other users: stays hoisted
        if d.op not in sinkable:
            continue
        chain.append(d)
        for o in d.value_operands():
            work.append(o)
    order = {id(i): k for k, i in enumerate(block.instrs)}
    chain.sort(key=lambda i: order[id(i)])
    return chain


def lower_selects(fn: Function, info: UniformityInfo, tti: VortexTTI) -> Dict[str, int]:
    """Rewrite SELECT (and MIN/MAX without native support) per target."""
    stats = {"cmov": 0, "diamond": 0, "minmax_rewritten": 0}

    # -- min/max -> select when the target lacks them -----------------------
    if not tti.has_minmax:
        for b in fn.blocks:
            for i in list(b.instrs):
                if i.op in (Op.MIN, Op.MAX) and i.result is not None:
                    a, c = i.operands[0], i.operands[1]
                    cmp = Instr(Op.LT if i.op is Op.MIN else Op.GT,
                                [a, c], Reg(Ty.BOOL))
                    sel = Instr(Op.SELECT, [cmp.result, a, c], i.result)
                    idx = b.instrs.index(i)
                    b.instrs[idx] = sel
                    sel.parent = b
                    b.insert(idx, cmp)
                    i.result = None
                    stats["minmax_rewritten"] += 1

    # -- selects -------------------------------------------------------------
    changed = True
    while changed:
        changed = False
        for b in list(fn.blocks):
            for pos, i in enumerate(b.instrs):
                if i.op is not Op.SELECT or i.result is None:
                    continue
                cond, av, bv = i.operands
                if tti.has_zicond:
                    i.op = Op.CMOV        # native predicated move
                    stats["cmov"] += 1
                    continue
                _reify_select(fn, b, pos, i)
                stats["diamond"] += 1
                changed = True
                break
            if changed:
                break
    if stats["cmov"]:
        # in-place opcode rewrite: CFG untouched, dataflow shape unchanged
        # for uniformity (CMOV result uniformity == SELECT's), but the
        # decoded interpreter must re-decode
        fn.bump_version(cfg=False, dataflow=False)
    return stats


def _reify_select(fn: Function, b: Block, pos: int, sel: Instr) -> None:
    """Reify ``r = select(c,a,b)`` as a diamond CFG (paper §4.3(c)),
    sinking single-use operand chains into the arms."""
    cond, av, bv = sel.operands
    r = sel.result
    assert r is not None
    then_chain = _single_use_chain(fn, b, av, sel) or []
    else_chain = _single_use_chain(fn, b, bv, sel) or []
    # avoid sinking the same instr to both arms
    overlap = {id(i) for i in then_chain} & {id(i) for i in else_chain}
    then_chain = [i for i in then_chain if id(i) not in overlap]
    else_chain = [i for i in else_chain if id(i) not in overlap]
    # also never sink the cond's chain
    cond_regs = set()
    if isinstance(cond, Reg):
        cond_regs.add(id(cond))
    then_chain = [i for i in then_chain
                  if i.result is None or id(i.result) not in cond_regs]
    else_chain = [i for i in else_chain
                  if i.result is None or id(i.result) not in cond_regs]

    slot = fn.new_slot(f"__sel{len(fn.slots)}", r.ty)
    then_bb = fn.new_block("sel.then")
    else_bb = fn.new_block("sel.else")
    merge_bb = fn.new_block("sel.end")

    sunk = {id(i) for i in then_chain} | {id(i) for i in else_chain}
    pre = [x for x in b.instrs[:pos] if id(x) not in sunk]
    post = b.instrs[pos + 1:]

    for i in then_chain:
        i.parent = then_bb
        then_bb.instrs.append(i)
    then_bb.append(Instr(Op.SLOT_STORE, [slot, av]))
    then_bb.append(Instr(Op.BR, [merge_bb]))
    for i in else_chain:
        i.parent = else_bb
        else_bb.instrs.append(i)
    else_bb.append(Instr(Op.SLOT_STORE, [slot, bv]))
    else_bb.append(Instr(Op.BR, [merge_bb]))

    newr = Reg(r.ty, f"{r.name}.m")
    load = Instr(Op.SLOT_LOAD, [slot], newr)
    merge_bb.append(load)
    for x in post:
        x.parent = merge_bb
        merge_bb.instrs.append(x)

    b.instrs = pre
    cbr = Instr(Op.CBR, [cond, then_bb, else_bb])
    b.append(cbr)

    # remap all uses of r -> newr
    for blk in fn.blocks:
        for ins in blk.instrs:
            ins.operands = [newr if o is r else o for o in ins.operands]
    fn.bump_version()   # diamond reified: edges + operand remap
