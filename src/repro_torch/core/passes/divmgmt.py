"""Divergence Management Function Insertion — paper Algorithm 2.

Walks every conditional branch; skips uniform / non-conditional ones; finds
the immediate post-dominator (IPDOM); classifies:

  * branch in a loop whose IPDOM stays inside the loop  -> D_branch
  * branch in a loop whose IPDOM leaves the loop        -> D_loop
    (after front-end legalization this is always the loop-header branch)
  * non-loop branch, IPDOM reachable                    -> D_branch

TRANSFORM_LOOP:   thread mask saved in the preheader (``tmc_save``),
                  header branch replaced by ``vx_pred`` (lane drops out when
                  its predicate fails; when no lane continues, the entry
                  mask is restored and control leaves), explicit
                  ``tmc_restore`` at the exit block.
TRANSFORM_BRANCH: ``vx_split`` immediately before the branch, ``vx_join``
                  at the IPDOM; joins are LIFO-ordered by dominance depth so
                  the IPDOM stack pops in well-nested order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..vir import Block, Function, Instr, Op, Reg, Ty
from .. import graph
from .analysis import AnalysisManager, ensure_manager
from .uniformity import UniformityInfo


def run_divmgmt(fn: Function, info: UniformityInfo,
                am: Optional[AnalysisManager] = None) -> Dict[str, int]:
    am = ensure_manager(am)
    d_branch: List[Tuple[Instr, Block]] = []
    d_loop: List[Tuple[Instr, Block]] = []

    pdom = am.postdominators(fn)
    dom = am.dominators(fn)
    loops = am.loops(fn)

    for b in fn.blocks:
        t = b.terminator
        if t is None or t.op is not Op.CBR:
            continue  # skip non-conditional
        if not info.branch_divergent(t):
            continue  # skip uniform
        ip = pdom.immediate(b)
        loop = graph.loop_of(loops, b)
        exits_loop = loop is not None and any(
            not loop.contains(s) for s in b.successors())
        if loop is not None and exits_loop:
            if ip is not None and loop.contains(ip):
                d_branch.append((t, ip))
            else:
                d_loop.append((t, ip))           # divergent loop
        else:
            if ip is not None and _reachable(b, ip):
                d_branch.append((t, ip))
            # unreachable IPDOM (infinite divergence) is left to the
            # verifier; cannot occur for front-end-generated code

    _transform_loop(fn, d_loop, loops, dom)
    _transform_branch(fn, d_branch, dom)
    if d_branch or d_loop:
        fn.bump_version()   # split/join/pred insertion rewrites the CFG
    return {"splits": len(d_branch), "preds": len(d_loop)}


def _reachable(src: Block, dst: Block) -> bool:
    seen = set()
    work = [src]
    while work:
        b = work.pop()
        if b is dst:
            return True
        if id(b) in seen:
            continue
        seen.add(id(b))
        work.extend(b.successors())
    return False


# --------------------------------------------------------------------------
# TRANSFORM_LOOP
# --------------------------------------------------------------------------

def _transform_loop(fn: Function, d_loop: List[Tuple[Instr, Block]],
                    loops: List[graph.Loop],
                    dom: graph.DomInfo) -> None:
    for t, ip in d_loop:
        header = t.parent
        assert header is not None
        loop = graph.loop_of(loops, header)
        assert loop is not None, "D_loop branch outside any loop"

        # --- preheader (create if missing) --------------------------------
        pre = loop.preheader()
        if pre is None:
            pre = fn.new_block("preheader")
            preds = graph.predecessors(fn)[loop.header]
            outside = [p for p in preds if not loop.contains(p)]
            pre.append(Instr(Op.BR, [loop.header]))
            for p in outside:
                pt = p.terminator
                assert pt is not None
                pt.operands = [pre if (isinstance(o, Block) and o is loop.header)
                               else o for o in pt.operands]

        # --- mask save in preheader ---------------------------------------
        tok = Reg(Ty.TOKEN, "lmask")
        save = Instr(Op.TMC_SAVE, [], tok)
        pre.insert(len(pre.instrs) - 1, save)   # before terminator

        # --- header: cbr -> vx_pred ----------------------------------------
        cond, inside, outside_bb = t.operands[0], t.operands[1], t.operands[2]
        if t.parent is not None and not loop.contains(t.operands[1]):
            inside, outside_bb = t.operands[2], t.operands[1]
            negate = True
        else:
            negate = False
        pred = Instr(Op.PRED, [cond, tok, inside, outside_bb],
                     attrs={"negate": negate})
        header.instrs[-1] = pred
        pred.parent = header

        # --- mask restore at the exit block ---------------------------------
        restore = Instr(Op.TMC_RESTORE, [tok])
        outside_bb.insert(0, restore)


# --------------------------------------------------------------------------
# TRANSFORM_BRANCH
# --------------------------------------------------------------------------

def _dom_depth(dom: graph.DomInfo, b: Block) -> int:
    d = 0
    cur: Optional[Block] = b
    while cur is not None:
        nxt = dom.idom.get(cur)
        if nxt is cur or nxt is None:
            break
        cur = nxt
        d += 1
    return d


def _reachable_avoiding(src: Block, dst: Block, avoid: Block) -> bool:
    """Can src reach dst without passing through `avoid`?"""
    if src is avoid:
        return False
    seen = set()
    work = [src]
    while work:
        b = work.pop()
        if b is dst:
            return True
        if id(b) in seen or b is avoid:
            continue
        seen.add(id(b))
        for s in b.successors():
            if s is not avoid:
                work.append(s)
    return False


def _transform_branch(fn: Function, d_branch: List[Tuple[Instr, Block]],
                      dom: graph.DomInfo) -> None:
    """Insert vx_split before each divergent branch and vx_join on every
    edge entering its IPDOM from inside the branch's region.

    Edge placement (rather than IPDOM-block placement) keeps the stack
    well-nested even when a path reaches the IPDOM without passing the
    split (shared-tail regions after CFG reconstruction).  LIFO order is
    maintained by processing inner (dominance-deeper) branches first, so
    on a shared edge the inner token joins before the outer one.
    """
    # inner branches first
    ordered = sorted(d_branch, key=lambda p: -_dom_depth(dom, p[0].parent))
    for t, ip in ordered:
        b = t.parent
        assert b is not None
        tok = Reg(Ty.TOKEN, "ipdom")
        split = Instr(Op.SPLIT, [t.operands[0]], tok,
                      attrs={"negate": False, "ipdom": ip})
        b.insert(len(b.instrs) - 1, split)   # back-to-back with branch
        preds = graph.predecessors(fn)[ip]
        for p in list(preds):
            in_region = (p is b) or _reachable_avoiding(b, p, ip)
            if not in_region:
                continue
            join = Instr(Op.JOIN, [tok])
            term = p.terminator
            assert term is not None
            if term.op is Op.BR:
                p.insert(len(p.instrs) - 1, join)
            else:
                # edge needs its own block (pred branches into ip directly)
                e = fn.new_block("join.edge")
                e.append(join)
                e.append(Instr(Op.BR, [ip]))
                term.operands = [e if (isinstance(o, Block) and o is ip)
                                 else o for o in term.operands]
