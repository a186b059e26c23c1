"""CFG structurization (paper §4.3.2).

Front-end-generated CFGs are structured by construction (exit legalization
in ast_frontend.py), so for them this pass only (a) merges multiple loop
latches into one and (b) verifies reducibility.  Hand-built IR (builder API,
the CFD-style benchmark, property-test graphs) can be irreducible; for those
we perform classic *node splitting*: duplicate the multi-entry region node
until every retreating edge targets a dominating header.  This matches the
paper's use of llvm::createStructurizeCFGPass plus its observation that
reducible graphs can grow exponentially in the worst case [8] — which is
what CFG *reconstruction* (reconstruct.py) then mitigates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..vir import Block, Const, Function, Instr, Op, Reg
from .. import graph
from .analysis import AnalysisManager, ensure_manager


def merge_latches(fn: Function, am: Optional[AnalysisManager] = None) -> int:
    """Give every natural loop a single latch block."""
    am = ensure_manager(am)
    n = 0
    loops = am.loops(fn)
    for loop in loops:
        if len(loop.latches) <= 1:
            continue
        latch = fn.new_block("latch")
        latch.append(Instr(Op.BR, [loop.header]))
        for lb in loop.latches:
            t = lb.terminator
            assert t is not None
            t.operands = [latch if (isinstance(o, Block) and o is loop.header)
                          else o for o in t.operands]
        fn.bump_version()   # retargeted latch edges
        n += 1
    return n


def _copy_block(fn: Function, b: Block, suffix: str) -> Block:
    """Clone a block (fresh result registers, operands remapped locally)."""
    nb = fn.new_block(f"{b.name}.{suffix}")
    remap: Dict[int, Reg] = {}

    def mapped(o):
        if isinstance(o, Reg) and id(o) in remap:
            return remap[id(o)]
        return o

    for i in b.instrs:
        res = None
        if i.result is not None:
            res = Reg(i.result.ty, f"{i.result.name}.{suffix}")
            remap[id(i.result)] = res
        ni = Instr(i.op, [mapped(o) for o in i.operands], res, dict(i.attrs))
        nb.append(ni)
    return nb


def _reg_escapes(b: Block) -> bool:
    """True if any register defined in b is used outside b (cloning such a
    block would break SSA uses; our duplication targets self-contained
    blocks, which guards/linearized tails always are)."""
    defined = {id(i.result) for i in b.instrs if i.result is not None}
    if not defined:
        return False
    fn = b.parent
    assert fn is not None
    for ob in fn.blocks:
        if ob is b:
            continue
        for i in ob.instrs:
            for o in i.value_operands():
                if isinstance(o, Reg) and id(o) in defined:
                    return True
    return False


def split_irreducible(fn: Function, max_iters: int = 200) -> int:
    """Node splitting until the CFG is reducible.

    Irreducibility <=> some cycle (SCC, possibly nested) has multiple
    entry blocks.  We find a multi-entry SCC — recursing into sub-SCCs
    with the header removed for nested irreducibility — and duplicate one
    of its entry blocks per external predecessor.  Bounded (reducible
    graphs can grow exponentially [Carter et al., POPL'03]); raises on
    the pathological bound.
    """
    total = 0
    for _ in range(max_iters):
        if graph.is_reducible(fn):
            return total
        preds = graph.predecessors(fn)
        target: Optional[Block] = None

        def find_multi_entry(blocks: List[Block], removed: set
                             ) -> Optional[Block]:
            """Multi-entry SCC search within `blocks`, edges through
            `removed` ids ignored."""
            bset = {id(b) for b in blocks} - removed
            # compute SCCs of the induced subgraph
            idx: Dict[int, Block] = {id(b): b for b in blocks
                                     if id(b) not in removed}
            sub_sccs = _induced_sccs(idx)
            for comp in sub_sccs:
                if len(comp) < 2 and not any(
                        s is comp[0] for s in comp[0].successors()):
                    continue
                cids = {id(b) for b in comp}
                entries = []
                for b in comp:
                    for p in preds.get(b, []):
                        if id(p) not in cids:
                            entries.append(b)
                            break
                if len(entries) > 1:
                    # duplicate the entry with the fewest instructions
                    entries.sort(key=lambda b: len(b.instrs))
                    for e in entries:
                        if not _reg_escapes(e):
                            return e
                    raise RuntimeError(
                        f"cannot split block %{entries[0].name}: "
                        "registers escape")
                if len(comp) >= 2:
                    # reducible at this level: recurse without the header
                    header = entries[0] if entries else comp[0]
                    deeper = find_multi_entry(comp, removed | {id(header)})
                    if deeper is not None:
                        return deeper
            return None

        target = find_multi_entry(list(fn.blocks), set())
        if target is None:
            raise RuntimeError("irreducible CFG but no split candidate")
        ps = [p for p in preds[target]]
        for p in ps[1:]:
            clone = _copy_block(fn, target, f"dup{total}")
            t = p.terminator
            assert t is not None
            t.operands = [clone if (isinstance(o, Block) and o is target)
                          else o for o in t.operands]
            total += 1
        fn.bump_version()   # retargeted edges onto the clones
        fn.drop_unreachable()
    raise RuntimeError("structurization did not converge")


def _induced_sccs(idx: Dict[int, Block]) -> List[List[Block]]:
    """Tarjan over the subgraph induced by `idx` (id -> block)."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    onstack: Dict[int, bool] = {}
    stack: List[Block] = []
    out: List[List[Block]] = []
    counter = [0]

    def succs(b: Block):
        return [s for s in b.successors() if id(s) in idx]

    def strongconnect(root: Block) -> None:
        work = [(root, iter(succs(root)))]
        index[id(root)] = low[id(root)] = counter[0]
        counter[0] += 1
        stack.append(root)
        onstack[id(root)] = True
        while work:
            b, it = work[-1]
            advanced = False
            for s in it:
                if id(s) not in index:
                    index[id(s)] = low[id(s)] = counter[0]
                    counter[0] += 1
                    stack.append(s)
                    onstack[id(s)] = True
                    work.append((s, iter(succs(s))))
                    advanced = True
                    break
                elif onstack.get(id(s)):
                    low[id(b)] = min(low[id(b)], index[id(s)])
            if advanced:
                continue
            work.pop()
            if work:
                pb = work[-1][0]
                low[id(pb)] = min(low[id(pb)], low[id(b)])
            if low[id(b)] == index[id(b)]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack[id(w)] = False
                    comp.append(w)
                    if w is b:
                        break
                out.append(comp)

    for b in idx.values():
        if id(b) not in index:
            strongconnect(b)
    return out


def _reaches(fn: Function, src: Block, dst: Block) -> bool:
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


def _region_blocks(b: Block, ip: Block) -> List[Block]:
    """Blocks reachable from b without passing through ip (exclusive)."""
    seen: Dict[int, Block] = {}
    work = list(b.successors())
    while work:
        n = work.pop()
        if n is ip or id(n) in seen:
            continue
        seen[id(n)] = n
        for s in n.successors():
            work.append(s)
    return list(seen.values())


def fix_side_entries(fn: Function, max_dup: int = 64,
                     am: Optional[AnalysisManager] = None) -> int:
    """Duplicate blocks that are entered from outside a branch's region
    (side entries / shared tails).  Such blocks would execute the branch's
    vx_join without having executed its vx_split — the misaligned
    reconvergence the IPDOM stack cannot absorb.  Front-end-generated CFGs
    never need this; hand-built goto-style IR (cfd-like graphs) does.
    """
    am = ensure_manager(am)
    total = 0
    changed = True
    while changed and total < max_dup:
        changed = False
        pdom = am.postdominators(fn)
        preds = am.predecessors(fn)
        loops = am.loops(fn)
        for b in fn.blocks:
            t = b.terminator
            if t is None or t.op is not Op.CBR:
                continue
            ip = pdom.immediate(b)
            if ip is None:
                continue
            if graph.loop_of(loops, b) is not None:
                continue  # loop-internal shapes are canonical by front-end
            region = _region_blocks(b, ip)
            rset = {id(x) for x in region} | {id(b)}
            for d in region:
                if d is b or graph.loop_of(loops, d) is not None:
                    continue  # never duplicate region entries / loop blocks
                outside = [p for p in preds.get(d, []) if id(p) not in rset]
                if not outside:
                    continue
                if _reg_escapes(d):
                    raise RuntimeError(
                        f"side-entry block %{d.name} has escaping registers")
                clone = _copy_block(fn, d, f"se{total}")
                for p in outside:
                    pt = p.terminator
                    assert pt is not None
                    pt.operands = [clone if (isinstance(o, Block) and o is d)
                                   else o for o in pt.operands]
                fn.bump_version()   # side entries rerouted to the clone
                total += 1
                changed = True
                break
            if changed:
                break
    return total


def run_structurize(fn: Function,
                    am: Optional[AnalysisManager] = None) -> Dict[str, int]:
    am = ensure_manager(am)
    # dead blocks first: unreachable cycles/branches must not drive
    # splitting or side-entry analysis
    fn.drop_unreachable()
    stats = {"latches_merged": merge_latches(fn, am)}
    stats["nodes_split"] = split_irreducible(fn)
    stats["side_entries_dup"] = fix_side_entries(fn, am=am)
    if stats["side_entries_dup"]:
        # duplication may expose further irreducible shapes: re-split
        stats["nodes_split"] += split_irreducible(fn)
    assert graph.is_reducible(fn), "structurization failed"
    return stats
