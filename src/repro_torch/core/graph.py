"""CFG analyses: dominators, post-dominators, RPO, natural loops, control
dependence. Self-contained (Cooper-Harvey-Kennedy iterative dominators).

These are the substrate for the paper's middle-end: uniformity propagation
uses control dependence; Algorithm 2 needs IPDOMs and loop membership;
structurization needs reducibility checks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .vir import Block, Function, Instr, Op


# --------------------------------------------------------------------------
# Basic traversals
# --------------------------------------------------------------------------

def successors(b: Block) -> List[Block]:
    return b.successors()


def predecessors(fn: Function) -> Dict[Block, List[Block]]:
    preds: Dict[Block, List[Block]] = {b: [] for b in fn.blocks}
    for b in fn.blocks:
        for s in b.successors():
            preds[s].append(b)
    return preds


def rpo(fn: Function) -> List[Block]:
    """Reverse post-order from entry."""
    seen: Set[int] = set()
    order: List[Block] = []

    def dfs(b: Block) -> None:
        seen.add(id(b))
        for s in b.successors():
            if id(s) not in seen:
                dfs(s)
        order.append(b)

    dfs(fn.entry)
    order.reverse()
    return order


def exit_blocks(fn: Function) -> List[Block]:
    return [b for b in fn.blocks
            if b.terminator is not None and b.terminator.op is Op.RET]


# --------------------------------------------------------------------------
# Dominators (Cooper-Harvey-Kennedy)
# --------------------------------------------------------------------------

def _idoms(order: List[Block], preds: Dict[Block, List[Block]],
           root: Block) -> Dict[Block, Optional[Block]]:
    index = {id(b): i for i, b in enumerate(order)}
    idom: Dict[int, Optional[Block]] = {id(b): None for b in order}
    idom[id(root)] = root
    changed = True

    def intersect(a: Block, b: Block) -> Block:
        fa, fb = a, b
        while id(fa) != id(fb):
            while index[id(fa)] > index[id(fb)]:
                fa = idom[id(fa)]  # type: ignore[assignment]
            while index[id(fb)] > index[id(fa)]:
                fb = idom[id(fb)]  # type: ignore[assignment]
        return fa

    while changed:
        changed = False
        for b in order:
            if b is root:
                continue
            new_idom: Optional[Block] = None
            for p in preds.get(b, []):
                if id(p) in index and idom[id(p)] is not None:
                    new_idom = p if new_idom is None else intersect(p, new_idom)
            if new_idom is not None and idom[id(b)] is not new_idom:
                idom[id(b)] = new_idom
                changed = True
    return {b: idom[id(b)] for b in order}


@dataclass
class DomInfo:
    idom: Dict[Block, Optional[Block]]
    order: List[Block]

    def dominates(self, a: Block, b: Block) -> bool:
        """a dom b (reflexive)."""
        cur: Optional[Block] = b
        while cur is not None:
            if cur is a:
                return True
            nxt = self.idom.get(cur)
            if nxt is cur:
                return cur is a
            cur = nxt
        return False

    def strictly_dominates(self, a: Block, b: Block) -> bool:
        return a is not b and self.dominates(a, b)


def dominators(fn: Function) -> DomInfo:
    order = rpo(fn)
    preds = predecessors(fn)
    return DomInfo(_idoms(order, preds, fn.entry), order)


@dataclass
class PostDomInfo:
    ipdom: Dict[Block, Optional[Block]]   # immediate post-dominator
    virtual_exit: object

    def immediate(self, b: Block) -> Optional[Block]:
        p = self.ipdom.get(b)
        return None if p is self.virtual_exit or p is b else p

    def postdominates(self, a: Block, b: Block) -> bool:
        cur: Optional[Block] = b
        while cur is not None and cur is not self.virtual_exit:
            if cur is a:
                return True
            nxt = self.ipdom.get(cur)
            if nxt is cur:
                break
            cur = nxt
        return a is cur


def postdominators(fn: Function) -> PostDomInfo:
    """Post-dominators over the reversed CFG with a virtual exit joining all
    RET blocks (and any infinite-loop tails, conservatively)."""
    vexit = Block("__vexit")
    # reversed edges: succ(v) in reverse graph = preds in original
    rsucc: Dict[Block, List[Block]] = {b: [] for b in fn.blocks}
    rsucc[vexit] = []
    for b in fn.blocks:
        for s in b.successors():
            rsucc[s].append(b)
    exits = exit_blocks(fn)
    # attach blocks with no successors (malformed mid-construction) too
    for b in fn.blocks:
        if not b.successors() and b not in exits:
            exits.append(b)
    for e in exits:
        rsucc[vexit].append(e)

    # post-order over reverse graph from vexit
    seen: Set[int] = set()
    order: List[Block] = []

    def dfs(b: Block) -> None:
        seen.add(id(b))
        for s in rsucc.get(b, []):
            if id(s) not in seen:
                dfs(s)
        order.append(b)

    dfs(vexit)
    order.reverse()
    rpreds: Dict[Block, List[Block]] = {b: [] for b in order}
    for b in order:
        for s in rsucc.get(b, []):
            if id(s) in seen:
                rpreds[s].append(b)
    idom = _idoms(order, rpreds, vexit)
    return PostDomInfo(idom, vexit)


# --------------------------------------------------------------------------
# Natural loops
# --------------------------------------------------------------------------

@dataclass
class Loop:
    header: Block
    latches: List[Block]
    body: Set[int] = field(default_factory=set)   # ids of member blocks
    blocks: List[Block] = field(default_factory=list)
    parent: Optional["Loop"] = None

    def contains(self, b: Block) -> bool:
        return id(b) in self.body

    def exits(self) -> List[Tuple[Block, Block]]:
        """(inside_block, outside_succ) pairs."""
        out = []
        for b in self.blocks:
            for s in b.successors():
                if not self.contains(s):
                    out.append((b, s))
        return out

    def preheader(self) -> Optional[Block]:
        """Unique out-of-loop predecessor of header with single succ."""
        assert self.header.parent is not None
        preds = predecessors(self.header.parent)[self.header]
        outside = [p for p in preds if not self.contains(p)]
        if len(outside) == 1 and len(outside[0].successors()) == 1:
            return outside[0]
        return None


def natural_loops(fn: Function, dom: Optional[DomInfo] = None) -> List[Loop]:
    dom = dom or dominators(fn)
    preds = predecessors(fn)
    loops: Dict[int, Loop] = {}
    for b in fn.blocks:
        for s in b.successors():
            if dom.dominates(s, b):     # back edge b -> s
                loop = loops.get(id(s))
                if loop is None:
                    loop = Loop(header=s, latches=[])
                    loop.body.add(id(s))
                    loop.blocks.append(s)
                    loops[id(s)] = loop
                loop.latches.append(b)
                # walk preds from latch up to header
                work = [b]
                while work:
                    n = work.pop()
                    if id(n) in loop.body:
                        continue
                    loop.body.add(id(n))
                    loop.blocks.append(n)
                    work.extend(preds.get(n, []))
    result = list(loops.values())
    # nesting: parent = smallest strictly-containing loop
    for l in result:
        best = None
        for m in result:
            if m is l or id(l.header) not in m.body:
                continue
            if best is None or len(m.body) < len(best.body):
                best = m
        l.parent = best
    return result


def loop_of(loops: Sequence[Loop], b: Block) -> Optional[Loop]:
    """Innermost loop containing b."""
    best: Optional[Loop] = None
    for l in loops:
        if l.contains(b) and (best is None or len(l.body) < len(best.body)):
            best = l
    return best


# --------------------------------------------------------------------------
# Control dependence (via post-dominance frontier)
# --------------------------------------------------------------------------

def control_deps(fn: Function,
                 pdom: Optional[PostDomInfo] = None) -> Dict[Block, Set[int]]:
    """block -> set of ids of branch-blocks it is control-dependent on.

    Classic Ferrante-Ottenstein-Warren: B is control-dependent on A iff A has
    successors S1 (postdominated path includes B) and S2 such that B
    postdominates S1 but does not postdominate A.
    """
    pdom = pdom or postdominators(fn)
    deps: Dict[Block, Set[int]] = {b: set() for b in fn.blocks}
    for a in fn.blocks:
        succs = a.successors()
        if len(succs) < 2:
            continue
        for s in succs:
            # walk the postdominator chain from s up to (exclusive) ipdom(a)
            stop = pdom.ipdom.get(a)
            cur: Optional[Block] = s
            while cur is not None and cur is not stop and cur is not pdom.virtual_exit:
                deps[cur].add(id(a))
                nxt = pdom.ipdom.get(cur)
                if nxt is cur:
                    break
                cur = nxt
    return deps


def cdg_leaves(fn: Function,
               deps: Optional[Dict[Block, Set[int]]] = None) -> Set[int]:
    """Blocks that no other block is control-dependent on (CDG leaf nodes,
    used by CFG reconstruction)."""
    deps = deps if deps is not None else control_deps(fn)
    non_leaves: Set[int] = set()
    for b, ds in deps.items():
        non_leaves |= ds
    return {id(b) for b in fn.blocks if id(b) not in non_leaves}


# --------------------------------------------------------------------------
# Reducibility
# --------------------------------------------------------------------------

def is_reducible(fn: Function) -> bool:
    """T1/T2 interval-collapse test for reducibility [Hecht-Ullman],
    restricted to blocks reachable from entry (unreachable cycles are
    dead code, not irreducibility)."""
    reach: Set[int] = set()
    work = [fn.entry]
    while work:
        b = work.pop()
        if id(b) in reach:
            continue
        reach.add(id(b))
        work.extend(b.successors())
    blocks = [b for b in fn.blocks if id(b) in reach]
    ids = {id(b) for b in blocks}
    succ: Dict[int, Set[int]] = {id(b): {id(s) for s in b.successors()}
                                 for b in blocks}
    pred: Dict[int, Set[int]] = {i: set() for i in ids}
    for u, ss in succ.items():
        for v in ss:
            pred[v].add(u)
    entry = id(fn.entry)
    changed = True
    while changed and len(ids) > 1:
        changed = False
        # T1: remove self loops
        for u in list(ids):
            if u in succ[u]:
                succ[u].discard(u)
                pred[u].discard(u)
                changed = True
        # T2: merge nodes with a unique predecessor
        for u in list(ids):
            if u == entry:
                continue
            ps = pred[u]
            if len(ps) == 1:
                p = next(iter(ps))
                # merge u into p
                succ[p].discard(u)
                for v in succ[u]:
                    if v != u:
                        succ[p].add(v)
                        pred[v].discard(u)
                        pred[v].add(p)
                ids.discard(u)
                del succ[u]
                del pred[u]
                changed = True
                break
    return len(ids) == 1
