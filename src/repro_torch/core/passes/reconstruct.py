"""CFG Reconstruction (paper §4.3.2, Fig 6) — the paper's new optimization.

When unstructured/deeply-nested regions are linearized, predicate
computation becomes expensive.  VOLT selectively *duplicates* nodes to
simplify predicates: when an unstructured block is a **divergent CDG leaf
node** (no other block is control-dependent on it) with multiple
predecessors living in different predicate contexts, duplicating it per
predecessor removes the merged predicate entirely (Fig 6: D -> D', D'').

If the governing dependency is *uniform*, each warp takes a single pass and
no duplication is needed — the pass skips those (the paper's "interesting
observation").

Heuristic trigger (measured on the cfd-style benchmark): a CDG-leaf block
whose predecessors are guard blocks (predicate re-loads) — duplication lets
each path fold its own guard away.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..vir import Block, Function, Instr, Op
from .. import graph
from .analysis import AnalysisManager, ensure_manager
from .structurize import _copy_block, _reg_escapes
from .uniformity import UniformityInfo


def run_reconstruct(fn: Function, info: UniformityInfo,
                    *, max_dup: int = 8,
                    am: Optional[AnalysisManager] = None) -> Dict[str, int]:
    am = ensure_manager(am)
    dup = 0
    changed = True
    while changed and dup < max_dup:
        changed = False
        leaves = am.cdg_leaves(fn)
        preds = am.predecessors(fn)
        loops = am.loops(fn)
        for b in fn.blocks:
            if id(b) not in leaves or b is fn.entry:
                continue
            # Fig 6 operates on acyclic unstructured regions; duplicating
            # inside a loop can move a branch's IPDOM onto the loop header
            # (join across the back edge) — bail out, like LLVM's
            # structurizer does.
            if graph.loop_of(loops, b) is not None:
                continue
            ps = preds.get(b, [])
            if len(ps) < 2:
                continue
            # only divergent CDG leaves (uniform deps need a single pass)
            if not info.block_divergent_exec(b):
                continue
            # do not touch loop headers (duplication would clone the loop)
            dom = am.dominators(fn)
            if any(dom.dominates(b, p) for p in ps):
                continue
            if _reg_escapes(b):
                continue
            # cost guard: small blocks only (predicate savings must win)
            if len(b.instrs) > 12:
                continue
            for p in ps[1:]:
                clone = _copy_block(fn, b, f"recon{dup}")
                t = p.terminator
                assert t is not None
                t.operands = [clone if (isinstance(o, Block) and o is b)
                              else o for o in t.operands]
                dup += 1
            fn.bump_version()   # rerouted preds onto clones
            changed = True
            break
    return {"blocks_duplicated": dup}
