"""Uniformity analysis (paper §4.3.1).

Mirrors VOLT's extension of LLVM UniformityAnalysis:

  * a TTI-style target interface (``isAlwaysUniform`` /
    ``isSourceOfDivergence``) implemented by the **divergence tracker**
    (VortexTTI below);
  * seed identification (always-uniform constants/CSRs vs divergence
    sources: thread-id intrinsics, atomics, unannotated args/returns);
  * propagation along def-use chains AND through control dependence
    (a divergent branch taints slot-stores it controls — slots are the
    phi-equivalents in our IR);
  * **annotation analysis**: "vortex.uniform" markers on params/locals and
    intrinsic-based reasoning about const/readonly memory (Uni-Ann);
  * **function-argument analysis** is Algorithm 1 in func_args.py; its
    results arrive here via ``Param.uniform`` / ``Function.ret_uniform``.

Ablation knobs (paper §5.2): ``uni_hw`` gates the CSR always-uniform seeds,
``uni_ann`` gates annotation analysis, ``uni_func`` gates Algorithm 1
(applied before this pass).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from ..vir import (AddrSpace, Block, Const, Function, GlobalVar, Instr,
                   Module, Op, Param, Reg, Slot, Ty, Value,
                   CSR_INTRINSICS, DIVERGENT_INTRINSICS)
from .. import graph


# --------------------------------------------------------------------------
# Target Transform Info (paper: RISC-V TTI extended with divergence mgmt)
# --------------------------------------------------------------------------

class VortexTTI:
    """The VOLT divergence tracker, exposed through the two TTI hooks the
    paper adds to the RISC-V back-end interface."""

    def __init__(self, *, uni_hw: bool = True, uni_ann: bool = True,
                 has_zicond: bool = False, has_minmax: bool = False,
                 wg_equals_warp: bool = True) -> None:
        self.uni_hw = uni_hw
        self.uni_ann = uni_ann
        self.has_zicond = has_zicond
        self.has_minmax = has_minmax
        # When a workgroup is exactly one warp, workgroup-uniform quantities
        # (group_id) are warp-uniform. The benchmark suite runs wg==warp.
        self.wg_equals_warp = wg_equals_warp

    # -- isSourceOfDivergence ------------------------------------------------
    def is_source_of_divergence(self, i: Instr) -> bool:
        if i.op is Op.INTR:
            name = i.operands[0]
            if name in ("global_id", "local_id", "lane_id",
                        "global_id_y", "local_id_y"):
                return True
            if name == "group_id":
                return not self.wg_equals_warp
            if name in CSR_INTRINSICS:
                # without Uni-HW the tracker is conservative about CSRs
                return not self.uni_hw
            return True
        if i.op is Op.ATOMIC:
            # multiple threads hitting one location observe different olds
            return True
        if i.op is Op.SHFL:
            return True  # lane-indexed gather: lane-dependent by nature
        return False

    # -- isAlwaysUniform -----------------------------------------------------
    def is_always_uniform(self, i: Instr) -> bool:
        if i.op is Op.INTR:
            name = i.operands[0]
            if name == "group_id":
                return self.wg_equals_warp
            if name in CSR_INTRINSICS:
                return self.uni_hw
            return False
        if i.op is Op.VOTE:
            return True  # warp-collective results are warp-uniform
        if i.op is Op.CALL:
            callee = i.operands[0]
            return bool(getattr(callee, "ret_uniform", False))
        return False


# --------------------------------------------------------------------------
# Analysis result
# --------------------------------------------------------------------------

@dataclass
class UniformityInfo:
    divergent_values: Set[int] = field(default_factory=set)   # ids of Reg
    divergent_slots: Set[int] = field(default_factory=set)    # ids of Slot
    divergent_exec: Set[int] = field(default_factory=set)     # ids of Block
    divergent_branches: Set[int] = field(default_factory=set)  # ids of Instr

    def is_uniform(self, v: Value) -> bool:
        if isinstance(v, Const):
            return True
        if isinstance(v, Reg):
            return id(v) not in self.divergent_values
        if isinstance(v, Param):
            # params were folded into seeds; Reg uses carry the result
            return v.uniform
        if isinstance(v, GlobalVar):
            return True   # the handle itself is uniform (not its contents)
        return False

    def slot_uniform(self, s: Slot) -> bool:
        return id(s) not in self.divergent_slots

    def branch_divergent(self, i: Instr) -> bool:
        return id(i) in self.divergent_branches

    def block_divergent_exec(self, b: Block) -> bool:
        return id(b) in self.divergent_exec


# --------------------------------------------------------------------------
# The propagation engine
# --------------------------------------------------------------------------

def run_uniformity(fn: Function, tti: VortexTTI,
                   *, kernel_params_uniform: bool = False,
                   am=None, seed: Optional[UniformityInfo] = None
                   ) -> UniformityInfo:
    """Fixpoint uniformity propagation.

    A value is divergent if (a) the TTI seeds it so, (b) any operand is
    divergent (def-use propagation), or (c) it loads a slot whose stores are
    divergent in value or control (sync/control dependence through our
    phi-replacement slots).  Everything else is uniform.

    ``am`` (optional AnalysisManager) supplies memoized control dependence.
    ``seed`` warm-starts the lattice from a previous run's result: the
    lattice is monotone toward "divergent", so restarting from prior state
    re-converges in one sweep when (almost) nothing changed.  Sound for any
    IR edit — a stale-divergent entry is merely conservative — so callers
    use it when instructions changed in place but results should carry
    over (the AnalysisManager skips the run entirely for attrs-only edits).
    """
    info = UniformityInfo()
    if seed is not None:
        info.divergent_values |= seed.divergent_values
        info.divergent_slots |= seed.divergent_slots
        info.divergent_exec |= seed.divergent_exec
        info.divergent_branches |= seed.divergent_branches
    div_vals = info.divergent_values
    div_slots = info.divergent_slots
    div_exec = info.divergent_exec
    div_branches = info.divergent_branches

    # ---- param seeds ------------------------------------------------------
    # Paper: "conservatively assumes that all function arguments are
    # potentially divergent except when they are marked as uniform".
    # Annotations are only honored under Uni-Ann; Algorithm 1 sets
    # Param.uniform for internal functions before this pass runs.
    param_uniform: Dict[int, bool] = {}
    for p in fn.params:
        u = False
        if kernel_params_uniform and p.ty is not Ty.PTR:
            u = True
        if tti.uni_ann and p.uniform:
            u = True
        if getattr(p, "proved_uniform", False):   # Algorithm 1 result
            u = True
        param_uniform[id(p)] = u

    cdeps = am.control_deps(fn) if am is not None else graph.control_deps(fn)
    block_of: Dict[int, Block] = {}
    branch_of_block: Dict[int, Instr] = {}
    for b in fn.blocks:
        block_of[id(b)] = b
        t = b.terminator
        if t is not None and t.op is Op.CBR:
            branch_of_block[id(b)] = t

    def value_divergent(v: Value) -> bool:
        if isinstance(v, Const):
            return False
        if isinstance(v, Reg):
            return id(v) in div_vals
        if isinstance(v, Param):
            return not param_uniform.get(id(v), False)
        if isinstance(v, GlobalVar):
            return False
        return True

    changed = True
    while changed:
        changed = False

        # (1) def-use + seeds
        for b in fn.blocks:
            for i in b.instrs:
                r = i.result
                if r is not None and id(r) not in div_vals:
                    d = False
                    if tti.is_always_uniform(i):
                        d = False
                    elif tti.is_source_of_divergence(i):
                        d = True
                    elif i.op is Op.SLOT_LOAD:
                        slot = i.operands[0]
                        if tti.uni_ann and slot.uniform_hint:
                            d = False
                        else:
                            d = id(slot) in div_slots
                    elif i.op is Op.LOAD:
                        ptr = i.operands[0]
                        idx_div = value_divergent(i.operands[1])
                        space = getattr(ptr, "space", None)
                        readonly = getattr(ptr, "readonly", False)
                        if tti.uni_ann and not idx_div and (
                                space is AddrSpace.CONST or readonly):
                            d = False  # constant-data reasoning (Uni-Ann)
                        else:
                            d = True   # global memory contents: conservative
                    elif i.op is Op.CALL:
                        callee = i.operands[0]
                        if getattr(callee, "ret_uniform", False):
                            d = any(value_divergent(o)
                                    for o in i.operands[1:])
                        else:
                            d = True
                    else:
                        d = any(value_divergent(o)
                                for o in i.value_operands())
                    if d:
                        div_vals.add(id(r))
                        changed = True

        # (2) divergent branches
        for b in fn.blocks:
            t = branch_of_block.get(id(b))
            if t is None or id(t) in div_branches:
                continue
            # NOTE: a uniform-condition branch inside divergent-exec code
            # stays a real branch (all *active* lanes agree) — same policy
            # as LLVM's uniformity analysis.
            if value_divergent(t.operands[0]):
                div_branches.add(id(t))
                changed = True

        # (3) divergent execution predicates (control dependence fixpoint)
        for b in fn.blocks:
            if id(b) in div_exec:
                continue
            for dep_id in cdeps.get(b, set()):
                dep_block = block_of.get(dep_id)
                if dep_block is None:
                    continue
                t = branch_of_block.get(dep_id)
                tainted = (t is not None and id(t) in div_branches) or \
                          (dep_id in div_exec)
                if tainted:
                    div_exec.add(id(b))
                    changed = True
                    break

        # (4) slots: divergent if any store writes a divergent value or
        #     happens under divergent control (slot == phi sync-dependence)
        for b in fn.blocks:
            for i in b.instrs:
                if i.op is not Op.SLOT_STORE:
                    continue
                slot = i.operands[0]
                if id(slot) in div_slots:
                    continue
                if tti.uni_ann and slot.uniform_hint:
                    continue  # trusted annotation overrides dataflow
                if value_divergent(i.operands[1]) or id(b) in div_exec:
                    div_slots.add(id(slot))
                    changed = True

    return info


__all__ = ["VortexTTI", "UniformityInfo", "run_uniformity"]
