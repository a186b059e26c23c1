"""Pass manager + the named pipelines used in the paper's §5.2 ablation.

Pipeline order (paper §4.3):
  simplify -> structurize -> [reconstruct] -> uniformity
  -> select/min-max lowering (ZiCond-aware) -> uniformity (re-run)
  -> Algorithm 2 divergence-management insertion -> MIR safety net.

Ablation configurations:
  baseline : divergence tracker + propagation only (CSRs conservative,
             annotations ignored) — everything needed for correctness.
  +uni_hw  : CSR-backed always-uniform seeds (Uni-HW)
  +uni_ann : annotation analysis (Uni-Ann)
  +uni_func: Algorithm 1 function-argument analysis (Uni-Func)
  +zicond  : ternary -> CMOV/vx_move (ZiCond)
  +recon   : CFG reconstruction (Recon)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from ..vir import Function, Module, verify
from .analysis import AnalysisManager
from .simplify import run_simplify
from .structurize import run_structurize
from .reconstruct import run_reconstruct
from .uniformity import UniformityInfo, VortexTTI, run_uniformity
from .func_args import run_func_arg_analysis
from .zicond import lower_selects
from .divmgmt import run_divmgmt
from .mir_safety import run_mir_safety


@dataclass
class PassConfig:
    uni_hw: bool = False
    uni_ann: bool = False
    uni_func: bool = False
    zicond: bool = False
    recon: bool = False
    wg_equals_warp: bool = True
    # launch-ABI knowledge: scalar kernel args are the same for every thread
    # (off by default to match the paper's conservative baseline)
    kernel_params_uniform: bool = False

    def tti(self) -> VortexTTI:
        return VortexTTI(uni_hw=self.uni_hw, uni_ann=self.uni_ann,
                         has_zicond=self.zicond, has_minmax=self.zicond,
                         wg_equals_warp=self.wg_equals_warp)

    @property
    def label(self) -> str:
        bits = [k for k, v in (("hw", self.uni_hw), ("ann", self.uni_ann),
                               ("func", self.uni_func), ("zic", self.zicond),
                               ("rec", self.recon)) if v]
        return "base" if not bits else "+".join(["base"] + bits)


# the paper's cumulative ablation ladder (Figs 7/8)
ABLATION_LADDER: List[PassConfig] = [
    PassConfig(),
    PassConfig(uni_hw=True),
    PassConfig(uni_hw=True, uni_ann=True),
    PassConfig(uni_hw=True, uni_ann=True, uni_func=True),
    PassConfig(uni_hw=True, uni_ann=True, uni_func=True, zicond=True),
    PassConfig(uni_hw=True, uni_ann=True, uni_func=True, zicond=True,
               recon=True),
]


@dataclass
class CompiledKernel:
    module: Module
    fn: Function
    info: UniformityInfo
    config: PassConfig
    stats: Dict[str, Dict[str, int]] = field(default_factory=dict)


def run_pipeline(module: Module, kernel_name: str,
                 config: Optional[PassConfig] = None,
                 *, use_analysis_cache: bool = True,
                 am: Optional[AnalysisManager] = None) -> CompiledKernel:
    """Run the §4.3 pipeline.

    An AnalysisManager is threaded through every pass: CFG analyses
    (predecessors / dominators / post-dominators / loops / control deps)
    and uniformity results are memoized keyed by each function's IR
    version counters, so the up-to-5 uniformity re-runs the ladder
    mandates collapse into cache hits whenever the intervening pass
    changed nothing (or only instruction attrs).  ``use_analysis_cache=
    False`` restores the recompute-everything behavior for benchmarking.
    """
    config = config or PassConfig()
    tti = config.tti()
    stats: Dict[str, Dict[str, int]] = {}
    if am is None:
        am = AnalysisManager(enabled=use_analysis_cache)

    def uniformity(fn: Function) -> UniformityInfo:
        return am.uniformity(
            fn, tti, kernel_params_uniform=config.kernel_params_uniform
            and fn.name == kernel_name)

    for fn in module.functions.values():
        stats[f"simplify:{fn.name}"] = run_simplify(fn, am)
        stats[f"structurize:{fn.name}"] = run_structurize(fn, am)

    if config.uni_func:
        run_func_arg_analysis(module, tti, roots=[kernel_name], am=am)

    kfn = module.functions[kernel_name]
    infos: Dict[str, UniformityInfo] = {}
    for fn in module.functions.values():
        infos[fn.name] = uniformity(fn)

    if config.recon:
        for fn in module.functions.values():
            stats[f"recon:{fn.name}"] = run_reconstruct(fn, infos[fn.name],
                                                        am=am)
            infos[fn.name] = uniformity(fn)

    for fn in module.functions.values():
        stats[f"select:{fn.name}"] = lower_selects(fn, infos[fn.name], tti)
        # CFG may have changed: the manager recomputes iff it did
        infos[fn.name] = uniformity(fn)
        stats[f"simplify2:{fn.name}"] = run_simplify(fn, am)
        infos[fn.name] = uniformity(fn)

    for fn in module.functions.values():
        stats[f"divmgmt:{fn.name}"] = run_divmgmt(fn, infos[fn.name], am)
        stats[f"mir_safety:{fn.name}"] = run_mir_safety(
            fn, infos[fn.name], tti)
        verify(fn)

    return CompiledKernel(module, kfn, infos[kernel_name], config, stats)


def compile_pipeline(kernel_handle, config: Optional[PassConfig] = None
                     ) -> CompiledKernel:
    """Convenience: build VIR from a @kernel handle and run the pipeline."""
    module = kernel_handle.build()
    return run_pipeline(module, kernel_handle.name, config)
