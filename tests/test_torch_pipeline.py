"""The port's copy of the compiler (frontends, VIR, passes, bench suite)
against the reference's: the same kernel source through both pipelines
gives the same VIR, and the port imports nothing of the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.passes.pipeline import ABLATION_LADDER as REF_LADDER
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.core.passes.pipeline import ABLATION_LADDER, run_pipeline
from repro_torch.volt_bench.suite import BENCHES

ROOT = Path(__file__).resolve().parents[1]

_SUFFIX = re.compile(r"(%v)(\d+)\b|(%[A-Za-z_][\w.]*\.)(\d+)(?![\w.])")


def _renumber(dump: str) -> str:
    """Number the ``%vN`` registers and ``%name.N`` block labels in order
    of first appearance: their suffixes come from process-global
    counters, so two builds of one kernel never match raw."""
    seen = {}

    def sub(m):
        key = m.group(0)
        if key not in seen:
            seen[key] = len(seen)
        return f"{m.group(1) or m.group(3)}#{seen[key]}"

    return _SUFFIX.sub(sub, dump)


def test_renumber_is_a_bijection_on_suffixes():
    a = "%v7 = add %v3 %v7\n  %for.cond.12:\n  br label %for.cond.12 f32 0.5"
    b = "%v1 = add %v9 %v1\n  %for.cond.4:\n  br label %for.cond.4 f32 0.5"
    assert _renumber(a) == _renumber(b)
    assert _renumber(a) != _renumber(a.replace("%v3", "%v7"))


@pytest.mark.parametrize("cfg_i", range(len(ABLATION_LADDER)),
                         ids=[c.label for c in ABLATION_LADDER])
@pytest.mark.parametrize("name", list(BENCHES))
def test_pipeline_dump_matches_reference(name, cfg_i):
    b, rb = BENCHES[name], REF_BENCHES[name]
    ck = run_pipeline(b.handle.build(None), b.handle.name,
                      ABLATION_LADDER[cfg_i])
    rk = ref_run_pipeline(rb.handle.build(None), rb.handle.name,
                          REF_LADDER[cfg_i])
    assert ABLATION_LADDER[cfg_i].label == REF_LADDER[cfg_i].label
    assert _renumber(ck.module.dump()) == _renumber(rk.module.dump())
    assert ck.stats == rk.stats


def test_port_imports_nothing_of_jax_or_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {f'repro_torch.{m}' for m in ("
        "'configs.granite_3_2b', 'models.blueprint', 'models.layers', "
        "'models.transformer', 'models.registry', 'core.faults', "
        "'serve.engine', 'launch.serve', 'kernels.build', "
        "'kernels.rmsnorm.rmsnorm', "
        "'kernels.flash_attention.flash_attention', "
        "'configs.olmoe_1b_7b', 'models.moe', "
        "'kernels.moe_dispatch.moe_dispatch', "
        "'configs.jamba_1_5_large_398b', 'models.ssm', "
        "'kernels.selective_scan.selective_scan', 'core.interp', "
        "'core.interp_mem', 'core.governor', 'core.parallel', "
        "'core.simx', 'core.runtime', 'core.backends.asm', "
        "'core.backends.torchgen', 'train.data', 'train.optimizer', "
        "'train.train_step', 'train.checkpoint', 'train.loop', "
        "'launch.train', 'kernels.rmsnorm.rmsnorm_bwd', "
        "'kernels.flash_attention.flash_attention_bwd', "
        "'distributed.collectives', 'distributed.context', "
        "'distributed.pipeline', 'launch.mesh', 'launch.dryrun', "
        "'launch.roofline', 'launch.perf_table', 'launch.recost')}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("clean")


def test_importing_the_dry_run_changes_no_state():
    """The reference's dry run sets XLA_FLAGS at import; the port's sets
    nothing and starts no process group until a cell runs."""
    code = (
        "import os, torch.distributed as dist\n"
        "env = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.recost\n"
        "import repro_torch.launch.mesh, repro_torch.distributed.pipeline\n"
        "assert dict(os.environ) == env, set(os.environ) ^ set(env)\n"
        "assert not dist.is_initialized()\n"
        "print('unchanged')\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("unchanged")
