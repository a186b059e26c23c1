"""What the benchmark's modules load, each in a fresh interpreter: the
reference nothing of JAX, of the JAX package or of the port; the harness
nothing of JAX or the JAX package. Top-level names are compared whole:
``repro_torch`` begins with ``repro``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench.tests.helpers import ROOT

JAX = ("jax", "jaxlib", "flax", "repro")

PROBE = """
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for m in {mods!r}:
    importlib.import_module(m)
{extra}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(mods, extra=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods,
                        extra=extra)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_jax_and_nothing_of_the_port():
    got = _top_level(["bench.reference.lm", "bench.weights",
                      "bench.generator"])
    assert not got & set(JAX + ("repro_torch",)), got & set(
        JAX + ("repro_torch",))


def test_harness_imports_no_jax():
    # every module of the benchmark, the port's modules that the drivers
    # and spans load, and every metric's reader
    extra = """
from pathlib import Path
from bench.harness import load_module
for p in sorted((Path({root!r}) / 'bench').rglob('*.py')):
    if 'tests' not in p.parts:
        load_module(p)
import bench.drivers._common as c
import repro_torch.models.registry, repro_torch.train.train_step
import repro_torch.models.moe, repro_torch.kernels.moe_dispatch.moe_dispatch
""".format(root=str(ROOT))
    got = _top_level(["bench.harness", "bench.trace", "bench.spans",
                      "bench.control"], extra)
    assert not got & set(JAX), got & set(JAX)
    assert "repro_torch" in got
