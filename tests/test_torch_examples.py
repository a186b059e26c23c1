"""The port's four examples (``examples/torch_*.py``) run on the CPU at a
small size, each in a subprocess of its own, and load neither ``jax`` nor
any module of the JAX package ``repro``: the subprocess runs the script
as ``__main__`` and then lists what ``sys.modules`` holds. On the card
``chip_smoke.py`` runs them without ``--device``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SCRIPTS = ("torch_quickstart.py", "torch_volt_simt_demo.py",
           "torch_serve_lm.py", "torch_train_lm.py")

_RUN = """
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def _run(script, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               VOLT_CACHE_DIR=str(tmp_path / "volt_cache"))
    p = subprocess.run([sys.executable, "-c", _RUN, str(EXAMPLES / script),
                        *args], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "LOADED []" in p.stdout, p.stdout[-2000:]
    return p.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_imports_torch_and_the_port_only(script):
    """Every import of the script names torch, numpy, the standard
    library or ``repro_torch``."""
    tree = ast.parse((EXAMPLES / script).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_quickstart_runs_on_cpu(tmp_path):
    out = _run("torch_quickstart.py", ["--device", "cpu"], tmp_path)
    assert "=== Vortex-flavored assembly ===" in out
    assert "torch backend on cpu matches the interpreter: OK" in out


def test_volt_simt_demo_runs_on_cpu(tmp_path):
    out = _run("torch_volt_simt_demo.py", ["--device", "cpu"], tmp_path)
    assert out.count("base+hw+ann+func+zic+rec") == 3
    assert "saxpy through simt_exec (plain torch version, cpu): OK" in out


@pytest.mark.parametrize("mode,want", [
    ([], "[serve] drained in"),
    (["--storm"], "[storm] post-storm clean request ok: engine alive"),
    (["--launch-storm"], "[launch-storm] all tenants bit-identical"),
])
def test_serve_lm_runs_on_cpu(mode, want, tmp_path):
    out = _run("torch_serve_lm.py", ["--device", "cpu", *mode], tmp_path)
    assert want in out


def test_train_lm_runs_on_cpu(tmp_path):
    """Two steps of the ~110M model at batch 2 and 32 tokens."""
    out = _run("torch_train_lm.py", ["--device", "cpu", "--batch", "2",
                                     "--seq", "32", "--steps", "2",
                                     "--ckpt", str(tmp_path / "ck")],
               tmp_path)
    assert "granite-110m: 100.7M params on cpu" in out
    assert "[train_lm] 2 steps: loss" in out
