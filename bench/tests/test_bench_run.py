"""Whole runs of small cells on the CPU (the harness's look for a card
skipped), with the timed path sound and broken underneath, and the runs
that must give no result."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench import harness
from bench.tests.helpers import ROOT, tiny_root

DENSE_PREFILL = "tiny-dense.prefill-tiny"
MOE_PREFILL = "tiny-moe.prefill-tiny"
TRAIN = "tiny-dense.train-tiny"
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def clean_modules(monkeypatch):
    """A test process may hold JAX from other test files; a run checks
    its own process, so they are hidden for the run."""
    for m in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, m)


def _run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.2, trace, "cpu")


@pytest.mark.parametrize("cell", [DENSE_PREFILL, MOE_PREFILL, TRAIN])
def test_sound_run_is_correct(root, clean_modules, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_manifest(root), cell, "end_to_end")}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    json.dumps(out)


def test_traced_run_reads_no_device_metric_on_the_host(root, clean_modules):
    out = _run(root, DENSE_PREFILL, trace=True)
    assert out["correct"]
    # no device events on the CPU: every reader of the trace is silent
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_answer(orig):
    def prefill(self, params, tokens):
        out = orig(self, params, tokens).clone()
        out[0, 0] = out[0].max() + 1.0
        return out
    return prefill


def _half_batch_prefill(orig):
    def prefill(self, params, tokens):
        B = tokens.shape[0]
        half = orig(self, params, tokens[:max(1, B // 2)])
        return torch.cat([half, half])[:B]
    return prefill


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_broken_prefill_is_not_correct(root, clean_modules, monkeypatch,
                                       fault):
    from repro_torch.models.transformer import LM
    make = _alter_answer if fault == "answer_altered" else \
        _half_batch_prefill
    monkeypatch.setattr(LM, "prefill", make(LM.prefill))
    out = _run(root, DENSE_PREFILL)
    assert not out["correct"], out["checks"]
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    # half the rows wrong fails a number that the full-size cell compares
    # too; one altered answer only the small cell's greedy gap
    assert {"half_batch": "logit_err_mean",
            "answer_altered": "greedy_gap_max"}[fault] in failed


def _unchanged_state(params, grads, state, cfg, grad_norm=None):
    from repro_torch.train.optimizer import global_norm
    return params, dict(state, step=state["step"] + 1), {
        "grad_norm": global_norm(grads), "lr": torch.zeros(())}


def _half_batch_loss(orig):
    def loss_fn(self, params, batch, remat=True):
        t = batch["tokens"]
        return orig(self, params, {"tokens": t[: t.shape[0] // 2]},
                    remat=remat)
    return loss_fn


def _token_altered_loss(orig):
    def loss_fn(self, params, batch, remat=True):
        t = batch["tokens"].clone()
        t[0, t.shape[1] // 2] = (t[0, t.shape[1] // 2] + 1) % self.cfg.vocab
        return orig(self, params, {"tokens": t}, remat=remat)
    return loss_fn


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_broken_train_step_is_not_correct(root, clean_modules, monkeypatch,
                                          fault):
    from repro_torch.models.transformer import LM
    from repro_torch.train import train_step
    if fault == "state_unchanged":
        monkeypatch.setattr(train_step, "adamw_update", _unchanged_state)
    elif fault == "half_batch":
        monkeypatch.setattr(LM, "loss_fn", _half_batch_loss(LM.loss_fn))
    else:
        monkeypatch.setattr(LM, "loss_fn", _token_altered_loss(LM.loss_fn))
    out = _run(root, TRAIN)
    assert not out["correct"], out["checks"]


def test_a_module_of_jax_refuses_the_result(root, clean_modules,
                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.HarnessError, match="jax"):
        _run(root, DENSE_PREFILL)


def _bench_cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmoe-1b-7b.prefill-mix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    r = _bench_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_cells_on_the_card(cuda, root, clean_modules):
    for cell in (DENSE_PREFILL, TRAIN):
        out = harness.run_cell(root, cell, SEED, 0.5, False, "cuda")
        assert out["device"]["platform"] == "gpu"
        assert out["metrics"] and out["checks"]


@pytest.mark.cuda
def test_benchmark_files_alone_give_no_result(cuda, tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmoe-1b-7b.prefill-mix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
