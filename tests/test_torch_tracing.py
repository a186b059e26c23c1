"""The program's spans and counters (``repro_torch.tracing``) on the host:
off, a run records nothing; on, a smoke MoE LM's prefill and train step
(remat) give every span, nested as the program opens them; the MoE
counters against ``dropped_share``; the kernels' launch counters as dicts;
the kernel builds and loads."""
from __future__ import annotations

import copy
import json
import os
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.models import get_model
from repro_torch.models import moe as MOE
from repro_torch.models.blueprint import init_params
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import StepConfig, build_train_step

#: each span -> the spans it may open inside (the innermost program
#: range around it on its thread)
PARENTS = {
    "lm.prefill": {None},
    "train.step": {None},
    "train.forward": {"train.step"},
    "train.backward": {"train.step"},
    "train.optimizer": {"train.step"},
    "train.grad_norm": {"train.optimizer"},
    "lm.period": {"lm.prefill", "train.forward", "train.backward"},
    "lm.loss_head": {"train.forward"},
    "moe.ff": {"lm.period"},
    "moe.route": {"moe.ff"},
    "moe.dispatch": {"moe.ff"},
    "moe.expert_ff": {"moe.ff"},
    "moe.combine": {"moe.ff"},
    "kernel.rmsnorm": {"lm.period", "lm.prefill", "lm.loss_head"},
    "kernel.flash_attention": {"lm.period"},
    "kernel.grouped_expert_ff": {"moe.expert_ff"},
    # the combine's gather, and the dispatch's gradient in the backward
    "kernel.gather_sum": {"moe.combine", "train.backward"},
    "kernel.rmsnorm_bwd": {"train.backward"},
    "kernel.flash_attention_bwd": {"train.backward"},
}


@pytest.fixture(autouse=True)
def clean_tracing():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


def _traced(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _prefill_and_step(model, params, tokens):
    def run():
        with torch.no_grad():
            model.prefill(params, tokens)
        step = build_train_step(model, StepConfig(remat=True))
        step(params, init_opt_state(params, AdamWConfig()),
             {"tokens": tokens})
    return run


def test_tracing_off_records_no_range_and_no_device_counter(tmp_path, smoke):
    cfg, model, params, tokens = smoke
    events = _traced(tmp_path, _prefill_and_step(model, copy.deepcopy(params),
                                                 tokens))
    assert not [e for e in events if e["name"].startswith(tracing.PREFIX)]
    assert not any(k.startswith("moe.") for k in tracing.counters())
    assert tracing.calls() == {}
    assert tracing.span("lm.prefill") is tracing.span("moe.ff")


def test_spans_nest_as_the_program_opens_them(tmp_path, smoke):
    cfg, model, params, tokens = smoke
    tracing.enable(True)
    events = _traced(tmp_path, _prefill_and_step(model, copy.deepcopy(params),
                                                 tokens))
    spans = sorted(((float(e["ts"]), -float(e["dur"]), e["tid"],
                     e["name"][len(tracing.PREFIX):]) for e in events
                    if e["name"].startswith(tracing.PREFIX)))
    assert {s[3] for s in spans} == set(PARENTS)
    stack: dict = {}
    parents: dict = {}
    for ts, neg, tid, name in spans:
        st = stack.setdefault(tid, [])
        while st and st[-1][1] <= ts:
            st.pop()
        parents.setdefault(name, set()).add(st[-1][2] if st else None)
        st.append((ts, ts - neg, name))
    for name, got in parents.items():
        assert got <= PARENTS[name], (name, got)
    n = Counter(s[3] for s in spans)
    L = cfg.n_layers
    # prefill, the forward and remat's rerun in the backward
    assert n["lm.period"] == n["moe.ff"] == 3 * L
    assert n["lm.prefill"] == n["train.step"] == n["lm.loss_head"] == 1
    back = [s for s in spans if s[3] == "train.backward"][0]
    inside = [s for s in spans if s[3] == "lm.period"
              and back[0] <= s[0] <= back[0] - back[1]]
    assert len(inside) == L


def test_kept_over_assignments_is_one_less_the_dropped_share(smoke):
    cfg, model, params, _ = smoke
    # the first period's MoE layer
    p = {k: v[0] for k, v in params["stack"][0]["moe"].items()}
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.moe_capacity)
    tracing.enable(True)
    with torch.no_grad():
        MOE.moe_ff(p, x, **kw)
        MOE.moe_ff(p, x, **kw)
    c = tracing.counters()
    assert c["moe.assignments"] == 2 * 2 * 64 * cfg.moe_top_k
    assert c["moe.kept"] / c["moe.assignments"] == pytest.approx(
        1.0 - MOE.dropped_share(p, x, **kw), abs=1e-12)
    assert sum(c["moe.expert_load"]) == c["moe.assignments"]
    assert len(c["moe.expert_load"]) == cfg.moe_experts
    tracing.reset()
    assert tracing.counters() == {}


def test_launch_routes_are_dicts_kept_in_the_counters():
    routes = FA.LAUNCHES_BY_ROUTE
    before = dict(routes)
    assert set(before) == {"tensor_cores", "cuda_cores", "decode"}
    routes["decode"] += 2
    assert routes == {**before, "decode": before["decode"] + 2}
    assert (1, routes) == (1, {**before, "decode": before["decode"] + 2})
    assert tracing.counters()["launches.flash_attention.decode"] == \
        before["decode"] + 2
    routes.update(before)
    assert dict(routes) == before
    with pytest.raises(KeyError):
        routes["tpu"] += 1


def test_kernel_builds_and_loads_are_counted(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    srcs = ["int a;", "int b;"]
    out = build.build_many("probe", srcs, flags=["-O3"], include=[])
    assert all(so.exists() for so, _ in out)
    c = tracing.counters()
    assert c["kernel.builds"] == 2 and c["kernel.build_s"] > 0
    assert "kernel.loads" not in c
    build.build_many("probe", srcs, flags=["-O3"], include=[])
    c = tracing.counters()
    assert c["kernel.builds"] == 2 and c["kernel.loads"] == 2
