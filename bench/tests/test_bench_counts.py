"""The counts behind ``mfu.*`` and the rooflines, and the reduction of a
trace to per-layer numbers."""
from __future__ import annotations

import json

import pytest
import torch

from bench import trace, weights
from bench.metrics import _work as W
from bench.tests.helpers import BENCH, DATA


def _config(name):
    path = (BENCH / "configs" / f"{name}.json") if "tiny" not in name \
        else DATA / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name,total", [("granite-3-2b", 2_534_049_792),
                                        ("olmoe-1b-7b", 6_919_620_608)])
def test_param_totals_are_the_cards(name, total):
    assert weights.count(_config(name)) == total


def test_tiny_dense_by_hand():
    c = _config("tiny-dense")
    # L 2, d 128, H 4, Hkv 2, D 32, ff 256, V 250 (pad 256), tied
    per_layer = 128 * 128 + 2 * 128 * 64 + 128 * 128 + 3 * 128 * 256
    assert weights.count(c) == 256 * 128 + 2 * (per_layer + 2 * 128) + 128
    layers, unembed = W.matmul_weights_per_token(c)
    assert (layers, unembed) == (2 * per_layer, 128 * 250)
    B, S = 3, 16
    attn = 12 * 2 * B * 4 * 32 * (16 * 17 // 2)
    assert W.train_flops(c, B, S) == 6 * (2 * per_layer + 128 * 250) * 48 \
        + attn
    assert W.prefill_flops(c, B, S) == 2 * 2 * per_layer * 48 \
        + 2 * 128 * 250 * B + attn / 3


def test_tiny_moe_by_hand():
    c = _config("tiny-moe")
    # E 8 top-2, f 64: the router and two experts a token
    attn = 4 * 128 * 128
    assert W.matmul_weights_per_token(c)[0] == 2 * (
        attn + 128 * 8 + 2 * 3 * 128 * 64)


def test_full_size_model_flops():
    g = _config("granite-3-2b")
    f = W.train_flops(g, 8, 2048)
    assert f == pytest.approx(2.656e14, rel=2e-3)
    o = _config("olmoe-1b-7b")
    layers, _ = W.matmul_weights_per_token(o)
    assert layers == 16 * (4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024)


def _arg(shape, dtype="torch.bfloat16", tensor=None):
    return {"shape": shape, "dtype": dtype, "tensor": tensor}


def test_attention_work():
    assert W.causal_pairs(4, 4, True) == 10
    assert W.causal_pairs(2, 4, True) == 3 + 4
    assert W.causal_pairs(3, 5, False) == 15
    q, kv = _arg((2, 8, 16, 64)), _arg((2, 2, 16, 64))
    f, b = W.attention_fwd({"args": [q, kv, kv],
                            "kwargs": {"causal": True, "with_lse": True}})
    assert f == 4 * 2 * 8 * 64 * 136
    assert b == 2 * (2 * 8 * 16 * 64) * 2 + 2 * (2 * 2 * 16 * 64) * 2 \
        + 4 * 2 * 8 * 16
    lse = _arg((2, 8, 16), "torch.float32")
    f, b = W.attention_bwd({"args": [q, kv, kv, q, q, lse],
                            "kwargs": {"causal": True}})
    assert f == 10 * 2 * 8 * 64 * 136
    assert b == 2 * 2 * (2 * 8 * 16 * 64) + 2 * 2 * (2 * 2 * 16 * 64) * 2 \
        + 2 * 2 * (2 * 8 * 16 * 64) + 4 * 2 * 8 * 16


def test_expert_ff_counts_kept_rows_and_live_experts():
    counts = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    call = {"args": [_arg((4, 6, 32)), _arg((4, 32, 2 * 16)),
                     _arg((4, 16, 32)),
                     _arg((4,), "torch.int32", counts)], "kwargs": {}}
    f, b = W.expert_ff(call)
    assert f == 9 * 6 * 32 * 16
    assert b == 2 * 9 * 32 * 2 + 3 * 3 * 32 * 16 * 2 + 16
    assert W.expert_ff({"args": call["args"][:3], "kwargs": {}}) is None
    assert W.bound_s(989e12, 0) == pytest.approx(1.0)
    assert W.bound_s(0, 3.35e12) == pytest.approx(1.0)


def _ev(cat, name, ts, dur, tid=1, corr=None, **extra):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    e.update(extra)
    return e


def test_trace_reduction():
    ev = [
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", "bench.step", 1, 90),
        _ev("user_annotation", "bench.adamw_update", 50, 30),
        _ev("cpu_op", "aten::mm", 2, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        # the backward's range on another thread
        _ev("user_annotation", "bench.flash_attention_bwd", 10, 5, tid=2),
        _ev("cuda_driver", "cuLaunchKernel", 11, 1, tid=2, corr=4),
        _ev("kernel", "gemm", 10, 20, tid=7, corr=1),
        _ev("kernel", "adam", 56, 10, tid=7, corr=2),
        _ev("kernel", "adam", 70, 5, tid=7, corr=3),
        _ev("kernel", "fa_bwd", 30, 10, tid=7, corr=4),
        _ev("gpu_memcpy", "Memcpy DtoH", 90, 5, tid=7, corr=99),
    ]
    s = trace.reduce_events(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 10 + 5 + 5) * 1e-6)
    assert s.device_s("adamw_update") == pytest.approx(15e-6)
    assert s.device_s("step") == pytest.approx(35e-6)
    # the backward thread's kernel lies inside the step's span
    assert s.busy_s_in("step") == pytest.approx(45e-6)
    assert s.device_s("flash_attention_bwd") == pytest.approx(10e-6)
    assert s.busy_s_in("adamw_update") == pytest.approx(15e-6)
    assert s.count("adamw_update") == 1
    assert s.launches_found == pytest.approx(4 / 5)
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    labels = dict(bd["idle_gaps"])
    # before the step and after it; inside the step; inside AdamW
    assert labels["-: host"] == pytest.approx(15e-6)
    assert labels["bench.step: bench.step"] == pytest.approx(16e-6)
    assert labels["bench.adamw_update: bench.adamw_update"] == \
        pytest.approx(19e-6)
    with pytest.raises(ValueError):
        trace.reduce_events(ev[1:])
