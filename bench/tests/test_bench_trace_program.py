"""The program's spans and counters in a traced run (``bench/program.py``):
a synthetic trace split into forward, backward and recompute; the fields
and metrics ``bench/trace.py`` computes unchanged by the program's ranges;
the kernels' descriptions as the benchmark's spans make them; a run whose
program has no tracing module."""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest
import torch

# the port's modules first: they hold the tracing module once imported
import repro_torch.models.transformer  # noqa: F401
import repro_torch.train.train_step  # noqa: F401
from bench import harness, program, spans, trace
from bench.tests.helpers import BENCH, tiny_root
from bench.tests.test_bench_counts import _ev
from repro_torch import tracing

program.install()


def _op(name, ts, dur, seq, tid=1, fwd=0):
    return _ev("cpu_op", name, ts, dur, tid=tid,
               args={"Sequence number": seq, "Fwd thread id": fwd})


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr)


def _kernel(name, ts, dur, corr):
    return _ev("kernel", name, ts, dur, tid=7, corr=corr)


def _range(name, ts, dur, tid=1):
    return _ev("user_annotation", name, ts, dur, tid=tid)


def train_trace():
    """A step: the forward on the main thread (1), the backward on
    autograd's thread (2) with a period's rerun, AdamW on the main one."""
    P, E = "repro_torch.", "autograd::engine::evaluate_function: "
    return [
        _range("bench.window", 0, 200), _range("bench.step", 1, 189),
        _range(P + "train.step", 2, 178),
        _range(P + "train.forward", 3, 37), _range(P + "lm.period", 4, 26),
        _range("bench.flash_attention", 4.5, 4),
        _op("aten::mm", 5, 3, 10), _launch(6, 1), _kernel("gemm", 10, 10, 1),
        _op("RMSNorm", 11, 6, 11), _range(P + "kernel.rmsnorm", 12, 4),
        _launch(13, 2), _kernel("rms", 21, 4, 2),
        _range(P + "lm.loss_head", 31, 8), _op("aten::mm", 32, 3, 12),
        _launch(33, 3), _kernel("lm_head", 26, 10, 3),
        _range(P + "train.backward", 41, 109),
        _op(E + "MmBackward0", 45, 15, 12, tid=2, fwd=1),
        _launch(50, 4, tid=2), _kernel("lm_head_bwd", 40, 20, 4),
        _op(E + "RMSNormBackward", 61, 39, 11, tid=2, fwd=1),
        _range(P + "lm.period", 62, 18, tid=2),
        _op("aten::mm", 63, 3, 0, tid=2), _launch(64, 5, tid=2),
        _kernel("gemm", 61, 10, 5),
        _range(P + "kernel.rmsnorm_bwd", 85, 10, tid=2),
        _range("bench.flash_attention_bwd", 84, 12, tid=2),
        _launch(90, 6, tid=2), _kernel("rms_bwd", 72, 8, 6),
        _op(E + "MmBackward0", 101, 19, 10, tid=2, fwd=1),
        _launch(110, 7, tid=2), _kernel("gemm_bwd", 81, 20, 7),
        _launch(125, 8, tid=2), _kernel("acc", 102, 2, 8),
        _range(P + "train.optimizer", 151, 24),
        _range("bench.adamw_update", 151.5, 23),
        _launch(152, 9), _kernel("adam", 105, 20, 9),
        _range(P + "train.grad_norm", 153, 7), _launch(154, 10),
        _kernel("norm", 126, 4, 10),
        _launch(185, 11), _ev("gpu_memcpy", "Memcpy DtoH", 131, 2, tid=7,
                              corr=11),
    ]


def prefill_trace():
    """A batch: a period's attention and MoE layer, then the unembedding;
    the program's ranges as torch's fast ranges record them."""
    P = "repro_torch."
    return [_program_op(e) for e in [
        _range("bench.window", 0, 100), _range("bench.prefill", 1, 94),
        _range(P + "lm.prefill", 2, 88), _range(P + "lm.period", 3, 77),
        _range("bench.flash_attention", 4, 6),
        _range(P + "kernel.flash_attention", 5, 4),
        _launch(6, 1), _kernel("fa", 10, 5, 1),
        _range("bench.moe_ff", 11, 59), _range(P + "moe.ff", 12, 57),
        _range(P + "moe.route", 13, 7), _launch(14, 2),
        _kernel("router", 16, 4, 2), _launch(18, 3), _kernel("sort", 21, 2, 3),
        _range(P + "moe.dispatch", 21, 9), _launch(25, 4),
        _kernel("gather", 24, 3, 4),
        _range(P + "moe.expert_ff", 31, 19),
        _range("bench.grouped_expert_ff", 32, 17),
        _range(P + "kernel.grouped_expert_ff", 33, 15),
        _launch(40, 5), _kernel("moe_up", 28, 20, 5),
        _launch(45, 6), _kernel("moe_down", 49, 15, 6),
        _range(P + "moe.combine", 51, 17), _launch(55, 7),
        _kernel("mul", 65, 10, 7), _launch(60, 8),
        _kernel("gather_sum", 76, 2, 8),
        _launch(85, 9), _kernel("unembed", 80, 2, 9),
        _launch(92, 10), _ev("gpu_memcpy", "Memcpy DtoH", 83, 1, tid=7,
                             corr=10),
    ]]


def _program_op(e):
    if e["name"].startswith(program.PREFIX):
        e["cat"] = "cpu_op"
    return e


def _no_program(events):
    return [e for e in events if not e["name"].startswith(program.PREFIX)]


def test_train_step_splits_into_forward_backward_and_recompute():
    p = program.reduce_program(train_trace())
    assert p.forward == pytest.approx({
        "train.step": 108, "train.forward": 24, "lm.period": 14,
        "kernel.rmsnorm": 4, "lm.loss_head": 10, "train.backward": 60,
        "kernel.rmsnorm_bwd": 8, "train.optimizer": 24,
        "train.grad_norm": 4})
    # the rerun on autograd's thread inside train.backward
    assert p.recompute == pytest.approx({"lm.period": 10})
    assert p.n_recompute == {"lm.period": 1}
    # by sequence number: the loss head's product, the norm's Function
    # (opened around the kernel's span, so not the kernel's) and the
    # period's product
    assert p.backward == pytest.approx({
        "lm.loss_head": 20, "lm.period": 28, "train.forward": 48,
        "train.step": 48})
    assert p.count("train.step") == 1 and p.count("lm.period") == 1
    assert p.busy_s_in("train.step") == pytest.approx(108e-6)
    assert p.coverage["train.step"] == pytest.approx((108, 108))
    # the engine's own launch (no function, no span) is left out
    assert p.coverage["train.backward"] == pytest.approx((58, 60))
    assert p.ops["lm.period"] == {
        "forward": {"gemm": 10, "rms": 4}, "recompute": {"gemm": 10},
        "backward": {"rms_bwd": 8, "gemm_bwd": 20}}


def test_prefill_batch_and_the_glue_share():
    p = program.reduce_program(prefill_trace())
    assert p.device_s("moe.ff") == pytest.approx(56e-6)
    assert p.device_s("moe.expert_ff") == pytest.approx(35e-6)
    assert p.busy_s_in("lm.prefill") == pytest.approx(63e-6)
    assert p.coverage["lm.prefill"] == pytest.approx((61, 63))
    assert p.backward == {} and p.recompute == {}
    run = SimpleNamespace(summary=trace.reduce_events(prefill_trace()),
                          traffic={"driver": "prefill"},
                          record={"counters": {"moe.assignments": 400,
                                               "moe.kept": 300}})
    read = _reader("moe_glue_share.prefill")
    assert read(run) == pytest.approx(100 * 21 / 63)
    assert _reader("moe_dropped.prefill")(run) == pytest.approx(25.0)
    run.traffic = {"driver": "train"}
    assert read(run) is None


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


def test_recompute_share_reads_the_rerun_over_the_step():
    run = SimpleNamespace(summary=trace.reduce_events(train_trace()),
                          traffic={"driver": "train"}, record={})
    assert _reader("recompute_share.train")(run) == pytest.approx(
        100 * 10 / 108)
    run.summary = program._REDUCE(train_trace())
    assert _reader("recompute_share.train")(run) is None


def _fields(s):
    return (s.busy_s, s.window_s, s.instances, s.ops, s.launches_found,
            s.n_device_events, s.busy)


@pytest.mark.parametrize("make", [train_trace, prefill_trace])
def test_benchmark_fields_unchanged_by_the_program(make):
    bare = _no_program(make())
    old = program._REDUCE(bare)
    assert _fields(program._reduce_events(bare)) == _fields(old)
    assert program._reduce_events(bare).gaps == old.gaps
    new = program._reduce_events(make())
    assert _fields(new) == _fields(old)
    # the gaps as they were, each naming its program range besides
    stripped: dict = {}
    for label, us in new.gaps.items():
        where, op = label.split(": ", 1)
        key = f"{where.split(' > ')[0]}: {op}"
        stripped[key] = stripped.get(key, 0.0) + us
    assert stripped == pytest.approx(old.gaps)
    assert any(" > repro_torch." in k for k in new.gaps)


def test_pr30_trace_reduces_as_before():
    from bench.tests.test_bench_counts import test_trace_reduction
    assert trace.reduce_events is program._reduce_events
    test_trace_reduction()


EXISTING = ["mfu.train", "optimizer_share.train", "attention_roofline.train",
            "device_idle.train", "peak_gb.train", "mfu.prefill",
            "moe_share.prefill", "expert_ff_roofline.prefill",
            "attention_roofline.prefill", "device_idle.prefill"]


def _arg(shape, dtype="torch.bfloat16", tensor=None):
    return {"shape": shape, "dtype": dtype, "tensor": tensor}


def _run(events, reduce, driver):
    q, kv = _arg((2, 16, 512, 128)), _arg((2, 16, 512, 128))
    lse = _arg((2, 16, 512), "torch.float32")
    counts = torch.tensor([40, 0, 100], dtype=torch.int32)
    calls = {"flash_attention": [{"args": [q, kv, kv],
                                  "kwargs": {"causal": True}}],
             "flash_attention_bwd": [{"args": [q, kv, kv, q, q, lse],
                                      "kwargs": {"causal": True}}],
             "grouped_expert_ff": [{"args": [
                 _arg((3, 160, 2048)), _arg((3, 2048, 2048)),
                 _arg((3, 1024, 2048)),
                 _arg((3,), "torch.int32", counts)], "kwargs": {}}]}
    name = {"train": "granite-3-2b", "prefill": "olmoe-1b-7b"}[driver]
    mix = {"train": "train-16k", "prefill": "prefill-mix"}[driver]
    return SimpleNamespace(
        summary=reduce(events),
        device_summary=trace.reduce_device(events, 250e-6),
        spans=SimpleNamespace(calls=calls),
        record={"traced_steps": [5], "traced_shapes": [(16, 512)],
                "stretch_peak_bytes": 4.4e10},
        traffic=json.loads((BENCH / "traffic" / f"{mix}.json").read_text()),
        config=json.loads((BENCH / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("make,driver", [(train_trace, "train"),
                                         (prefill_trace, "prefill")])
def test_existing_metrics_read_the_same(make, driver):
    """Each of the ten per-layer metrics of the benchmark reads the same
    from a trace of a program without spans reduced as before, and from
    the trace with the program's ranges reduced with them."""
    before = _run(_no_program(make()), program._REDUCE, driver)
    after = _run(make(), program._reduce_events, driver)
    read = {}
    for name in EXISTING:
        r = _reader(name)
        read[name] = r(before)
        assert r(after) == read[name], name
    assert sum(v is not None for v in read.values()) >= 4, read


KERNELS = [
    ("repro_torch.kernels.flash_attention.flash_attention:flash_attention",
     "kernel.flash_attention",
     lambda t: ((t(1, 2, 8, 32), t(1, 1, 8, 32), t(1, 1, 8, 32)),
                {"causal": True, "with_lse": True})),
    ("repro_torch.kernels.flash_attention.flash_attention_bwd:"
     "flash_attention_bwd", "kernel.flash_attention_bwd",
     lambda t: ((t(1, 2, 8, 32), t(1, 1, 8, 32), t(1, 1, 8, 32),
                 t(1, 2, 8, 32), t(1, 2, 8, 32), t(1, 2, 8)),
                {"causal": True})),
    ("repro_torch.kernels.moe_dispatch.moe_dispatch:grouped_expert_ff",
     "kernel.grouped_expert_ff",
     lambda t: ((t(2, 4, 16), t(2, 16, 16), t(2, 8, 16),
                 torch.tensor([3, 1], dtype=torch.int32)), {})),
    ("repro_torch.kernels.rmsnorm.rmsnorm:rmsnorm", "kernel.rmsnorm",
     lambda t: ((t(4, 16), t(16)), {"with_rstd": True})),
    ("repro_torch.kernels.rmsnorm.rmsnorm_bwd:rmsnorm_bwd",
     "kernel.rmsnorm_bwd",
     lambda t: ((t(4, 16), t(16), t(4).abs(), t(4, 16)), {})),
    ("repro_torch.kernels.moe_dispatch.moe_combine:gather_sum",
     "kernel.gather_sum",
     lambda t: ((t(6, 16), torch.tensor([[0, 6], [2, 5], [6, 6]],
                                        dtype=torch.int32)), {})),
]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, torch.Tensor):
        return a is b
    return a == b


@pytest.mark.parametrize("target,name,make", KERNELS,
                         ids=[k[1] for k in KERNELS])
def test_kernel_span_describes_its_call_as_the_benchmark(target, name, make):
    g = torch.Generator().manual_seed(0)
    args, kwargs = make(lambda *s: torch.randn(*s, generator=g))
    sp = spans.Spans()
    sp.wrap("k", target)
    sp.recording = True
    tracing.reset()
    tracing.enable(True)
    try:
        mod, attr = target.split(":")
        getattr(sys.modules[mod], attr)(*args, **kwargs)
    finally:
        tracing.enable(False)
        sp.undo()
    got = tracing.calls()[name]
    tracing.reset()
    assert len(got) == 1 and _same(got[0], sp.calls["k"][0])


def test_kernel_span_keeps_no_large_integer_tensor():
    """The combine's slots at a batch of 8,192 tokens (65,536 integers)
    are described by shape alone; the benchmark's spans never wrap it."""
    slots = torch.zeros(8192, 8, dtype=torch.int32)
    counts = torch.zeros(384, dtype=torch.int32)
    assert tracing.describe(slots)["tensor"] is None
    assert tracing.describe(counts)["tensor"] is counts
    assert spans.describe(counts)["tensor"] is counts


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_program_without_tracing_reads_as_before(root, monkeypatch):
    """The parent's program has no tracing module: every metric it had
    reads as before, the new ones read nothing, and no gap names a
    program range."""
    for m in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, m)
    cell = "tiny-moe.prefill-tiny"
    new = harness.run_cell(root, cell, 2**31 + 5, 0.1, True, "cpu")
    assert set(new["metrics"]) == {"moe_dropped.prefill"}
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    old = harness.run_cell(root, cell, 2**31 + 5, 0.1, True, "cpu")
    assert old["metrics"] == {} and old["correct"]
    assert not any(" > " in g for g, _ in old["breakdown"]["idle_gaps"])
    assert not tracing.enabled()
