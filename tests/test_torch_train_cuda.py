"""The backward kernels and training on the card: each backward kernel
against its plain version on each of its routes, bit for bit
determinism, the forward's lse, the MoE and mamba smoke losses
backpropagating through their backward kernels, and a few train_loop
steps.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Skips where ``torch.cuda.is_available()`` is false.

Tolerances, as the largest |got - want| over the largest |want| of each
output: bf16 1e-2 (both sides round one float32 result to bf16, so they
differ by at most one bf16 ulp, 2^-7 of the largest value); float32
1e-4 (float32 sums of up to 8192 terms in another order). The smoke
model's loss on the card against the CPU: 2e-2 absolute on a loss of
about 6.9, per-leaf gradients at relative L2 2e-2 (bf16 products in
another order), as ``tests/test_torch_train.py`` holds the port to the
JAX package.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention_bwd as FB
from repro_torch.kernels.moe_dispatch import moe_combine as MC
from repro_torch.kernels.moe_dispatch import moe_dispatch_bwd as MB
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as RB
from repro_torch.kernels.selective_scan import selective_scan_bwd as SB
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import AdamWConfig, leaves
from repro_torch.train.train_step import StepConfig, value_and_grad

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    assert got.dtype == want.dtype and got.shape == want.shape
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("N,d", [(8192, 2048), (300, 2048), (5, 300),
                                 (64, 7168), (33, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, N, d, dtype):
    g = torch.Generator(cuda).manual_seed(N + d)
    x = torch.randn(N, d, generator=g, device=cuda).to(dtype)
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    dy = torch.randn(N, d, generator=g, device=cuda).to(dtype)
    y, r = RN.rmsnorm(x, s, with_rstd=True)
    y0, r0 = RN.rmsnorm_plain(x, s, with_rstd=True)
    assert torch.equal(y, RN.rmsnorm(x, s))       # rstd changes nothing
    assert _rel(r, r0) < 1e-5
    before = RB.LAUNCHES
    dx, ds = RB.rmsnorm_bwd(x, s, r, dy)
    torch.cuda.synchronize()
    assert RB.LAUNCHES == before + 1
    wdx, wds = RB.rmsnorm_bwd_plain(x, s, r, dy)
    assert _rel(dx, wdx) < TOL[dtype] and _rel(ds, wds) < TOL[dtype]
    dx2, ds2 = RB.rmsnorm_bwd(x, s, r, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,offset", [
    (8192, 2048, 0),     # granite's rows: the vector route, one a thread
    (700, 4096, 0),      # two vectors a thread, more rows than CTAs
    (64, 8192, 0),       # four vectors a thread (bf16)
    (300, 2047, 0),      # odd d: the scalar route
    (300, 2048, 1),      # x, dy one element past 16 bytes: scalar route
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_routes_match_plain(cuda, N, d, offset, dtype):
    """Both routes of the backward: x and dy as views one element into
    their storage where ``offset`` is 1, which the vector route's 16-byte
    loads cannot take."""
    g = torch.Generator(cuda).manual_seed(N + d + offset)
    x, dy = (torch.randn(N * d + offset, generator=g, device=cuda)
             .to(dtype)[offset:].view(N, d) for _ in range(2))
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    _, r = RN.rmsnorm(x, s, with_rstd=True)
    dx, ds = RB.rmsnorm_bwd(x, s, r, dy)
    wdx, wds = RB.rmsnorm_bwd_plain(x, s, r, dy)
    assert _rel(dx, wdx) < TOL[dtype] and _rel(ds, wds) < TOL[dtype]
    dx2, ds2 = RB.rmsnorm_bwd(x, s, r, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


def _qkv(g, dev, B, H, Hkv, Sq, Sk, D, dtype):
    """q, k, v as the layer hands them over: (B, H, S, D) views of
    (B, S, H, D) tensors."""
    return (torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            .transpose(1, 2),
            *(torch.randn(B, Sk, Hkv, D, generator=g, device=dev).to(dtype)
              .transpose(1, 2) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (4, 32, 8, 2048, 2048, 64, True),    # granite's training shape
    (1, 8, 2, 130, 130, 112, True),      # head dim 112, ragged tiles
    (1, 4, 4, 200, 200, 128, True),      # head dim 128
    (2, 4, 1, 70, 150, 64, False),       # Sq != Sk, every key, GQA 4
    (1, 2, 1, 100, 60, 32, True),        # Sq > Sk, causal
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_kernel_matches_plain(cuda, B, H, Hkv, Sq, Sk,
                                                  D, causal, dtype):
    g = torch.Generator(cuda).manual_seed(Sq + D)
    q, k, v = _qkv(g, cuda, B, H, Hkv, Sq, Sk, D, dtype)
    o, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(o, FA.flash_attention(q, k, v, causal=causal))
    _, want_lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                           with_lse=True)
    assert _rel(lse, want_lse) < 1e-5
    do = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    before = FB.LAUNCHES
    got = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before + 1
    want = FB.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) < TOL[dtype], errs
    again = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk", [
    (2, 2, 2, 200, 200),     # G = 1, ragged last tiles
    (1, 8, 2, 150, 90),      # G = 4, Sq > Sk
    (1, 8, 1, 70, 260),      # G = 8, Sq < Sk
])
@pytest.mark.parametrize("do_scale", [1.0, 1.0 / 8192])
def test_flash_attention_bwd_tensor_cores_match_plain(
        cuda, D, causal, B, H, Hkv, Sq, Sk, do_scale):
    """The tensor-core route against the plain version, at the layer's
    layouts, with do at unit scale and at the train step's 1 / 8192 (the
    mean loss over 4 x 2048 tokens); counted under ``tensor_cores``; two
    calls bit for bit the same."""
    g = torch.Generator(cuda).manual_seed(Sq + Sk + D)
    q, k, v = _qkv(g, cuda, B, H, Hkv, Sq, Sk, D, torch.bfloat16)
    o, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
    do = (torch.randn(B, Sq, H, D, generator=g, device=cuda) * do_scale) \
        .bfloat16().transpose(1, 2)
    assert FB.route(q.dtype, D, FA._rows_aligned(q, k, v, do)) \
        == "tensor_cores"
    before = dict(FB.LAUNCHES_BY_ROUTE)
    got = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert FB.LAUNCHES_BY_ROUTE == {**before, "tensor_cores":
                                    before["tensor_cores"] + 1}
    want = FB.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) < TOL[torch.bfloat16], errs
    assert all(torch.isfinite(a).all() for a in got)
    again = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_bwd_unaligned_rows_take_cuda_cores(cuda):
    """bf16 rows off 16 bytes (q one element into its storage) and bf16 at
    head dim 32 go to the CUDA cores, and agree with the plain version."""
    g = torch.Generator(cuda).manual_seed(3)
    B, H, Hkv, S = 1, 4, 2, 100
    for D, off in ((64, 1), (32, 0)):
        q = torch.randn(B * H * S * D + off, generator=g, device=cuda) \
            .bfloat16()[off:].view(B, H, S, D)
        k, v = (torch.randn(B, Hkv, S, D, generator=g, device=cuda)
                .bfloat16() for _ in range(2))
        o, lse = FA.flash_attention(q, k, v, causal=True, with_lse=True)
        do = torch.randn(B, H, S, D, generator=g, device=cuda).bfloat16()
        before = dict(FB.LAUNCHES_BY_ROUTE)
        got = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        torch.cuda.synchronize()
        assert FB.LAUNCHES_BY_ROUTE == {**before, "cuda_cores":
                                        before["cuda_cores"] + 1}
        want = FB.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)
        assert max(_rel(a, b) for a, b in zip(got, want)) \
            < TOL[torch.bfloat16]


@pytest.mark.cuda
def test_functions_give_autograd_the_kernels(cuda):
    """Through the layers' Functions, a loss's gradients reach q, k, v,
    x and scale, each launch of a forward kernel paired with one of its
    backward."""
    from repro_torch.models import layers as L
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(2, 64, 128, generator=g, device=cuda).bfloat16()
    x.requires_grad_()
    p = {"scale": torch.ones(128, device=cuda, dtype=torch.bfloat16,
                             requires_grad=True)}
    q, k, v = (t.detach().requires_grad_() for t in _qkv(
        g, cuda, 2, 4, 2, 64, 64, 64, torch.bfloat16))
    n = (RN.LAUNCHES, RB.LAUNCHES, FA.LAUNCHES, FB.LAUNCHES)
    h = L.rmsnorm(p, x)
    o = L.attention_chunked(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    (h.float().square().sum() + o.float().sum()).backward()
    torch.cuda.synchronize()
    assert (RN.LAUNCHES, RB.LAUNCHES, FA.LAUNCHES, FB.LAUNCHES) == tuple(
        c + 1 for c in n)
    for t in (x, p["scale"], q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_kernels_without_backward_refuse_grad(cuda, arch):
    """The MoE and mamba layers' kernels have their backward now: the
    smoke LM's loss (jamba's one period, ragged chunks) backpropagates on
    the card through the expert FF's SwiGLU kernel, the combine's gather
    and the reverse scan, with no plain version on the way, and every
    leaf's gradient is finite; the card meets the CPU at the smoke
    tolerances (2e-2 on the loss, routers zeroed)."""
    cfg = get_config(arch, smoke=True)
    hybrid = cfg.family == "hybrid"
    if hybrid:
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern()))
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    for layer in params["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    l_cpu, _ = value_and_grad(model, params, {"tokens": toks}, remat=True)
    n = MB.LAUNCHES, MC.LAUNCHES, SB.LAUNCHES
    loss, grads = value_and_grad(model, tree_map(lambda a: a.to(cuda),
                                                 params),
                                 {"tokens": toks.to(cuda)}, remat=True)
    torch.cuda.synchronize()
    moe = sum(k.ff == "moe" for k in cfg.layer_pattern()) * (
        cfg.n_layers // len(cfg.layer_pattern()))
    mamba = sum(k.mixer == "mamba" for k in cfg.layer_pattern())
    assert MB.LAUNCHES - n[0] == moe and MC.LAUNCHES - n[1] == 3 * moe
    assert SB.LAUNCHES - n[2] == (mamba * math.ceil(40 / cfg.ssm_chunk)
                                  if hybrid else 0)
    assert abs(float(loss) - float(l_cpu)) < 2e-2
    for g in leaves(grads):
        assert torch.isfinite(g.float()).all()


@pytest.mark.cuda
def test_smoke_loss_and_grads_card_vs_cpu(cuda):
    model = get_model(get_config("granite-3-2b", smoke=True))
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    l_cpu, g_cpu = value_and_grad(model, params, {"tokens": toks},
                                  remat=True)
    l_gpu, g_gpu = value_and_grad(
        model, tree_map(lambda a: a.to(cuda), params),
        {"tokens": toks.to(cuda)}, remat=True)
    assert abs(float(l_gpu) - float(l_cpu)) < 2e-2
    for a, b in zip(leaves(g_gpu), leaves(g_cpu)):
        err = float((a.cpu().float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30))
        assert err < 2e-2


@pytest.mark.cuda
def test_train_loop_resumes_bit_for_bit(cuda, tmp_path):
    """2 steps, a checkpoint, a fresh loop resuming for 2 more: the same
    losses as 4 steps straight, bit for bit."""
    model = get_model(get_config("granite-3-2b", smoke=True))
    data = DataConfig(vocab=model.cfg.vocab, seq_len=128, global_batch=4)
    scfg = StepConfig(remat=True, opt=AdamWConfig(lr=1e-3))
    straight = train_loop(model, data, LoopConfig(total_steps=4,
                                                  ckpt_every=100,
                                                  log_every=0),
                          scfg, str(tmp_path / "a"), device=cuda)
    first = train_loop(model, data, LoopConfig(total_steps=2, ckpt_every=2,
                                               log_every=0),
                       scfg, str(tmp_path / "b"), device=cuda)
    rest = train_loop(model, data, LoopConfig(total_steps=4, ckpt_every=100,
                                              log_every=0),
                      scfg, str(tmp_path / "b"), device=cuda)
    assert rest.resumed_from == 2
    assert first.losses + rest.losses == straight.losses
    assert all(math.isfinite(x) for x in straight.losses)
