"""rmsnorm and flash_attention on the card: each CUDA kernel against its
plain version, and the LM's layers going through them.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances are those
of ``tests/test_kernels.py``: rmsnorm 1e-5 in float32 and 2e-2 in
bfloat16, attention 2e-5 in float32 and 3e-2 in bfloat16; the shapes
added for the tensor-core route (P and V in fp16) and for head dim 112
are held at chip_smoke.py's rtol 1e-2, atol 2e-3 in bf16. The smoke LM
on the card against the same LM on the CPU: atol = rtol = 0.1 on the
logits, as ``tests/test_torch_lm.py`` holds it to the JAX package.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map

TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (2e-2, 3e-2)}
#: chip_smoke.py's bf16 tolerance for flash_attention: rtol, atol
CARD_BF16_TOL = (1e-2, 2e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048), (300, 2048), (5, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    s = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    before = RN.LAUNCHES
    got = RN.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert RN.LAUNCHES == before + 1
    _close(got, RN.rmsnorm_plain(x, s), TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 8, 8192])
@pytest.mark.parametrize("d", [2048, 7168, 8192, 100, 4608, 12288, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_at_path_shapes(cuda, N, d, dtype):
    """The paths' widths (16-byte vectors, one CTA a row) and d 100 (in
    bf16 not a whole number of 8-element vectors: the scalar route)."""
    g = torch.Generator(cuda).manual_seed(N + d)
    x = torch.randn(N, d, generator=g, device=cuda).to(dtype)
    s = torch.randn(d, generator=g, device=cuda).to(dtype)
    before = RN.LAUNCHES
    got = RN.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert RN.LAUNCHES == before + 1
    _close(got, RN.rmsnorm_plain(x, s), TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_unaligned_rows_match_plain(cuda, dtype):
    """x one element off a 16-byte boundary takes the scalar route at a
    width the vector route would take (d 2048)."""
    g = torch.Generator(cuda).manual_seed(7)
    x = torch.randn(64 * 2048 + 1, generator=g, device=cuda).to(dtype)
    s = torch.randn(2048, generator=g, device=cuda).to(dtype)
    for xv in (x[:-1].view(64, 2048), x[1:].view(64, 2048)):
        got = RN.rmsnorm(xv, s)
        torch.cuda.synchronize()
        _close(got, RN.rmsnorm_plain(xv, s), TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 300, 300, 64),
    (1, 4, 1, 77, 77, 32), (1, 2, 2, 50, 190, 32),
    (1, 4, 4, 200, 200, 128), (2, 4, 1, 64, 130, 128),
    (1, 4, 4, 200, 200, 112), (2, 8, 1, 64, 130, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, B, H, Hkv, Sq, Sk, D,
                                              dtype, causal):
    """q, k, v as transposed views of (B, S, H, D), as the layer hands
    them over."""
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = FA.LAUNCHES
    routes = dict(FA.LAUNCHES_BY_ROUTE)
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    routes[FA.route(dtype, D)] += 1
    assert FA.LAUNCHES_BY_ROUTE == routes
    _close(got, FA.flash_attention_plain(q, k, v, causal=causal),
           TOL[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (1, 2, 1, 1000, 1000, 64, True),      # a ragged last query tile
    (1, 2, 1, 1000, 1000, 128, True),
    (1, 4, 2, 64, 300, 64, False),        # Sq != Sk, every key
    (1, 4, 2, 64, 300, 128, False),
    (1, 64, 8, 512, 512, 128, True),      # jamba's GQA, 64 / 8 heads
    (1, 2, 1, 1000, 1000, 112, True),     # D = 112: zero-filled columns
    (1, 4, 2, 64, 300, 112, False),
    (1, 64, 8, 512, 512, 112, True)])     # kimi-k2's GQA, 64 / 8 heads
def test_flash_attention_tensor_cores_match_plain(cuda, B, H, Hkv, Sq, Sk,
                                                  D, causal):
    """The bf16 route on the tensor cores, at the card's bf16 tolerance."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=cuda)
               .bfloat16().transpose(1, 2)
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    tc = FA.LAUNCHES_BY_ROUTE["tensor_cores"]
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES_BY_ROUTE["tensor_cores"] == tc + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tensor_cores_take_v_past_fp16_range(cuda, D,
                                                             causal):
    """ROADMAP C13 on the card: one element of v at 7e4, past fp16's
    65504, and query rows that put most of their weight on its key. The
    output is finite and within the card's bf16 tolerance of the plain
    version (tests/test_torch_lm_kernels.py runs the same on the host)."""
    g = torch.Generator(cuda).manual_seed(D)
    B, H, Hkv, Sq, Sk = 1, 4, 2, 300, 500
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=cuda)
               .bfloat16().transpose(1, 2)
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    v[0, 1, 200, 5] = 7e4
    q[0, 2:4, 250:260] = 4 * k[0, 1, 200]
    tc = FA.LAUNCHES_BY_ROUTE["tensor_cores"]
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES_BY_ROUTE["tensor_cores"] == tc + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    assert float(want.float().abs().max()) > 65504
    assert torch.isfinite(got.float()).all()
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_smoke_xlstm_on_the_card_goes_through_rmsnorm(cuda):
    """xlstm-1.3b's smoke LM, one period: prefill on the card goes
    through the rmsnorm kernel (one launch per layer and ln_f, no ln2:
    d_ff is 0) and meets the CPU within tests/test_archs.py's atol 0.55,
    rtol 0.1 (the two round bf16 differently and the random-weight xLSTM
    is ill-conditioned: ROADMAP C15)."""
    import dataclasses
    cfg = get_config("xlstm-1.3b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern()))
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    want = model.prefill(params, toks)
    rn = RN.LAUNCHES
    got = model.prefill(tree_map(lambda a: a.to(cuda), params),
                        toks.to(cuda))
    torch.cuda.synchronize()
    assert RN.LAUNCHES - rn == cfg.n_layers + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0.1, atol=0.55)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,aligned,way", [
    (torch.bfloat16, True, "tensor_cores"),
    (torch.bfloat16, False, "cuda_cores"),
    (torch.float32, True, "cuda_cores")])
def test_flash_attention_d112_on_both_routes(cuda, dtype, aligned, way):
    """kimi-k2's head dim on each route: bf16 rows on 16 bytes take the
    tensor cores, bf16 rows one element off and float32 the CUDA cores."""
    B, H, Hkv, S, D = 1, 8, 2, 200, 112
    g = torch.Generator(cuda).manual_seed(4)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device=cuda).to(dtype)
               for h in (H, Hkv, Hkv))
    if not aligned:
        q = torch.zeros(q.numel() + 1, dtype=dtype, device=cuda)[1:] \
            .view(q.shape).copy_(q)
    assert FA.route(dtype, D, FA._rows_aligned(q, k, v)) == way
    routes = dict(FA.LAUNCHES_BY_ROUTE)
    got = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    routes[way] += 1
    assert FA.LAUNCHES_BY_ROUTE == routes
    want = FA.flash_attention_plain(q, k, v, causal=True)
    rtol, atol = (CARD_BF16_TOL if dtype == torch.bfloat16
                  else (TOL[dtype][1],) * 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        RN.rmsnorm(x.double(), torch.ones(8, device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        RN.rmsnorm(torch.ones(8, 4, device=cuda).T, torch.ones(8,
                                                              device=cuda))
    q = torch.ones(1, 2, 16, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    q = torch.ones(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        FA.flash_attention(q, q.cpu(), q)


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(cuda, monkeypatch):
    """With no nvcc and nothing built, a launch raises instead of running
    the plain version."""
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(build, "BUILD_ROOT", build.BUILD_ROOT / "never")
    monkeypatch.setattr(RN.KERNEL, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        RN.rmsnorm(torch.ones(4, 8, device=cuda), torch.ones(8, device=cuda))


@pytest.mark.cuda
def test_smoke_lm_on_the_card_goes_through_the_kernels(cuda):
    """granite-3-2b's smoke LM: prefill on the card (kernels) equals the
    CPU (plain versions), one rmsnorm launch per norm and one attention
    launch per layer."""
    cfg = get_config("granite-3-2b", smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    want = model.prefill(params, toks)
    on_card = tree_map(lambda a: a.to(cuda), params)
    rn, fa = RN.LAUNCHES, FA.LAUNCHES
    got = model.prefill(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    assert RN.LAUNCHES - rn == 2 * cfg.n_layers + 1
    assert FA.LAUNCHES - fa == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0.1, atol=0.1)
