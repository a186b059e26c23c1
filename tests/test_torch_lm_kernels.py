"""rmsnorm and flash_attention: the port's plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, and the CUDA
sources' float32 instantiations run on the host.

The gradients: ``rmsnorm_bwd_plain`` and ``flash_attention_bwd_plain``
against ``jax.vjp`` of the JAX package's oracles (``rmsnorm_ref``,
``attention_ref``) in float32 at rtol = atol = 1e-5 (the same float32
closed forms, summed in another order); the autograd Functions' CPU path
under ``torch.autograd.gradcheck`` in float64; the backward sources'
float32 instantiations run on the host against the plain versions at
1e-5 (rmsnorm) and 2e-5 (attention), as the forward sources are held.

The CUDA kernels against their plain versions, on a card, are in
``test_torch_lm_cuda.py`` and ``test_torch_train_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: rmsnorm 1e-5 in
float32 and 2e-2 in bfloat16; attention 2e-5 in float32 and 3e-2 in
bfloat16 (both sides round their output to bf16 once). The host runs of
the CUDA sources are held to the plain version at 1e-5 (rmsnorm) and
2e-5 (attention): sums in another order, the online softmax. The
tensor-core route's rounding model is held at chip_smoke.py's bf16
tolerance, rtol 1e-2 and atol 2e-3.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm_op
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention_bwd as FB
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as RB

HOST_CUDA = Path(__file__).parent / "cuda_host"
#: chip_smoke.py's bf16 tolerance for flash_attention: rtol, atol
CARD_BF16_TOL = (1e-2, 2e-3)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype: torch.dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.array(t.float().numpy(), JNP[dtype]), t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(256, 64), (128, 512), (384, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    jx, x = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    js, s = _pair(rng.standard_normal(shape[1]).astype(np.float32), dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got = RN.rmsnorm(x, s)
    assert got.dtype == dtype
    _close(got, rmsnorm_op(jx, js, block=128), tol)
    _close(RN.rmsnorm_plain(x, s), rmsnorm_ref(jx, js), tol)


@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 1, 256, 64),
                                   (1, 1, 128, 128), (2, 2, 192, 32),
                                   (1, 2, 128, 128), (1, 1, 192, 128),
                                   (1, 2, 128, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(shape, dtype, causal):
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = [
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for _ in range(3)]
    got = FA.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _close(got, flash_attention_op(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64), tol)


@pytest.mark.parametrize("S", [1, 37, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_gqa_matches_oracle(S, causal):
    """Any S, and K/V with Hkv = H/4 heads, against the JAX oracle on
    K/V repeated to H heads (head h reads KV head h // 4)."""
    rng = np.random.default_rng(2)
    B, H, Hkv, D = 2, 8, 2, 32
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    want = attention_ref(jnp.array(q), jnp.array(np.repeat(k, 4, axis=1)),
                         jnp.array(np.repeat(v, 4, axis=1)), causal=causal)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    _close(got, want, 2e-5)


def _split_bf16(p: torch.Tensor) -> torch.Tensor:
    """p as two bf16 parts: bf16(p) + bf16(p - bf16(p))."""
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float()


def _tc_attention_model(q, k, v, causal=True, part="f16"):
    """The tensor-core route's arithmetic, written out: float32 scores
    and softmax weights P, P rounded before the product with V (float32
    sums), the sum l of the unrounded P, the output rounded to bf16 once.
    ``part``: "f16", the route's (P and V rounded to fp16, the product's
    operand type); "bf16", P rounded to bf16 alone."""
    H, Hkv, D = q.shape[1], k.shape[1], q.shape[3]
    k = k.float().repeat_interleave(H // Hkv, dim=1)
    v = v.float().repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(D)
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        keep = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = s.masked_fill(~keep, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if part == "f16":
        pr, v = p.half().float(), v.half().float()
    else:
        pr = p.bfloat16().float()
    o = torch.einsum("bhqk,bhkd->bhqd", pr, v)
    return (o / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("Sk", [200, 256])
@pytest.mark.parametrize("D", [64, 112, 128])
def test_tensor_core_rounding_model_meets_plain_and_oracle(Sk, D):
    """The route rounds only P (to one fp16 part) and V (bf16 to fp16)
    between its two products; that model stays within the card's bf16
    tolerance of the plain version and of the JAX oracle. B = 1, H = 4,
    Hkv = 2, Sq = 256, causal."""
    rng = np.random.default_rng(5)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 4, 256, D), (1, 2, Sk, D),
                                     (1, 2, Sk, D))]
    got = _tc_attention_model(q, k, v)
    rtol, atol = CARD_BF16_TOL
    want = FA.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    oracle = attention_ref(
        jnp.array(q.float().numpy(), jnp.bfloat16),
        jnp.array(np.repeat(k.float().numpy(), 2, axis=1), jnp.bfloat16),
        jnp.array(np.repeat(v.float().numpy(), 2, axis=1), jnp.bfloat16),
        causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), rtol=rtol,
                               atol=atol)


def test_p_rounded_alone_misses_the_card_tolerance():
    """Why the route carries fp16 and not bf16: a row whose weight sits
    on two keys of about equal score, with values that nearly cancel,
    puts P's bf16 rounding (up to 2^-8 of each weight) past rtol 1e-2 +
    atol 2e-3 of the float32 softmax; one fp16 part (2^-11) stays
    inside."""
    q = torch.zeros(1, 1, 2, 64)
    k = torch.zeros(1, 1, 2, 64)
    v = torch.zeros(1, 1, 2, 64)
    q[0, 0, 1, 0] = 1.0
    k[0, 0, 1, 0] = 1.875                   # score 0.234 against 0
    v[0, 0, 0] = torch.linspace(-4, 4, 64)
    v[0, 0, 1] = 0.3 - 0.9 * torch.linspace(-4, 4, 64)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    want = FA.flash_attention_plain(q, k, v, causal=True).float()
    rtol, atol = CARD_BF16_TOL
    for part, misses in (("bf16", True), ("f16", False)):
        err = (_tc_attention_model(q, k, v, part=part).float()
               - want).abs()
        assert bool((err > atol + rtol * want.abs()).any()) == misses


def test_split_keeps_sixteen_bits():
    """hi + lo carries a float to about 2^-16 of itself; hi alone, 2^-8."""
    p = torch.from_numpy(np.random.default_rng(6).uniform(
        1e-3, 1.0, 4096).astype(np.float32))
    assert float(((_split_bf16(p) - p) / p).abs().max()) < 2.0 ** -16
    assert float(((p.bfloat16().float() - p) / p).abs().max()) > 2.0 ** -10


def test_f16_keeps_eleven_bits():
    """P in [2^-14, 1] rounded to fp16 is within 2^-11 of itself; bf16
    V converts to fp16 exactly in fp16's normal range."""
    p = torch.from_numpy(np.random.default_rng(7).uniform(
        2.0 ** -14, 1.0, 4096).astype(np.float32))
    assert float(((p.half().float() - p) / p).abs().max()) <= 2.0 ** -11
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(
        4096).astype(np.float32) * 1000).bfloat16()
    v = v[v.float().abs() >= 2.0 ** -14]
    assert torch.equal(v.half().float(), v.float())
    assert torch.isinf(torch.tensor(65536.0).bfloat16().half())


@pytest.mark.parametrize("dtype,D,aligned,want", [
    (torch.bfloat16, 64, True, "tensor_cores"),    # granite (4, 32, 2048, 64)
    (torch.bfloat16, 128, True, "tensor_cores"),   # olmoe, jamba: D = 128
    (torch.bfloat16, 112, True, "tensor_cores"),   # kimi-k2: D = 112
    (torch.bfloat16, 112, False, "cuda_cores"),
    (torch.float32, 112, True, "cuda_cores"),
    (torch.bfloat16, 32, True, "cuda_cores"),      # no path uses D = 32
    (torch.bfloat16, 64, False, "cuda_cores"),     # rows off 16 bytes
    (torch.float32, 64, True, "cuda_cores"),
    (torch.float32, 128, True, "cuda_cores")])
def test_route_names_the_entry(dtype, D, aligned, want):
    assert FA.route(dtype, D, aligned) == want
    name = FA.entry(dtype, D, aligned)
    assert name in FA.KERNEL.argtypes
    assert ("_tc_" in name) == (want == "tensor_cores")


@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 64), (16, 16, 128),
                                     (64, 8, 128), (64, 8, 112)])
def test_path_layouts_take_the_tensor_cores(H, Hkv, D):
    """The four prefill paths' heads (granite, olmoe, jamba, kimi) as the
    layer hands them over, transposed views of (B, S, H, D) projections
    (S cut to 16 here): their rows start on 16 bytes. One element off,
    they do not."""
    q, k, v = (torch.zeros(2, 16, h, D, dtype=torch.bfloat16)
               .transpose(1, 2) for h in (H, Hkv, Hkv))
    assert FA._rows_aligned(q, k, v)
    assert FA.route(q.dtype, D, FA._rows_aligned(q, k, v)) \
        == "tensor_cores"
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(
        2, H, 16, D)
    assert not FA._rows_aligned(off, k, v)
    assert FA.route(q.dtype, D, FA._rows_aligned(off, k, v)) \
        == "cuda_cores"


def test_plain_versions_do_not_count():
    x = torch.ones(4, 8)
    before = (RN.LAUNCHES, FA.LAUNCHES, dict(FA.LAUNCHES_BY_ROUTE))
    RN.rmsnorm(x, torch.ones(8))
    FA.flash_attention(x.view(1, 1, 4, 8), x.view(1, 1, 4, 8),
                       x.view(1, 1, 4, 8))
    assert (RN.LAUNCHES, FA.LAUNCHES, FA.LAUNCHES_BY_ROUTE) == before


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="scale"):
        RN.rmsnorm(torch.ones(4, 8), torch.ones(7))
    with pytest.raises(ValueError, match="Hkv must divide H"):
        FA.flash_attention(torch.ones(1, 4, 8, 32), torch.ones(1, 3, 8, 32),
                           torch.ones(1, 3, 8, 32))


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; anything else goes to
    the kernel's checks and is refused there."""
    x = torch.ones(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        RN.rmsnorm(x, torch.ones(8, device="meta"))
    q = torch.ones(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention(q, q, q)


# --------------------------------------------------------------------------
# the CUDA sources, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The four kernel sources (rmsnorm, flash_attention and their
    backward) built for the host, one g++ each, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_lm_kernels")
    procs = {}
    for mod in (RN, FA, RB, FB):
        so = out / f"{mod.KERNEL.kind}.so"
        procs[mod] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{HOST_CUDA}", f"-I{CSRC}", "-x", "c++", "-o", str(so),
             str(mod.KERNEL.cu)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for mod, (so, p) in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        for name, types in mod.KERNEL.argtypes.items():
            if "bf16" not in name:
                getattr(lib, name).argtypes = types
        libs[mod] = lib
    return libs


@pytest.mark.parametrize("shape", [(3, 64), (5, 300), (2, 2048)])
def test_rmsnorm_source_matches_plain_on_host(shape, host_libs):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    s = torch.randn(shape[1], generator=g)
    out, rstd = torch.empty_like(x), torch.empty(shape[0])
    err = host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), rstd.data_ptr(),
                                    shape[0], shape[1], 1e-6, None)
    assert err == 0
    want, want_rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    _close(out, want.numpy(), 1e-5)
    _close(rstd, want_rstd.numpy(), 1e-5)


@pytest.mark.parametrize("N", [1, 8, 129])
@pytest.mark.parametrize("d", [8, 99, 100, 2048, 4096, 7168, 8196])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_routes_match_plain_on_host(N, d, offset, host_libs):
    """Each route of the float32 source: 256 threads a row holding one,
    two, four or eight vectors of 4 (d 8, 100, 2048, 4096 and 7168: 2,
    25, 512, 1024 and 1792 vectors), and the scalar route (d 99, not a
    whole number of vectors; d 8196, more than 8 vectors a thread; or x
    one element past a 16-byte boundary)."""
    g = torch.Generator().manual_seed(N * d)
    x = torch.randn(N * d + offset, generator=g)[offset:].view(N, d)
    s = torch.randn(d, generator=g)
    out, rstd = torch.empty(N, d), torch.empty(N)
    err = host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), rstd.data_ptr(), N, d,
                                    1e-6, None)
    assert err == 0
    want, want_rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    _close(out, want.numpy(), 1e-5)
    _close(rstd, want_rstd.numpy(), 1e-5)
    # without an rstd buffer the same output
    again = torch.empty(N, d)
    assert host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                     again.data_ptr(), None, N, d, 1e-6,
                                     None) == 0
    assert torch.equal(again, out)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (1, 2, 1, 80, 80, 32, True),      # ragged second query tile, GQA
    (2, 4, 2, 64, 64, 64, True),      # one full tile, D = 64
    (1, 2, 2, 50, 90, 32, False),     # Sq != Sk, every key
    (1, 1, 1, 130, 130, 64, True),    # three query tiles, ragged keys
    (1, 2, 1, 70, 70, 128, True),     # D = 128: the dynamic-memory tiles
    (1, 1, 1, 40, 100, 128, False),   # D = 128, Sq != Sk, every key
    (1, 1, 1, 90, 90, 112, True),     # D = 112: a ragged query tile
    (1, 4, 1, 64, 70, 112, False),    # D = 112, GQA 4 / 1, ragged keys
])
def test_flash_attention_source_matches_plain_on_host(B, H, Hkv, Sq, Sk, D,
                                                      causal, host_libs):
    """q, k, v as transposed views of (B, S, H, D) tensors, as the layer
    passes them: the kernel reads their strides."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g).transpose(1, 2)
    k = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    v = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    out, lse = torch.empty(B, H, Sq, D), torch.empty(B, H, Sq)
    fn = getattr(host_libs[FA], f"flash_attention_f32_d{D}")
    args = (B, H, Hkv, Sq, Sk, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), 1.0 / math.sqrt(D), None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *args)
    assert err == 0
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                              with_lse=True)
    _close(out, want.numpy(), 2e-5)
    _close(lse, want_lse.numpy(), 2e-5)
    # without an lse buffer the same output, bit for bit
    again = torch.empty(B, H, Sq, D)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), again.data_ptr(),
              None, *args) == 0
    assert torch.equal(again, out)


@pytest.mark.parametrize("N,d", [(3, 64), (5, 300), (40, 2048), (600, 8),
                                 (2, 8192)])
def test_rmsnorm_bwd_source_matches_plain_on_host(N, d, host_libs):
    """Every width of the float32 backward source (1 to 32 columns a
    thread), and more rows than its 528 CTAs (600), whose dscale
    partials are summed in a fixed order."""
    g = torch.Generator().manual_seed(N + d)
    x, dy = torch.randn(N, d, generator=g), torch.randn(N, d, generator=g)
    s = torch.randn(d, generator=g)
    _, rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    parts = min(N, RB.PARTS)
    dx, ds = torch.empty(N, d), torch.empty(d)
    partial = torch.empty(parts, d)
    err = host_libs[RB].rmsnorm_bwd_f32(
        x.data_ptr(), s.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ds.data_ptr(), partial.data_ptr(), N, d, parts, None)
    assert err == 0
    want_dx, want_ds = RB.rmsnorm_bwd_plain(x, s, rstd, dy)
    _close(dx, want_dx.numpy(), 1e-5)
    _close(ds, want_ds.numpy(), 1e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (1, 2, 1, 80, 80, 32, True),      # ragged tiles, GQA 2
    (1, 4, 2, 70, 100, 64, False),    # Sq != Sk, every key
    (1, 2, 1, 130, 130, 112, True),   # D = 112, three tiles each way
    (1, 1, 1, 40, 70, 128, True),     # D = 128, keys past the last query
    (2, 4, 1, 64, 64, 64, True),      # one full tile, GQA 4, two batches
])
def test_flash_attention_bwd_source_matches_plain_on_host(
        B, H, Hkv, Sq, Sk, D, causal, host_libs):
    """q, k, v, o and do read through their strides (q, k, v transposed
    views of (B, S, H, D) tensors, as the layer passes them)."""
    g = torch.Generator().manual_seed(Sq + D)
    q = torch.randn(B, Sq, H, D, generator=g).transpose(1, 2)
    k = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    v = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal, with_lse=True)
    do = torch.randn(B, Sq, H, D, generator=g).transpose(1, 2)
    dq = torch.empty(B, H, Sq, D)
    dk, dv = torch.empty(B, Hkv, Sk, D), torch.empty(B, Hkv, Sk, D)
    delta = torch.empty(B, H, Sq)
    strides = FB._STRIDES(*(st for t in (q, k, v, o, do)
                            for st in t.stride()[:3]))
    err = getattr(host_libs[FB], f"flash_attention_bwd_f32_d{D}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Sk, strides,
        int(causal), 1.0 / math.sqrt(D), None)
    assert err == 0
    want = FB.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w.numpy(), 2e-5)


# --------------------------------------------------------------------------
# the gradients: plain closed forms against jax.vjp of the oracles, and
# the autograd Functions' CPU path under gradcheck
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 64), (128, 512), (7, 300)])
def test_rmsnorm_bwd_plain_matches_jax_grad(shape):
    rng = np.random.default_rng(10)
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    s = rng.standard_normal(shape[1]).astype(np.float32)
    _, vjp = jax.vjp(rmsnorm_ref, jnp.array(x), jnp.array(s))
    want_dx, want_ds = vjp(jnp.array(dy))
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    _, rstd = RN.rmsnorm_plain(tx, ts, with_rstd=True)
    dx, ds = RB.rmsnorm_bwd_plain(tx, ts, rstd, torch.from_numpy(dy))
    _close(dx, want_dx, 1e-5)
    _close(ds, want_ds, 1e-5)


@pytest.mark.parametrize("D", [32, 64, 112, 128])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_plain_matches_jax_grad(D, H, Hkv, causal):
    """GQA through the oracle: K and V repeated to H heads inside the
    differentiated function, so their gradients sum over each group."""
    rng = np.random.default_rng(D + H)
    B, S = 2, 96
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)

    def ref(q, k, v):
        return attention_ref(q, jnp.repeat(k, H // Hkv, axis=1),
                             jnp.repeat(v, H // Hkv, axis=1), causal=causal)

    _, vjp = jax.vjp(ref, jnp.array(q), jnp.array(k), jnp.array(v))
    want = vjp(jnp.array(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                      with_lse=True)
    got = FB.flash_attention_bwd_plain(tq, tk, tv, o, torch.from_numpy(do),
                                       lse, causal=causal)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_rmsnorm_function_passes_gradcheck():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    s = torch.randn(8, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, s: RB.RMSNorm.apply(x, s, 1e-6),
                                    (x, s))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_passes_gradcheck(causal):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, 5, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(1, 2, 6, 3, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FB.FlashAttention.apply(q, k, v, causal), (q, k, v))


def test_backward_plain_versions_do_not_count():
    x = torch.ones(4, 8, requires_grad=True)
    q = torch.ones(1, 1, 4, 32, requires_grad=True)
    before = (RN.LAUNCHES, RB.LAUNCHES, FA.LAUNCHES, FB.LAUNCHES)
    RB.RMSNorm.apply(x, torch.ones(8), 1e-6).sum().backward()
    FB.FlashAttention.apply(q, q, q, True).sum().backward()
    assert (RN.LAUNCHES, RB.LAUNCHES, FA.LAUNCHES, FB.LAUNCHES) == before

