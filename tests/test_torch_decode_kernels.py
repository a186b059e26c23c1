"""The two decode routes on the host: attention at one query row
(``flash_attention_decode.cu``) and the expert FF at C = 1 with counts
(``moe_decode.cu``).

  * Both sources built with g++ against the stand-in runtime in
    ``tests/cuda_host`` (``-D__CUDACC__`` with ``tests/cuda_host/sm90``:
    their cp.async copies land at once, their shuffles and ballots run a
    warp of std::threads), held against the plain versions: attention at
    Sq = 1 with GQA groups 1 and 8 (and 12: two CTAs a KV head), ragged
    Sk (130), one split and several, every head dim, bf16 and float32,
    causal or not, with and without the lse; the expert FF with counts
    none filled, mixed and all filled, f not a multiple of the slice, d
    past one and three passes of 2048 columns, E past 256 (the live list
    in two rounds), a grid that walks several units a CTA. Two calls give
    the same bits.
  * ``route`` and ``entry`` naming the new routes.
  * The plain versions at Sq = 1 and C = 1 against the JAX package's
    oracles (``repro/kernels/{flash_attention,moe_dispatch}/ref.py``) from
    numpy inputs: the Pallas kernels assert that Sq and C are multiples
    of their blocks, so they cannot take these shapes.

Tolerances: attention in float32 at 2e-5 (the online softmax's sums in
another order, as ``test_torch_lm_kernels.py`` holds the other routes),
bf16 at the card's rtol 1e-2, atol 2e-3 (``chip_smoke.py``'s ``FA_TOL``:
both round the output to bf16 once), the lse at 1e-5; the expert FF at
``MOE_TOL`` (1e-2, 2e-3: the same bf16 rounding of y); the plain versions
against the oracles at 1e-5 in float32 (the same float32 formulas).
"""
import ctypes
import math
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.moe_dispatch.ref import grouped_expert_ff_ref
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from torch_host_kernels import HOST_CUDA, HOST_SM90, close

FA_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2e-3)}
MOE_TOL = (1e-2, 2e-3)


@pytest.fixture(scope="module")
def decode_libs(tmp_path_factory):
    """Both decode sources built for the host, one g++ each, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_decode_kernels")
    procs = {}
    for name, kernel in (("fa", FA.DECODE_KERNEL), ("moe", MD.DECODE_KERNEL)):
        so = out / f"{kernel.kind}.so"
        procs[name] = (kernel, so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-D__CUDACC__", f"-I{HOST_SM90}", f"-I{HOST_CUDA}", "-x", "c++",
             "-o", str(so), str(kernel.cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (kernel, so, p) in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        for fn, types in kernel.argtypes.items():
            getattr(lib, fn).argtypes = types
        libs[name] = lib
    return libs


# --------------------------------------------------------------------------
# attention at one query row
# --------------------------------------------------------------------------

def _qkv(B, H, Hkv, Sk, D, dtype, seed):
    """q, k, v as the layer passes them: transposed views of (B, S, H, D)
    tensors."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 1, H, D, generator=g).to(dtype).transpose(1, 2),
            *(torch.randn(B, Sk, Hkv, D, generator=g).to(dtype)
              .transpose(1, 2) for _ in range(2)))


def _splits(keys, n_split):
    """(n_split, split_len) for about ``n_split`` splits of ``keys``,
    rounded as ``decode_splits`` rounds them."""
    length = -(-(-(-keys // n_split)) // 64) * 64
    return -(-keys // length), length


def _fa_decode(lib, q, k, v, causal, with_lse, n_split):
    B, H, _, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    keys = min(Sk, 1) if causal else Sk
    ns, length = _splits(keys, n_split)
    out = torch.empty(B, H, 1, D, dtype=q.dtype)
    lse = torch.empty(B, H, 1) if with_lse else None
    ws = torch.full((B * H * ns * (D + 2),), float("nan"))
    done = torch.zeros(B * Hkv * -(-(H // Hkv) // FA.DECODE_ROWS),
                       dtype=torch.int32)
    err = getattr(lib, FA.entry(q.dtype, D, True, 1))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *((ws.data_ptr(), done.data_ptr()) if ns > 1 else (None, None)),
        B, H, Hkv, Sk, *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
        int(causal), 1.0 / math.sqrt(D), ns, length, None)
    assert err == 0
    assert (done == 0).all()   # the counters are left at 0 for the next
    return out, lse, ns


@pytest.mark.parametrize("B,H,Hkv,Sk,D,n_split", [
    (2, 2, 2, 130, 64, 1),      # G 1, ragged keys, one split
    (1, 4, 4, 130, 64, 3),      # G 1, three splits (64, 64, 2 keys)
    (1, 8, 1, 130, 128, 1),     # G 8: one CTA takes the KV head's rows
    (1, 8, 1, 192, 64, 3),      # G 8, three splits
    (1, 8, 1, 130, 112, 2),     # G 8 at D 112 (14 chunks on 16 lanes)
    (1, 12, 1, 200, 32, 2),     # G 12: two CTAs a KV head (8 + 4 rows)
    (1, 6, 2, 70, 64, 1),       # G 3: four rows a CTA, one masked
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_decode_attention_source_matches_plain_on_host(
        B, H, Hkv, Sk, D, n_split, dtype, causal, decode_libs):
    """o and the lse against the plain version (causal: query row 0 sees
    key 0 alone, as the plain version masks it); without an lse buffer
    the same o, bit for bit."""
    q, k, v = _qkv(B, H, Hkv, Sk, D, dtype, Sk + D + H)
    out, lse, ns = _fa_decode(decode_libs["fa"], q, k, v, causal, True,
                              n_split)
    assert ns == (1 if causal else n_split)
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                              with_lse=True)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    close(lse, want_lse.numpy(), 1e-5)
    again, _, _ = _fa_decode(decode_libs["fa"], q, k, v, causal, False,
                             n_split)
    assert torch.equal(again, out)


@pytest.mark.parametrize("D", [32, 64, 112, 128])
def test_decode_attention_every_head_dim_on_host(D, decode_libs):
    """Every head dim of ``HEAD_DIMS`` in float32 at G 2, with the splits
    the wrapper would choose at 130 keys (one: under two splits of 128)."""
    q, k, v = _qkv(1, 4, 2, 130, D, torch.float32, D)
    n, length = FA.decode_splits(1, 2, 2, 130, 264)
    assert (n, length) == (1, 192)
    out, lse, _ = _fa_decode(decode_libs["fa"], q, k, v, False, True, n)
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=False,
                                              with_lse=True)
    close(out, want.numpy(), 2e-5)
    close(lse, want_lse.numpy(), 1e-5)


def test_decode_attention_refuses_a_split_that_does_not_fit(decode_libs):
    """A split length that leaves a split empty, or misses keys, or
    several splits without their scratch, is refused (code 1) before
    anything runs."""
    q, k, v = _qkv(1, 2, 2, 130, 64, torch.float32, 0)
    fn = getattr(decode_libs["fa"], FA.entry(torch.float32, 64, True, 1))
    out = torch.empty(1, 2, 1, 64)
    ws, done = torch.empty(2 * 4 * 66), torch.zeros(2, dtype=torch.int32)
    for ns, length, scratch in ((4, 64, True), (2, 64, True),
                                (1, 128, True), (2, 128, False)):
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None, *((ws.data_ptr(), done.data_ptr()) if scratch
                          else (None, None)), 1, 2, 2, 130,
                  *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], 0,
                  0.125, ns, length, None) == 1


@pytest.mark.parametrize("B,Hkv,G,keys,slots,want", [
    (8, 16, 1, 2048, 396, (3, 704)),    # seamless's cross-attention at
    (8, 16, 1, 4096, 396, (3, 1408)),   # decode: 3 CTAs an SM, 132 SMs
    (8, 8, 8, 4096, 264, (4, 1024)),    # qwen2-vl's check shape: 2 an SM
    (4, 8, 8, 4096, 264, (8, 512)),
    (8, 16, 1, 130, 396, (1, 192)),     # under two splits of 128 keys
    (8, 16, 1, 1, 396, (1, 64)),        # causal: key 0 alone
    (64, 16, 1, 2048, 396, (1, 2048)),  # the grid past the slots already
    (1, 1, 16, 100000, 264, (131, 768)),  # two CTAs (row blocks) a split
])
def test_decode_splits(B, Hkv, G, keys, slots, want):
    """As many splits as fill the card's slots in one wave, at least 128
    keys each where there are that many, a multiple of 64 keys each, and
    none empty."""
    n, length = FA.decode_splits(B, Hkv, G, keys, slots)
    assert (n, length) == want
    assert (n - 1) * length < keys <= n * length and length % 64 == 0
    assert n == 1 or B * Hkv * -(-G // FA.DECODE_ROWS) * n <= slots


@pytest.mark.parametrize("D,G,want", [(64, 1, 2), (128, 8, 2), (112, 3, 2),
                                      (48, 1, -1)])
def test_decode_occupancy_entry_on_host(D, G, want, decode_libs):
    """The entry the wrapper asks for the CTAs an SM holds, per head dim
    and group (the stand-in's occupancy is 2; a head dim the source has
    no instantiation for gives -1)."""
    fn = decode_libs["fa"].flash_attention_decode_ctas
    fn.restype = ctypes.c_int
    assert fn(1, D, G) == want and fn(0, D, G) == want


@pytest.mark.parametrize("dtype,D,aligned,Sq,want", [
    (torch.bfloat16, 64, True, 1, "decode"),     # seamless's cross, decode
    (torch.bfloat16, 128, True, 1, "decode"),    # qwen2-vl's check shape
    (torch.bfloat16, 112, True, 1, "decode"),
    (torch.bfloat16, 32, True, 1, "decode"),
    (torch.float32, 64, True, 1, "decode"),
    (torch.bfloat16, 64, False, 1, "cuda_cores"),  # rows off 16 bytes
    (torch.bfloat16, 64, True, 2, "tensor_cores"),
    (torch.bfloat16, 64, True, 0, "tensor_cores"),  # Sq not given
    (torch.float32, 64, True, 2048, "cuda_cores")])
def test_attention_route_names_the_decode_entry(dtype, D, aligned, Sq, want):
    assert FA.route(dtype, D, aligned, Sq) == want
    name = FA.entry(dtype, D, aligned, Sq)
    table = FA.DECODE_KERNEL if want == "decode" else FA.KERNEL
    assert name in table.argtypes
    assert ("_decode_" in name) == (want == "decode")


# --------------------------------------------------------------------------
# the expert FF at C = 1
# --------------------------------------------------------------------------

def _moe_inputs(E, d, f, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(E, 1, d, generator=g).bfloat16(),
            (torch.randn(E, d, 2 * f, generator=g) / d ** 0.5).bfloat16(),
            (torch.randn(E, f, d, generator=g) / f ** 0.5).bfloat16())


def _moe_decode(lib, x, wi, wo, counts, W, n_ctas):
    E, _, d = x.shape
    f = wo.shape[1]
    n_sl = -(-f // W)
    ws = torch.full((n_sl, E, d), float("nan"))
    y = torch.full((E, 1, d), 7.0).bfloat16()
    err = lib.moe_ff_decode_bf16(
        x.data_ptr(), wi.data_ptr(), wo.data_ptr(), counts.data_ptr(),
        ws.data_ptr(), y.data_ptr(), E, d, f, W, n_sl, n_ctas, None)
    assert err == 0
    return y


@pytest.mark.parametrize("E,d,f,W,n_ctas", [
    (5, 64, 200, 64, 3),       # 4 slices, the last of 8 columns
    (3, 136, 200, 128, 2),     # d past a k tile, a slice of two chunks
    (2, 2056, 72, 64, 2),      # d past one pass of 2048 columns
    (2, 4096, 64, 64, 1),      # two passes, two wo rows a stage
    (2, 6152, 64, 64, 1),      # four passes, one wo row a stage
    (4, 128, 1024, 192, 5),    # 6 slices of three chunks, the last short
    (300, 64, 256, 192, 7),    # E past 256: the live list in two rounds
])
@pytest.mark.parametrize("how", ["none", "mixed", "full"])
def test_decode_expert_ff_source_matches_plain_on_host(
        E, d, f, W, n_ctas, how, decode_libs):
    """y against the plain version: counts none filled (no unit; y is
    zero), mixed (the first expert empty, the last full) and all filled;
    an empty expert's row comes out zero and its workspace rows (NaN
    here) are not read. Two calls give the same bits."""
    x, wi, wo = _moe_inputs(E, d, f, E + d + f)
    counts = torch.full((E,), int(how != "none"), dtype=torch.int32)
    if how == "mixed":
        counts[0] = 0
        counts[1:-1] = torch.from_numpy(np.random.default_rng(E).integers(
            0, 2, E - 2).astype(np.int32))
    y = _moe_decode(decode_libs["moe"], x, wi, wo, counts, W, n_ctas)
    want = MD.grouped_expert_ff_plain(x, wi, wo, counts)
    rtol, atol = MOE_TOL
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    assert (y[counts == 0] == 0).all()
    again = _moe_decode(decode_libs["moe"], x, wi, wo, counts, W, n_ctas)
    assert torch.equal(again, y)


def test_decode_expert_ff_refuses_bad_slicing(decode_libs):
    """A slicing that leaves a slice empty or misses columns, a width off
    64, d past 8192, no counts: refused (code 1), y left as it was."""
    x, wi, wo = _moe_inputs(2, 64, 128, 0)
    ws, y = torch.empty(4, 2, 64), torch.full((2, 1, 64), 7.0).bfloat16()
    counts = torch.ones(2, dtype=torch.int32)
    for W, n_sl, d, c in ((64, 3, 64, counts), (64, 1, 64, counts),
                          (96, 2, 64, counts), (64, 2, 8200, counts),
                          (64, 2, 64, None)):
        assert decode_libs["moe"].moe_ff_decode_bf16(
            x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            None if c is None else c.data_ptr(), ws.data_ptr(),
            y.data_ptr(), 2, d, 128, W, n_sl, 1, None) == 1
    assert (y == 7).all()


@pytest.mark.parametrize("E,d,f,want", [
    (64, 2048, 1024, (16, 64)),      # olmoe: 624 units of ~39 experts
    (16, 8192, 24576, (192, 128)),   # jamba
    (384, 7168, 2048, (11, 192)),    # kimi-k2
    (4, 64, 200, (4, 64)),
])
def test_decode_slicing(E, d, f, want):
    """As many slices as the chunks allow within the scratch budget."""
    n, W = MD.decode_slicing(E, d, f)
    assert (n, W) == want
    assert (n - 1) * W < f <= n * W and W % 64 == 0
    assert 4 * n * E * d <= MD.DECODE_WS_BYTES


@pytest.mark.parametrize("dtype,shape,counted,want", [
    (torch.bfloat16, (64, 1, 2048, 1024), True, "decode"),     # olmoe
    (torch.bfloat16, (16, 1, 8192, 24576), True, "decode"),    # jamba
    (torch.bfloat16, (384, 1, 7168, 2048), True, "decode"),    # kimi-k2
    (torch.bfloat16, (64, 1, 2048, 1024), False, "cuda_cores"),  # no counts
    (torch.bfloat16, (2, 1, 100, 64), True, "cuda_cores"),     # d % 8
    (torch.bfloat16, (2, 1, 16384, 64), True, "cuda_cores"),   # d > 8192
    (torch.bfloat16, (1025, 1, 64, 64), True, "cuda_cores"),   # E > 1024
    (torch.float32, (64, 1, 2048, 1024), True, "cuda_cores"),
    (torch.bfloat16, (64, 1280, 2048, 1024), True, "tensor_cores")])
def test_expert_ff_route_names_the_decode_entry(dtype, shape, counted,
                                                want):
    """``n_counts`` is the number of the caller's counts, E, or 0 without
    counts: leaving it out never names the decode route."""
    E, C, d, f = shape
    n = E if counted else 0
    assert MD.route(dtype, C, d, f, n) == want
    name = MD.entry(dtype, C, d, f, n)
    table = MD.DECODE_KERNEL if want == "decode" else MD.KERNEL
    assert name in table.argtypes
    assert (name == "moe_ff_decode_bf16") == (want == "decode")


# --------------------------------------------------------------------------
# the plain versions at Sq = 1 and C = 1 against the JAX oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hkv,Sk,D", [(4, 4, 130, 64), (8, 1, 70, 128),
                                        (6, 2, 33, 112)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_at_one_row_matches_oracle(H, Hkv, Sk, D, causal):
    rng = np.random.default_rng(Sk + D)
    q = rng.standard_normal((2, H, 1, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, Hkv, Sk, D)).astype(np.float32)
            for _ in range(2))
    G = H // Hkv
    want = attention_ref(jnp.array(q), jnp.array(np.repeat(k, G, axis=1)),
                         jnp.array(np.repeat(v, G, axis=1)), causal=causal)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    close(got, want, 1e-5)


@pytest.mark.parametrize("E,d,f", [(5, 64, 200), (8, 136, 96)])
@pytest.mark.parametrize("how", ["none", "mixed", "full"])
def test_plain_expert_ff_at_one_row_matches_oracle(E, d, f, how):
    """C = 1: every row live, or the live rows' against the oracle on x
    with the others zeroed (an empty expert's output is zero)."""
    rng = np.random.default_rng(E + d)
    x = rng.standard_normal((E, 1, d)).astype(np.float32)
    wi = (rng.standard_normal((E, d, 2 * f)) / d ** 0.5).astype(np.float32)
    wo = (rng.standard_normal((E, f, d)) / f ** 0.5).astype(np.float32)
    counts = None
    if how != "none":
        c = np.ones(E, np.int32) if how == "full" else \
            rng.integers(0, 2, E).astype(np.int32)
        counts = torch.from_numpy(c)
        x = (x * c[:, None, None]).astype(np.float32)
    got = MD.grouped_expert_ff(torch.from_numpy(x), torch.from_numpy(wi),
                               torch.from_numpy(wo), counts)
    close(got, grouped_expert_ff_ref(jnp.array(x), jnp.array(wi),
                                     jnp.array(wo)), 1e-5)


def test_decode_plain_versions_do_not_count():
    """The CPU takes the plain versions at Sq = 1 and C = 1 with counts;
    no route counts them."""
    before = (FA.LAUNCHES, dict(FA.LAUNCHES_BY_ROUTE), MD.LAUNCHES,
              dict(MD.LAUNCHES_BY_ROUTE))
    q, k, v = _qkv(1, 2, 2, 8, 32, torch.bfloat16, 0)
    FA.flash_attention(q, k, v, causal=False)
    x, wi, wo = _moe_inputs(2, 16, 8, 0)
    MD.grouped_expert_ff(x, wi, wo, torch.ones(2, dtype=torch.int32))
    assert (FA.LAUNCHES, FA.LAUNCHES_BY_ROUTE, MD.LAUNCHES,
            MD.LAUNCHES_BY_ROUTE) == before
