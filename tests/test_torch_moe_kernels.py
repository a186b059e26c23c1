"""moe_dispatch: the port's plain grouped expert FF against the JAX
package's Pallas kernel (interpret mode) and oracle, and the CUDA
source's float32 instantiation run on the host.

The CUDA kernel against its plain version, on a card, is in
``test_torch_moe_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: 1e-5 in float32 and
3e-2 in bfloat16 (both sides compute in float32 and round the output to
bf16 once). The host run of the CUDA source is held to the plain version
at 1e-5: the same float32 sums in another order (the down product summed
over slices of the hidden columns, each slice over chunks). The
tensor-core route's rounding model is held at chip_smoke.py's bf16
tolerance, rtol 1e-2 and atol 2e-3.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.moe_dispatch.ops import grouped_expert_ff_op
from repro.kernels.moe_dispatch.ref import grouped_expert_ff_ref
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD

HOST_CUDA = Path(__file__).parent / "cuda_host"
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
#: chip_smoke.py's bf16 tolerance for moe_dispatch: rtol, atol
CARD_BF16_TOL = (1e-2, 2e-3)


def _inputs(shape, dtype, seed):
    """x (E, C, d), wi (E, d, 2f), wo (E, f, d) at scale 0.1, as JAX
    arrays and torch tensors of the same values."""
    E, C, d, f = shape
    rng = np.random.default_rng(seed)
    out = []
    for s in ((E, C, d), (E, d, 2 * f), (E, f, d)):
        t = torch.from_numpy(
            (rng.standard_normal(s) * 0.1).astype(np.float32)).to(dtype)
        out.append((jnp.array(t.float().numpy(), JNP[dtype]), t))
    return out


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(4, 128, 64, 32), (2, 256, 32, 64),
                                   (8, 128, 128, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas(shape, dtype):
    """The shapes of tests/test_kernels.py::test_moe_grouped_ff_sweep."""
    (jx, x), (jwi, wi), (jwo, wo) = _inputs(shape, dtype, 0)
    got = MD.grouped_expert_ff(x, wi, wo)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, grouped_expert_ff_op(jx, jwi, jwo, block_c=128), TOL[dtype])


@pytest.mark.parametrize("C", [1, 40, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_ragged_capacity_matches_oracle(C, dtype):
    """Capacities the Pallas kernel refuses (C % 128 != 0): decode's
    C = 1, the smoke LM's C = 40, and one past a block."""
    (jx, x), (jwi, wi), (jwo, wo) = _inputs((3, C, 64, 48), dtype, 1)
    _close(MD.grouped_expert_ff_plain(x, wi, wo),
           grouped_expert_ff_ref(jx, jwi, jwo), TOL[dtype])


@pytest.mark.parametrize("C", [1, 40])
def test_plain_wide_expert_matches_oracle(C):
    """An expert wider than the first kernel took (f > 3552): jamba's
    experts are 24576 wide."""
    (jx, x), (jwi, wi), (jwo, wo) = _inputs((2, C, 16, 3600),
                                            torch.float32, 4)
    _close(MD.grouped_expert_ff(x, wi, wo),
           grouped_expert_ff_ref(jx, jwi, jwo), TOL[torch.float32])


@pytest.mark.parametrize("E,C,f,want", [
    (16, 1, 24576, (16, 1536)),     # jamba decode: 256 CTAs
    (64, 1, 1024, (4, 256)),        # olmoe decode: 256 CTAs
    (16, 1280, 24576, (1, 24576)),  # jamba prefill: 1280 CTAs already
    (64, 1280, 1024, (1, 1024)),    # olmoe prefill
    (8, 40, 64, (1, 256)),          # smoke prefill: f is one slice
    (2, 1, 300, (2, 256)),
    (1, 1, 2048, (8, 256)),         # kimi decode with counts: the finest
    (1, 1, 24576, (96, 256))])      # jamba decode with counts
def test_slicing_covers_f_and_fills_the_grid(E, C, f, want):
    n, fs = MD.slicing(E, C, f)
    assert (n, fs) == want
    assert (n - 1) * fs < f <= n * fs


def _path_inputs(shape, seed):
    """x (E, C, d) at unit scale, as an RMSNorm hands it over, and wi, wo
    drawn as init_params draws them (normal over the square root of the
    fan-in), all bf16."""
    E, C, d, f = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale)
                             .astype(np.float32)).bfloat16()
            for s, scale in (((E, C, d), 1.0), ((E, d, 2 * f), d ** -0.5),
                             ((E, f, d), f ** -0.5))]


def _tc_model(x, wi, wo, part="f16"):
    """The tensor-core route's arithmetic, written out: float32 sums, the
    hidden silu(g) * u rounded between the two products, the output
    rounded to bf16 once. ``part``: "f16", the route's (the hidden and wo
    rounded to fp16, the down product's operand type); "bf16", the hidden
    rounded to bf16 alone."""
    f = wo.shape[1]
    h = torch.bmm(x.float(), wi.float())
    h = F.silu(h[..., :f]) * h[..., f:]
    wo = wo.float()
    if part == "f16":
        h, wo = h.half().float(), wo.half().float()
    else:
        h = h.bfloat16().float()
    return torch.bmm(h, wo).bfloat16()


def _misses(got, want):
    """Outputs past chip_smoke.py's rtol 1e-2 + atol 2e-3."""
    rtol, atol = CARD_BF16_TOL
    err = (got.float() - want.float()).abs()
    return int((err > atol + rtol * want.float().abs()).sum())


@pytest.mark.parametrize("shape", [(4, 40, 256, 96), (2, 130, 128, 200),
                                   (2, 64, 1024, 512), (8, 256, 512, 256)])
def test_tensor_core_rounding_model_meets_plain_and_oracle(shape):
    """The route rounds only the hidden (to one fp16 part) and wo (bf16 to
    fp16) between its products; that model stays within the card's bf16
    tolerance of the plain version and of the JAX oracle."""
    x, wi, wo = _path_inputs(shape, 10)
    got = _tc_model(x, wi, wo)
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(
        got.float(), MD.grouped_expert_ff_plain(x, wi, wo).float(),
        rtol=rtol, atol=atol)
    oracle = grouped_expert_ff_ref(
        *(jnp.array(t.float().numpy(), jnp.bfloat16) for t in (x, wi, wo)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), rtol=rtol,
                               atol=atol)


def test_hidden_rounded_alone_misses_the_card_tolerance():
    """Why the route carries fp16 and not bf16: the hidden rounded to bf16
    alone puts some outputs past rtol 1e-2 + atol 2e-3 of the plain
    version; one fp16 part stays inside."""
    x, wi, wo = _path_inputs((8, 256, 512, 256), 11)
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    assert _misses(_tc_model(x, wi, wo, part="bf16"), want) > 0
    assert _misses(_tc_model(x, wi, wo), want) == 0


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, (64, 1280, 2048, 1024), "tensor_cores"),   # olmoe
    (torch.bfloat16, (16, 1280, 8192, 24576), "tensor_cores"),  # jamba
    (torch.bfloat16, (64, 1, 2048, 1024), "cuda_cores"),    # olmoe decode
    (torch.bfloat16, (16, 1, 8192, 24576), "cuda_cores"),   # jamba decode
    (torch.bfloat16, (2, 130, 100, 300), "cuda_cores"),     # d = 100
    (torch.bfloat16, (2, 130, 128, 300), "cuda_cores"),     # f % 8 != 0
    (torch.bfloat16, (3, 130, 136, 200), "tensor_cores"),   # 8 | d, f
    (torch.bfloat16, (384, 212, 7168, 2048), "tensor_cores"),  # kimi
    (torch.bfloat16, (384, 1, 7168, 2048), "cuda_cores"),   # kimi decode
    (torch.float32, (64, 1280, 2048, 1024), "cuda_cores")])
def test_route_names_the_entry(dtype, shape, want):
    E, C, d, f = shape
    assert MD.route(dtype, C, d, f) == want
    name = MD.entry(dtype, C, d, f)
    assert name in MD.KERNEL.argtypes
    assert (name == "moe_ff_bf16_tc") == (want == "tensor_cores")


def _counts(E, C, how, seed=0):
    """Counts of filled rows: none, every row, or a mix of 0, C and
    values between."""
    if how == "zero":
        return torch.zeros(E, dtype=torch.int32)
    if how == "full":
        return torch.full((E,), C, dtype=torch.int32)
    c = torch.from_numpy(np.random.default_rng(seed).integers(
        0, C + 1, E).astype(np.int32))
    c[0], c[-1] = 0, C
    return c


@pytest.mark.parametrize("how", ["zero", "mixed", "full"])
@pytest.mark.parametrize("C", [1, 40])
def test_plain_with_counts_zeroes_rows_past_the_count(how, C):
    """Rows at or past an expert's count come out zero, whatever x holds
    there; rows before it are the oracle's on x with those rows zeroed."""
    (_, x), (_, wi), (_, wo) = _inputs((5, C, 32, 24), torch.float32, 12)
    counts = _counts(5, C, how)
    got = MD.grouped_expert_ff(x, wi, wo, counts)
    keep = torch.arange(C)[None, :] < counts[:, None]
    assert (got[~keep] == 0).all()
    xz = x * keep[..., None]
    _close(got, grouped_expert_ff_ref(*(jnp.array(t.numpy())
                                        for t in (xz, wi, wo))), 1e-5)
    if how == "full":
        assert torch.equal(got, MD.grouped_expert_ff(x, wi, wo))


def test_counts_are_checked():
    (_, x), (_, wi), (_, wo) = _inputs((3, 4, 8, 8), torch.float32, 13)
    for bad in (torch.zeros(3, dtype=torch.int64),
                torch.zeros(4, dtype=torch.int32),
                torch.zeros(3, 1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="counts"):
            MD.grouped_expert_ff(x, wi, wo, bad)


def test_zero_capacity_gives_an_empty_output():
    x = torch.zeros(4, 0, 16)
    y = MD.grouped_expert_ff(x, torch.zeros(4, 16, 8), torch.zeros(4, 4, 16))
    assert y.shape == (4, 0, 16)


def test_plain_version_does_not_count():
    (_, x), (_, wi), (_, wo) = _inputs((2, 3, 8, 4), torch.float32, 2)
    before = MD.LAUNCHES, dict(MD.LAUNCHES_BY_ROUTE)
    MD.grouped_expert_ff(x, wi, wo)
    assert (MD.LAUNCHES, MD.LAUNCHES_BY_ROUTE) == before


def test_wrapper_refuses_bad_shapes_dtypes_and_devices():
    x, wi, wo = torch.ones(2, 3, 8), torch.ones(2, 8, 8), torch.ones(2, 4, 8)
    with pytest.raises(ValueError, match="do not fit"):
        MD.grouped_expert_ff(x, torch.ones(2, 8, 6), wo)
    with pytest.raises(ValueError, match="do not fit"):
        MD.grouped_expert_ff(x, wi, torch.ones(3, 4, 8))
    with pytest.raises(ValueError, match=r"\(E, C, d\)"):
        MD.grouped_expert_ff(x[0], wi, wo)
    with pytest.raises(TypeError, match="dtype"):
        MD.grouped_expert_ff(x.double(), wi.double(), wo.double())
    with pytest.raises(TypeError, match="dtype"):
        MD.grouped_expert_ff(x, wi.bfloat16(), wo)
    meta = [t.to("meta") for t in (x, wi, wo)]
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.grouped_expert_ff(*meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.grouped_expert_ff(x, *meta[1:])


# --------------------------------------------------------------------------
# the CUDA source, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    so = tmp_path_factory.mktemp("host_moe") / "moe_dispatch.so"
    p = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{HOST_CUDA}", f"-I{CSRC}", "-x", "c++", "-o", str(so),
         str(MD.KERNEL.cu)],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    lib.moe_ff_f32.argtypes = MD.KERNEL.argtypes["moe_ff_f32"]
    return lib


def _host_run(lib, x, wi, wo, n_slices, fs, counts=None):
    """The kernel's output, its workspace filled with NaN first: a row
    the kernel forgot to write would show."""
    E, C, d = x.shape
    f = wo.shape[1]
    ws = torch.full((n_slices, E, C, d), float("nan"))
    y = torch.full_like(x, float("nan"))
    err = lib.moe_ff_f32(x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
                         None if counts is None else counts.data_ptr(),
                         ws.data_ptr(), y.data_ptr(), E, C, d, f, fs,
                         n_slices, None)
    return err, y


@pytest.mark.parametrize("shape", [
    (4, 128, 64, 32), (2, 256, 32, 64), (8, 128, 128, 16),   # Pallas sweep
    (3, 1, 64, 48), (2, 40, 128, 64), (2, 130, 64, 48),      # ragged C
    (2, 17, 70, 300),     # d past one k tile, f past one 256-column chunk
])
def test_source_matches_plain_on_host(shape, host_lib):
    """At the wrapper's own slicing."""
    (_, x), (_, wi), (_, wo) = _inputs(shape, torch.float32, 3)
    E, C, d, f = shape
    err, y = _host_run(host_lib, x, wi, wo, *MD.slicing(E, C, f))
    assert err == 0
    _close(y, MD.grouped_expert_ff_plain(x, wi, wo).numpy(), 1e-5)


@pytest.mark.parametrize("shape,n_slices,fs", [
    ((3, 1, 72, 600), 3, 256),      # C = 1: several slices, a short last
    ((1, 1, 40, 2100), 9, 256),     # C = 1: many slices
    ((1, 1, 24, 2100), 1, 2100),    # C = 1: one slice of two chunks
    ((2, 40, 24, 3600), 4, 1024),   # C = 40: several slices
    ((1, 20, 24, 1100), 1, 1100),   # C = 20: one slice of two chunks
    ((1, 3, 24, 1100), 2, 768),     # a slice of one chunk, the last short
])
def test_source_slices_match_plain_on_host(shape, n_slices, fs, host_lib):
    """Slicings the wrapper picks for other grids, and slices longer than
    one chunk of hidden columns (1024 at C > 1, 2048 at C = 1), with
    f > 3552 and d not a multiple of the 8-column loads."""
    (_, x), (_, wi), (_, wo) = _inputs(shape, torch.float32, 8)
    err, y = _host_run(host_lib, x, wi, wo, n_slices, fs)
    assert err == 0
    _close(y, MD.grouped_expert_ff_plain(x, wi, wo).numpy(), 1e-5)


@pytest.mark.parametrize("n_slices,fs", [(2, 500), (3, 600), (1, 1000)])
def test_source_refuses_a_slicing_that_does_not_cover_f(n_slices, fs,
                                                        host_lib):
    """Too few slices, one slice too many, one slice too narrow."""
    (_, x), (_, wi), (_, wo) = _inputs((1, 3, 8, 1100), torch.float32, 9)
    err, _ = _host_run(host_lib, x, wi, wo, n_slices, fs)
    assert err != 0


@pytest.mark.parametrize("how", ["zero", "mixed", "full"])
@pytest.mark.parametrize("shape", [(6, 1, 72, 600), (5, 40, 24, 300)])
def test_source_with_counts_matches_plain_on_host(shape, how, host_lib):
    """The kernel with counts (none filled, a mix, all filled), at C = 1
    over several slices and at C = 40 over row blocks that a count cuts:
    x's rows past the count are not zero here, and still come out zero."""
    (_, x), (_, wi), (_, wo) = _inputs(shape, torch.float32, 14)
    E, C, d, f = shape
    counts = _counts(E, C, how, seed=1)
    err, y = _host_run(host_lib, x, wi, wo, *MD.slicing(E, C, f), counts)
    assert err == 0
    _close(y, MD.grouped_expert_ff_plain(x, wi, wo, counts).numpy(), 1e-5)


# --------------------------------------------------------------------------
# the tensor-core route run on the host: moe_ff_bf16_tc (moe_up_tc and
# moe_down_tc) built with g++ against tests/cuda_host/sm90, whose wgmma
# reads its operands through the descriptors and the 128-byte swizzle, as
# tests/test_torch_lm_kernels.py runs attention's
# --------------------------------------------------------------------------

HOST_SM90 = HOST_CUDA / "sm90"


@pytest.fixture(scope="module")
def host_tc_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    so = tmp_path_factory.mktemp("host_moe_tc") / "moe_dispatch_tc.so"
    p = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-D__CUDACC__", f"-I{HOST_SM90}", f"-I{HOST_CUDA}", "-x", "c++",
         "-o", str(so), str(MD.KERNEL.cu)],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    lib.moe_ff_bf16_tc.argtypes = MD.KERNEL.argtypes["moe_ff_bf16_tc"]
    return lib


def _host_tc_run(lib, x, wi, wo, counts=None, gu=None):
    """(y, hexp, hmax, redo) of the tensor-core entry on the host; y and
    the scratch filled with garbage first, hmax with 7s (the launcher
    zeroes it). ``gu``, where given, receives the up product."""
    E, C, d = x.shape
    f = wo.shape[1]
    h, hexp, hmax, redo = MD.tc_scratch(E, C, d, f, "cpu")
    h.fill_(float("nan"))
    hexp.fill_(99)
    hmax.fill_(7)
    redo.fill_(7)
    y = torch.full_like(x, float("nan"))
    err = lib.moe_ff_bf16_tc(
        x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
        None if counts is None else counts.data_ptr(), h.data_ptr(),
        hexp.data_ptr(), hmax.data_ptr(), redo.data_ptr(),
        None if gu is None else gu.data_ptr(), y.data_ptr(), E, C, d, f,
        None)
    assert err == 0
    return y, hexp, hmax, redo


@pytest.mark.parametrize("shape,how", [
    ((2, 130, 64, 136), None),      # two row blocks, a short column block
    ((3, 40, 136, 200), "mixed"),   # counts: an empty expert, a full one
    ((1, 20, 264, 72), "full"),     # two down column blocks
])
def test_tensor_core_source_matches_plain_on_host(shape, how, host_tc_lib):
    """The route's two kernels under the emulated helpers, at x, wi, wo
    of the path's scales, against the plain version at the card's bf16
    tolerance; every exponent 0 (the values are in range), rows past a
    count zero."""
    x, wi, wo = _path_inputs(shape, 20)
    E, C, d, f = shape
    counts = None if how is None else _counts(E, C, how, seed=2)
    y, hexp, hmax, redo = _host_tc_run(host_tc_lib, x, wi, wo, counts)
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(
        y.float(), MD.grouped_expert_ff_plain(x, wi, wo, counts).float(),
        rtol=rtol, atol=atol)
    assert (hmax == 0).all() and (redo == 0).all()
    filled = (torch.arange(C)[None, :] < (torch.full((E, 1), C)
                                          if counts is None
                                          else counts[:, None]))
    assert (hexp[filled] == 0).all()
    if counts is not None:
        assert (y[~filled] == 0).all()


def _c13_inputs(what):
    """ROADMAP C13's inputs for the expert FF, (E, C, d, f) (2, 70, 64,
    200): "h", expert 1's gate and up columns 150 set to 5 x row 3 of its
    x, so that row 3's hidden there is about 1e5, past fp16's 65504, and
    every other row's stays under 1e4; "wo", one element of expert 0's
    wo at 7e4."""
    x, wi, wo = _path_inputs((2, 70, 64, 200), 21)
    if what == "h":
        wi[1, :, 150] = (5 * x[1, 3].float()).bfloat16()
        wi[1, :, 200 + 150] = wi[1, :, 150]
    else:
        wo[0, 37, 50] = 7e4
    return x, wi, wo


@pytest.mark.parametrize("what", ["h", "wo"])
def test_tensor_core_source_takes_values_past_fp16_range_on_host(
        what, host_tc_lib):
    """ROADMAP C13: a hidden value or a wo element past fp16's range
    (bf16's reaches 3.4e38, as the plain version's float32 does). The
    output is finite and within the card's bf16 tolerance of the plain
    version. The hidden's exponents are 0 but at the row and tile past
    the range, and only the down product's CTAs that meet it are left to
    the scaled launch. (Before the fix the route stored h and converted
    wo to fp16 as they were and gave inf.)"""
    x, wi, wo = _c13_inputs(what)
    y, hexp, hmax, redo = _host_tc_run(host_tc_lib, x, wi, wo)
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    hid = torch.bmm(x.float(), wi.float())
    hid = F.silu(hid[..., :200]) * hid[..., 200:]
    assert torch.isfinite(y.float()).all()
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol,
                               atol=atol)
    want_e = 0
    if what == "h":
        big = hid.abs() > 65504
        assert big.nonzero().tolist() == [[1, 3, 150]]
        assert float(hid.abs()[~big].max()) < 1e4
        # the tile's largest under 2^15: floor(log2 |h|) - 14
        want_e = int(math.floor(math.log2(float(hid[1, 3, 150].abs())))) - 14
        assert want_e >= 2
        assert int(hmax[1, 3]) == want_e and int(hexp[1, 3, 2]) == want_e
        hexp[1, 3, 2] = 0
    assert (hexp == 0).all() and int(hmax.sum()) == want_e
    # the down product's CTAs left to the scaled launch: those of expert 1
    # (rows of h with an exponent) or of expert 0's wo columns 0-255 (one
    # CTA: d 64 is one block of 256 columns), over its row blocks
    n_mb = -(-70 // 128)
    assert redo.tolist() == ([0] * n_mb + [1] * n_mb if what == "h"
                             else [1] * n_mb + [0] * n_mb)
