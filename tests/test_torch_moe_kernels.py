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
    (2, 1, 300, (2, 256))])
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


def _tc_model(x, wi, wo, split=True):
    """The tensor-core route's arithmetic, written out: float32 sums, the
    hidden silu(g) * u carried as two bf16 parts hi + lo (or, with
    ``split`` False, rounded to bf16 alone) between the two products,
    the output rounded to bf16 once."""
    f = wo.shape[1]
    h = torch.bmm(x.float(), wi.float())
    h = F.silu(h[..., :f]) * h[..., f:]
    hi = h.bfloat16().float()
    if split:
        hi = hi + (h - hi).bfloat16().float()
    return torch.bmm(hi, wo.float()).bfloat16()


@pytest.mark.parametrize("shape", [(4, 40, 256, 96), (2, 130, 128, 200)])
def test_tensor_core_rounding_model_meets_plain_and_oracle(shape):
    """The route rounds only the hidden (to hi + lo bf16 parts) between
    its products; that model stays within the card's bf16 tolerance of
    the plain version and of the JAX oracle."""
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
    """Why the route carries two parts: the hidden rounded to bf16 alone
    puts some outputs past rtol 1e-2 + atol 2e-3 of the plain version."""
    x, wi, wo = _path_inputs((8, 256, 512, 256), 11)
    want = MD.grouped_expert_ff_plain(x, wi, wo).float()
    rtol, atol = CARD_BF16_TOL
    err = (_tc_model(x, wi, wo, split=False).float() - want).abs()
    assert int((err > atol + rtol * want.abs()).sum()) > 0
    err = (_tc_model(x, wi, wo).float() - want).abs()
    assert int((err > atol + rtol * want.abs()).sum()) == 0


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, (64, 1280, 2048, 1024), "tensor_cores"),   # olmoe
    (torch.bfloat16, (16, 1280, 8192, 24576), "tensor_cores"),  # jamba
    (torch.bfloat16, (64, 1, 2048, 1024), "cuda_cores"),    # olmoe decode
    (torch.bfloat16, (16, 1, 8192, 24576), "cuda_cores"),   # jamba decode
    (torch.bfloat16, (2, 130, 100, 300), "cuda_cores"),     # d = 100
    (torch.bfloat16, (2, 130, 128, 300), "cuda_cores"),     # f % 8 != 0
    (torch.bfloat16, (3, 130, 136, 200), "tensor_cores"),   # 8 | d, f
    (torch.float32, (64, 1280, 2048, 1024), "cuda_cores")])
def test_route_names_the_entry(dtype, shape, want):
    E, C, d, f = shape
    assert MD.route(dtype, C, d, f) == want
    name = MD.entry(dtype, C, d, f)
    assert name in MD.KERNEL.argtypes
    assert (name == "moe_ff_bf16_tc") == (want == "tensor_cores")


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


def _host_run(lib, x, wi, wo, n_slices, fs):
    """The kernel's output, its workspace filled with NaN first: a row
    the kernel forgot to write would show."""
    E, C, d = x.shape
    f = wo.shape[1]
    ws = torch.full((n_slices, E, C, d), float("nan"))
    y = torch.full_like(x, float("nan"))
    err = lib.moe_ff_f32(x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
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
