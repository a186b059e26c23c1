"""moe_dispatch: the port's plain grouped expert FF against the JAX
package's Pallas kernel (interpret mode) and oracle, and the CUDA
source's float32 instantiation run on the host.

The CUDA kernel against its plain version, on a card, is in
``test_torch_moe_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: 1e-5 in float32 and
3e-2 in bfloat16 (both sides compute in float32 and round the output to
bf16 once). The host run of the CUDA source is held to the plain version
at 1e-5: the same float32 sums in another order.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch.ops import grouped_expert_ff_op
from repro.kernels.moe_dispatch.ref import grouped_expert_ff_ref
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD

HOST_CUDA = Path(__file__).parent / "cuda_host"
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


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


def test_zero_capacity_gives_an_empty_output():
    x = torch.zeros(4, 0, 16)
    y = MD.grouped_expert_ff(x, torch.zeros(4, 16, 8), torch.zeros(4, 4, 16))
    assert y.shape == (4, 0, 16)


def test_plain_version_does_not_count():
    (_, x), (_, wi), (_, wo) = _inputs((2, 3, 8, 4), torch.float32, 2)
    before = MD.LAUNCHES
    MD.grouped_expert_ff(x, wi, wo)
    assert MD.LAUNCHES == before


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
         f"-I{HOST_CUDA}", "-x", "c++", "-o", str(so), str(MD.KERNEL.cu)],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    lib.moe_ff_f32.argtypes = MD.KERNEL.argtypes["moe_ff_f32"]
    return lib


@pytest.mark.parametrize("shape", [
    (4, 128, 64, 32), (2, 256, 32, 64), (8, 128, 128, 16),   # Pallas sweep
    (3, 1, 64, 48), (2, 40, 128, 64), (2, 130, 64, 48),      # ragged C
    (2, 17, 70, 300),     # d past one k tile, f past one 256-column chunk
])
def test_source_matches_plain_on_host(shape, host_lib):
    (_, x), (_, wi), (_, wo) = _inputs(shape, torch.float32, 3)
    y = torch.full_like(x, float("nan"))
    E, C, d, f = shape
    err = host_lib.moe_ff_f32(x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
                              y.data_ptr(), E, C, d, f, None)
    assert err == 0
    _close(y, MD.grouped_expert_ff_plain(x, wi, wo).numpy(), 1e-5)
