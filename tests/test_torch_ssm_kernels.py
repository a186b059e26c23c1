"""selective_scan: the port's plain version against the JAX package's
Pallas kernel (interpret mode) and sequential oracle, the state handed
from one call to the next, and the CUDA source's float32 instantiation
run on the host.

The CUDA kernel against its plain version, on a card, is in
``test_torch_ssm_cuda.py``.

Tolerances: rtol = atol = 1e-4, those of ``tests/test_kernels.py``
(float32 on both sides; the Pallas kernel and the oracle multiply h by
Cm as a matrix product, the plain version as a batched one). A sequence
cut into chained calls repeats the same float32 steps: held at 1e-6.
The host run of the CUDA source is held to the plain version at 1e-5:
the same recurrence, its dot product summed in another order.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan_op
from repro.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan import selective_scan as SS

HOST_CUDA = Path(__file__).parent / "cuda_host"
TOL = 1e-4


def _inputs(shape, seed, dtype=torch.float32):
    """dA in (0.5, 0.99), dBx and Cm at scale 0.1, as in
    tests/test_kernels.py: torch tensors, and the same values as JAX
    arrays."""
    B, S, d, n = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0.5, 0.99, (B, S, d, n)),
            rng.standard_normal((B, S, d, n)) * 0.1,
            rng.standard_normal((B, S, n)) * 0.1]
    ts = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]
    return ts, [jnp.array(t.float().numpy()) for t in ts]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(2, 128, 16, 8), (1, 256, 32, 16),
                                   (3, 64, 8, 4)])
def test_plain_matches_pallas_and_oracle(shape):
    """The shapes of tests/test_kernels.py::test_selective_scan_sweep."""
    (dA, dBx, Cm), (jA, jB, jC) = _inputs(shape, 0)
    got = SS.selective_scan(dA, dBx, Cm)
    assert got.dtype == torch.float32 and got.shape == shape[:3]
    _close(got, selective_scan_op(jA, jB, jC, chunk=32))
    _close(SS.selective_scan_plain(dA, dBx, Cm),
           selective_scan_ref(jA, jB, jC))


def test_plain_carries_the_state_across_chunks():
    """tests/test_kernels.py's carry case: y_t = n * 0.9^t stays nonzero
    past the Pallas kernel's chunk boundary, and equals the kernel's."""
    B, S, d, n = 1, 64, 4, 2
    dA = torch.full((B, S, d, n), 0.9)
    dBx = torch.zeros(B, S, d, n)
    dBx[:, 0] = 1.0
    Cm = torch.ones(B, S, n)
    got = SS.selective_scan(dA, dBx, Cm)
    assert float(got[0, 17, 0]) > 0.1
    _close(got, selective_scan_op(jnp.array(dA.numpy()),
                                  jnp.array(dBx.numpy()),
                                  jnp.array(Cm.numpy()), chunk=16))
    _close(got[0, :, 0], 2 * 0.9 ** np.arange(S), 1e-5)


@pytest.mark.parametrize("cuts", [(16, 48), (5, 30, 29), (63, 1)])
def test_chained_calls_match_one_call(cuts):
    """A sequence scanned in pieces, the state handed over in h, gives
    one call's y and leaves the last state in h; the first piece starts
    from a given state."""
    (dA, dBx, Cm), _ = _inputs((2, sum(cuts), 12, 8), 1)
    h0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, 8)).astype(np.float32))
    # one call from h0: prepend a step with dA = 0, dBx = h0
    want = SS.selective_scan(torch.cat([torch.zeros_like(dA[:, :1]), dA], 1),
                             torch.cat([h0[:, None], dBx], 1),
                             torch.cat([torch.zeros_like(Cm[:, :1]), Cm], 1)
                             )[:, 1:]
    h = h0.clone()
    ys, t0 = [], 0
    for c in cuts:
        ys.append(SS.selective_scan(dA[:, t0:t0 + c], dBx[:, t0:t0 + c],
                                    Cm[:, t0:t0 + c], h))
        t0 += c
    _close(torch.cat(ys, 1), want, 1e-6)
    last = h0
    for t in range(dA.shape[1]):
        last = dA[:, t] * last + dBx[:, t]
    _close(h, last, 1e-6)


def test_bf16_inputs_give_a_bf16_output():
    (dA, dBx, Cm), _ = _inputs((1, 32, 16, 16), 3, torch.bfloat16)
    got = SS.selective_scan(dA, dBx, Cm)
    assert got.dtype == torch.bfloat16
    want = SS.selective_scan_plain(dA.float(), dBx.float(), Cm.float())
    _close(got.float(), want, 2e-2)


def test_plain_version_does_not_count():
    (dA, dBx, Cm), _ = _inputs((1, 4, 8, 4), 4)
    before = SS.LAUNCHES
    SS.selective_scan(dA, dBx, Cm)
    assert SS.LAUNCHES == before


def test_wrapper_refuses_bad_shapes_dtypes_and_devices():
    dA, Cm = torch.ones(2, 3, 8, 4), torch.ones(2, 3, 4)
    with pytest.raises(ValueError, match=r"\(B, S, d, n\)"):
        SS.selective_scan(dA[0], dA[0], Cm)
    with pytest.raises(ValueError, match="does not fit"):
        SS.selective_scan(dA, dA, torch.ones(2, 3, 5))
    with pytest.raises(ValueError, match="state h"):
        SS.selective_scan(dA, dA, Cm, torch.zeros(2, 8, 4).double())
    with pytest.raises(ValueError, match="state h"):
        SS.selective_scan(dA, dA, Cm, torch.zeros(2, 4, 8))
    with pytest.raises(TypeError, match="dtype"):
        SS.selective_scan(dA.double(), dA.double(), Cm.double())
    with pytest.raises(TypeError, match="dtype"):
        SS.selective_scan(dA, dA.bfloat16(), Cm)
    meta = [t.to("meta") for t in (dA, dA, Cm)]
    with pytest.raises(ValueError, match="one CUDA device"):
        SS.selective_scan(*meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        SS.selective_scan(dA, dA, Cm, torch.zeros(2, 8, 4, device="meta"))


# --------------------------------------------------------------------------
# the CUDA source, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    so = tmp_path_factory.mktemp("host_ss") / "selective_scan.so"
    p = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{HOST_CUDA}", "-x", "c++", "-o", str(so), str(SS.KERNEL.cu)],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lib = ctypes.CDLL(str(so))
    lib.selective_scan_f32.argtypes = SS.KERNEL.argtypes[
        "selective_scan_f32"]
    return lib


@pytest.mark.parametrize("shape", [
    (2, 128, 16, 8), (1, 256, 32, 16), (3, 64, 8, 4),   # Pallas sweep
    (2, 37, 200, 16),     # odd S (the unrolled steps), d past one CTA
])
@pytest.mark.parametrize("with_state", [False, True])
def test_source_matches_plain_on_host(shape, with_state, host_lib):
    (dA, dBx, Cm), _ = _inputs(shape, 5)
    B, S, d, n = shape
    h0 = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, d, n)).astype(np.float32))
    h, want_h = h0.clone(), h0.clone()
    y = torch.full((B, S, d), float("nan"))
    err = host_lib.selective_scan_f32(
        dA.data_ptr(), dBx.data_ptr(), Cm.data_ptr(),
        h.data_ptr() if with_state else None, None, y.data_ptr(), B, S, d,
        n, None)
    assert err == 0
    want = SS.selective_scan_plain(dA, dBx, Cm,
                                   want_h if with_state else None)
    _close(y, want, 1e-5)
    _close(h, want_h if with_state else h0, 1e-5)


def test_source_refuses_a_state_size_it_does_not_take(host_lib):
    (dA, dBx, Cm), _ = _inputs((1, 4, 8, 2), 7)
    y = torch.zeros(1, 4, 8)
    assert host_lib.selective_scan_f32(dA.data_ptr(), dBx.data_ptr(),
                                       Cm.data_ptr(), None, None,
                                       y.data_ptr(), 1, 4, 8, 2,
                                       None) != 0
