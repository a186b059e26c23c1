"""simt_exec on the card: the CUDA kernel against its plain version.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_simt_exec_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances: integer
buffers exact; float buffers exact, except kernels with EXP or LOG
(blackscholes, srad_flag) at rtol = atol = 1e-5, because CUDA's
expf/logf and torch's differ by a few ulps.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy, to_tensors
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.kernels import build
from repro_torch.kernels.simt_exec import simt_exec as sx
from repro_torch.volt_bench.suite import BENCHES

TILEABLE = ["vecadd", "saxpy", "psum", "psort", "sfilter", "blackscholes",
            "pathfinder", "stencil", "cfd_like", "srad_flag", "vote_hw",
            "bscan_hw"]
EXP_LOG = ("blackscholes", "srad_flag")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TILEABLE)
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    b = BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(0))
    ck = run_pipeline(b.handle.build(None), b.handle.name,
                      PassConfig(uni_hw=True, uni_ann=True, uni_func=True))
    want = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, "cuda"), sc)
    before = sx.LAUNCHES
    got = sx.simt_launch(ck.fn, params, to_tensors(bufs, "cuda"), sc)
    torch.cuda.synchronize()
    assert sx.LAUNCHES == before + 1
    tol = 1e-5 if name in EXP_LOG else 0.0
    got, want = to_numpy(got), to_numpy(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with no nvcc the
    launch raises instead of running the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    b = BENCHES["cfd_like"]
    bufs, sc, params = b.make(np.random.default_rng(0))
    ck = run_pipeline(b.handle.build(None), "cfd_like", PassConfig())
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(build, "BUILD_ROOT", build.BUILD_ROOT / "never")
    with pytest.raises(RuntimeError, match="nvcc"):
        sx.simt_launch(ck.fn, params, to_tensors(bufs, "cuda"), sc)
