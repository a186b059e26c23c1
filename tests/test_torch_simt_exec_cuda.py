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
from repro_torch.core.frontends import opencl
from repro_torch.core.interp import LaunchParams
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.kernels import build
from repro_torch.kernels.simt_exec import codegen
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


def _compiled(name):
    b = BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(0))
    ck = run_pipeline(b.handle.build(None), b.handle.name,
                      PassConfig(uni_hw=True, uni_ann=True, uni_func=True))
    return ck, bufs, sc, params


def _at(name, grid, W):
    """The bench's inputs at ``grid`` workgroups of ``W`` lanes: each
    buffer's values repeated to the new length, ``n`` as far from the end
    as the bench has it (where it covers more than half the buffers)."""
    ck, bufs, sc, params = _compiled(name)
    L0, L = params.grid * params.wg_threads, grid * W
    bufs = {k: np.resize(v, L) for k, v in bufs.items()}
    sc = dict(sc)
    if "n" in sc and sc["n"] > L0 // 2:
        sc["n"] = L - (L0 - sc["n"])
    return ck, bufs, sc, LaunchParams(grid=grid, local_size=W,
                                      warp_size=32)


def _match(got, want, name):
    tol = 1e-5 if name in EXP_LOG else 0.0
    got, want = to_numpy(got), to_numpy(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,name",
                         [("warp", n) for n in TILEABLE]
                         + [("cta", n) for n in TILEABLE if n != "bscan_hw"]
                         + [("cta16", n) for n in TILEABLE])
def test_cuda_kernel_matches_plain_in_each_mode(mode, name):
    """Warp mode at 1,001 workgroups of 32 (125 CTAs of 8 warps and one
    of 1); CTA mode at 37 workgroups of 256 lanes (one a CTA: a small
    grid) and 70,001 of 16 (on a card of up to 132 SMs, 4 a CTA in
    turn). The CTAs are read back from the launcher."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    grid, W = {"warp": (1001, 32), "cta": (37, 256),
               "cta16": (70001, 16)}[mode]
    ck, bufs, sc, params = _at(name, grid, W)
    assert codegen.warp_mode(W) == (mode == "warp")
    want = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, "cuda"), sc)
    tens = to_tensors(bufs, "cuda")
    got = sx.simt_launch(ck.fn, params, tens, sc)
    torch.cuda.synchronize()
    _match(got, want, name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    turns = (4 if mode == "cta16" and -(-grid // 4) >= 128 * sms else 1)
    assert sx.last_ctas(sx.kernel_source(ck.fn, params, tens)) == (
        126 if mode == "warp" else -(-grid // turns))


@opencl.kernel
def shift(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        y[gid] = x[gid - 1] * 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [32, 256])
def test_aliased_buffers_match_plain(W):
    """shift writes y over the x it reads at gid - 1: with x and y one
    tensor the wrapper keeps every barrier, and each y sees the x of
    before the launch, as the plain version computes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    params = LaunchParams(grid=301, local_size=W, warp_size=32)
    ck = run_pipeline(shift.build(None), "shift",
                      PassConfig(uni_hw=True, uni_ann=True, uni_func=True))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        301 * W).astype(np.float32)).cuda()
    sc = {"n": 301 * W - 3}
    want = sx.simt_launch_plain(ck.fn, params, {"x": x.clone(),
                                                "y": x.clone()}, sc)["y"]
    same = x.clone()
    sx.simt_launch(ck.fn, params, {"x": same, "y": same}, sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(same, want, rtol=0, atol=0)
