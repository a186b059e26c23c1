"""simt_exec: the tiled plain version against the reference's Pallas
kernel, and the CUDA code generator's output. The CUDA kernel against the
plain version, on a card, is in ``test_torch_simt_exec_cuda.py``.

Tolerances: integer buffers exact; float buffers exact for the kernels
with no multiply-add and no transcendental (EXACT), where XLA on the CPU
has nothing to contract; rtol = atol = 1e-6 for the others, except
blackscholes and srad_flag at the bench's atol (XLA contracts
multiply-adds into FMAs and evaluates exp/log differently).
"""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent / "kernels"))

from repro.core import interp
from repro.core.passes.pipeline import PassConfig as RefPassConfig
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.kernels.simt_exec.ops import volt_pallas_run
from repro.kernels.simt_exec.ref import volt_reference_run
from repro.kernels.simt_exec.simt_exec import pallas_simt_launch
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.convert import launch_params, to_numpy, to_tensors
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.kernels.simt_exec import simt_exec as sx
from repro_torch.kernels.simt_exec.codegen import emit_kernel
from repro_torch.kernels.simt_exec.ops import volt_torch_run
from repro_torch.volt_bench.suite import BENCHES

import volt_kernels as K

CFG = dict(uni_hw=True, uni_ann=True, uni_func=True)
TILEABLE = ["vecadd", "saxpy", "psum", "psort", "sfilter", "blackscholes",
            "pathfinder", "stencil", "cfd_like", "srad_flag", "vote_hw"]
#: kernels with EXP or LOG: CUDA's expf/logf differ from torch's in ulps
EXP_LOG = ("blackscholes", "srad_flag")
#: float arithmetic is adds, mins and single multiplies only
EXACT = ("vecadd", "psum", "psort", "pathfinder", "stencil", "vote_hw")
HOST_CUDA = Path(__file__).parent / "cuda_host"


def _compiled(name):
    b = BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(0))
    mod = b.handle.build(None)
    return b, bufs, sc, params, mod, run_pipeline(mod, b.handle.name,
                                                  PassConfig(**CFG))


def _tol(name):
    if name in EXACT:
        return 0.0
    return BENCHES[name].atol if name in EXP_LOG else 1e-6


def _assert_match(got, want, tol):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", TILEABLE)
def test_plain_matches_pallas_interpret(name):
    b, bufs, sc, params, mod, ck = _compiled(name)
    got = to_tensors(bufs, "cpu")
    sx.simt_launch_plain(ck.fn, params, got, sc)
    rb = REF_BENCHES[name]
    rmod = rb.handle.build(None)
    rck = ref_run_pipeline(rmod, rb.handle.name, RefPassConfig(**CFG))
    want = pallas_simt_launch(rck.fn, rb.make(np.random.default_rng(0))[2],
                              {k: jnp.array(v) for k, v in bufs.items()},
                              sc, rmod, interpret=True)
    _assert_match(to_numpy(got), want, _tol(name))


def test_bscan_hw_matches_oracle():
    """Ballot builds the oracle's bitmask (the reference backend sums
    the active lanes instead, ROADMAP C1)."""
    b, bufs, sc, params, mod, ck = _compiled("bscan_hw")
    got = to_numpy(sx.simt_launch(ck.fn, params, to_tensors(bufs, "cpu"),
                                  sc))
    rb = REF_BENCHES["bscan_hw"]
    rck = ref_run_pipeline(rb.handle.build(None), "bscan_hw",
                           RefPassConfig(**CFG))
    want = {k: v.copy() for k, v in bufs.items()}
    interp.launch(rck.fn, want, rb.make(np.random.default_rng(0))[2],
                  scalar_args=sc)
    _assert_match(got, want, 0.0)
    _assert_match(got, b.ref(bufs, sc), 0.0)


def test_saxpy_matches_volt_reference_run():
    """Port of test_kernels.py's simt_exec case: the whole slice
    (frontend -> pipeline -> simt_launch) against the scalar oracle."""
    rng = np.random.default_rng(0)
    params = interp.LaunchParams(grid=4, local_size=32, warp_size=32)
    x = rng.standard_normal(128).astype(np.float32)
    y = rng.standard_normal(128).astype(np.float32)
    out = volt_torch_run(BENCHES["saxpy"].handle, {"x": x, "y": y},
                         launch_params(params),
                         {"a": np.float32(3.0), "n": np.int32(120)},
                         device="cpu")
    ref = volt_reference_run(K.saxpy, {"x": x, "y": y.copy()}, params,
                             {"a": 3.0, "n": 120})
    np.testing.assert_allclose(out["y"].numpy(), ref["y"], atol=1e-5)
    np.testing.assert_array_equal(out["x"].numpy(), x)


@pytest.mark.parametrize("name", ["vecadd", "stencil", "psum", "vote_hw"])
def test_volt_torch_run_matches_volt_pallas_run(name):
    rb = REF_BENCHES[name]
    bufs, sc, params = rb.make(np.random.default_rng(1))
    got = volt_torch_run(BENCHES[name].handle, bufs, launch_params(params),
                         sc, device="cpu")
    want = volt_pallas_run(rb.handle, {k: jnp.array(v)
                                       for k, v in bufs.items()}, params, sc)
    _assert_match(to_numpy(got), want, _tol(name))


@pytest.mark.parametrize("name", TILEABLE + ["bscan_hw"])
def test_codegen_emits_one_global_kernel(name):
    b, bufs, sc, params, mod, ck = _compiled(name)
    src = sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu"))
    assert src.count("__global__") == 1
    assert f"volt_{ck.fn.name}(" in src
    assert 'extern "C" int launch(void** bufs, const void* scalars, ' \
           "int grid, void* stream)" in src
    assert src.count("{") == src.count("}")
    # scalars are kernel arguments, not baked in
    scal = [p for p in ck.fn.params if p.ty.value != "ptr"]
    assert src.count("memcpy(&s") == len(scal)


def test_source_hash_is_stable_across_builds():
    srcs = []
    for _ in range(2):
        b, bufs, sc, params, mod, ck = _compiled("blackscholes")
        srcs.append(sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu")))
    assert srcs[0] == srcs[1]
    assert sx.source_hash(srcs[0]) == sx.source_hash(srcs[1])
    b, bufs, sc, params, mod, ck = _compiled("saxpy")
    other = sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu"))
    assert sx.source_hash(other) != sx.source_hash(srcs[0])


def test_atomics_are_refused():
    b, bufs, sc, params, mod, ck = _compiled("vote_sw")
    with pytest.raises(NotImplementedError, match="atomic"):
        sx.simt_launch(ck.fn, params, to_tensors(bufs, "cpu"), sc)
    with pytest.raises(NotImplementedError, match="atomic"):
        emit_kernel(ck.fn, params, {"x": "float", "y": "float"})


def test_non_tileable_buffer_is_refused():
    b, bufs, sc, params, mod, ck = _compiled("vecadd")
    t = to_tensors(bufs, "cpu")
    t["z"] = t["z"][:-1].clone()
    with pytest.raises(ValueError, match="not tileable"):
        sx.simt_launch(ck.fn, params, t, sc)
    t = to_tensors(bufs, "cpu")
    t["x"] = t["x"].to(torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        sx.simt_launch(ck.fn, params, t, sc)


def test_plain_updates_in_place_and_does_not_count():
    b, bufs, sc, params, mod, ck = _compiled("saxpy")
    t = to_tensors(bufs, "cpu")
    y = t["y"]
    before = sx.LAUNCHES
    out = sx.simt_launch(ck.fn, params, t, sc)
    assert out["y"] is y
    np.testing.assert_allclose(y.numpy()[:250], (np.float32(2.5)
                               * bufs["x"] + bufs["y"])[:250], rtol=1e-6)
    assert sx.LAUNCHES == before


# --------------------------------------------------------------------------
# the emitted CUDA, run on the host: g++ with a stand-in CUDA runtime
# (tests/cuda_host), one thread per lane
# --------------------------------------------------------------------------

_LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), 0, \(cudaStream_t\)stream>>>"
                     r"\((.*)\);")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Every tileable bench's emitted source, built for the host by one
    g++ process each, all started together."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the emitted CUDA on the host")
    out = tmp_path_factory.mktemp("host_cuda")
    procs = {}
    for name in TILEABLE + ["bscan_hw"]:
        b, bufs, sc, params, mod, ck = _compiled(name)
        src = sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu"))
        src = _LAUNCH.sub(r"vx_host_launch(\2, \3, [&] { \1(\4); });", src)
        (out / f"{name}.cpp").write_text(src)
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", f"-I{HOST_CUDA}",
             f"-I{Path(sx.__file__).parent / 'csrc'}",
             "-o", str(out / f"{name}.so"), str(out / f"{name}.cpp")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.launch.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                               ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]
        lib.launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


@pytest.mark.parametrize("name", TILEABLE + ["bscan_hw"])
def test_emitted_cuda_matches_plain_on_host(name, host_libs):
    b, bufs, sc, params, mod, ck = _compiled(name)
    want = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, "cpu"), sc)
    got = to_tensors(bufs, "cpu")
    names = [p.name for p in ck.fn.params if p.ty.value == "ptr"]
    ptrs = (ctypes.c_void_p * len(names))(*[got[n].data_ptr()
                                            for n in names])
    packed = ctypes.create_string_buffer(sx._pack_scalars(ck.fn, sc))
    err = host_libs[name].launch(ptrs, ctypes.cast(packed, ctypes.c_void_p),
                                 params.grid, None)
    assert err == 0
    _assert_match(to_numpy(got), to_numpy(want),
                  1e-5 if name in EXP_LOG else 0.0)
