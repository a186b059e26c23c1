"""simt_exec: the tiled plain version against the reference's Pallas
kernel, and the CUDA code generator's output: run on the host in both
modes (warp mode at W = 32, CTA mode at W = 256 and 16), and where it
drops a store's barrier pair. The CUDA kernel against the plain version,
on a card, is in ``test_torch_simt_exec_cuda.py``.

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
from repro_torch.core.frontends import opencl
from repro_torch.core.interp import LaunchParams
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.kernels.simt_exec import simt_exec as sx
from repro_torch.kernels.simt_exec import codegen
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


@opencl.kernel
def store_then_shift(x: "ptr_f32", y: "ptr_f32", n: "i32 uniform"):
    # x is stored at the thread's cell and then read at its neighbour's
    gid = get_global_id(0)
    if gid < n:
        x[gid] = x[gid] + 1.0
        y[gid] = x[gid - 1]


@opencl.kernel
def shift(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        y[gid] = x[gid - 1] * 2.0


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


def _at(name, grid, W):
    """The bench's inputs at ``grid`` workgroups of ``W`` lanes: each
    buffer's values repeated to the new length, ``n`` as far from the end
    as the bench has it (where it covers more than half the buffers)."""
    b, bufs, sc, params, mod, ck = _compiled(name)
    L0, L = params.grid * params.wg_threads, grid * W
    bufs = {k: np.resize(v, L) for k, v in bufs.items()}
    sc = dict(sc)
    if "n" in sc and sc["n"] > L0 // 2:
        sc["n"] = L - (L0 - sc["n"])
    return ck, bufs, sc, LaunchParams(grid=grid, local_size=W,
                                      warp_size=32)


#: (grid, W) of each mode: a grid of 13 is not a whole number of CTAs of 8
#: warps, so the last CTA holds spare warps; 9 workgroups of 256 lanes, on
#: a device that reports no SMs (so any grid fills it), take 3 CTAs of 4
#: turns, each running 3 in turn (CTA b: b, b + 3, b + 6); 9 of 16 lanes
#: (less than a warp), on the stand-in's 132 SMs, one CTA each
MODES = {"warp": (13, 32), "cta": (9, 256), "cta16": (9, 16)}
#: (SMs the stand-in reports, CTAs launched) of each mode
MODE_GEOMETRY = {"warp": (132, 2), "cta": (0, 3), "cta16": (132, 9)}
#: the cases of each mode: ballot takes at most 32 lanes
MODE_CASES = [("warp", n) for n in TILEABLE + ["bscan_hw"]] + \
    [("cta", n) for n in TILEABLE] + \
    [("cta16", n) for n in TILEABLE + ["bscan_hw"]]


def _host_build(out, name, src):
    src = _LAUNCH.sub(r"vx_host_launch(\2, \3, [&] { \1(\4); });", src)
    (out / f"{name}.cpp").write_text(src)
    return subprocess.Popen(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
         "-fPIC", "-pthread", f"-I{HOST_CUDA}",
         f"-I{Path(sx.__file__).parent / 'csrc'}",
         "-o", str(out / f"{name}.so"), str(out / f"{name}.cpp")],
        stderr=subprocess.PIPE, text=True)


def _host_load(path):
    lib = ctypes.CDLL(str(path))
    lib.launch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    return lib


def _host_run(lib, ck, params, bufs, sc):
    got = to_tensors(bufs, "cpu")
    names = [p.name for p in ck.fn.params if p.ty.value == "ptr"]
    ptrs = (ctypes.c_void_p * len(names))(*[got[n].data_ptr()
                                            for n in names])
    packed = ctypes.create_string_buffer(sx._pack_scalars(ck.fn, sc))
    assert lib.launch(ptrs, ctypes.cast(packed, ctypes.c_void_p),
                      params.grid, None) == 0
    return got


@pytest.fixture(scope="module")
def cta_libs(tmp_path_factory):
    """Every CTA-mode case of MODE_CASES emitted and built for the host,
    one g++ each, all at once (warp mode's are ``host_libs``: the source
    does not depend on the grid)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the emitted CUDA on the host")
    out = tmp_path_factory.mktemp("host_cuda_cta")
    procs = {}
    for mode, name in MODE_CASES:
        if mode != "warp":
            ck, bufs, sc, params = _at(name, *MODES[mode])
            procs[(mode, name)] = _host_build(
                out, f"{mode}_{name}",
                sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu")))
    libs = {}
    for (mode, name), p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        libs[(mode, name)] = _host_load(out / f"{mode}_{name}.so")
    return libs


@pytest.mark.parametrize("mode,name", MODE_CASES)
def test_emitted_cuda_matches_plain_in_each_mode_on_host(mode, name,
                                                         host_libs,
                                                         cta_libs):
    """Warp mode at 13 workgroups (two CTAs of 8 warps, 3 spare); CTA
    mode at 9 workgroups of 256 lanes on 3 CTAs, each running 3 in turn
    (the device reports no SMs, so the grid counts as large), and of 16
    lanes one a CTA (132 SMs: a small grid). The launch's geometry is
    read back from the stand-in and from the launcher's ``vx_ctas``."""
    ck, bufs, sc, params = _at(name, *MODES[mode])
    lib = host_libs[name] if mode == "warp" else cta_libs[(mode, name)]
    sms, ctas = MODE_GEOMETRY[mode]
    lib.vx_host_set_sm_count(sms)
    want = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, "cpu"), sc)
    got = _host_run(lib, ck, params, bufs, sc)
    _assert_match(to_numpy(got), to_numpy(want),
                  1e-5 if name in EXP_LOG else 0.0)
    threads = 32 * codegen.WARPS_PER_CTA if mode == "warp" else MODES[mode][1]
    assert (lib.vx_host_last_launch(0), lib.vx_host_last_launch(1)) == \
        (ctas, threads)
    assert ctypes.c_int.in_dll(lib, "vx_ctas").value == ctas


def _fenced(src, buffer):
    """For each store to ``buffer`` (a pointer param's name, or a shared
    array's C name): whether a barrier comes right before and right
    after it."""
    tiles = {m.group(2): f"t{m.group(1)}"
             for m in re.finditer(r"// b(\d+): buffer (\w+)", src)}
    target = tiles.get(buffer, buffer)
    lines = [ln.strip() for ln in src.splitlines()]
    sync = ("__syncthreads();", "__syncwarp();")
    out = [lines[k - 1] in sync and lines[k + 1] in sync
           for k, ln in enumerate(lines)
           if ln.startswith("vx_store<") and ln.split("(")[1].startswith(
               target + ",")]
    assert out, f"no store to {buffer}"
    return out


def _source(name, aliases=()):
    b, bufs, sc, params, mod, ck = _compiled(name)
    t = to_tensors(bufs, "cpu")
    for a, b_ in aliases:
        t[a] = t[b_]
    return sx.kernel_source(ck.fn, params, t)


@pytest.mark.parametrize("name,buffer", [("vecadd", "z"), ("saxpy", "y"),
                                         ("vote_hw", "y"), ("psum", "y")])
def test_own_cell_stores_drop_their_barriers(name, buffer):
    """A store whose buffer is only ever indexed at the thread's own cell
    (global_id, or vote_hw's group_id * local_size + local_id) needs no
    barrier: vecadd and saxpy then have none at all."""
    src = _source(name)
    assert not any(_fenced(src, buffer))
    if name in ("vecadd", "saxpy"):
        assert "__syncthreads" not in src and "__syncwarp" not in src


def test_shared_array_stores_keep_their_barriers():
    """psum's tmp is read at lid - off: every store to it is fenced."""
    assert all(_fenced(_source("psum"), "sh0"))


def _tiny(handle, W=32, grid=3):
    params = LaunchParams(grid=grid, local_size=W, warp_size=32)
    ck = run_pipeline(handle.build(None), handle.name, PassConfig(**CFG))
    rng = np.random.default_rng(3)
    bufs = {p.name: rng.standard_normal(grid * W).astype(np.float32)
            for p in ck.fn.params if p.ty.value == "ptr"}
    return ck, params, bufs, {"n": grid * W - 5}


def test_a_buffer_read_at_a_neighbour_keeps_its_barriers(tmp_path):
    """store_then_shift stores x at gid and reads it at gid - 1: x's
    store keeps its pair, y's drops it; on the host the emitted kernel
    equals the plain version (every y sees the stored x)."""
    ck, params, bufs, sc = _tiny(store_then_shift)
    src = sx.kernel_source(ck.fn, params, to_tensors(bufs, "cpu"))
    assert all(_fenced(src, "x")) and not any(_fenced(src, "y"))
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the emitted CUDA on the host")
    p = _host_build(tmp_path, "store_then_shift", src)
    assert p.wait(timeout=300) == 0, p.stderr.read()
    got = _host_run(_host_load(tmp_path / "store_then_shift.so"), ck, params,
                    bufs, sc)
    want = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, "cpu"), sc)
    _assert_match(to_numpy(got), to_numpy(want), 0.0)


def test_aliased_buffers_keep_every_barrier(tmp_path):
    """Where two buffers share storage (the wrapper compares their
    address ranges), every store keeps its pair: vecadd writing z into x,
    and shift writing y over the x it reads at gid - 1. On the host the
    kept barriers give the plain version's answer."""
    t = {"a": torch.zeros(64), "b": torch.zeros(64)}
    assert not sx.aliased(t, ["a", "b"])
    assert sx.aliased({"a": t["a"], "b": t["a"][10:]}, ["a", "b"])
    assert all(_fenced(_source("vecadd", [("z", "x")]), "z"))
    ck, params, bufs, sc = _tiny(shift)
    assert not any(_fenced(sx.kernel_source(ck.fn, params,
                                            to_tensors(bufs, "cpu")), "y"))
    same = torch.from_numpy(bufs["x"])
    src = sx.kernel_source(ck.fn, params, {"x": same, "y": same})
    assert all(_fenced(src, "y"))
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the emitted CUDA on the host")
    p = _host_build(tmp_path, "shift", src)
    assert p.wait(timeout=300) == 0, p.stderr.read()
    lib = _host_load(tmp_path / "shift.so")
    got = same.clone()
    want = sx.simt_launch_plain(ck.fn, params, {"x": same.clone(),
                                                "y": same.clone()}, sc)["y"]
    ptrs = (ctypes.c_void_p * 2)(got.data_ptr(), got.data_ptr())
    packed = ctypes.create_string_buffer(sx._pack_scalars(ck.fn, sc))
    assert lib.launch(ptrs, ctypes.cast(packed, ctypes.c_void_p),
                      params.grid, None) == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
