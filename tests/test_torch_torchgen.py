"""The port's torch rung (core/backends/torchgen.py) on CPU tensors
against the reference's JAX rung (core/backends/jaxgen.py) and oracle.

  * the licence verdict (admitted or refused) equals jaxgen's on every
    bench of the registry at its native shape;
  * on the benches both admit, the rung's buffers are byte-equal and its
    ExecStats field-equal to the reference oracle's and to jaxgen's
    certified primary;
  * certification goes unknown -> pass, and the verdict survives a
    ``.vtc`` round trip (a second compile of the kernel runs as the
    certified primary straight from disk);
  * each error bit (OOB store, uniformity, fuel) demotes a certified
    launch with the buffers untouched, and the chain then raises the
    oracle's error;
  * the arithmetic edge cases (shift counts outside [0, 32), POPC and
    FFS of negative values, FTOI of NaN and out-of-range values, integer
    division and modulo by zero, float modulo signs, min/max of signed
    zeros and NaN, SQRT of negatives and of integers) give the oracle's
    bits.
"""
import numpy as np
import pytest
import torch

from repro.core import interp as ref_interp
from repro.core.backends import jaxgen
from repro.core.passes.pipeline import ABLATION_LADDER as REF_LADDER
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.core import faults, interp
from repro_torch.core.backends import torchgen
from repro_torch.core.frontends import opencl
from repro_torch.core.passes.pipeline import (ABLATION_LADDER, PassConfig,
                                              run_pipeline)
from repro_torch.core.runtime import Runtime
from repro_torch.core.vir import Op
from repro_torch.volt_bench.suite import BENCHES

#: the benches jaxgen licenses at their native shapes
#: (BENCH_perf.json, interp_speed_jax.per_bench)
LICENSED = ("kmeans", "nearn", "pathfinder", "psum", "reduce0", "sfilter",
            "sgemm", "shuffle_hw", "shuffle_sw", "spmv", "spmv_csr",
            "spmv_tail", "transpose", "vecadd")


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VOLT_CACHE_DIR", str(tmp_path))


def _port_fn(name, cfg=None):
    b = BENCHES[name]
    return run_pipeline(b.handle.build(None), b.handle.name,
                        cfg or ABLATION_LADDER[-1]).fn


def _ref_fn(name):
    b = REF_BENCHES[name]
    return ref_run_pipeline(b.handle.build(None), b.handle.name,
                            REF_LADDER[-1]).fn


def _stats(st):
    return (st.instrs, dict(st.by_op), st.mem_requests, st.mem_insts,
            st.shared_requests, st.atomic_serial, st.max_ipdom_depth,
            st.prints)


def _launch(mod, fn, bufs0, params, sc, **kw):
    bufs = {k: v.copy() for k, v in bufs0.items()}
    st = mod.launch(fn, bufs, params, scalar_args=sc, **kw)
    return _stats(st), bufs


@pytest.mark.parametrize("name", list(BENCHES))
def test_licence_verdict_equals_jaxgen(name):
    bufs0, sc, params = BENCHES[name].make(np.random.default_rng(7))
    rbufs0, rsc, rparams = REF_BENCHES[name].make(np.random.default_rng(7))
    ok, why = torchgen.licence_check(_port_fn(name), params, bufs0, sc, {},
                                     device="cpu")
    ref_ok, ref_why = jaxgen.licence_check(_ref_fn(name), rparams, rbufs0,
                                           rsc, {})
    assert ok == ref_ok, (why, ref_why)
    assert ok == (name in LICENSED)
    if not ok:
        assert why == ref_why


@pytest.mark.parametrize("name", LICENSED)
def test_rung_equals_oracle_and_jaxgen(name):
    fn, ref_fn = _port_fn(name), _ref_fn(name)
    bufs0, sc, params = BENCHES[name].make(np.random.default_rng(11))
    rbufs0, rsc, rparams = REF_BENCHES[name].make(np.random.default_rng(11))
    oracle = _launch(ref_interp, ref_fn, rbufs0, rparams, rsc, decoded=False)
    torchgen.reset_torch_telemetry()
    cert = _launch(interp, fn, bufs0, params, sc, torch=True, device="cpu")
    t = dict(torchgen.TORCH_TELEMETRY)
    assert (t["cert_runs"], t["certified"], t["engaged"]) == (1, 1, 0)
    got = _launch(interp, fn, bufs0, params, sc, torch=True, device="cpu")
    assert torchgen.TORCH_TELEMETRY["engaged"] == 1
    assert interp.LAST_EXECUTOR[0] == "torch"
    sig = torchgen.shape_sig(fn, params, bufs0, sc, device="cpu")
    assert torchgen.recorded(fn, sig)[0] == "pass"
    jaxgen.reset_jax_telemetry()
    _launch(ref_interp, ref_fn, rbufs0, rparams, rsc, jax=True)
    jax_primary = _launch(ref_interp, ref_fn, rbufs0, rparams, rsc, jax=True)
    assert jaxgen.JAX_TELEMETRY["engaged"] == 1
    for want in (oracle, jax_primary):
        assert got[0] == want[0] == cert[0]
        for k in rbufs0:
            assert got[1][k].tobytes() == want[1][k].tobytes(), k
            assert cert[1][k].tobytes() == want[1][k].tobytes(), k


def test_chunking_leaves_results_unchanged(monkeypatch):
    """Chunks of 3 workgroups (a ragged last chunk) give the bits of one
    chunk: the shape signature keeps the chunk width, so each width is
    certified on its own."""
    for name in ("psum", "spmv_tail"):
        fn = _port_fn(name)
        bufs0, sc, params = BENCHES[name].make(np.random.default_rng(5))
        want = _launch(interp, fn, bufs0, params, sc, decoded=False)
        sigs = set()
        for cw in (3, 256):
            monkeypatch.setattr(torchgen, "_CHUNK_WGS", cw)
            torchgen.reset_torch_telemetry()
            for _ in range(2):
                got = _launch(interp, fn, bufs0, params, sc, torch=True,
                              device="cpu")
                assert got[0] == want[0]
                for k in bufs0:
                    assert got[1][k].tobytes() == want[1][k].tobytes()
            assert torchgen.TORCH_TELEMETRY["engaged"] == 1
            sigs.add(torchgen.shape_sig(fn, params, bufs0, sc, "cpu"))
        assert len(sigs) == 2


def test_certification_round_trips_through_a_vtc_file(tmp_path):
    bufs0, sc, params = BENCHES["sfilter"].make(np.random.default_rng(1))
    fn = _port_fn("sfilter")
    rt = Runtime(device="cpu", torch=True)
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    torchgen.reset_torch_telemetry()
    rt.launch(fn, grid=params.grid, block=params.local_size, scalar_args=sc)
    assert torchgen.TORCH_TELEMETRY["certified"] == 1
    files = sorted(p.suffix for p in tmp_path.iterdir())
    assert ".vtc" in files and ".vjc" not in files
    sig = torchgen.shape_sig(fn, params, bufs0, sc, "cpu")
    assert torchgen.recorded(fn, sig)[0] == "pass"
    # a fresh compile of the same kernel: its verdict comes from disk
    fn2 = _port_fn("sfilter")
    assert fn2 is not fn
    torchgen.reset_torch_telemetry()
    rt2 = Runtime(device="cpu", torch=True)
    for k, v in bufs0.items():
        rt2.create_buffer(k, v.copy())
    rt2.launch(fn2, grid=params.grid, block=params.local_size,
               scalar_args=sc)
    t = torchgen.TORCH_TELEMETRY
    assert (t["cert_runs"], t["engaged"]) == (0, 1)
    assert rt2.last_report.executor == "torch"
    for k in bufs0:
        assert rt2.buffers[k].tobytes() == rt.buffers[k].tobytes()


@opencl.kernel
def lying_uniform(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    v: "f32 uniform" = x[gid]
    acc = 0.0
    while v > 0.0:
        acc += v
        v = v - 1.0
    if gid < n:
        y[gid] = acc


@opencl.kernel
def count_up(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform",
             trips: "i32 uniform"):
    gid = get_global_id(0)
    acc = 0.0
    for i in range(trips):
        acc += x[gid]
    if gid < n:
        y[gid] = acc


def _certified(fn, bufs0, params, sc):
    torchgen.reset_torch_telemetry()
    _launch(interp, fn, bufs0, params, sc, torch=True, device="cpu")
    assert torchgen.TORCH_TELEMETRY["certified"] == 1, \
        torchgen.licence_check(fn, params, bufs0, sc, {}, "cpu")


def _demotes(fn, bufs0, params, sc, bit_name):
    bufs = {k: v.copy() for k, v in bufs0.items()}
    with pytest.raises(faults.EngineFault) as ei:
        interp.launch(fn, bufs, params, scalar_args=sc, torch=True,
                      device="cpu")
    assert ei.value.site == "torch.exec" and ei.value.rung == "torch"
    assert bit_name in str(ei.value)
    for k in bufs0:
        assert bufs[k].tobytes() == bufs0[k].tobytes(), k
    assert torchgen.TORCH_TELEMETRY["demotions"] == 1
    # the chain: the torch rung's fault demotes, the grid rung raises
    # the oracle's error
    with pytest.raises(interp.ExecError) as oracle_err:
        interp.launch(fn, {k: v.copy() for k, v in bufs0.items()}, params,
                      scalar_args=sc, decoded=False)
    rt = Runtime(device="cpu", torch=True)
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    with pytest.raises(interp.ExecError) as chain_err:
        rt.launch(fn, grid=params.grid, block=params.local_size,
                  scalar_args=sc, fuel=params.fuel)
    assert type(chain_err.value) is type(oracle_err.value)
    steps = rt.last_report.summary()
    assert "torch:engine_fault -> grid:kernel_fault" in steps, steps


def test_oob_store_bit_demotes_with_buffers_untouched():
    fn = _port_fn("vecadd")
    params = interp.LaunchParams(grid=8, local_size=32, warp_size=32)
    rng = np.random.default_rng(2)
    bufs0 = {k: rng.standard_normal(200).astype(np.float32)
             for k in ("x", "y", "z")}
    _certified(fn, bufs0, params, {"n": 200})
    _demotes(fn, bufs0, params, {"n": 256}, "oob-store")


def test_uniformity_bit_demotes_with_buffers_untouched():
    mod = lying_uniform.build(None)
    fn = run_pipeline(mod, "lying_uniform",
                      PassConfig(uni_hw=True, uni_ann=True,
                                 uni_func=True)).fn
    params = interp.LaunchParams(grid=4, local_size=32, warp_size=32)
    same = np.repeat(np.arange(4, dtype=np.float32), 32)
    bufs0 = {"x": same, "y": np.zeros(128, np.float32)}
    _certified(fn, bufs0, params, {"n": 128})
    apart = bufs0 | {"x": np.arange(128, dtype=np.float32) % 3}
    _demotes(fn, apart, params, {"n": 128}, "uniformity")


def test_fuel_bit_demotes_with_buffers_untouched():
    fn = run_pipeline(count_up.build(None), "count_up",
                      ABLATION_LADDER[-1]).fn
    params = interp.LaunchParams(grid=4, local_size=32, warp_size=32,
                                 fuel=2000)
    bufs0 = {"x": np.ones(128, np.float32), "y": np.zeros(128, np.float32)}
    _certified(fn, bufs0, params, {"n": 128, "trips": 3})
    _demotes(fn, bufs0, params, {"n": 128, "trips": 200}, "fuel")


# --------------------------------------------------------------------------
# arithmetic edge cases against the oracle's numpy tables
# --------------------------------------------------------------------------

_I = np.array([0, 1, -1, 5, -7, 2**31 - 1, -2**31, 12345, -98765, 3, 64, -3],
              np.int32)
_SH = np.array([0, 31, 32, 33, -1, 40, 1, 100, -32, 16, 2**31 - 1, -2**31],
               np.int32)
_F = np.array([0.0, -0.0, 1.5, -1.5, np.nan, np.inf, -np.inf, 3e9, -3e9,
               2147483520.0, -2147483648.0, 2147483648.0, 7.25, -7.25,
               1e-45, -2.5], np.float32)
_G = np.array([-0.0, 0.0, 0.5, 2.0, 1.0, np.nan, 3.0, -0.0, 4.0, -2.0,
               0.0, 1.5, -3.0, 3.0, np.inf, -np.inf], np.float32)


def _oracle_bits(fn, *args):
    with np.errstate(all="ignore"):
        return np.asarray(fn(*args))


@pytest.mark.parametrize("op", [Op.SHL, Op.SHR, Op.DIV, Op.MOD, Op.MIN,
                                Op.MAX, Op.AND, Op.OR, Op.XOR, Op.ADD,
                                Op.MUL, Op.LT])
def test_int_binops_match_the_oracle(op):
    a, b = _I, _SH
    want = _oracle_bits(interp._BIN_FNS[op], a, b)
    got = torchgen._tg_binop(op, torch.from_numpy(a),
                             torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _float_bits_equal(got, want, op):
    assert got.dtype == want.dtype
    if op is Op.MOD:
        # fmod's NaN of an infinite or NaN operand carries libm's sign,
        # which numpy and torch draw differently; the number is NaN on
        # both sides (certification compares bytes, so a launch that
        # met one would record "fail", never a wrong result)
        nan = np.isnan(want)
        assert (np.isnan(got) == nan).all()
        got, want = got[~nan], want[~nan]
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("op", [Op.DIV, Op.MOD, Op.MIN, Op.MAX, Op.AND,
                                Op.ADD, Op.SUB, Op.MUL, Op.EQ, Op.GE])
def test_float_binops_match_the_oracle(op):
    for a, b in ((_F, _G), (_G, _F)):   # signed zeros, NaN on either side
        want = _oracle_bits(interp._BIN_FNS[op], a, b)
        got = torchgen._tg_binop(op, torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
        _float_bits_equal(got, want, op)


def test_float_mod_signs_match_the_oracle():
    a = np.array([0.0, -0.0, 4.0, -4.0, 3.0, -3.0, 4.0, -4.0, 7.5, -7.5],
                 np.float32)
    b = np.array([2.0, 2.0, -2.0, 2.0, -1.5, 1.5, 2.0, -2.0, 2.0, 2.0],
                 np.float32)
    want = _oracle_bits(interp._BIN_FNS[Op.MOD], a, b)
    got = torchgen._tg_binop(Op.MOD, torch.from_numpy(a),
                             torch.from_numpy(b)).numpy()
    assert got.tobytes() == want.tobytes()
    assert np.signbit(got).tolist() == np.signbit(want).tolist()


@pytest.mark.parametrize("op,arg", [(Op.POPC, "i"), (Op.FFS, "i"),
                                    (Op.FTOI, "f"), (Op.SQRT, "f"),
                                    (Op.SQRT, "i"), (Op.ITOF, "i"),
                                    (Op.NEG, "i"), (Op.ABS, "f"),
                                    (Op.NOT, "i")])
def test_unops_match_the_oracle(op, arg):
    a = _I if arg == "i" else _F
    want = _oracle_bits(interp._UN_FNS[op], a)
    got = torchgen._tg_unop(op, torch.from_numpy(a)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_ftoi_of_nan_and_out_of_range_is_int32_min():
    got = torchgen._ftoi(torch.tensor([np.nan, 3e9, -3e9, np.inf, 2.9,
                                       -2.9], dtype=torch.float32))
    assert got.tolist() == [-2**31] * 4 + [2, -2]


def test_refused_ops_equal_the_reference():
    assert {o.value for o in torchgen._REFUSED_OPS} == \
        {o.value for o in jaxgen._REFUSED_OPS}
    assert (torchgen.ERR_OOB_STORE, torchgen.ERR_UNIFORM,
            torchgen.ERR_FUEL) == (jaxgen.ERR_OOB_STORE, jaxgen.ERR_UNIFORM,
                                   jaxgen.ERR_FUEL)
