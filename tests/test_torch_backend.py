"""compile_torch (the port's whole-buffer backend, eager torch on the CPU)
against the reference's compile_jax and the scalar oracle.

Float tolerance: rtol = atol = 1e-5. XLA on the CPU contracts a multiply
and an add into one FMA (docs/performance.md, "FMA"), the port does not,
so saxpy, sgemm, the spmv family and blackscholes differ in the last bits.
Integer buffers are exact.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent / "kernels"))

from repro.core import interp
from repro.core.backends.jax_backend import _np_jax_binop, _np_jax_unop
from repro.core.backends.jax_backend import compile_jax
from repro.core.passes.pipeline import PassConfig as RefPassConfig
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.core.vir import Op as RefOp
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.convert import (launch_params, to_numpy, to_scalars,
                                 to_tensors)
from repro_torch.core.backends.torch_backend import (LowerError,
                                                     _torch_binop,
                                                     _torch_unop,
                                                     compile_torch)
from repro_torch.core.frontends import opencl
from repro_torch.core.interp import LaunchParams
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline
from repro_torch.core.vir import BINOPS, UNOPS, Op
from repro_torch.volt_bench.suite import BENCHES

import volt_kernels as K

CFG = dict(uni_hw=True, uni_ann=True, uni_func=True)
#: compile_jax sums the active lanes for ballot at W >= 32 (ROADMAP C1);
#: the port builds the oracle's bitmask, so these meet interp.launch
BALLOT_FAULT = ("bscan_hw", "atomic_agg")


def _port(name, seed=0, scalarize_uniform=False, cfg=None):
    b = BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(seed))
    mod = b.handle.build(None)
    ck = run_pipeline(mod, b.handle.name, cfg or PassConfig(**CFG))
    tk = compile_torch(ck.fn, params, mod, scalarize_uniform,
                       device="cpu")
    return bufs, to_numpy(tk.fn(to_tensors(bufs, "cpu"), sc))


def _reference(name, seed=0, scalarize_uniform=False):
    b = REF_BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(seed))
    mod = b.handle.build(None)
    ck = ref_run_pipeline(mod, b.handle.name, RefPassConfig(**CFG))
    jk = compile_jax(ck.fn, params, mod, scalarize_uniform)
    out = jk.fn({k: jnp.array(v) for k, v in bufs.items()},
                {k: jnp.asarray(v) for k, v in sc.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _oracle(name, seed=0):
    b = REF_BENCHES[name]
    bufs, sc, params = b.make(np.random.default_rng(seed))
    ck = ref_run_pipeline(b.handle.build(None), b.handle.name,
                          RefPassConfig(**CFG))
    out = {k: v.copy() for k, v in bufs.items()}
    interp.launch(ck.fn, out, params, scalar_args=sc)
    return out


def _assert_match(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", [n for n in BENCHES
                                  if n not in BALLOT_FAULT])
def test_compile_torch_matches_compile_jax(name):
    _, got = _port(name)
    _assert_match(got, _reference(name))


@pytest.mark.parametrize("name", BALLOT_FAULT)
def test_compile_torch_ballot_matches_oracle(name):
    bufs, got = _port(name)
    want = _oracle(name)
    _assert_match(got, want)
    ref = BENCHES[name].ref(bufs, BENCHES[name].make(
        np.random.default_rng(0))[1])
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_scalarized_uniform_branch_backend():
    """A uniform branch taken by a host ``if`` matches the linearized
    lowering and the numpy reference (port of test_system.py's
    scalarize_uniform test)."""
    b = BENCHES["srad_flag"]
    bufs, scalars, _ = b.make(np.random.default_rng(7))
    expect = b.ref(bufs, scalars)
    outs = []
    for scal in (False, True):
        _, got = _port("srad_flag", 7, scal,
                       PassConfig(uni_hw=True, uni_ann=True))
        np.testing.assert_allclose(got["out"], expect["out"], atol=1e-3)
        ref = _reference("srad_flag", 7, scal)
        np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5,
                                   atol=1e-5)
        outs.append(got["out"])
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


@opencl.kernel
def loop_break_continue(x: "ptr_f32", out: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    acc = 0.0
    for i in range(n):
        v = x[gid * n + i]
        if v < 0.0:
            break
        if i == 2:
            continue
        acc += v
    out[gid] = acc


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_loop_break_continue_matches_oracle(seed):
    """Port of test_property.py's backend equivalence, at fixed seeds:
    the same kernel source through the port's frontend and compile_torch
    against the reference's scalar oracle."""
    params = LaunchParams(grid=2, local_size=32, warp_size=32)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(64 * 5) + 0.5).astype(np.float32)
    mod = loop_break_continue.build(None)
    ck = run_pipeline(mod, "loop_break_continue",
                      PassConfig(uni_hw=True, uni_ann=True))
    tk = compile_torch(ck.fn, params, mod, device="cpu")
    out = tk.fn({"x": torch.from_numpy(x.copy()),
                 "out": torch.zeros(64, dtype=torch.float32)}, {"n": 5})
    ref = {"x": x.copy(), "out": np.zeros(64, np.float32)}
    interp.reference_launch(K.loop_break_continue.build(None).functions[
        "loop_break_continue"], ref, interp.LaunchParams(
            grid=2, local_size=32, warp_size=32), scalar_args={"n": 5})
    np.testing.assert_allclose(out["out"].numpy(), ref["out"], atol=1e-5)


_I = np.array([-2**31, -2**31, -7, -7, -1, 0, 1, 7, 31, 2**31 - 1, 5, -5],
              np.int32)
_J = np.array([-1, 33, 2, -2, 40, 0, 31, 0, 1, -1, -3, 32], np.int32)
_F = np.array([-2.5, -0.0, 0.0, 1.5, 3e9, -3e9, np.nan, 7.25, 0.1, -1e-3,
               np.inf, 2.0], np.float32)
_G = np.array([2.0, 0.0, -0.0, -1.5, 7.0, 0.5, 1.0, -2.0, 3.0, 4.0, 1.0,
               -np.inf], np.float32)


def _inputs(op):
    shifts = (Op.SHL, Op.SHR, Op.AND, Op.OR, Op.XOR)
    out = [(_I, _J)]
    if op not in shifts:
        out.append((_F, _G))
    return out


@pytest.mark.parametrize("op", sorted(BINOPS, key=lambda o: o.value),
                         ids=lambda o: o.value)
def test_binop_semantics_match_jnp(op):
    """Each lowered binop gives jnp's answer on int32 and float32 edge
    values: floor division and modulo, a zero divisor, shifts past 31,
    int32 wraparound, NaN propagation."""
    for a, b in _inputs(op):
        want = np.asarray(_np_jax_binop(RefOp(op.value), jnp.asarray(a),
                                        jnp.asarray(b)))
        got = _torch_binop(op, torch.from_numpy(a), torch.from_numpy(b))
        got = got.numpy()
        assert got.dtype == want.dtype
        if op is Op.POW:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", sorted(UNOPS, key=lambda o: o.value),
                         ids=lambda o: o.value)
def test_unop_semantics_match_jnp(op):
    args = [_I] if op in (Op.POPC, Op.FFS, Op.ITOF, Op.NOT) else [_I, _F]
    for a in args:
        if op in (Op.EXP, Op.LOG, Op.SIN, Op.COS, Op.SQRT) and \
                a.dtype == np.int32:
            continue
        want = np.asarray(_np_jax_unop(RefOp(op.value), jnp.asarray(a)))
        got = _torch_unop(op, torch.from_numpy(a)).numpy()
        assert got.dtype == want.dtype
        if op in (Op.EXP, Op.LOG, Op.SIN, Op.COS):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_ballot_refuses_wide_workgroups():
    b = BENCHES["bscan_hw"]
    bufs, sc, _ = b.make(np.random.default_rng(0))
    params = LaunchParams(grid=4, local_size=64, warp_size=32)
    mod = b.handle.build(None)
    ck = run_pipeline(mod, "bscan_hw", PassConfig(**CFG))
    tk = compile_torch(ck.fn, params, mod, device="cpu")
    with pytest.raises(LowerError, match="ballot"):
        tk.fn(to_tensors(bufs, "cpu"), sc)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = BENCHES["vecadd"]
    mod = b.handle.build(None)
    ck = run_pipeline(mod, "vecadd", PassConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_torch(ck.fn, LaunchParams(), mod)


def test_convert_carries_reference_data():
    rb = REF_BENCHES["blackscholes"]
    bufs, sc, params = rb.make(np.random.default_rng(0))
    lp = launch_params(params)
    assert isinstance(lp, LaunchParams)
    assert (lp.grid, lp.local_size, lp.wg_threads) == (8, 32, 32)
    t = to_tensors(bufs, "cpu")
    t["S"][0] = -1.0
    assert bufs["S"][0] != -1.0            # copied, not aliased
    assert t["call"].dtype == torch.float32
    ck = run_pipeline(BENCHES["blackscholes"].handle.build(None),
                      "blackscholes", PassConfig(**CFG))
    typed = to_scalars(sc, ck.fn)
    assert typed["n"].dtype == np.int32 and typed["r"].dtype == np.float32
    assert typed["r"] == np.float32(0.05)
