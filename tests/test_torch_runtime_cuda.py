"""The torch rung (core/backends/torchgen.py) on the card: on CUDA
tensors it equals the grid executor bit for bit, buffers and ExecStats,
on every bench it licenses, and the Runtime on the card serves a large
launch from it.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_runtime_cuda.py

Skips where ``torch.cuda.is_available()`` is false.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import interp, runtime
from repro_torch.core.backends import torchgen
from repro_torch.core.passes.pipeline import ABLATION_LADDER, run_pipeline
from repro_torch.core.vir import Op
from repro_torch.volt_bench.suite import BENCHES

LICENSED = ("kmeans", "nearn", "pathfinder", "psum", "reduce0", "sfilter",
            "sgemm", "shuffle_hw", "shuffle_sw", "spmv", "spmv_csr",
            "spmv_tail", "transpose", "vecadd")


@pytest.fixture(autouse=True)
def _card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setenv("VOLT_CACHE_DIR", str(tmp_path))


def _fn(name):
    b = BENCHES[name]
    return run_pipeline(b.handle.build(None), b.handle.name,
                        ABLATION_LADDER[-1]).fn


def _stats(st):
    return (st.instrs, dict(st.by_op), st.mem_requests, st.mem_insts,
            st.shared_requests, st.atomic_serial, st.max_ipdom_depth)


def _launch(fn, bufs0, params, sc, **kw):
    bufs = {k: v.copy() for k, v in bufs0.items()}
    return _stats(interp.launch(fn, bufs, params, scalar_args=sc, **kw)), bufs


@pytest.mark.cuda
@pytest.mark.parametrize("name", LICENSED)
def test_card_rung_equals_the_grid_executor(name):
    fn = _fn(name)
    bufs0, sc, params = BENCHES[name].make(np.random.default_rng(0))
    want = _launch(fn, bufs0, params, sc, grid=True)
    torchgen.reset_torch_telemetry()
    for _ in range(2):      # certification, then the certified primary
        got = _launch(fn, bufs0, params, sc, torch=True, device="cuda")
        assert got[0] == want[0]
        for k in bufs0:
            assert got[1][k].tobytes() == want[1][k].tobytes(), k
    t = torchgen.TORCH_TELEMETRY
    assert (t["certified"], t["engaged"]) == (1, 1)
    assert interp.LAST_EXECUTOR[0] == "torch"


@pytest.mark.cuda
def test_card_rung_chunks_a_large_launch(monkeypatch):
    """vecadd and psum at 2^20 lanes in chunks of 2^14 workgroups (and
    one ragged chunk), through Runtime() on the card."""
    monkeypatch.setattr(torchgen, "_CHUNK_WGS_CUDA", 1 << 14)
    for name in ("vecadd", "psum"):
        fn = _fn(name)
        b = BENCHES[name]
        grid = (1 << 15) + 3
        n = grid * 32
        rng = np.random.default_rng(1)
        bufs0 = {k: (rng.standard_normal(n).astype(v.dtype)
                     if k in ("x", "y") else np.zeros(n, v.dtype))
                 for k, v in b.make(np.random.default_rng(0))[0].items()}
        sc = {"n": n - 5}
        params = interp.LaunchParams(grid=grid, local_size=32, warp_size=32)
        want = _launch(fn, bufs0, params, sc, grid=True)
        rt = runtime.Runtime()
        for k, v in bufs0.items():
            rt.create_buffer(k, v.copy())
        torchgen.reset_torch_telemetry()
        for _ in range(2):
            st = rt.launch(fn, grid=grid, block=32, scalar_args=sc)
        assert rt.last_report.executor == "torch"
        assert torchgen.TORCH_TELEMETRY["engaged"] == 1
        assert _stats(st) == want[0]
        for k in bufs0:
            assert rt.buffers[k].tobytes() == want[1][k].tobytes(), k


_I = np.array([0, 1, -1, 5, -7, 2**31 - 1, -2**31, 12345, -98765, 3, 64, -3],
              np.int32)
_SH = np.array([0, 31, 32, 33, -1, 40, 1, 100, -32, 16, 2**31 - 1, -2**31],
               np.int32)
_F = np.array([0.0, -0.0, 1.5, -1.5, np.nan, np.inf, -np.inf, 3e9, -3e9,
               2147483520.0, -2147483648.0, 2147483648.0, 7.25, -7.25,
               1e-45, -2.5], np.float32)
_G = np.array([-0.0, 0.0, 0.5, 2.0, 1.0, np.nan, 3.0, -0.0, 4.0, -2.0,
               0.0, 1.5, -3.0, 3.0, np.inf, -np.inf], np.float32)


@pytest.mark.cuda
def test_card_arithmetic_matches_the_oracle_tables():
    """Shifts, POPC, FFS, FTOI, integer DIV and MOD, MIN/MAX and SQRT on
    the card give numpy's bits, where the card's own conversions and
    shifts differ (FTOI saturates, NaN to 0). A float operation that
    makes a NaN from a NaN gives the card's canonical NaN (0x7fffffff),
    not the operand's payload as the host does: there only NaN-ness is
    held, and certification, which compares bytes, would record such a
    launch "fail" rather than serve it."""
    cu = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    with np.errstate(all="ignore"):
        for op in (Op.SHL, Op.SHR, Op.DIV, Op.MOD, Op.MIN, Op.MAX):
            want = interp._BIN_FNS[op](_I, _SH)
            got = torchgen._tg_binop(op, cu(_I), cu(_SH)).cpu().numpy()
            assert got.tobytes() == np.asarray(want).tobytes(), op
        for op in (Op.DIV, Op.MIN, Op.MAX, Op.MUL):
            for a, b in ((_F, _G), (_G, _F)):
                want = np.asarray(interp._BIN_FNS[op](a, b))
                got = torchgen._tg_binop(op, cu(a), cu(b)).cpu().numpy()
                nan = np.isnan(want)
                assert (np.isnan(got) == nan).all(), op
                assert got[~nan].tobytes() == want[~nan].tobytes(), op
        for op, a in ((Op.POPC, _I), (Op.FFS, _I), (Op.FTOI, _F),
                      (Op.SQRT, _F), (Op.SQRT, _I), (Op.ITOF, _I)):
            want = np.asarray(interp._UN_FNS[op](a))
            got = torchgen._tg_unop(op, cu(a)).cpu().numpy()
            nan = np.isnan(want) if want.dtype.kind == "f" else \
                np.zeros(want.shape, bool)
            assert (got[nan] != got[nan]).all(), op
            assert got[~nan].tobytes() == want[~nan].tobytes(), op
