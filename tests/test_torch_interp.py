"""The port's executors (core/interp.py, core/interp_mem.py) against the
reference's: every kernel of the bench registry, built from the same
seed at native shape and folded to 1, 2 and 4 warps per workgroup, runs
through the port's oracle, decoded, wg-batched and grid executors and
through the reference's same four. Each port executor must give the
reference executor's ExecStats (every field) and buffers bit for bit, or
raise the same error class where the launch is erroneous at that shape
(a 32-wide shared tile under a 64- or 128-thread workgroup); and every
executor of the port must agree with its own oracle wherever the
reference's conformance suite holds it to that
(tests/test_executor_conformance.py)."""
import numpy as np
import pytest

from repro.core import interp as ref_interp
from repro.core.passes.pipeline import ABLATION_LADDER as REF_LADDER
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.core import faults, interp
from repro_torch.core.passes.pipeline import ABLATION_LADDER, run_pipeline
from repro_torch.volt_bench.suite import BENCHES

WARP_FACTORS = [1, 2, 4]

EXECUTORS = {
    "oracle": dict(decoded=False),
    "decoded": dict(decoded=True, batched=False),
    "wg_batched": dict(decoded=True, batched=True, grid=False),
    "grid": dict(decoded=True, batched=True, grid=True),
}

#: the reference's own exclusions: bfs reads cells other threads write,
#: so its batched executors follow the oracle only at one warp a
#: workgroup (tests/test_executor_conformance.py, SCHEDULE_SENSITIVE)
SCHEDULE_SENSITIVE = {"bfs"}

_FNS: dict = {}


def _fns(name):
    if name not in _FNS:
        b, rb = BENCHES[name], REF_BENCHES[name]
        _FNS[name] = (
            run_pipeline(b.handle.build(None), b.handle.name,
                         ABLATION_LADDER[-1]).fn,
            ref_run_pipeline(rb.handle.build(None), rb.handle.name,
                             REF_LADDER[-1]).fn)
    return _FNS[name]


def _stats(st):
    return (st.instrs, dict(st.by_op), st.mem_requests, st.mem_insts,
            st.shared_requests, st.atomic_serial, st.max_ipdom_depth,
            st.prints)


def _run(mod, fn, bufs0, params, scalars, kw):
    bufs = {k: v.copy() for k, v in bufs0.items()}
    try:
        st = mod.launch(fn, bufs, params, scalar_args=scalars, **kw)
    except mod.ExecError as e:
        return ("error", type(e).__name__, None, None)
    return ("ok", None, _stats(st), bufs)


def _same(a, b, what):
    assert a[0] == b[0], f"{what}: {a[0]} against {b[0]}"
    if a[0] == "error":
        assert a[1] == b[1], f"{what}: raised {a[1]}, not {b[1]}"
        return
    assert a[2] == b[2], f"{what}: ExecStats {a[2]} against {b[2]}"
    for k in b[3]:
        assert a[3][k].dtype == b[3][k].dtype
        assert a[3][k].tobytes() == b[3][k].tobytes(), f"{what}: buffer {k}"


@pytest.mark.parametrize("factor", WARP_FACTORS)
@pytest.mark.parametrize("name", list(BENCHES))
def test_port_executors_match_the_reference(name, factor):
    fn, ref_fn = _fns(name)
    bufs0, scalars, params = BENCHES[name].make(np.random.default_rng(7))
    rbufs0, rscalars, rparams = REF_BENCHES[name].make(
        np.random.default_rng(7))
    for k in bufs0:
        assert bufs0[k].tobytes() == rbufs0[k].tobytes()
    params = interp.fold_warps(params, factor)
    rparams = ref_interp.fold_warps(rparams, factor)
    got = {label: _run(interp, fn, bufs0, params, scalars, kw)
           for label, kw in EXECUTORS.items()}
    for label, kw in EXECUTORS.items():
        want = _run(ref_interp, ref_fn, rbufs0, rparams, rscalars, kw)
        _same(got[label], want, f"{name} x{factor} {label}")
    # the port's executors among themselves, as the reference's
    # conformance suite holds the reference's
    compared = ["decoded", "wg_batched", "grid"]
    if factor > 1 and name in SCHEDULE_SENSITIVE:
        compared = ["decoded"]
    for label in compared:
        _same(got[label], got["oracle"], f"{name} x{factor} {label}/oracle")


def test_every_bench_is_covered_and_some_launches_fail():
    """The sweep holds both outcomes: shared-tile kernels fail at four
    warps a workgroup on both sides, the rest run."""
    outcomes = {}
    for name in ("reduce0", "vecadd"):
        fn, _ = _fns(name)
        bufs0, scalars, params = BENCHES[name].make(np.random.default_rng(7))
        outcomes[name] = _run(interp, fn, bufs0,
                              interp.fold_warps(params, 4), scalars,
                              EXECUTORS["grid"])[0]
    assert outcomes == {"reduce0": "error", "vecadd": "ok"}
    assert set(BENCHES) == set(REF_BENCHES)


def test_executor_errors_carry_context_and_sites_are_scoped():
    """A semantic error names the kernel and the workgroup (the
    reference's contract), and a scoped fault site never fires under
    the oracle, so recovery always ends there."""
    fn, _ = _fns("vecadd")
    bufs0, scalars, params = BENCHES["vecadd"].make(np.random.default_rng(7))
    params = interp.LaunchParams(grid=params.grid,
                                 local_size=params.local_size,
                                 warp_size=params.warp_size, fuel=50)
    for label, kw in EXECUTORS.items():
        bufs = {k: v.copy() for k, v in bufs0.items()}
        with pytest.raises(interp.ExecError) as ei:
            interp.launch(fn, bufs, params, scalar_args=scalars, **kw)
        assert "in @vecadd" in str(ei.value), label
        assert "workgroup" in str(ei.value), label
    bufs = {k: v.copy() for k, v in bufs0.items()}
    with faults.inject("grid.exec"):
        with pytest.raises(faults.EngineFault):
            interp.launch(fn, bufs, BENCHES["vecadd"].make(
                np.random.default_rng(7))[2], scalar_args=scalars)
        interp.launch(fn, bufs, BENCHES["vecadd"].make(
            np.random.default_rng(7))[2], scalar_args=scalars,
            decoded=False)
    assert interp.LAST_EXECUTOR[0] == "oracle"
