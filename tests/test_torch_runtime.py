"""The port's Runtime (core/runtime.py, core/governor.py, core/faults.py,
core/parallel.py) against the reference's, scenario by scenario: each
scenario runs once through each package on the same inputs, and the two
traces must be equal — every LaunchReport's attempts (requested rung,
executor, outcome, and the injected fault's reason), its demotions,
rollbacks and governor state, the ExecStats and every buffer.

  * the degradation chain under fault injection at every scoped site,
    on the host (the reference's default numpy chain, which
    ``Runtime(device="cpu")`` runs);
  * the codegen rung's sites: the port's torch rung with ``torch.*``
    injected against the reference's JAX rung with ``jax.*`` (rung names
    mapped), cold and on a certified primary;
  * the governor: a deadline that expires mid-launch (rolled back bit
    for bit), the circuit breaker's open / pinned / probe / re-promote
    walk, and the memory budget. The launch report of a surfacing
    exception is read from ``e.__notes__`` (Python 3.11+ keeps notes out
    of ``str(e)``);
  * the launch service's coalescing against solo launches;
  * ``cuda_memcpy_to_symbol`` (Case Study 2): host data staged and
    materialized at launch;
  * the disk caches: the port never loads an entry the reference wrote.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.faults as ref_faults
import repro.core.governor as ref_governor
import repro.core.interp as ref_interp
import repro.core.runtime as ref_runtime
import repro.core.vir as ref_vir
from repro.core.backends import jaxgen
from repro.core.passes.pipeline import ABLATION_LADDER as REF_LADDER
from repro.core.passes.pipeline import PassConfig as RefPassConfig
from repro.core.passes.pipeline import run_pipeline as ref_run_pipeline
from repro.volt_bench.suite import BENCHES as REF_BENCHES
from repro_torch.core import faults, governor, interp, runtime, vir
from repro_torch.core.backends import torchgen
from repro_torch.core.passes.pipeline import (ABLATION_LADDER, PassConfig,
                                              run_pipeline)
from repro_torch.volt_bench.suite import BENCHES

ROOT = Path(__file__).resolve().parents[1]

PORT = SimpleNamespace(
    name="repro_torch", faults=faults, governor=governor, interp=interp,
    runtime=runtime, vir=vir, benches=BENCHES, ladder=ABLATION_LADDER,
    run_pipeline=run_pipeline, PassConfig=PassConfig,
    rt_kw={"device": "cpu"}, codegen="torch", codegen_mod=torchgen)
REF = SimpleNamespace(
    name="repro", faults=ref_faults, governor=ref_governor,
    interp=ref_interp, runtime=ref_runtime, vir=ref_vir,
    benches=REF_BENCHES, ladder=REF_LADDER, run_pipeline=ref_run_pipeline,
    PassConfig=RefPassConfig, rt_kw={}, codegen="jax", codegen_mod=jaxgen)

CHAIN_SITES = sorted(s for s, meta in faults.SITES.items()
                     if meta["scoped"] and not s.startswith("torch."))
CODEGEN_SITES = ("trace", "exec", "cache.load")
#: one bench of each kind: map, shared tile, ragged loop, read-write
#: hazard (schedule-sensitive: run at one warp a workgroup)
CHAIN_BENCHES = {"vecadd": 2, "reduce0": 1, "spmv_csr": 2, "bfs": 1}


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VOLT_CACHE_DIR", str(tmp_path))


def _compiled(pkg, name):
    b = pkg.benches[name]
    return pkg.run_pipeline(b.handle.build(None), b.handle.name,
                            pkg.ladder[-1]).fn


def _case(pkg, name, factor=1, seed=7):
    bufs0, sc, params = pkg.benches[name].make(np.random.default_rng(seed))
    return (_compiled(pkg, name), bufs0, sc,
            pkg.interp.fold_warps(params, factor))


def _stats(st):
    return (st.instrs, dict(st.by_op), st.mem_requests, st.mem_insts,
            st.shared_requests, st.atomic_serial, st.max_ipdom_depth,
            st.prints)


def _report(pkg, rep):
    """A LaunchReport with the codegen rung's name made neutral and
    wall times dropped."""
    def rung(r):
        return "codegen" if r == pkg.codegen else r

    def reason(a):
        return (a.reason.replace(f"'{pkg.codegen}.", "'codegen.")
                if a.reason.startswith("injected fault") else "")
    return ([(rung(a.rung), rung(a.executor), a.outcome, reason(a))
             for a in rep.attempts],
            rung(rep.executor), rep.demotions, rep.rolled_back,
            rep.breaker, rung(rep.pinned_rung), rep.probe,
            rep.deadline_expired, rep.snapshot_skipped)


def _new_rt(pkg, bufs0, **kw):
    rt = pkg.runtime.Runtime(**pkg.rt_kw, **kw)
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    return rt


def _launch(pkg, rt, fn, params, sc, **kw):
    try:
        st = rt.launch(fn, grid=params.grid, block=params.local_size,
                       scalar_args=sc, **kw)
    except Exception as e:
        return ("error", type(e).__name__, _report(pkg, rt.last_report),
                {k: v.copy() for k, v in rt.buffers.items()})
    return ("ok", _stats(st), _report(pkg, rt.last_report),
            {k: v.copy() for k, v in rt.buffers.items()})


def _same(a, b):
    assert a[:3] == b[:3]
    for k in b[3]:
        assert a[3][k].tobytes() == b[3][k].tobytes(), k


# --------------------------------------------------------------------------
# the chain under fault injection
# --------------------------------------------------------------------------

def _chain_run(pkg, name, site, seed):
    fn, bufs0, sc, params = _case(pkg, name, CHAIN_BENCHES[name])
    workers = 2 if site.startswith("parallel.") else 1
    rt = _new_rt(pkg, bufs0, workers=workers)
    with pkg.faults.inject(site, prob=0.5, seed=seed) as inj:
        out = _launch(pkg, rt, fn, params, sc)
    return out, (inj.hits, inj.fired)


@pytest.mark.parametrize("site", CHAIN_SITES)
@pytest.mark.parametrize("name", list(CHAIN_BENCHES))
def test_chain_under_injection_matches_the_reference(name, site):
    for seed in (0, 3):
        got, gi = _chain_run(PORT, name, site, seed)
        want, wi = _chain_run(REF, name, site, seed)
        assert gi == wi
        _same(got, want)
        if got[0] == "ok":
            assert got[2][0][-1][2] == "ok"


def test_chain_sites_cover_the_reference_and_fire():
    ref_sites = {s for s, m in ref_faults.SITES.items() if m["scoped"]}
    port = {s.replace("torch.", "jax.") for s, m in faults.SITES.items()
            if m["scoped"]}
    assert port == ref_sites
    assert faults.DEMOTABLE == ("torch",) + ref_faults.DEMOTABLE[1:]
    # "decode" at every hit walks the whole chain down to the oracle,
    # where scoped sites never fire
    fn, bufs0, sc, params = _case(PORT, "vecadd", 2)
    rt = _new_rt(PORT, bufs0)
    with faults.inject("decode") as inj:
        got = _launch(PORT, rt, fn, params, sc)
    assert inj.fired >= 1 and got[0] == "ok"
    assert got[2][0][0][0] == "grid"
    assert got[2][0][-1][:3] == ("oracle", "oracle", "ok")


# --------------------------------------------------------------------------
# the codegen rung's sites
# --------------------------------------------------------------------------

def _codegen_cold(pkg, name, site):
    fn, bufs0, sc, params = _case(pkg, name, 2)
    rt = _new_rt(pkg, bufs0, **{pkg.codegen: True})
    tel = getattr(pkg.codegen_mod, f"reset_{pkg.codegen}_telemetry")
    tel()
    with pkg.faults.inject(f"{pkg.codegen}.{site}") as inj:
        out = _launch(pkg, rt, fn, params, sc)
    t = getattr(pkg.codegen_mod, f"{pkg.codegen.upper()}_TELEMETRY")
    return out, inj.fired, (t["demotions"], t["engaged"], t["cert_runs"])


@pytest.mark.parametrize("site", CODEGEN_SITES)
@pytest.mark.parametrize("name", ["vecadd", "spmv_tail"])
def test_codegen_site_demotes_to_grid_like_the_reference(monkeypatch, name,
                                                         site):
    monkeypatch.setenv("VOLT_DISK_CACHE", "0")
    got, fired, tel = _codegen_cold(PORT, name, site)
    want, ref_fired, ref_tel = _codegen_cold(REF, name, site)
    assert fired == ref_fired >= 1
    assert tel == ref_tel and tel[0] >= 1 and tel[1] == 0
    _same(got, want)
    attempts = got[2][0]
    assert attempts[0][:3] == ("codegen", "codegen", "engine_fault")
    assert got[2][1] == "grid"


def _codegen_warm(pkg, monkeypatch, name):
    monkeypatch.setattr(pkg.codegen_mod, "_CHUNK_WGS", 8)
    fn, bufs0, sc, params = _case(pkg, name, 2)
    rt = _new_rt(pkg, bufs0, **{pkg.codegen: True})
    first = _launch(pkg, rt, fn, params, sc)            # certifies
    for k, v in bufs0.items():
        rt.buffers[k][:] = v
    with pkg.faults.inject(f"{pkg.codegen}.exec", after=1) as inj:
        warm = _launch(pkg, rt, fn, params, sc)
    for k, v in bufs0.items():
        rt.buffers[k][:] = v
    clean = _launch(pkg, rt, fn, params, sc)
    return first, warm, clean, inj.fired


def test_codegen_primary_fault_demotes_like_the_reference(monkeypatch):
    monkeypatch.setenv("VOLT_DISK_CACHE", "0")
    got = _codegen_warm(PORT, monkeypatch, "spmv_tail")
    want = _codegen_warm(REF, monkeypatch, "spmv_tail")
    assert got[3] == want[3] == 1
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    assert got[1][2][0][0][:3] == ("codegen", "codegen", "engine_fault")
    assert got[2][2][1] == "codegen"      # the certified primary again


def test_codegen_rung_is_off_on_the_host_by_default(monkeypatch):
    monkeypatch.delenv("VOLT_TORCH", raising=False)
    assert not runtime.Runtime(device="cpu").torch
    assert runtime.Runtime(device="cpu", torch=True).torch
    monkeypatch.setenv("VOLT_TORCH", "1")
    assert runtime.Runtime(device="cpu").torch
    monkeypatch.setenv("VOLT_TORCH", "0")
    assert not runtime.Runtime(device="cpu", torch=None).torch
    for site in CODEGEN_SITES:
        fn, bufs0, sc, params = _case(PORT, "vecadd")
        rt = _new_rt(PORT, bufs0)
        with faults.inject(f"torch.{site}") as inj:
            out = _launch(PORT, rt, fn, params, sc)
        assert out[0] == "ok" and inj.fired == 0
        assert all(a[0] != "codegen" for a in out[2][0])


# --------------------------------------------------------------------------
# the governor
# --------------------------------------------------------------------------

def _notes(e):
    return [n for n in getattr(e, "__notes__", ())
            if n.startswith("launch report: ")]


def test_deadline_expiry_rolls_back_bit_exact():
    n = 2048 * 32
    rng = np.random.default_rng(4)
    bufs0 = {"x": rng.standard_normal(n).astype(np.float32),
             "y": rng.standard_normal(n).astype(np.float32),
             "z": np.full(n, 7.0, np.float32)}
    for pkg in (PORT, REF):
        fn = _compiled(pkg, "vecadd")
        rt = _new_rt(pkg, bufs0)
        with pytest.raises(pkg.faults.DeadlineExceeded) as ei:
            rt.launch(fn, grid=2048, block=32, scalar_args={"n": n},
                      deadline_ms=0.5)
        e = ei.value
        assert e.report is rt.last_report and e.report.deadline_expired
        assert e.report.attempts[-1].outcome == "deadline"
        assert e.stats is not None
        assert _notes(e) == ["launch report: " + e.report.summary()]
        for k, v in bufs0.items():
            assert rt.buffers[k].tobytes() == v.tobytes(), (pkg.name, k)
        # a workable deadline on the same runtime serves the kernel
        st = rt.launch(fn, grid=2048, block=32, scalar_args={"n": n},
                       deadline_ms=600_000.0)
        assert st.instrs > 0 and not rt.last_report.deadline_expired
        np.testing.assert_array_equal(rt.buffers["z"],
                                      bufs0["x"] + bufs0["y"])


def _breaker_walk(pkg):
    fn, bufs0, sc, params = _case(pkg, "vecadd")
    rt = pkg.runtime.Runtime(
        **pkg.rt_kw, governor=pkg.governor.GovernorConfig(
            breaker_threshold=2, breaker_probe_every=3))
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    pkg.runtime.reset_launch_telemetry()
    walk = []
    with pkg.faults.inject("grid.exec"):
        for _ in range(5):
            walk.append(_launch(pkg, rt, fn, params, sc))
    for _ in range(5):
        walk.append(_launch(pkg, rt, fn, params, sc))
    t = pkg.runtime.LAUNCH_TELEMETRY
    return walk, {k: t[k] for k in ("breaker_trips", "breaker_pinned",
                                    "breaker_probes", "breaker_promotions",
                                    "demotions", "rollbacks")}


def test_breaker_walk_matches_the_reference():
    got, gt = _breaker_walk(PORT)
    want, wt = _breaker_walk(REF)
    for g, w in zip(got, want):
        _same(g, w)
    assert gt == wt
    states = [g[2][4] for g in got]
    assert "open" in states and states[-1] == "closed"
    assert gt["breaker_promotions"] == 1


def _budget_run(pkg, name, budget):
    fn, bufs0, sc, params = _case(pkg, name)
    rt = pkg.runtime.Runtime(
        **pkg.rt_kw, governor=pkg.governor.GovernorConfig(mem_budget=budget))
    for k, v in bufs0.items():
        rt.create_buffer(k, v.copy())
    try:
        st = rt.launch(fn, grid=params.grid, block=params.local_size,
                       scalar_args=sc)
    except pkg.faults.EngineFault as e:
        assert e.site == "mem.alloc" and e.report is rt.last_report
        assert _notes(e) == ["launch report: " + e.report.summary()]
        for k, v in bufs0.items():      # every demotion rolled back
            assert rt.buffers[k].tobytes() == v.tobytes()
        return ("fault", _report(pkg, rt.last_report))
    return ("ok", _stats(st), _report(pkg, rt.last_report),
            {k: v.copy() for k, v in rt.buffers.items()})


@pytest.mark.parametrize("name,budget", [("reduce0", 64), ("vecadd", 64),
                                         ("reduce0", 1 << 30)])
def test_memory_budget_matches_the_reference(name, budget):
    got, want = _budget_run(PORT, name, budget), _budget_run(REF, name,
                                                              budget)
    assert got[0] == want[0]
    if got[0] == "fault":
        assert got[1] == want[1]
        assert got[1][0][-1][2] == "engine_fault"
    else:
        _same(got, want)
    if (name, budget) == ("vecadd", 64):
        # the write-root snapshot is over budget: oracle-first
        assert got[2][8] == "mem-budget" and got[2][1] == "oracle"


def test_nontransactional_report_in_notes():
    for pkg in (PORT, REF):
        fn, bufs0, sc, params = _case(pkg, "vecadd")
        rt = _new_rt(pkg, bufs0, transactional=False)
        with pkg.faults.inject("grid.exec"):
            with pytest.raises(pkg.faults.EngineFault) as ei:
                rt.launch(fn, grid=params.grid, block=params.local_size,
                          scalar_args=sc)
        assert _notes(ei.value) == [
            "launch report: " + ei.value.report.summary()]
        assert rt.last_report.demotions == 0


# --------------------------------------------------------------------------
# the launch service
# --------------------------------------------------------------------------

def _service(pkg, coalesce):
    rt = pkg.runtime.Runtime(**pkg.rt_kw)
    svc = pkg.runtime.LaunchService(rt, coalesce=coalesce)
    fn = _compiled(pkg, "vecadd")
    fn2 = _compiled(pkg, "psum")
    tenants = []
    for t in range(4):
        name = ("vecadd", "psum")[t % 2]
        bufs0, sc, params = pkg.benches[name].make(
            np.random.default_rng(20 + t))
        bufs = {k: v.copy() for k, v in bufs0.items()}
        h = svc.submit(fn if name == "vecadd" else fn2, grid=params.grid,
                       block=params.local_size, buffers=bufs,
                       scalar_args=sc, tenant=t)
        tenants.append((h, bufs))
    for t in range(4, 7):
        bufs0, sc, params = pkg.benches["vecadd"].make(
            np.random.default_rng(20 + t))
        bufs = {k: v.copy() for k, v in bufs0.items()}
        tenants.append((svc.submit(fn, grid=params.grid,
                                   block=params.local_size, buffers=bufs,
                                   scalar_args=sc, tenant=t), bufs))
    done = svc.flush()
    assert [h for h, _ in tenants] == done
    out = [(h.mode, _stats(h.result()), h.report.executor,
            {k: v.tobytes() for k, v in bufs.items()})
           for h, bufs in tenants]
    return out, dict(svc.telemetry)


def test_launch_service_coalescing_matches_solo_and_the_reference():
    got, gt = _service(PORT, True)
    want, wt = _service(REF, True)
    assert got == want and gt == wt
    solo, _ = _service(PORT, False)
    assert {m for m, *_ in got} == {"coalesced", "solo"} \
        or {m for m, *_ in got} == {"coalesced"}
    assert gt["coalesced_launches"] >= 5
    for g, s in zip(got, solo):
        assert g[1:] == s[1:]
        assert s[0] == "solo"


def test_launch_service_busy():
    rt = runtime.Runtime(device="cpu")
    svc = runtime.LaunchService(rt, max_pending=1)
    fn, bufs0, sc, params = _case(PORT, "vecadd")
    svc.submit(fn, grid=params.grid, block=params.local_size,
               buffers={k: v.copy() for k, v in bufs0.items()},
               scalar_args=sc)
    with pytest.raises(faults.EngineBusy):
        svc.submit(fn, grid=params.grid, block=params.local_size,
                   buffers={k: v.copy() for k, v in bufs0.items()},
                   scalar_args=sc)
    assert svc.pending() == 1 and svc.telemetry["busy_rejections"] == 1


# --------------------------------------------------------------------------
# Case Study 2: cudaMemcpyToSymbol
# --------------------------------------------------------------------------

_CS2 = '''
from {pkg}.core.frontends import cuda

@cuda.kernel
def scale_by_lut(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = blockIdx.x * blockDim.x + threadIdx.x
    if gid < n:
        y[gid] = x[gid] * lut[gid % 8]
'''


def _case_study_2(pkg, tmp_path):
    module = pkg.vir.Module("cs2")
    module.new_global("lut", pkg.vir.Ty.F32, 8)
    path = tmp_path / f"cs2_{pkg.name}.py"
    path.write_text(_CS2.format(pkg=pkg.name))
    spec = importlib.util.spec_from_file_location(f"cs2_{pkg.name}", path)
    mod_py = importlib.util.module_from_spec(spec)
    mod_py.lut = module.globals["lut"]
    spec.loader.exec_module(mod_py)
    vmod = mod_py.scale_by_lut.build(module)
    fn = pkg.run_pipeline(vmod, "scale_by_lut",
                          pkg.PassConfig(uni_hw=True, uni_ann=True)).fn
    rt = pkg.runtime.Runtime(**pkg.rt_kw)
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    rt.create_buffer("x", x)
    rt.create_buffer("y", np.zeros(64, np.float32))
    lut = np.arange(8, dtype=np.float32) + 1
    with pytest.raises(KeyError):
        rt.cuda_memcpy_to_symbol(vmod, "nope", lut)
    with pytest.raises(ValueError):
        rt.cuda_memcpy_to_symbol(vmod, "lut", np.zeros(9, np.float32))
    rt.cuda_memcpy_to_symbol(vmod, "lut", lut)     # staged, not yet live
    assert "lut" not in rt.globals_mem
    st = rt.launch(fn, grid=2, block=32, scalar_args={"n": 64})
    np.testing.assert_array_equal(rt.globals_mem["lut"], lut)
    np.testing.assert_array_equal(rt.read_buffer("y"),
                                  x * lut[np.arange(64) % 8])
    return _stats(st), rt.read_buffer("y").tobytes(), rt.cycles()


def test_cuda_memcpy_to_symbol_matches_the_reference(tmp_path):
    assert _case_study_2(PORT, tmp_path) == _case_study_2(REF, tmp_path)


# --------------------------------------------------------------------------
# disk caches
# --------------------------------------------------------------------------

_ISOLATION = '''
import sys
import numpy as np
from repro_torch.core import runtime
from repro_torch.volt_bench.suite import BENCHES
b = BENCHES["psum"]
ck = runtime.compile_kernel(b.handle)
bufs, sc, params = b.make(np.random.default_rng(0))
rt = runtime.Runtime(device="cpu", torch=True)
for k, v in bufs.items():
    rt.create_buffer(k, v)
for _ in range(2):
    rt.launch(ck.fn, grid=params.grid, block=params.local_size,
              scalar_args=sc)
want = b.ref(bufs, sc)
assert np.allclose(rt.read_buffer("y"), want["y"], atol=b.atol)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "jax"))
assert not bad, bad
assert type(ck.module).__module__ == "repro_torch.core.vir", type(ck.module)
print(runtime.DISK_CACHE_STATS["hits"], runtime.DISK_CACHE_STATS["misses"],
      runtime.DISK_CACHE_STATS["cert_hits"], rt.last_report.executor)
'''

_REFERENCE_FILL = '''
from repro.core import runtime
from repro.volt_bench.suite import BENCHES
runtime.compile_kernel(BENCHES["psum"].handle)
print(runtime.DISK_CACHE_STATS["misses"])
'''


def test_port_never_loads_a_reference_cache_entry(tmp_path):
    """One VOLT_CACHE_DIR for both packages: the reference compiles psum
    and stores its entry; the port then compiles the same kernel, misses
    (its keys carry its package's name), loads no ``repro.*`` module,
    builds its own CompiledKernel, and runs psum on its torch rung, on
    the host, certified from its own ``.vtc``."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
           "VOLT_CACHE_DIR": str(tmp_path), "JAX_PLATFORMS": "cpu"}
    env.pop("VOLT_DISK_CACHE", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE_FILL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    ref_entries = sorted(p.name for p in tmp_path.iterdir())
    assert any(n.endswith(".vck") for n in ref_entries)
    r = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["0", "1", "0", "torch"]
    after = sorted(p.name for p in tmp_path.iterdir())
    assert set(ref_entries) < set(after)
    assert any(n.endswith(".vtc") for n in after)
    # a second port process hits its own entries, its verdict among them
    # (with both timings recorded, the router may send a launch this
    # small to the grid executor)
    r = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    hits, misses, cert_hits, executor = r.stdout.split()
    assert (hits, misses, cert_hits) == ("1", "0", "1")
    assert executor in ("torch", "grid")


def test_disk_keys_carry_the_package(monkeypatch):
    mod = BENCHES["vecadd"].handle.build(None)
    rmod = REF_BENCHES["vecadd"].handle.build(None)
    cfg = PassConfig()
    assert runtime._disk_key(mod, "vecadd", cfg, 32) != ref_runtime._disk_key(
        rmod, "vecadd", RefPassConfig(), 32)
    assert runtime._compiler_fingerprint() == \
        ref_runtime._compiler_fingerprint()
    fn, rfn = _compiled(PORT, "vecadd"), _compiled(REF, "vecadd")
    assert runtime._decode_plan_key(fn) != ref_runtime._decode_plan_key(rfn)
    monkeypatch.delenv("VOLT_CACHE_DIR")
    assert runtime.disk_cache_dir().name == "volt_repro_torch"
    assert ref_runtime.disk_cache_dir().name == "volt_repro"


def test_the_card_is_the_default_and_never_replaced_by_the_host():
    """``Runtime()`` and ``interp.launch(torch=True)`` mean the card:
    without one they raise before anything runs, never falling back."""
    import torch
    if torch.cuda.is_available():
        assert runtime.Runtime().device.type == "cuda"
        assert runtime.Runtime().torch
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.Runtime()
    fn, bufs0, sc, params = _case(PORT, "vecadd")
    bufs = {k: v.copy() for k, v in bufs0.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interp.launch(fn, bufs, params, scalar_args=sc, torch=True)
    for k, v in bufs0.items():
        assert bufs[k].tobytes() == v.tobytes()
