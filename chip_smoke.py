"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path (kernel source -> frontend -> VIR ->
run_pipeline -> CUDA ``simt_launch``) at full size, holds every launch
against the plain torch version on the card and the map kernels against a
numpy reference, runs the whole-buffer ``compile_torch`` backend on the
card, times each kernel, and prints one JSON line of kernel records and a
last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N] [--reps N]

It needs a CUDA device and the CUDA toolkit (nvcc), and exits non-zero
without a result when either is missing or any check fails.

Tolerances: integer buffers exact; float buffers exact, except kernels
with EXP or LOG (blackscholes, srad_flag), held at rtol = atol = 1e-5
because CUDA's expf/logf and torch's differ by a few ulps. Against the
numpy reference, blackscholes, srad_flag and psum use the bench's atol
(5e-2, 1e-3 and 1e-3); vecadd, saxpy, cfd_like, vote_hw and bscan_hw are
exact.

Each kernel is timed twice: CUDA events around a batch of wrapper calls,
and the device time of its kernel from a torch.profiler trace.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import to_tensors  # noqa: E402
from repro_torch.core.backends.torch_backend import compile_torch  # noqa: E402
from repro_torch.core.interp import LaunchParams  # noqa: E402
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline  # noqa: E402
from repro_torch.core.vir import BINOPS, UNOPS, Op, Ty  # noqa: E402
from repro_torch.kernels.simt_exec import simt_exec as sx  # noqa: E402
from repro_torch.kernels.simt_exec.ops import volt_torch_run  # noqa: E402
from repro_torch.volt_bench import suite  # noqa: E402

N = 2**24 - 37                 # ragged tail: exercises the `gid < n` guard
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/simt_exec/codegen.py"
REPLACES = "src/repro/kernels/simt_exec/simt_exec.py:121"
CONFIG = PassConfig(uni_hw=True, uni_ann=True, uni_func=True)
EXP_LOG = {"blackscholes", "srad_flag"}


def _inputs(name: str, rng: np.random.Generator, local: int):
    """Full-size buffers, scalars and launch for one bench, drawn as the
    bench's own ``make`` draws them."""
    grid = -(-N // local)
    L = grid * local
    params = LaunchParams(grid=grid, local_size=local, warp_size=32)
    f32 = np.float32
    if name == "vecadd":
        b = {"x": rng.standard_normal(L).astype(f32),
             "y": rng.standard_normal(L).astype(f32),
             "z": np.zeros(L, f32)}
        return b, {"n": N}, params
    if name == "saxpy":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": rng.standard_normal(L).astype(f32)}, \
            {"a": 2.5, "n": N}, params
    if name == "blackscholes":
        return {"S": rng.uniform(10, 100, L).astype(f32),
                "K": rng.uniform(10, 100, L).astype(f32),
                "T": rng.uniform(0.1, 2.0, L).astype(f32),
                "call": np.zeros(L, f32), "put": np.zeros(L, f32)}, \
            {"r": 0.05, "v": 0.3, "n": N}, params
    if name.startswith("srad_flag"):
        return {"img": rng.standard_normal(L).astype(f32),
                "out": np.zeros(L, f32)}, \
            {"lam": 0.5, "mode": int(name[-1]), "n": N}, params
    if name == "cfd_like":
        return {"q": (rng.standard_normal(L) * 1.5).astype(f32),
                "flux": np.zeros(L, f32)}, {"n": N}, params
    if name == "psum":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": np.zeros(L, f32)}, {"n": N}, params
    if name == "vote_hw":
        x = rng.uniform(0, 1.0, L).astype(f32)
        hot = rng.integers(0, grid, grid // 4)
        x[hot * local + 5] = 3.0          # a quarter of the warps vote yes
        return {"x": x, "y": np.zeros(L, f32)}, {"n": N}, params
    if name == "bscan_hw":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": np.zeros(L, np.int32)}, {"n": N}, params
    raise KeyError(name)


def _numpy_ref(name: str, b, sc):
    """Full-size numpy reference for the map kernels and the collectives;
    None where only the plain version holds the kernel."""
    n = sc["n"]
    if name == "vecadd":
        z = b["z"].copy()
        z[:n] = b["x"][:n] + b["y"][:n]
        return {"z": z}, 0.0
    if name == "saxpy":
        y = b["y"].copy()
        y[:n] = np.float32(sc["a"]) * b["x"][:n] + b["y"][:n]
        return {"y": y}, 0.0
    if name == "blackscholes":
        out = suite._ref_blackscholes_np(b, sc)
        return {"call": out["call"], "put": out["put"]}, 5e-2
    if name.startswith("srad_flag"):
        return {"out": suite._ref_srad(b, sc)["out"]}, 1e-3
    if name == "cfd_like":
        v = b["q"][:n]
        f = np.where(v > 0, np.where(v > 1, v * v, v * np.float32(0.5))
                     + np.float32(1),
                     np.where(v < -1, -v * v, v * np.float32(-0.5))
                     - np.float32(1)).astype(np.float32)
        f = np.where(f > 0, np.where(f > 2, f * np.float32(0.25), f) + v, f)
        flux = b["flux"].copy()
        flux[:n] = f
        return {"flux": flux}, 0.0
    if name == "psum":
        xm = np.where(np.arange(b["x"].size) < n, b["x"], np.float32(0))
        y = b["y"].copy()
        y[:n] = np.cumsum(xm.reshape(-1, 32), axis=1).reshape(-1)[:n]
        return {"y": y}, 1e-3
    if name == "vote_hw":
        x = b["x"].reshape(-1, 32)
        gid = np.arange(x.size).reshape(-1, 32)
        hit = ((x > 2.0) & (gid < n)).any(axis=1, keepdims=True)
        y = np.where(hit, x * np.float32(2.0), x).reshape(-1)
        y[n:] = b["y"][n:]
        return {"y": y.astype(np.float32)}, 0.0
    if name == "bscan_hw":
        gid = np.arange(b["x"].size)
        p = ((gid < n) & (b["x"] > 0)).reshape(-1, 32).astype(np.int32)
        ranks = (np.cumsum(p, axis=1) - p).reshape(-1)
        y = b["y"].copy()
        y[:n] = ranks[:n]
        return {"y": y}, 0.0
    return None, None


def _compare(name, got, want, exact_rtol=0.0, exact_atol=0.0):
    """Max abs error over the buffers; raises past the tolerance."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}.{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}.{k}: non-finite values")
        d = (g.double() - w.double()).abs()
        worst = max(worst, float(d.max()))
        ok = torch.allclose(g.double(), w.double(), rtol=exact_rtol,
                            atol=exact_atol)
        if not ok:
            raise AssertionError(f"{name}.{k}: max abs err {float(d.max())} "
                                 f"past rtol={exact_rtol} atol={exact_atol}")
    return worst


def _median_ms(fn, reps: int, batch: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``batch`` calls in a
    row, per call (a batch keeps the queue full, so the wrapper's host
    time hides behind the kernels it enqueues)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _traffic(fn) -> int:
    """Buffers read plus buffers written (each counted once)."""
    reads = {getattr(i.operands[0], "name", "?")
             for i in fn.instructions() if i.op is Op.LOAD}
    writes = {getattr(i.operands[0], "name", "?")
              for i in fn.instructions() if i.op is Op.STORE}
    ptrs = {p.name for p in fn.params if p.ty is Ty.PTR}
    return len(reads & ptrs) + len(writes & ptrs)


ARITH = BINOPS | UNOPS | {Op.SELECT, Op.CMOV}


def _lane_ops(fn, lanes: int) -> int:
    """Lane operations of one pass over the VIR: each arithmetic
    instruction once per lane. Loop trips past the first are left out, so
    this undercounts, as a term of a least time may."""
    return lanes * sum(i.op in ARITH for i in fn.instructions())


def _device_ms(fn, calls: int = 20):
    """Device time per call of the kernels that ``fn`` launches, summed
    from a torch.profiler trace of ``calls`` calls (CUDA activity only),
    with the kernels' names and launches per call; None where the trace
    shows no device time in three tries (one trace of the H100 came back
    empty)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
        if evs:
            us = sum(e.self_device_time_total for e in evs)
            return (us / calls / 1e3, sorted({e.key[:40] for e in evs}),
                    sum(e.count for e in evs) / calls)
    return None, [], 0.0


CASES = [("vecadd", 256), ("saxpy", 256), ("blackscholes", 256),
         ("srad_flag0", 256), ("srad_flag1", 256), ("cfd_like", 256),
         ("psum", 32), ("vote_hw", 32), ("bscan_hw", 32)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # inputs and compiled VIR for every case
    rng = np.random.default_rng(args.seed)
    cases = {}
    for name, local in CASES:
        bench = suite.BENCHES[name.rstrip("01")]
        bufs, sc, params = _inputs(name, rng, local)
        mod = bench.handle.build(None)
        ck = run_pipeline(mod, bench.handle.name, CONFIG)
        cases[name] = (bench, bufs, sc, params, ck)

    # 2. build every kernel, one nvcc each, all at once
    t0 = time.perf_counter()
    srcs = {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        srcs[name] = sx.kernel_source(
            ck.fn, params, {k: torch.from_numpy(v) for k, v in bufs.items()})
    built = sx.build_many(list(srcs.values()))
    for name, (so, secs) in zip(srcs, built):
        print(f"build {name:13s} {so.name[:12]} nvcc {secs:.1f} s")
    print(f"build total {time.perf_counter() - t0:.1f} s")

    # 3. the main path at full size, counted
    sx.LAUNCHES = 0
    outs, launches = {}, {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        before = sx.LAUNCHES
        outs[name] = volt_torch_run(bench.handle, bufs, params, sc,
                                    CONFIG, device=dev)
        launches[name] = sx.LAUNCHES - before
    torch.cuda.synchronize()
    total = sx.LAUNCHES
    if total != len(cases) or min(launches.values()) < 1:
        raise AssertionError(f"main path launched {launches}")
    print(f"main path: {total} CUDA launches {launches}")

    # held against the plain version on the card and numpy
    errs = {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        plain = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, dev), sc)
        tol = 1e-5 if name.rstrip("01") in EXP_LOG else 0.0
        errs[name] = _compare(name, outs[name], plain, tol, tol)
        ref, atol = _numpy_ref(name, bufs, sc)
        msg = ""
        if ref is not None:
            ref_t = {k: torch.from_numpy(v).to(dev) for k, v in ref.items()}
            e = _compare(name + "/numpy", outs[name], ref_t, 0.0, atol)
            msg = f", numpy max abs err {e:.3g} (atol {atol})"
        print(f"check {name:13s} vs plain max abs err {errs[name]:.3g} "
              f"(tol {tol}){msg}")

    # 4. the whole-buffer backend on the card: sgemm at the suite's size
    b = suite.BENCHES["sgemm"]
    bufs, sc, params = b.make(np.random.default_rng(args.seed))
    mod = b.handle.build(None)
    ck = run_pipeline(mod, "sgemm", CONFIG)
    tk = compile_torch(ck.fn, params, mod, device=dev)
    got = tk.fn(to_tensors(bufs, dev), sc)
    want = b.ref(bufs, sc)
    e = _compare("sgemm/compile_torch", got,
                 {k: torch.from_numpy(v).to(dev) for k, v in want.items()},
                 0.0, b.atol)
    print(f"check compile_torch sgemm vs numpy max abs err {e:.3g} "
          f"(atol {b.atol})")

    # 5. times: CUDA events, median of --reps runs, the plain one beside
    records = []
    for name, (bench, bufs, sc, params, ck) in cases.items():
        tens = to_tensors(bufs, dev)
        ms = _median_ms(lambda: sx.simt_launch(ck.fn, params, tens, sc),
                        args.reps)
        plain_ms = _median_ms(
            lambda: sx.simt_launch_plain(ck.fn, params, tens, sc), args.reps,
            batch=1)
        L = params.grid * params.wg_threads
        nbytes = _traffic(ck.fn) * L * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lanes_ops = _lane_ops(ck.fn, L)
        ops_ms = lanes_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        # the yardstick: one torch call computing the same function
        n = sc["n"]
        if name == "vecadd":
            x, y, z = tens["x"][:n], tens["y"][:n], tens["z"][:n]
            lib_fn = lambda: torch.add(x, y, out=z)  # noqa: E731
        elif name == "saxpy":
            x, y = tens["x"][:n], tens["y"][:n]
            lib_fn = lambda: y.add_(x, alpha=sc["a"])  # noqa: E731
        elif name == "psum":   # a scan never reads past its lane
            x, y = tens["x"].view(-1, 32), tens["y"].view(-1, 32)
            lib_fn = lambda: torch.cumsum(x, 1, out=y)  # noqa: E731
        else:
            lib_fn = None
        library_ms = None if lib_fn is None else _median_ms(lib_fn, args.reps)
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"time {name:13s} {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"{nbytes} B {bytes_ms:.4f} ms  {lanes_ops} lane ops "
              f"{ops_ms:.4f} ms  bound {bound_ms:.4f} ms by {bound_by}  "
              f"achieved {bound_ms / ms:.3f} of bound{lib}")
        # device time from a profiler trace, beside the event time above
        dev_ms, kernels, per_call = _device_ms(
            lambda: sx.simt_launch(ck.fn, params, tens, sc))
        lib_dev = (None,) if lib_fn is None else _device_ms(lib_fn)
        print(f"device {name:13s} kernel "
              + ("not measured" if dev_ms is None else
                 f"{dev_ms:.4f} ms ({per_call:g} kernels/call {kernels})")
              + f" events {ms:.4f} ms"
              + ("" if lib_dev[0] is None else
                 f"  library kernel {lib_dev[0]:.4f} ms"))
        records.append({"name": f"simt_exec/{name}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms})

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
