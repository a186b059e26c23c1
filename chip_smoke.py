"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Four paths of the port, each at full width:

  * the compiler's main path (kernel source -> frontend -> VIR ->
    run_pipeline -> CUDA ``simt_launch``): every launch held against the
    plain torch version on the card and the map kernels against a numpy
    reference, and the whole-buffer ``compile_torch`` backend on the card;
  * the dense LM serving path on granite-3-2b at full width and depth
    (random weights from ``--seed``): ``LM.prefill`` on 4 prompts of 2048
    tokens, whose 81 RMSNorms and 40 attentions go through the rmsnorm
    and flash_attention kernels, and ``ServeEngine`` answering 16
    requests;
  * the MoE LM serving path on olmoe-1b-7b at full width and depth
    (6.9 B params, random weights from ``--seed``, granite's freed
    first): the same prefill, whose 33 RMSNorms, 16 attentions at head
    dim 128 and 16 grouped expert FFs go through the rmsnorm,
    flash_attention and moe_dispatch kernels, and the same engine;
  * the hybrid LM serving path on jamba-1.5-large-398b at full width,
    its depth cut to four layers, one of each kind (mamba with dense FF,
    mamba with MoE FF, attention with dense FF, mamba with MoE FF:
    23.0 B params, random weights from ``--seed``, olmoe's freed first):
    the same prefill, whose 9 RMSNorms at d 8192, one attention (64
    heads, 8 KV heads of 128), 2 grouped expert FFs (16 experts of f
    24576) and 3 x 8 selective scans (one a layer and chunk of 256) go
    through the rmsnorm, flash_attention, moe_dispatch and selective_scan
    kernels, and the same engine. Its kernel checks and timings run
    before its params exist: the plain expert FF holds float32 copies of
    a layer's experts (38.7 GB).

On each LM path every kernel is held against its plain version at the
path's shapes, decode is held against prefill, and a short model on the
card against the same model on the CPU (depth 2 at full width for
granite and olmoe; for jamba one period of its smoke config, 8 layers at
d_model 128, the only place where widths are cut: at full width the CPU
would need 46 GB and minutes). The MoE paths also print the share of
expert assignments the capacity drops (the first MoE layer, prefill and
decode) and the tokens routed apart by card and CPU.

Each kernel's launches are counted on each path (counts set to 0 just
before, read just after): a record's ``launches_by_path`` gives each
path's own count (``compiler``; ``<model>/prefill`` and
``<model>/serve``) and ``launches`` their sum. flash_attention and
moe_dispatch also count by route (``launches_by_route``: tensor_cores or
cuda_cores, on each path); every launch of theirs on the three prefill
paths must take the tensor cores. nvcc's ``-Xptxas -v`` registers and
spills of the tensor-core kernels are printed after the build. Each kernel is timed, and
the script prints one JSON line of kernel records and a last line
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N] [--reps N]

jamba's one-chip cut: every width as published, the period shortened
from 8 layers to 4 (``n_layers`` 72 -> 4, ``attn_every_k`` 8 -> 4, both
printed). Attention is one layer in four, not one in eight, so it takes
a larger share of prefill than in a deployment.

It needs a CUDA device and the CUDA toolkit (nvcc), and exits non-zero
without a result when either is missing or any check fails.

Tolerances: integer buffers exact; float buffers exact, except kernels
with EXP or LOG (blackscholes, srad_flag), held at rtol = atol = 1e-5
because CUDA's expf/logf and torch's differ by a few ulps. Against the
numpy reference, blackscholes, srad_flag and psum use the bench's atol
(5e-2, 1e-3 and 1e-3); vecadd, saxpy, cfd_like, vote_hw and bscan_hw are
exact.

LM tolerances, each beside the typical size of what it holds (the
check lines print both):

  * rmsnorm rtol = atol = 1e-5 in float32 and 2e-2 in bf16 (those of
    tests/test_kernels.py); outputs of randn rows and scales have a
    median |y| of about 0.45, one bf16 ulp at most 0.0078 of |y|.
  * flash_attention at the paths' shapes (4, 32, 2048, 64),
    (4, 16, 2048, 128) and (4, 64, 2048, 128) with 8 KV heads, causal:
    bf16 rtol 1e-2, atol 2e-3; float32 rtol = atol = 2e-5. With randn q,
    k, v the softmax weights of a row of n keys act as about n / e equal
    ones, so |o| is about (e / n) ** 0.5: a median over all elements of
    about 0.035, up to about 4 in the first rows. The rtol covers one
    bf16 ulp (at most 0.0078 of |o|) and the atol sits well below the
    median |o|, so a dropped or doubled key tile or a wrong scale in a
    late row fails. The plain version rounds one float32 result; the
    bf16 route (tensor cores) also rounds the softmax weights P between
    its two products, into two bf16 parts hi + lo that carry P to about
    2^-16, so its output too is within about one ulp of the float32
    result. (P in one bf16 part, 2^-8, misses this tolerance where a few
    keys carry a row's weight, as in the first rows of a causal head.)
  * moe_dispatch at (64, 1280, 2048) and (64, 1, 2048), f 1024, and at
    (16, 1280, 8192) and (16, 1, 8192), f 24576, bf16: rtol 1e-2 (one
    bf16 ulp of the output), atol 2e-3, well below the median |y|
    printed beside it. The plain version rounds one float32 result; at
    C > 1 the bf16 route (tensor cores) also rounds the hidden
    silu(g) * u between its two products, into two bf16 parts hi + lo
    (about 2^-16); at C = 1 (CUDA cores) the hidden stays float32. (The
    hidden in one bf16 part misses this tolerance at these widths.)
  * selective_scan at (4, 256, 16384, 16), the chunk the path scans:
    float32 rtol = atol = 1e-5 (the same float32 recurrence, the dot
    product summed in another order), bf16 rtol 1e-2 (one bf16 ulp of
    the output), atol 1e-5; the same for a call chained through its
    state h against one call. dA in (0.5, 0.99), dBx and Cm at scale 0.1
    as tests/test_kernels.py draws them: |y| about 0.05.
  * decode against prefill (64 teacher-forced steps, the path's depth):
    atol 0.2, rtol 0, inside tests/test_archs.py's atol 0.55, rtol 0.1;
    the logits have a standard deviation of about 1 and granite's two
    paths measured 0.098 apart on the H100. olmoe runs both paths at a
    capacity factor of 8, so that neither drops an assignment (at the
    real factor the two paths drop differently by design), and is held
    at test_archs.py's tolerance: bf16 near-ties between the 8th and 9th
    of 64 experts route about one (token, layer) in seven apart on the
    two paths (printed; 149 of 1,024 on the H100, error 0.203).
    jamba, at capacity factor 8 too, is printed with its random routers
    (0.63 apart on the H100: a token routed apart moves the logits) and
    held at atol 0.2, rtol 0 with its routers zeroed, where both paths
    route every token alike.
  * the depth-2 model on the card against the CPU: atol = rtol = 0.1 on
    the logits (tests/test_torch_lm.py); jamba's 8-layer smoke period,
    its routers zeroed, atol 0.2, rtol 0.1 (tests/test_torch_ssm.py).

Each kernel is timed twice: CUDA events around a batch of wrapper calls,
and the device time of its kernel from a torch.profiler trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the allocator grows segments in place instead of caching freed blocks
# whole: the paths' models and their float32 init draws (26 GB for one of
# jamba's expert leaves) follow each other on one card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import to_tensors  # noqa: E402
from repro_torch.core.backends.torch_backend import compile_torch  # noqa: E402
from repro_torch.core.interp import LaunchParams  # noqa: E402
from repro_torch.core.passes.pipeline import PassConfig, run_pipeline  # noqa: E402
from repro_torch.core.vir import BINOPS, UNOPS, Op, Ty  # noqa: E402
from repro_torch.kernels.simt_exec import simt_exec as sx  # noqa: E402
from repro_torch.kernels.simt_exec.ops import volt_torch_run  # noqa: E402
from repro_torch.volt_bench import suite  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch as md  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.selective_scan import \
    selective_scan as ss  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.blueprint import (count_params, init_params,  # noqa
                                          tree_map)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

N = 2**24 - 37                 # ragged tail: exercises the `gid < n` guard
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
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
    """Device time per call of the kernels that ``fn`` launches, from a
    torch.profiler trace of ``calls`` calls (CUDA activity only): each
    kernel's mean time over its recorded launches, summed over the
    kernels, so a kernel counts once per call. The trace can drop launch
    records (on the H100 as few as 1 in 20), so the records are not
    counted as launches; records per call come back beside the kernels'
    names. None where the trace shows no device time in three tries (one
    trace of the H100 came back empty)."""
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
            us = sum(e.self_device_time_total / e.count for e in evs)
            return (us / 1e3, sorted({e.key[:40] for e in evs}),
                    sum(e.count for e in evs) / calls)
    return None, [], 0.0


CASES = [("vecadd", 256), ("saxpy", 256), ("blackscholes", 256),
         ("srad_flag0", 256), ("srad_flag1", 256), ("cfd_like", 256),
         ("psum", 32), ("vote_hw", 32), ("bscan_hw", 32)]


# --------------------------------------------------------------------------
# the LM serving paths: granite-3-2b and olmoe-1b-7b at full width and depth
# --------------------------------------------------------------------------

LM_ARCH, MOE_ARCH, HYBRID_ARCH = ("granite-3-2b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b")
#: jamba on one card: every width, one layer of each kind
HYBRID_CUT = {"n_layers": 4, "attn_every_k": 4}
PREFILL_B, PREFILL_S = 4, 2048       # 8192 rows for each RMSNorm
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 8, 512, 16, 16
RMS_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
FA_TOL = {torch.bfloat16: (1e-2, 2e-3), torch.float32: (2e-5, 2e-5)}
MOE_TOL = (1e-2, 2e-3)               # rtol, atol; bf16
SCAN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
SMOKE_TOL = (0.1, 0.2)               # rtol, atol; jamba's smoke period
DECODE_ATOL = 0.2
ROUTED_APART_TOL = (0.1, 0.55)       # rtol, atol of tests/test_archs.py
NO_DROP_CAPACITY = 8.0               # C >= T at T = 64: nothing dropped
KERNELS = {"simt_exec": sx, "rmsnorm": rn, "flash_attention": fa,
           "moe_dispatch": md, "selective_scan": ss}
LM_SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:23"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:113"),
    "moe_dispatch": (
        "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu",
        "src/repro/kernels/moe_dispatch/moe_dispatch.py:38"),
    "selective_scan": (
        "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        "src/repro/kernels/selective_scan/selective_scan.py:59")}


def _count(cfg, mixer=None, ff=None) -> int:
    """Layers of the model with this mixer (or this feed-forward)."""
    period = cfg.layer_pattern()
    return cfg.n_layers // len(period) * sum(
        k.mixer == mixer or k.ff == ff for k in period)


#: launches of the two-route kernels by route, on each counted path
ROUTE_COUNTS: dict = {}
ROUTED = {"flash_attention": fa, "moe_dispatch": md}


def _zero_counts() -> None:
    for m in KERNELS.values():
        m.LAUNCHES = 0
    for m in ROUTED.values():
        m.LAUNCHES_BY_ROUTE.update(dict.fromkeys(m.LAUNCHES_BY_ROUTE, 0))


def _counts() -> dict:
    return {k: m.LAUNCHES for k, m in KERNELS.items()}


def _route_counts() -> dict:
    return {k: dict(m.LAUNCHES_BY_ROUTE) for k, m in ROUTED.items()}


def _ptxas_lines(kernel) -> list:
    """Registers and spills of each tensor-core entry in the kernel's
    nvcc log (built with -Xptxas=-v)."""
    out, name = [], None
    for line in kernel.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(fa_tc_kernel|moe_up_tc|moe_down_tc)(ILi(\d+))?",
                          m.group(1))
            name = None if k is None else k.group(1) + (
                f"<{k.group(3)}>" if k.group(3) else "")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split('Used ')[1].strip()}; {spill}")
            name = None
    return out


def _rms_inputs(g, dev, N, d, dtype):
    return (torch.randn(N, d, generator=g, device=dev).to(dtype),
            torch.randn(d, generator=g, device=dev).to(dtype))


def _library_rmsnorm(x, s):
    """The yardstick: torch's own RMSNorm of the same rows."""
    return F.rms_norm(x, (x.shape[1],), s, 1e-6)


def _library_moe(x, wi, wo):
    """The yardstick, three calls in bf16: bmm, silu times mul, bmm."""
    f = wo.shape[1]
    h = torch.bmm(x, wi)
    return torch.bmm(F.silu(h[..., :f]) * h[..., f:], wo)


def _qkv(g, dev, cfg, B, S, dtype):
    """q, k, v as the layer hands them to the kernel: (B, H, S, D) views
    of (B, S, H, D) projections, K/V with the config's KV heads."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return tuple(torch.randn(B, S, h, D, generator=g, device=dev)
                 .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv))


def _fa_checks(g, dev, cfg, errs):
    S = PREFILL_S
    for dt, (rtol, atol) in FA_TOL.items():
        q, k, v = _qkv(g, dev, cfg, PREFILL_B, S, dt)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        e = _compare(f"flash_attention({S}, {cfg.head_dim})",
                     {"o": fa.flash_attention(q, k, v, causal=True)},
                     {"o": want}, rtol, atol)
        errs[("flash_attention", cfg.head_dim, dt)] = e
        print(f"check flash_attention ({PREFILL_B}, {cfg.n_heads}, {S}, "
              f"{cfg.head_dim}) kv heads {cfg.n_kv_heads} causal "
              f"{str(dt)[6:]} vs plain max abs err {e:.3g} (rtol {rtol}, "
              f"atol {atol}; median |o| "
              f"{float(want.float().abs().median()):.3g})")
        del q, k, v, want


def lm_kernel_checks(dev, cfg, seed):
    """Each kernel against its plain version on the card, at the dense
    path's shapes; returns the max abs errors by (kernel, shape, dtype)."""
    g = torch.Generator(dev).manual_seed(seed)
    errs = {}
    for N in (PREFILL_B * PREFILL_S, SERVE_SLOTS):
        for dt, tol in RMS_TOL.items():
            x, s = _rms_inputs(g, dev, N, cfg.d_model, dt)
            want = rn.rmsnorm_plain(x, s)
            e = _compare(f"rmsnorm({N})", {"y": rn.rmsnorm(x, s)},
                         {"y": want}, tol, tol)
            errs[("rmsnorm", N, dt)] = e
            print(f"check rmsnorm ({N}, {cfg.d_model}) {str(dt)[6:]} vs "
                  f"plain max abs err {e:.3g} (tol {tol}; median |y| "
                  f"{float(want.float().abs().median()):.3g})")
    _fa_checks(g, dev, cfg, errs)
    return errs


def _moe_shapes(cfg):
    """The expert FF's capacity at the prefill and the engine's decode."""
    return {n: MOE.capacity(T, cfg.moe_top_k, cfg.moe_experts,
                            cfg.moe_capacity)
            for n, T in (("prefill", PREFILL_B * PREFILL_S),
                         ("decode", SERVE_SLOTS))}


def _moe_checks(g, dev, cfg, wi, wo, errs):
    """The expert FF against its plain version at the path's capacities
    (x drawn as the unit-RMS output of an RMSNorm)."""
    rtol, atol = MOE_TOL
    for name, C in _moe_shapes(cfg).items():
        x = torch.randn(cfg.moe_experts, C, cfg.d_model, generator=g,
                        device=dev).bfloat16()
        want = md.grouped_expert_ff_plain(x, wi, wo)
        e = _compare(f"moe_dispatch({C})", {"y": md.grouped_expert_ff(
            x, wi, wo)}, {"y": want}, rtol, atol)
        errs[("moe_dispatch", name, torch.bfloat16)] = e
        print(f"check moe_dispatch ({cfg.moe_experts}, {C}, {cfg.d_model})"
              f" f {cfg.moe_d_ff} bf16 vs plain max abs err {e:.3g} (rtol "
              f"{rtol}, atol {atol}; median |y| "
              f"{float(want.float().abs().median()):.3g})")
        del x, want


def moe_kernel_checks(dev, cfg, layer0, seed):
    """flash_attention at olmoe's head dim and the expert FF at the
    path's capacities (layer 0's weights), each against its plain
    version."""
    g = torch.Generator(dev).manual_seed(seed)
    errs = {}
    _fa_checks(g, dev, cfg, errs)
    _moe_checks(g, dev, cfg, layer0["wi"], layer0["wo"], errs)
    return errs


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _kernel_row(name, shape, fn, plain_fn, lib_fn, nbytes, ops, ops_rate,
                reps, launches, batch=10, calls=20):
    """Times one kernel at one shape: events (``reps`` batches of
    ``batch`` calls), profiler device time (``calls`` calls), the plain
    version, the library call where there is one (``lib_fn`` None: no
    single torch call computes the function); the bound from bytes and
    ops. The card's SM clock and power draw are read right after the
    events, while it is still loaded."""
    ms = _median_ms(fn, reps, batch)
    clocks = _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    dev_ms, _, per_call = _device_ms(fn, calls)
    plain_ms = _median_ms(plain_fn, reps, batch=1)
    library_ms = None if lib_fn is None else _median_ms(lib_fn, reps, batch)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"time {name:15s} {shape}  launches {launches}  {ms:.4f} ms  "
          "device " + ("not measured" if dev_ms is None else
                       f"{dev_ms:.4f} ms ({per_call:g} records/call)")
          + f"  bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, "
          f"{ops:.4g} ops)  share {bound_ms / ms:.3f}  plain "
          f"{plain_ms:.4f} ms  library "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms")
          + f"  card after the events: {clocks.splitlines()[0]} (sm, max "
          "sm, power, temp)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms}


def _fa_row(g, dev, cfg, reps, errs):
    B, S, H, D = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(g, dev, cfg, B, S, torch.bfloat16)
    nbytes = sum(t.numel() * 2 for t in (q, k, v, q))
    pairs = S * (S + 1) // 2          # (query, key) pairs under the mask
    row = _kernel_row(
        "flash_attention", f"({B}, {H}, {S}, {D}) causal bf16",
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes, 4 * B * H * D * pairs, BF16_OPS_PER_S, reps,
        f"{_count(cfg, 'attn')} a prefill")
    return {**row, "max_abs_err": errs[("flash_attention", D,
                                        torch.bfloat16)]}


def lm_kernel_times(dev, cfg, reps, errs):
    """Timing rows at the dense path's shapes; the records take the
    prefill shape in bf16."""
    g = torch.Generator(dev).manual_seed(7)
    d = cfg.d_model
    records = {}
    for N in (PREFILL_B * PREFILL_S, SERVE_SLOTS):
        # four input sets in turn (134 MB at 8192 rows), so that a call
        # does not find its 33.5 MB input in the 50 MB L2 cache
        sets = itertools.cycle([_rms_inputs(g, dev, N, d, torch.bfloat16)
                                for _ in range(4)])
        row = _kernel_row(
            "rmsnorm", f"({N}, {d}) bf16",
            lambda: rn.rmsnorm(*next(sets)),
            lambda: rn.rmsnorm_plain(*next(sets)),
            lambda: _library_rmsnorm(*next(sets)),
            2 * N * d * 2 + d * 2, 4 * N * d, F32_OPS_PER_S, reps,
            f"{2 * cfg.n_layers + 1} a prefill or decode step")
        if N == PREFILL_B * PREFILL_S:
            records["rmsnorm"] = {**row, "max_abs_err":
                                  errs[("rmsnorm", N, torch.bfloat16)]}
    records["flash_attention"] = _fa_row(g, dev, cfg, reps, errs)
    return records


def _moe_rows(dev, cfg, wi, wo, reps, errs, launches, prefill_batch=10):
    """Timing rows of the expert FF at the prefill and decode capacities
    (one layer's weights: far past the L2 cache). The bound: 6 E C d f
    FLOP of bf16 products, or each input read and the output written
    once. Returns the prefill row with the decode row in it."""
    g = torch.Generator(dev).manual_seed(8)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    rows = {}
    for name, C in _moe_shapes(cfg).items():
        x = torch.randn(E, C, d, generator=g, device=dev).bfloat16()
        nbytes = 2 * (2 * x.numel() + wi.numel() + wo.numel())
        batch = prefill_batch if name == "prefill" else 10
        rows[name] = {**_kernel_row(
            "moe_dispatch", f"({E}, {C}, {d}) f {f} bf16 ({name})",
            lambda: md.grouped_expert_ff(x, wi, wo),
            lambda: md.grouped_expert_ff_plain(x, wi, wo),
            lambda: _library_moe(x, wi, wo),
            nbytes, 6 * E * C * d * f, BF16_OPS_PER_S, reps, launches,
            batch=batch, calls=2 * batch), "shape": [E, C, d, f],
            "max_abs_err": errs[("moe_dispatch", name, torch.bfloat16)]}
        del x
    print("library for moe_dispatch: three calls in bf16 (bmm, silu times "
          "mul, bmm)")
    return {**rows["prefill"], "decode": rows["decode"],
            "library": "torch.bmm, F.silu * mul, torch.bmm (bf16)"}


def moe_kernel_times(dev, cfg, layer0, reps, errs):
    """Timing rows of the expert FF (layer 0's weights: 805 MB) and of
    attention at head dim 128."""
    record = _moe_rows(dev, cfg, layer0["wi"], layer0["wo"], reps, errs,
                       f"{cfg.n_layers} a prefill or decode step")
    g = torch.Generator(dev).manual_seed(9)
    return record, _fa_row(g, dev, cfg, reps, errs)


def _breakdown(fn, wall_ms: float, label: str) -> None:
    """Where one call's time goes: the device's busy time (the sum of its
    kernels in a torch.profiler trace of CUDA activity) against the
    call's wall time measured without the profiler, and the kernels that
    take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not evs:
        print(f"where the time goes, {label}: not measured (empty trace)")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    n = sum(e.count for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
    print(f"where the time goes, {label}: wall {wall_ms:.2f} ms, device "
          f"busy {busy:.2f} ms in {n} kernels, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))


def _sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _routed(fn):
    """``fn()`` and the expert indices (T, k) of every MoE layer it ran,
    in order."""
    seen, route = [], MOE.route

    def record(p, xt, top_k):
        out = route(p, xt, top_k)
        seen.append(out[2])
        return out

    MOE.route = record
    try:
        return fn(), seen
    finally:
        MOE.route = route


def _apart(a, b) -> int:
    """Tokens whose expert sets differ between two (T, k) routings."""
    return int((a.sort(dim=1).values.cpu()
                != b.sort(dim=1).values.cpu()).any(dim=1).sum())


def _first_moe_dropped(fn, cfg) -> float:
    """The share of expert assignments dropped by capacity at the first
    MoE layer that ``fn()`` runs, from that layer's own input."""
    seen, moe_ff = [], MOE.moe_ff

    def record(p, x, **kw):
        seen.append((p, x))
        return moe_ff(p, x, **kw)

    MOE.moe_ff = record
    try:
        fn()
    finally:
        MOE.moe_ff = moe_ff
    p, x = seen[0]
    return MOE.dropped_share(p, x, n_experts=cfg.moe_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity)


def _init(dev, cfg, seed):
    model = get_model(cfg)
    bp = model.blueprint()
    params, secs = _sync_s(lambda: init_params(
        bp, torch.Generator(dev).manual_seed(seed)))
    moe = (f", {cfg.moe_experts} experts of d_ff {cfg.moe_d_ff}, top-"
           f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity}"
           if cfg.moe_experts else "")
    mamba = (f", mamba d_inner {cfg.ssm_d_inner} d_state "
             f"{cfg.ssm_d_state} conv {cfg.ssm_d_conv} chunk {cfg.ssm_chunk}"
             if cfg.family == "hybrid" else "")
    layers = " ".join(f"{k.mixer}/{k.ff}" for k in model.period)
    print(f"lm {cfg.name}: {count_params(bp)} params, {cfg.n_layers} "
          f"layers (period {layers}), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv) x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}{moe}{mamba}, vocab {cfg.vocab}; init on the "
          f"card {secs:.2f} s")
    return model, params


def serve_path(dev, cfg, model, params, seed):
    """The path, counted (counts set to 0 just before each part, read
    just after): one prefill of 4 x 2048 tokens, then the engine
    answering 16 requests; then prefill and decode speed, and where their
    time goes. Returns the tokens, the engine, the rng, the counts by
    path and the decode step's inputs."""
    L, arch = cfg.n_layers, cfg.name
    moe_layers = _count(cfg, ff="moe")
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                         generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
    _zero_counts()
    logits, first_s = _sync_s(lambda: model.prefill(params, toks))
    per_prefill = _counts()
    routes = _route_counts()
    for name, by_route in routes.items():
        if by_route != {"tensor_cores": per_prefill[name], "cuda_cores": 0}:
            raise AssertionError(f"{arch} prefill: {name} launched "
                                 f"{by_route} by route; every launch must "
                                 "take the tensor cores")
    ROUTE_COUNTS[f"{arch}/prefill"] = routes
    want = {"simt_exec": 0, "rmsnorm": 2 * L + 1,
            "flash_attention": _count(cfg, "attn"),
            "moe_dispatch": moe_layers,
            "selective_scan": _count(cfg, "mamba") * math.ceil(
                PREFILL_S / cfg.ssm_chunk)}
    if per_prefill != want:
        raise AssertionError(f"{arch} prefill launched {per_prefill}; "
                             f"expected {want}")
    if (logits.shape != (PREFILL_B, cfg.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    print(f"{arch} prefill main path: launches per call {per_prefill}, by "
          f"route {routes}; first call {first_s:.3f} s")

    rng = np.random.default_rng(seed)
    eng = ServeEngine(model, params, slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(16, 65))).astype(np.int32),
        max_new=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    for r in reqs:
        eng.submit(r)
    _zero_counts()
    _, serve_s = _sync_s(eng.run_until_drained)
    per_serve = _counts()
    ROUTE_COUNTS[f"{arch}/serve"] = _route_counts()
    bad = [(r.rid, r.error, len(r.out)) for r in reqs
           if not r.done or r.error or len(r.out) != SERVE_NEW]
    if (bad or per_serve["rmsnorm"] < 1 or per_serve["simt_exec"]
            or per_serve["flash_attention"] or per_serve["selective_scan"]
            or (per_serve["moe_dispatch"] < 1) != (moe_layers == 0)):
        raise AssertionError(f"serving: failed requests {bad}, launches "
                             f"{per_serve}")
    prompt_toks = sum(len(r.prompt) for r in reqs)
    gen = SERVE_REQUESTS * SERVE_NEW
    print(f"{arch} serve main path: {SERVE_REQUESTS} requests "
          f"({prompt_toks} prompt tokens, {gen} generated) on "
          f"{SERVE_SLOTS} slots in {serve_s:.3f} s, {gen / serve_s:.1f} "
          f"generated tokens/s; launches {per_serve}, by route "
          f"{ROUTE_COUNTS[f'{arch}/serve']}")
    by_path = {f"{arch}/prefill": per_prefill, f"{arch}/serve": per_serve}

    times = [_sync_s(lambda: model.prefill(params, toks))[1]
             for _ in range(3)]
    pre_s = statistics.median(times)
    print(f"{arch} prefill {PREFILL_B} x {PREFILL_S}: {pre_s * 1e3:.1f} ms "
          f"(median of 3), {PREFILL_B * PREFILL_S / pre_s:.0f} tokens/s")
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (SERVE_SLOTS, 1))).to(dev)
    step_pos = torch.full((SERVE_SLOTS,), 100, device=dev)

    def step():
        return model.decode_step(params, eng.cache, step_toks, step_pos)

    step_ms = statistics.median(_sync_s(step)[1] for _ in range(10)) * 1e3
    print(f"{arch} decode_step {SERVE_SLOTS} slots, cache {SERVE_MAX_SEQ}: "
          f"{step_ms:.2f} ms (median of 10), "
          f"{SERVE_SLOTS / step_ms * 1e3:.1f} tokens/s")
    _breakdown(lambda: model.prefill(params, toks), pre_s * 1e3,
               f"{arch} prefill {PREFILL_B} x {PREFILL_S}")
    _breakdown(step, step_ms, f"{arch} decode_step {SERVE_SLOTS} slots")
    return toks, eng, rng, by_path, step


def _decode_vs_prefill(dev, model, params, prompt, cfg):
    """Teacher-forced decode over the prompt against prefill's last
    logits, and the (token, layer) pairs whose experts the two paths
    chose apart."""
    full, pre_routes = _routed(lambda: model.prefill(params, prompt))
    cache = model.init_cache(1, prompt.shape[1], device=dev)
    apart = 0
    for t in range(prompt.shape[1]):
        (last, cache), routes = _routed(lambda: model.decode_step(
            params, cache, prompt[:, t:t + 1], torch.full((1,), t,
                                                          device=dev)))
        apart += sum(_apart(pr[t:t + 1], r)
                     for pr, r in zip(pre_routes, routes))
    return last[:, 0, :cfg.vocab], full[:, :cfg.vocab], apart


def lm_phase(dev, seed: int, reps: int):
    """The dense LM serving path on granite-3-2b, checked and timed;
    returns its kernels' records and its counts by path."""
    cfg = get_config(LM_ARCH)
    model, params = _init(dev, cfg, seed)
    errs = lm_kernel_checks(dev, cfg, seed)
    toks, eng, rng, by_path, _ = serve_path(dev, cfg, model, params, seed)

    # decode matches prefill at full width (tests/test_archs.py's check)
    got, want, _ = _decode_vs_prefill(dev, model, params, toks[:1, :64], cfg)
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, 0.0,
                 DECODE_ATOL)
    print(f"check decode (64 steps) vs prefill logits max abs err {e:.3g} "
          f"(atol {DECODE_ATOL}, rtol 0; logits std {float(want.std()):.3g})")

    # the card (kernels) against the CPU (plain versions), depth 2
    m2 = get_model(dataclasses.replace(cfg, n_layers=2))
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    want2 = m2.prefill(p_cpu, toks2)
    got2 = m2.prefill(tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev))
    e = _compare("depth-2 card vs cpu", {"l": got2.cpu()[:, :cfg.vocab]},
                 {"l": want2[:, :cfg.vocab]}, 0.1, 0.1)
    print(f"check depth-2 prefill (2 x 128) card vs cpu logits max abs err "
          f"{e:.3g} (atol = rtol = 0.1)")
    del params, eng
    torch.cuda.empty_cache()
    return lm_kernel_times(dev, cfg, min(reps, 10), errs), by_path


def moe_phase(dev, seed: int, reps: int):
    """The MoE LM serving path on olmoe-1b-7b, checked and timed;
    returns its kernels' records and its counts by path."""
    cfg = get_config(MOE_ARCH)
    model, params = _init(dev, cfg, seed)
    layer0 = {k: params["stack"][0]["moe"][k][0] for k in ("wi", "wo")}
    errs = moe_kernel_checks(dev, cfg, layer0, seed)
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed)

    # assignments the capacity drops, at the first layer (untimed)
    for name, fn in (("prefill", lambda: model.prefill(params, toks)),
                     ("decode", step)):
        share = _first_moe_dropped(fn, cfg)
        print(f"{cfg.name} {name}: {share:.4f} of layer 0's expert "
              f"assignments dropped by capacity (C = "
              f"{_moe_shapes(cfg)[name]})")

    # decode matches prefill where neither drops (C >= T at T = 64)
    m8 = get_model(dataclasses.replace(cfg, moe_capacity=NO_DROP_CAPACITY))
    got, want, apart = _decode_vs_prefill(dev, m8, params, toks[:1, :64],
                                          cfg)
    rtol, atol = ROUTED_APART_TOL
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, rtol, atol)
    print(f"check decode (64 steps) vs prefill, capacity factor "
          f"{NO_DROP_CAPACITY}, logits max abs err {e:.3g} (atol {atol}, "
          f"rtol {rtol}; logits std {float(want.std()):.3g}); (token, "
          f"layer) pairs routed apart: {apart} of {64 * cfg.n_layers}")

    # the card (kernels) against the CPU (plain versions), depth 2
    m2 = get_model(dataclasses.replace(cfg, n_layers=2))
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    want2, r_cpu = _routed(lambda: m2.prefill(p_cpu, toks2))
    got2, r_card = _routed(lambda: m2.prefill(
        tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev)))
    apart = [_apart(a, b) for a, b in zip(r_cpu, r_card)]
    e = _compare("depth-2 card vs cpu", {"l": got2.cpu()[:, :cfg.vocab]},
                 {"l": want2[:, :cfg.vocab]}, 0.1, 0.1)
    print(f"check depth-2 prefill (2 x 128) card vs cpu logits max abs err "
          f"{e:.3g} (atol = rtol = 0.1); tokens whose experts differ "
          f"between card and cpu, by layer: {apart} of {toks2.numel()}")
    del p_cpu, eng
    record, fa128 = moe_kernel_times(dev, cfg, layer0, min(reps, 10), errs)
    del params, layer0
    torch.cuda.empty_cache()
    return {"moe_dispatch": record, "flash_attention_d128": fa128}, by_path


def _scan_inputs(g, dev, shape, dtype):
    """dA in (0.5, 0.99), dBx and Cm at scale 0.1, as tests/test_kernels.py
    draws them."""
    B, S, d, n = shape
    dA = torch.rand(B, S, d, n, generator=g, device=dev).mul_(0.49).add_(0.5)
    dBx = torch.randn(B, S, d, n, generator=g, device=dev).mul_(0.1)
    Cm = torch.randn(B, S, n, generator=g, device=dev).mul_(0.1)
    return [t.to(dtype) for t in (dA, dBx, Cm)]


def scan_kernel(dev, cfg, seed, reps):
    """selective_scan at the chunk the path scans, (B, chunk, d_inner, n):
    against its plain version in float32 and bf16, from a given state h,
    and a call chained through h against one call; then the timing row in
    float32, the path's dtype (each call reads and writes h). The bound:
    dA, dBx, Cm and h read, y and h written once; 4 FLOP per state a
    step."""
    g = torch.Generator(dev).manual_seed(seed)
    shape = (PREFILL_B, cfg.ssm_chunk, cfg.ssm_d_inner, cfg.ssm_d_state)
    B, S, d, n = shape
    err = 0.0
    for dt, (rtol, atol) in SCAN_TOL.items():
        dA, dBx, Cm = _scan_inputs(g, dev, shape, dt)
        h0 = torch.randn(B, d, n, generator=g, device=dev)
        h, want_h = h0.clone(), h0.clone()
        want = ss.selective_scan_plain(dA, dBx, Cm, want_h)
        e = _compare(f"selective_scan{shape}", {
            "y": ss.selective_scan(dA, dBx, Cm, h), "h": h},
            {"y": want, "h": want_h}, rtol, atol)
        one = ss.selective_scan(dA, dBx, Cm)
        h = torch.zeros(B, d, n, device=dev)
        parts = [ss.selective_scan(*(t[:, a:b].contiguous()
                                     for t in (dA, dBx, Cm)), h)
                 for a, b in ((0, S // 2), (S // 2, S))]
        e2 = _compare("selective_scan chained", {"y": torch.cat(parts, 1)},
                      {"y": one}, rtol, atol)
        print(f"check selective_scan {shape} {str(dt)[6:]} from a state vs "
              f"plain max abs err {e:.3g}; two calls chained through h vs "
              f"one call {e2:.3g} (rtol {rtol}, atol {atol}; median |y| "
              f"{float(want.float().abs().median()):.3g})")
        if dt == torch.float32:
            err = e
        del dA, dBx, Cm, want, one, parts
    dA, dBx, Cm = _scan_inputs(g, dev, shape, torch.float32)
    h = torch.zeros(B, d, n, device=dev)
    nbytes = 4 * (dA.numel() + dBx.numel() + Cm.numel() + B * S * d
                  + 2 * h.numel())
    row = _kernel_row(
        "selective_scan", f"({B}, {S}, {d}, {n}) float32 with h",
        lambda: ss.selective_scan(dA, dBx, Cm, h),
        lambda: ss.selective_scan_plain(dA, dBx, Cm, h), None, nbytes,
        4 * B * S * d * n, F32_OPS_PER_S, reps,
        f"{_count(cfg, 'mamba')} x {math.ceil(PREFILL_S / S)} a prefill")
    return {**row, "max_abs_err": err, "shape": list(shape)}


def hybrid_moe(dev, cfg, seed, reps):
    """The expert FF at jamba's width, before the model's params exist:
    one layer's 16 experts drawn as ``init_params`` draws them (normal
    over the square root of the fan-in, bf16), one expert at a time;
    checked against the plain version at both capacities, then timed
    (prefill in batches of one call: about a second each)."""
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    g = torch.Generator(dev).manual_seed(seed)
    wi = torch.empty(E, d, 2 * f, dtype=torch.bfloat16, device=dev)
    wo = torch.empty(E, f, d, dtype=torch.bfloat16, device=dev)
    for e in range(E):
        wi[e] = torch.randn(d, 2 * f, generator=g, device=dev).mul_(
            d ** -0.5).bfloat16()
        wo[e] = torch.randn(f, d, generator=g, device=dev).mul_(
            f ** -0.5).bfloat16()
    errs = {}
    _moe_checks(g, dev, cfg, wi, wo, errs)
    print(f"moe_dispatch slicing of f {f}: " + ", ".join(
        f"C = {C}: {md.slicing(E, C, f)} (slices, width)"
        for C in _moe_shapes(cfg).values()))
    record = _moe_rows(dev, cfg, wi, wo, reps, errs,
                       f"{_count(cfg, ff='moe')} a prefill or decode step",
                       prefill_batch=1)
    del wi, wo
    torch.cuda.empty_cache()
    return record


def hybrid_phase(dev, seed: int, reps: int):
    """The hybrid LM serving path on jamba-1.5-large-398b at full width,
    cut to one layer of each kind; checked and timed. Its kernels are
    checked and timed first, before its params exist. Returns its
    kernels' records and its counts by path."""
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, **HYBRID_CUT)
    print(f"{HYBRID_ARCH} cut for one card: " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in HYBRID_CUT.items())
        + "; every width as published")
    errs = lm_kernel_checks(dev, cfg, seed)
    records = lm_kernel_times(dev, cfg, min(reps, 10), errs)
    records["moe_dispatch"] = hybrid_moe(dev, cfg, seed, min(reps, 3))
    records["selective_scan"] = scan_kernel(dev, cfg, seed, min(reps, 10))
    torch.cuda.empty_cache()

    model, params = _init(dev, cfg, seed)
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed)
    first = [k.ff for k in model.period].index("moe")
    for name, fn in (("prefill", lambda: model.prefill(params, toks)),
                     ("decode", step)):
        share = _first_moe_dropped(fn, cfg)
        print(f"{cfg.name} {name}: {share:.4f} of layer {first}'s expert "
              f"assignments dropped by capacity (C = "
              f"{_moe_shapes(cfg)[name]})")

    # decode matches prefill where neither drops (C >= T at T = 64): with
    # the random routers (printed: a token routed apart on the two paths
    # moves the logits), then held with the routers zeroed, where both
    # paths route every token to experts 0 and 1
    m8 = get_model(dataclasses.replace(cfg, moe_capacity=NO_DROP_CAPACITY))
    moe_layers = _count(cfg, ff="moe")
    got, want, apart = _decode_vs_prefill(dev, m8, params, toks[:1, :64],
                                          cfg)
    print(f"decode (64 steps) vs prefill, capacity factor "
          f"{NO_DROP_CAPACITY}, random routers: logits max abs err "
          f"{float((got - want).abs().max()):.3g} (logits std "
          f"{float(want.std()):.3g}); (token, layer) pairs routed apart: "
          f"{apart} of {64 * moe_layers}")
    tied = dict(params, stack=[
        dict(layer, moe=dict(layer["moe"], router=torch.zeros_like(
            layer["moe"]["router"]))) if "moe" in layer else layer
        for layer in params["stack"]])
    got, want, apart = _decode_vs_prefill(dev, m8, tied, toks[:1, :64], cfg)
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, 0.0,
                 DECODE_ATOL)
    print(f"check decode (64 steps) vs prefill, capacity factor "
          f"{NO_DROP_CAPACITY}, routers zeroed, logits max abs err {e:.3g} "
          f"(atol {DECODE_ATOL}, rtol 0; logits std "
          f"{float(want.std()):.3g}); pairs routed apart: {apart}")
    del params, tied, eng, step
    torch.cuda.empty_cache()

    # the card (kernels) against the CPU (plain versions): one period of
    # the smoke config, its routers zeroed (widths cut: the CPU would
    # need 46 GB at full width)
    sm = get_config(HYBRID_ARCH, smoke=True)
    sm = dataclasses.replace(sm, n_layers=len(sm.layer_pattern()))
    m2 = get_model(sm)
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    for layer in p_cpu["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()
    toks2 = torch.from_numpy(rng.integers(0, sm.vocab, (2, 128)))
    want2 = m2.prefill(p_cpu, toks2)
    _zero_counts()
    got2 = m2.prefill(tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev))
    torch.cuda.synchronize()
    rtol, atol = SMOKE_TOL
    e = _compare("smoke period card vs cpu", {"l": got2.cpu()[:, :sm.vocab]},
                 {"l": want2[:, :sm.vocab]}, rtol, atol)
    print(f"check {sm.name} one period ({sm.n_layers} layers, d_model "
          f"{sm.d_model}, routers zeroed) prefill (2 x 128) card vs cpu "
          f"logits max abs err {e:.3g} (atol {atol}, rtol {rtol}); card "
          f"launches {_counts()}")
    return records, by_path


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
    print(_smi("name,power.limit").splitlines()[0])
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
    with ThreadPoolExecutor(4) as pool:
        lm_built = {m.KERNEL.kind: pool.submit(m.KERNEL.build)
                    for m in (rn, fa, md, ss)}
        built = sx.build_many(list(srcs.values()))
        for kind, fut in lm_built.items():
            so, secs = fut.result()
            print(f"build {kind:15s} {so.name[:12]} nvcc {secs:.1f} s")
    for name, (so, secs) in zip(srcs, built):
        print(f"build {name:13s} {so.name[:12]} nvcc {secs:.1f} s")
    print(f"build total {time.perf_counter() - t0:.1f} s")
    for m in ROUTED.values():
        for line in _ptxas_lines(m.KERNEL):
            print(f"ptxas {line}")

    # 3. the main path at full size, counted
    _zero_counts()
    outs, launches = {}, {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        before = sx.LAUNCHES
        outs[name] = volt_torch_run(bench.handle, bufs, params, sc,
                                    CONFIG, device=dev)
        launches[name] = sx.LAUNCHES - before
    torch.cuda.synchronize()
    total = sx.LAUNCHES
    if (total != len(cases) or min(launches.values()) < 1
            or sum(_counts().values()) != total):
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
                 f"{dev_ms:.4f} ms ({per_call:g} records/call {kernels})")
              + f" events {ms:.4f} ms"
              + ("" if lib_dev[0] is None else
                 f"  library kernel {lib_dev[0]:.4f} ms"))
        records.append({"name": f"simt_exec/{name}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": launches[name],
                        "launches_by_path": {"compiler": launches[name]},
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms})

    # 6. the LM serving paths, dense, MoE and hybrid; each kernel's record
    # counts its launches on every path
    t0 = time.perf_counter()
    lm_records, paths = lm_phase(dev, args.seed, args.reps)
    print(f"lm phase {LM_ARCH} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_records, moe_paths = moe_phase(dev, args.seed, args.reps)
    print(f"lm phase {MOE_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(moe_paths)
    lm_records["flash_attention"]["d128"] = moe_records.pop(
        "flash_attention_d128")
    lm_records.update(moe_records)
    t0 = time.perf_counter()
    hybrid_records, hybrid_paths = hybrid_phase(dev, args.seed, args.reps)
    print(f"lm phase {HYBRID_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(hybrid_paths)
    for name in ("rmsnorm", "flash_attention", "moe_dispatch"):
        lm_records[name]["jamba"] = hybrid_records.pop(name)
    lm_records.update(hybrid_records)
    for name, r in lm_records.items():
        src, replaces = LM_SOURCES[name]
        per_path = {p: n[name] for p, n in paths.items()}
        by_route = {} if name not in ROUTED else {"launches_by_route": {
            p: n[name] for p, n in ROUTE_COUNTS.items()}}
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(per_path.values()),
                        "launches_by_path": per_path, **by_route, **r})

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
