"""The paper's benchmark suite (§5.1), in the two VOLT front-end dialects.

OpenCL-dialect: vecadd saxpy dotproduct transpose reduce0 psum psort
sfilter sgemm blackscholes bfs pathfinder kmeans nearn stencil spmv
cfd_like.  CUDA-dialect (Case Study 1 kernels): vote / shuffle / bscan /
atomic-aggregate, each in an ISA-extension (hw) and software-emulated (sw)
variant for the Fig 9 comparison.

Each Bench provides deterministic inputs and a numpy reference; the
benchmark drivers run them through the ablation ladder (Fig 7/8), the ISA
case study (Fig 9), and the shared-memory mapping case study (Fig 10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.frontends import cuda, opencl
from ..core.interp import LaunchParams


# ==========================================================================
# OpenCL kernels
# ==========================================================================

@opencl.kernel
def vecadd(x: "ptr_f32 const", y: "ptr_f32 const", z: "ptr_f32",
           n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        z[gid] = x[gid] + y[gid]


@opencl.kernel
def saxpy(a: "f32", x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        y[gid] = a * x[gid] + y[gid]


@opencl.kernel
def dotproduct(x: "ptr_f32 const", y: "ptr_f32 const", out: "ptr_f32",
               n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        atomic_add(out, 0, x[gid] * y[gid])


@opencl.kernel
def transpose(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    row = gid // n
    col = gid - row * n
    v = x[col * n + row] if row < n else 0.0
    if gid < n * n:
        y[gid] = v


@opencl.kernel
def reduce0(x: "ptr_f32 const", out: "ptr_f32", n: "i32 uniform"):
    tmp = local_array(f32, 32)
    lid = get_local_id(0)
    gid = get_global_id(0)
    tmp[lid] = x[gid] if gid < n else 0.0
    barrier()
    s = get_local_size(0) // 2
    while s > 0:
        if lid < s:
            tmp[lid] = tmp[lid] + tmp[lid + s]
        barrier()
        s = s // 2
    if lid == 0:
        out[get_group_id(0)] = tmp[0]


@opencl.kernel
def psum(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    tmp = local_array(f32, 32)
    lid = get_local_id(0)
    gid = get_global_id(0)
    tmp[lid] = x[gid] if gid < n else 0.0
    barrier()
    off = 1
    while off < get_local_size(0):
        v = 0.0
        if lid >= off:
            v = tmp[lid - off]
        barrier()
        tmp[lid] = tmp[lid] + v
        barrier()
        off = off * 2
    if gid < n:
        y[gid] = tmp[lid]


@opencl.kernel
def psort(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        v = x[gid]
        rank = 0
        for i in range(n):
            xi = x[i]
            if xi < v or (xi == v and i < gid):
                rank += 1
        y[rank] = v


@opencl.kernel
def sfilter(x: "ptr_f32 const", y: "ptr_f32", w: "ptr_f32 const",
            n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        # region-dependent tap selection: w is piecewise-constant over
        # warps, so the branch is warp-uniform at run time but not
        # provably so -> ZiCond turns it into two loads per lane
        left = x[gid - 1] if gid > 0 else 0.0
        right = x[gid + 1] if gid < n - 1 else 0.0
        pick = left if w[gid] > 0.5 else right
        y[gid] = 0.5 * x[gid] + 0.5 * pick


@opencl.kernel
def sgemm(a: "ptr_f32 const", b: "ptr_f32 const", c: "ptr_f32",
          m: "i32 uniform", n: "i32 uniform", k: "i32 uniform"):
    gid = get_global_id(0)
    if gid < m * n:
        row = gid // n
        col = gid - row * n
        acc = 0.0
        for i in range(k):
            acc += a[row * k + i] * b[i * n + col]
        c[gid] = acc


@opencl.device
def cnd(x: "f32") -> "f32":
    kk = 1.0 / (1.0 + 0.2316419 * abs(x))
    poly = kk * (0.31938153 + kk * (-0.356563782 + kk * (1.781477937
                 + kk * (-1.821255978 + kk * 1.330274429))))
    w = 1.0 - 0.39894228 * exp(-0.5 * x * x) * poly
    return w if x > 0.0 else 1.0 - w


@opencl.kernel(deps=(cnd,))
def blackscholes(S: "ptr_f32 const", K: "ptr_f32 const", T: "ptr_f32 const",
                 call: "ptr_f32", put: "ptr_f32", r: "f32 uniform",
                 v: "f32 uniform", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        s = S[gid]
        k = K[gid]
        t = T[gid]
        srt = v * sqrt(t)
        d1 = (log(s / k) + (r + 0.5 * v * v) * t) / srt
        d2 = d1 - srt
        c = s * cnd(d1) - k * exp(-r * t) * cnd(d2)
        call[gid] = c
        put[gid] = c - s + k * exp(-r * t)


@opencl.kernel
def bfs(row_ptr: "ptr_i32 const", cols: "ptr_i32 const",
        frontier: "ptr_i32 const", next_frontier: "ptr_i32",
        visited: "ptr_i32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        if frontier[gid] != 0:
            start = row_ptr[gid]
            end = row_ptr[gid + 1]
            for e in range(start, end):
                c = cols[e]
                if visited[c] == 0:
                    visited[c] = 1
                    next_frontier[c] = 1


@opencl.kernel
def pathfinder(src: "ptr_f32 const", wall: "ptr_f32 const", dst: "ptr_f32",
               n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        left = src[gid - 1] if gid > 0 else 1000000.0
        right = src[gid + 1] if gid < n - 1 else 1000000.0
        center = src[gid]
        best = min(min(left, right), center)
        dst[gid] = wall[gid] + best


@opencl.device
def dist2(features: "ptr_f32 const", centroids: "ptr_f32 const",
          p: "i32", c: "i32", dims: "i32") -> "f32":
    s = 0.0
    for d in range(dims):
        diff = features[p * dims + d] - centroids[c * dims + d]
        s += diff * diff
    return s


@opencl.kernel(deps=(dist2,))
def kmeans(features: "ptr_f32 const", centroids: "ptr_f32 const",
           assign: "ptr_i32", npoints: "i32 uniform", k: "i32 uniform",
           dims: "i32 uniform"):
    gid = get_global_id(0)
    if gid < npoints:
        best = 1000000.0
        bi = 0
        for c in range(k):
            dd = dist2(features, centroids, gid, c, dims)
            if dd < best:
                best = dd
                bi = c
        assign[gid] = bi


@opencl.kernel(deps=(dist2,))
def nearn(features: "ptr_f32 const", query: "ptr_f32 const",
          out_idx: "ptr_i32", npoints: "i32 uniform", dims: "i32 uniform",
          nq: "i32 uniform"):
    gid = get_global_id(0)
    if gid < nq:
        best = 1000000.0
        bi = 0
        for p in range(npoints):
            dd = dist2(features, query, p, gid, dims)
            if dd < best:
                best = dd
                bi = p
        out_idx[gid] = bi


@opencl.kernel
def stencil(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    row = gid // n
    col = gid - row * n
    if row > 0 and row < n - 1 and col > 0 and col < n - 1:
        y[gid] = 0.2 * (x[gid] + x[gid - 1] + x[gid + 1]
                        + x[gid - n] + x[gid + n])
    else:
        if gid < n * n:
            y[gid] = x[gid]


@opencl.kernel
def spmv(row_ptr: "ptr_i32 const", cols: "ptr_i32 const",
         vals: "ptr_f32 const", x: "ptr_f32 const", y: "ptr_f32",
         n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        acc = 0.0
        for e in range(row_ptr[gid], row_ptr[gid + 1]):
            acc += vals[e] * x[cols[e]]
        y[gid] = acc


@opencl.kernel
def spmv_csr(row_ptr: "ptr_i32 const", cols: "ptr_i32 const",
             vals: "ptr_f32 const", x: "ptr_f32 const", y: "ptr_f32",
             n: "i32 uniform"):
    # CSR sparse matrix-vector product over a ragged degree
    # distribution: the per-row nonzero loop is RAGGED both within a warp
    # (vx_pred masks lanes out as their rows run dry) and across warps
    # (warps disagree on the loop exit -> vx_pred ride-along), and the
    # grid is many single-warp workgroups (grid-level batching).
    gid = get_global_id(0)
    if gid < n:
        acc = 0.0
        for e in range(row_ptr[gid], row_ptr[gid + 1]):
            acc += vals[e] * x[cols[e]]
        y[gid] = acc


@opencl.kernel
def bfs_frontier(row_ptr: "ptr_i32 const", cols: "ptr_i32 const",
                 frontier: "ptr_i32 const", next_frontier: "ptr_i32",
                 visited: "ptr_i32 const", n: "i32 uniform"):
    # bottom-up BFS step: node u joins the next frontier if it is
    # unvisited and ANY in-neighbor is in the current frontier.  Unlike
    # the top-down `bfs` kernel, every thread writes only its own cell
    # and never reads a buffer the kernel writes, so results and
    # ExecStats are schedule-independent — safe for lockstep batching.
    # The edge scan has a data-dependent early exit (`break`), so warps
    # leave the ragged loop at wildly different trip counts.
    gid = get_global_id(0)
    if gid < n:
        found = 0
        if visited[gid] == 0:
            e = row_ptr[gid]
            end = row_ptr[gid + 1]
            while e < end:
                if frontier[cols[e]] != 0:
                    found = 1
                    break
                e += 1
        next_frontier[gid] = found


@opencl.kernel
def srad_flag(img: "ptr_f32 const", out: "ptr_f32", lam: "f32 uniform",
              mode: "i32 uniform", n: "i32 uniform"):
    # Rodinia-srad-style: a heavy math body selected by a UNIFORM mode
    # flag. With annotation analysis the branch is provably uniform ->
    # one side executes; without it the whole diamond is linearized.
    gid = get_global_id(0)
    if gid < n:
        v = img[gid]
        if mode == 0:
            g = exp(-lam * v * v)
            out[gid] = v * g + 0.25 * sqrt(abs(v))
        else:
            g = log(1.0 + lam * abs(v))
            out[gid] = v - g * 0.5 + 0.125 * v * v


@opencl.kernel
def gc_like(deg: "ptr_i32 const", colors: "ptr_i32", work: "ptr_i32",
            n: "i32 uniform"):
    # graph-coloring-ish: warp 0 of each block does coordinator work
    # (branch on warp_id / num_warps CSRs -> uniform under Uni-HW)
    gid = get_global_id(0)
    lid = get_local_id(0)
    if get_warp_id(0) == 0:
        if lid == 0:
            work[get_group_id(0)] = get_num_warps(0)
    if gid < n:
        d = deg[gid]
        c = 0
        if d > 4:
            c = 2
        else:
            if d > 2:
                c = 1
        colors[gid] = c


@opencl.kernel
def cfd_like(q: "ptr_f32 const", flux: "ptr_f32", n: "i32 uniform"):
    gid = get_global_id(0)
    if gid < n:
        v = q[gid]
        f = 0.0
        # deep data-dependent control dependence (cfd's CDG depth)
        if v > 0.0:
            if v > 1.0:
                f = v * v
            else:
                f = v * 0.5
            f = f + 1.0
        else:
            if v < -1.0:
                f = -v * v
            else:
                f = v * -0.5
            f = f - 1.0
        if f > 0.0:
            if f > 2.0:
                f = f * 0.25
            f = f + v
        flux[gid] = f


# ==========================================================================
# CUDA kernels (Case Study 1)
# ==========================================================================

@cuda.kernel
def vote_hw(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = blockIdx.x * blockDim.x + threadIdx.x
    v = x[gid] if gid < n else 0.0
    if __any_sync(-1, v > 2.0):       # vx_vote: result is warp-uniform
        if gid < n:
            y[gid] = v * 2.0
    else:
        if gid < n:
            y[gid] = v


@cuda.kernel
def vote_sw(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    flag = __shared__(i32, 1)
    if threadIdx.x == 0:
        flag[0] = 0
    __syncthreads()
    gid = blockIdx.x * blockDim.x + threadIdx.x
    v = x[gid] if gid < n else 0.0
    if v > 2.0:
        atomicMax(flag, 0, 1)
    __syncthreads()
    if flag[0] != 0:
        if gid < n:
            y[gid] = v * 2.0
    else:
        if gid < n:
            y[gid] = v


@cuda.kernel
def shuffle_hw(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    gid = blockIdx.x * blockDim.x + threadIdx.x
    lane = __lane_id()
    v = x[gid] if gid < n else 0.0
    off = 16
    while off > 0:
        v += __shfl_sync(-1, v, lane ^ off)
        off = off // 2
    if lane == 0:
        y[blockIdx.x] = v


@cuda.kernel
def shuffle_sw(x: "ptr_f32 const", y: "ptr_f32", n: "i32 uniform"):
    tmp = __shared__(f32, 32)
    gid = blockIdx.x * blockDim.x + threadIdx.x
    lid = threadIdx.x
    tmp[lid] = x[gid] if gid < n else 0.0
    __syncthreads()
    s = 16
    while s > 0:
        if lid < s:
            tmp[lid] = tmp[lid] + tmp[lid + s]
        __syncthreads()
        s = s // 2
    if lid == 0:
        y[blockIdx.x] = tmp[0]


@cuda.kernel
def bscan_hw(x: "ptr_f32 const", y: "ptr_i32", n: "i32 uniform"):
    gid = blockIdx.x * blockDim.x + threadIdx.x
    lane = __lane_id()
    p = 1 if (gid < n and x[gid] > 0.0) else 0
    b = __ballot_sync(-1, p)
    m = (1 << lane) - 1
    if gid < n:
        y[gid] = __popc(b & m)


@cuda.kernel
def atomic_naive(x: "ptr_f32 const", counter: "ptr_i32", n: "i32 uniform"):
    gid = blockIdx.x * blockDim.x + threadIdx.x
    if gid < n:
        if x[gid] > 0.0:
            atomicAdd(counter, 0, 1)


@cuda.kernel
def atomic_agg(x: "ptr_f32 const", counter: "ptr_i32", n: "i32 uniform"):
    # warp-aggregated atomics (HeCBench atomic-aggregate): one lane issues
    # a single RMW for the whole warp — vx_vote + vx_popc + vx_ffs
    gid = blockIdx.x * blockDim.x + threadIdx.x
    lane = __lane_id()
    p = 1 if (gid < n and x[gid] > 0.0) else 0
    b = __ballot_sync(-1, p)
    if p != 0 and lane == __ffs(b) - 1:
        atomicAdd(counter, 0, __popc(b))


# ==========================================================================
# Bench registry: inputs + numpy references
# ==========================================================================

@dataclass
class Bench:
    name: str
    handle: Any
    make: Callable[[np.random.Generator], Tuple[Dict[str, np.ndarray],
                                                Dict[str, Any],
                                                LaunchParams]]
    ref: Callable[[Dict[str, np.ndarray], Dict[str, Any]],
                  Dict[str, np.ndarray]]
    atol: float = 1e-4
    uses_shared: bool = False
    check_bufs: Optional[Tuple[str, ...]] = None


def _params(grid: int) -> LaunchParams:
    return LaunchParams(grid=grid, local_size=32, warp_size=32)


def _mk_vecadd(rng):
    n = 200
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    y = rng.standard_normal(g * 32).astype(np.float32)
    z = np.zeros(g * 32, np.float32)
    return {"x": x, "y": y, "z": z}, {"n": n}, _params(g)


def _ref_vecadd(bufs, sc):
    out = dict(bufs)
    n = sc["n"]
    z = bufs["z"].copy()
    z[:n] = bufs["x"][:n] + bufs["y"][:n]
    out["z"] = z
    return out


def _mk_saxpy(rng):
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    y = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "y": y}, {"a": 2.5, "n": 250}, _params(g)


def _ref_saxpy(bufs, sc):
    out = dict(bufs)
    y = bufs["y"].copy()
    n = sc["n"]
    y[:n] = sc["a"] * bufs["x"][:n] + bufs["y"][:n]
    out["y"] = y
    return out


def _mk_dot(rng):
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    y = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "y": y, "out": np.zeros(1, np.float32)}, {"n": 230}, \
        _params(g)


def _ref_dot(bufs, sc):
    n = sc["n"]
    return {**bufs, "out": np.array(
        [np.dot(bufs["x"][:n], bufs["y"][:n])], np.float32)}


def _mk_transpose(rng):
    n = 14
    g = 8   # 256 threads > 196
    x = rng.standard_normal(n * n).astype(np.float32)
    return {"x": x, "y": np.zeros(g * 32, np.float32)}, {"n": n}, _params(g)


def _ref_transpose(bufs, sc):
    n = sc["n"]
    y = bufs["y"].copy()
    xm = bufs["x"][:n * n].reshape(n, n)
    y[:n * n] = xm.T.reshape(-1)
    return {**bufs, "y": y}


def _mk_reduce0(rng):
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "out": np.zeros(g, np.float32)}, {"n": 230}, _params(g)


def _ref_reduce0(bufs, sc):
    n = sc["n"]
    xm = bufs["x"].copy()
    xm[n:] = 0
    return {**bufs, "out": xm.reshape(8, 32).sum(1).astype(np.float32)}


def _mk_psum(rng):
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "y": np.zeros(g * 32, np.float32)}, {"n": 250}, _params(g)


def _ref_psum(bufs, sc):
    n = sc["n"]
    xm = bufs["x"].copy()
    xm[n:] = 0
    ps = np.cumsum(xm.reshape(8, 32), axis=1).reshape(-1).astype(np.float32)
    y = bufs["y"].copy()
    y[:n] = ps[:n]
    return {**bufs, "y": y}


def _mk_psort(rng):
    g = 4
    n = 100
    x = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "y": np.zeros(g * 32, np.float32)}, {"n": n}, _params(g)


def _ref_psort(bufs, sc):
    n = sc["n"]
    y = bufs["y"].copy()
    y[:n] = np.sort(bufs["x"][:n])
    return {**bufs, "y": y}


def _mk_sfilter(rng):
    g = 8
    n = g * 32
    x = rng.standard_normal(n).astype(np.float32)
    # piecewise-constant region flags (warp-uniform in practice)
    w = np.repeat(rng.uniform(0, 1, g).astype(np.float32), 32)
    return {"x": x, "y": np.zeros(n, np.float32), "w": w}, {"n": n}, \
        _params(g)


def _ref_sfilter(bufs, sc):
    n = sc["n"]
    x, w = bufs["x"], bufs["w"]
    y = np.zeros_like(x)
    for i in range(n):
        left = x[i - 1] if i > 0 else 0.0
        right = x[i + 1] if i < n - 1 else 0.0
        pick = left if w[i] > 0.5 else right
        y[i] = 0.5 * x[i] + 0.5 * pick
    return {**bufs, "y": y}


def _mk_sgemm(rng):
    m = n = 16
    k = 8
    g = 8
    a = rng.standard_normal(m * k).astype(np.float32)
    b = rng.standard_normal(k * n).astype(np.float32)
    return {"a": a, "b": b, "c": np.zeros(g * 32, np.float32)}, \
        {"m": m, "n": n, "k": k}, _params(g)


def _ref_sgemm(bufs, sc):
    m, n, k = sc["m"], sc["n"], sc["k"]
    c = bufs["c"].copy()
    c[:m * n] = (bufs["a"].reshape(m, k) @ bufs["b"].reshape(k, n)
                 ).reshape(-1)
    return {**bufs, "c": c}


def _mk_blackscholes(rng):
    g = 8
    n = g * 32
    S = rng.uniform(10, 100, n).astype(np.float32)
    K = rng.uniform(10, 100, n).astype(np.float32)
    T = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return {"S": S, "K": K, "T": T,
            "call": np.zeros(n, np.float32), "put": np.zeros(n, np.float32)}, \
        {"r": 0.05, "v": 0.3, "n": 240}, _params(g)


def _ref_blackscholes(bufs, sc):
    from scipy.stats import norm  # pragma: no cover (no scipy) - fallback
    raise NotImplementedError


def _ref_blackscholes_np(bufs, sc):
    def cnd_np(x):
        k = 1.0 / (1.0 + 0.2316419 * np.abs(x))
        poly = k * (0.31938153 + k * (-0.356563782 + k * (1.781477937
                    + k * (-1.821255978 + k * 1.330274429))))
        w = 1.0 - 0.39894228 * np.exp(-0.5 * x * x) * poly
        return np.where(x > 0, w, 1.0 - w)

    n = sc["n"]
    r, v = sc["r"], sc["v"]
    S, K, T = (bufs[k][:n].astype(np.float64) for k in ("S", "K", "T"))
    srt = v * np.sqrt(T)
    d1 = (np.log(S / K) + (r + 0.5 * v * v) * T) / srt
    d2 = d1 - srt
    c = S * cnd_np(d1) - K * np.exp(-r * T) * cnd_np(d2)
    call = bufs["call"].copy()
    put = bufs["put"].copy()
    call[:n] = c
    put[:n] = c - S + K * np.exp(-r * T)
    return {**bufs, "call": call, "put": put}


def _mk_bfs(rng):
    g = 4
    n = 100
    # random graph, ~4 edges per node
    deg = rng.integers(0, 8, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    cols = rng.integers(0, n, row_ptr[-1]).astype(np.int32)
    frontier = (rng.uniform(0, 1, n) < 0.15).astype(np.int32)
    return {"row_ptr": row_ptr, "cols": cols, "frontier": frontier,
            "next_frontier": np.zeros(n, np.int32),
            "visited": np.zeros(n, np.int32)}, {"n": n}, _params(g)


def _ref_bfs(bufs, sc):
    n = sc["n"]
    nf = bufs["next_frontier"].copy()
    vis = bufs["visited"].copy()
    for u in range(n):
        if bufs["frontier"][u]:
            for e in range(bufs["row_ptr"][u], bufs["row_ptr"][u + 1]):
                c = bufs["cols"][e]
                if vis[c] == 0:
                    vis[c] = 1
                    nf[c] = 1
    return {**bufs, "next_frontier": nf, "visited": vis}


def _mk_pathfinder(rng):
    g = 8
    n = g * 32
    src = rng.uniform(0, 10, n).astype(np.float32)
    wall = rng.uniform(0, 5, n).astype(np.float32)
    return {"src": src, "wall": wall, "dst": np.zeros(n, np.float32)}, \
        {"n": n}, _params(g)


def _ref_pathfinder(bufs, sc):
    n = sc["n"]
    src, wall = bufs["src"], bufs["wall"]
    dst = np.zeros_like(src)
    for i in range(n):
        left = src[i - 1] if i > 0 else 1e6
        right = src[i + 1] if i < n - 1 else 1e6
        dst[i] = wall[i] + min(min(left, right), src[i])
    return {**bufs, "dst": dst}


def _mk_kmeans(rng):
    g = 4
    npoints = 100
    k, dims = 5, 4
    feats = rng.standard_normal(npoints * dims).astype(np.float32)
    cents = rng.standard_normal(k * dims).astype(np.float32)
    return {"features": feats, "centroids": cents,
            "assign": np.zeros(g * 32, np.int32)}, \
        {"npoints": npoints, "k": k, "dims": dims}, _params(g)


def _ref_kmeans(bufs, sc):
    npoints, k, dims = sc["npoints"], sc["k"], sc["dims"]
    f = bufs["features"].reshape(npoints, dims)
    c = bufs["centroids"].reshape(k, dims)
    d = ((f[:, None] - c[None]) ** 2).sum(-1)
    a = bufs["assign"].copy()
    a[:npoints] = d.argmin(1)
    return {**bufs, "assign": a}


def _mk_nearn(rng):
    g = 2
    npoints, dims, nq = 60, 4, 40
    feats = rng.standard_normal(npoints * dims).astype(np.float32)
    q = rng.standard_normal(nq * dims + (64 - nq) * dims).astype(np.float32)
    return {"features": feats, "query": q,
            "out_idx": np.zeros(g * 32, np.int32)}, \
        {"npoints": npoints, "dims": dims, "nq": nq}, _params(g)


def _ref_nearn(bufs, sc):
    npoints, dims, nq = sc["npoints"], sc["dims"], sc["nq"]
    f = bufs["features"].reshape(npoints, dims)
    q = bufs["query"][:nq * dims].reshape(nq, dims)
    # kernel computes dist2(features, query, p, gid, dims):
    #   sum_d (features[p*dims+d] - query[gid*dims+d])^2
    d = ((f[:, None] - q[None]) ** 2).sum(-1)      # (npoints, nq)
    out = bufs["out_idx"].copy()
    out[:nq] = d.argmin(0)
    return {**bufs, "out_idx": out}


def _mk_stencil(rng):
    n = 14
    g = 8
    x = rng.standard_normal(g * 32).astype(np.float32)
    return {"x": x, "y": np.zeros(g * 32, np.float32)}, {"n": n}, _params(g)


def _ref_stencil(bufs, sc):
    n = sc["n"]
    x = bufs["x"]
    y = bufs["y"].copy()
    for gid in range(len(x)):
        row, col = gid // n, gid % n
        if 0 < row < n - 1 and 0 < col < n - 1:
            y[gid] = 0.2 * (x[gid] + x[gid - 1] + x[gid + 1]
                            + x[gid - n] + x[gid + n])
        elif gid < n * n:
            y[gid] = x[gid]
    return {**bufs, "y": y}


def _mk_spmv(rng):
    g = 4
    n = 100
    deg = rng.integers(0, 12, n)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    nnz = int(row_ptr[-1])
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return {"row_ptr": row_ptr, "cols": cols, "vals": vals, "x": x,
            "y": np.zeros(g * 32, np.float32)}, {"n": n}, _params(g)


def _ref_spmv(bufs, sc):
    n = sc["n"]
    y = bufs["y"].copy()
    for i in range(n):
        lo, hi = bufs["row_ptr"][i], bufs["row_ptr"][i + 1]
        y[i] = (bufs["vals"][lo:hi]
                * bufs["x"][bufs["cols"][lo:hi]]).sum()
    return {**bufs, "y": y}


def _ragged_csr(rng, n: int, base_deg: int = 16,
                max_deg: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged-degree CSR skeleton: uniformly scattered short rows, a few
    heavy rows, and empty rows — trip counts diverge within warps (lanes
    drop out of the vx_pred loop) AND across warps (warps disagree on the
    loop exit), without a single pathological row dominating the walk."""
    deg = rng.integers(0, base_deg, n)
    hot = rng.uniform(0, 1, n) < 0.05
    deg[hot] = rng.integers(base_deg, max_deg + 1, int(hot.sum()))
    deg[rng.uniform(0, 1, n) < 0.15] = 0          # empty rows too
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    cols = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, cols


def _mk_spmv_csr(rng):
    g = 16
    n = g * 32
    row_ptr, cols = _ragged_csr(rng, n)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return {"row_ptr": row_ptr, "cols": cols, "vals": vals, "x": x,
            "y": np.zeros(n, np.float32)}, {"n": n}, _params(g)


def _ref_spmv_csr(bufs, sc):
    n = sc["n"]
    y = bufs["y"].copy()
    for i in range(n):
        lo, hi = bufs["row_ptr"][i], bufs["row_ptr"][i + 1]
        y[i] = (bufs["vals"][lo:hi]
                * bufs["x"][bufs["cols"][lo:hi]]).sum()
    return {**bufs, "y": y}


def _mk_spmv_tail(rng):
    """Pareto-tail CSR for the ``spmv_tail`` bench: ~99% of rows have at
    most 3 nonzeros (most lanes leave the vx_pred loop almost instantly)
    while under one percent carry hundreds — the whole walk is dominated
    by a handful of workgroups looping long after the rest of the grid
    chunk went empty.  This is the workload row compaction exists for:
    the grid is one FULL 64-workgroup batch chunk, so every surviving
    trip would otherwise pay (64 x 32)-wide batched work on dead rows."""
    g = 64
    n = g * 32
    deg = rng.integers(0, 4, n)
    hot = rng.uniform(0, 1, n) < 0.008
    deg[hot] = rng.integers(250, 400, int(hot.sum()))
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(deg)
    cols = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return {"row_ptr": row_ptr, "cols": cols, "vals": vals, "x": x,
            "y": np.zeros(n, np.float32)}, {"n": n}, _params(g)


def _mk_bfs_frontier(rng):
    g = 16
    n = g * 32
    row_ptr, cols = _ragged_csr(rng, n, base_deg=12, max_deg=32)
    frontier = (rng.uniform(0, 1, n) < 0.1).astype(np.int32)
    visited = (rng.uniform(0, 1, n) < 0.3).astype(np.int32)
    return {"row_ptr": row_ptr, "cols": cols, "frontier": frontier,
            "next_frontier": np.zeros(n, np.int32),
            "visited": visited}, {"n": n}, _params(g)


def _ref_bfs_frontier(bufs, sc):
    n = sc["n"]
    nf = bufs["next_frontier"].copy()
    for u in range(n):
        found = 0
        if bufs["visited"][u] == 0:
            for e in range(bufs["row_ptr"][u], bufs["row_ptr"][u + 1]):
                if bufs["frontier"][bufs["cols"][e]]:
                    found = 1
                    break
        nf[u] = found
    return {**bufs, "next_frontier": nf}


def _mk_srad(rng):
    g = 8
    n = g * 32
    img = rng.standard_normal(n).astype(np.float32)
    return {"img": img, "out": np.zeros(n, np.float32)}, \
        {"lam": 0.5, "mode": 0, "n": 240}, _params(g)


def _ref_srad(bufs, sc):
    n, lam, mode = sc["n"], sc["lam"], sc["mode"]
    v = bufs["img"][:n].astype(np.float64)
    out = bufs["out"].copy()
    if mode == 0:
        g = np.exp(-lam * v * v)
        out[:n] = v * g + 0.25 * np.sqrt(np.abs(v))
    else:
        g = np.log(1.0 + lam * np.abs(v))
        out[:n] = v - g * 0.5 + 0.125 * v * v
    return {**bufs, "out": out}


def _mk_gc(rng):
    g = 8
    n = g * 32
    deg = rng.integers(0, 8, n).astype(np.int32)
    return {"deg": deg, "colors": np.zeros(n, np.int32),
            "work": np.zeros(g, np.int32)}, {"n": n}, _params(g)


def _ref_gc(bufs, sc):
    n = sc["n"]
    d = bufs["deg"][:n]
    colors = bufs["colors"].copy()
    colors[:n] = np.where(d > 4, 2, np.where(d > 2, 1, 0))
    work = np.ones(len(bufs["work"]), np.int32)
    return {**bufs, "colors": colors, "work": work}


def _mk_cfd(rng):
    g = 8
    n = g * 32
    q = (rng.standard_normal(n) * 1.5).astype(np.float32)
    return {"q": q, "flux": np.zeros(n, np.float32)}, {"n": n}, _params(g)


def _ref_cfd(bufs, sc):
    n = sc["n"]
    q = bufs["q"]
    out = np.zeros_like(q)
    for i in range(n):
        v = q[i]
        if v > 0:
            f = v * v if v > 1 else v * 0.5
            f += 1
        else:
            f = -v * v if v < -1 else v * -0.5
            f -= 1
        if f > 0:
            if f > 2:
                f *= 0.25
            f += v
        out[i] = f
    return {**bufs, "flux": out}


# CUDA bench inputs ---------------------------------------------------------

def _mk_vote(rng):
    g = 8
    n = g * 32
    # most warps all-below-threshold: the vote prunes whole warps
    x = rng.uniform(0, 1.0, n).astype(np.float32)
    hot = rng.integers(0, g, 2)
    for h in hot:
        x[h * 32 + 5] = 3.0
    return {"x": x, "y": np.zeros(n, np.float32)}, {"n": n}, _params(g)


def _ref_vote(bufs, sc):
    n = sc["n"]
    x = bufs["x"]
    y = np.zeros_like(x)
    for w in range(len(x) // 32):
        sl = slice(w * 32, (w + 1) * 32)
        if (x[sl] > 2.0).any():
            y[sl] = x[sl] * 2.0
        else:
            y[sl] = x[sl]
    return {**bufs, "y": y}


def _mk_shuffle(rng):
    g = 8
    n = g * 32
    x = rng.standard_normal(n).astype(np.float32)
    return {"x": x, "y": np.zeros(g, np.float32)}, {"n": n}, _params(g)


def _ref_shuffle(bufs, sc):
    x = bufs["x"]
    return {**bufs, "y": x.reshape(-1, 32).sum(1).astype(np.float32)}


def _mk_bscan(rng):
    g = 8
    n = g * 32
    x = rng.standard_normal(n).astype(np.float32)
    return {"x": x, "y": np.zeros(n, np.int32)}, {"n": n}, _params(g)


def _ref_bscan(bufs, sc):
    x = bufs["x"]
    p = (x > 0).reshape(-1, 32)
    ranks = np.zeros_like(p, dtype=np.int32)
    for w in range(p.shape[0]):
        c = 0
        for l in range(32):
            ranks[w, l] = c
            if p[w, l]:
                c += 1
    return {**bufs, "y": ranks.reshape(-1)}


def _mk_atomic(rng):
    g = 8
    n = g * 32
    x = rng.standard_normal(n).astype(np.float32)
    return {"x": x, "counter": np.zeros(1, np.int32)}, {"n": n}, _params(g)


def _ref_atomic(bufs, sc):
    n = sc["n"]
    return {**bufs, "counter": np.array([(bufs["x"][:n] > 0).sum()],
                                        np.int32)}


BENCHES: Dict[str, Bench] = {
    "vecadd": Bench("vecadd", vecadd, _mk_vecadd, _ref_vecadd),
    "saxpy": Bench("saxpy", saxpy, _mk_saxpy, _ref_saxpy),
    "dotproduct": Bench("dotproduct", dotproduct, _mk_dot, _ref_dot,
                        atol=1e-2),
    "transpose": Bench("transpose", transpose, _mk_transpose,
                       _ref_transpose),
    "reduce0": Bench("reduce0", reduce0, _mk_reduce0, _ref_reduce0,
                     atol=1e-3, uses_shared=True),
    "psum": Bench("psum", psum, _mk_psum, _ref_psum, atol=1e-3,
                  uses_shared=True),
    "psort": Bench("psort", psort, _mk_psort, _ref_psort),
    "sfilter": Bench("sfilter", sfilter, _mk_sfilter, _ref_sfilter),
    "sgemm": Bench("sgemm", sgemm, _mk_sgemm, _ref_sgemm, atol=1e-3),
    "blackscholes": Bench("blackscholes", blackscholes, _mk_blackscholes,
                          _ref_blackscholes_np, atol=5e-2),
    "bfs": Bench("bfs", bfs, _mk_bfs, _ref_bfs),
    "pathfinder": Bench("pathfinder", pathfinder, _mk_pathfinder,
                        _ref_pathfinder),
    "kmeans": Bench("kmeans", kmeans, _mk_kmeans, _ref_kmeans),
    "nearn": Bench("nearn", nearn, _mk_nearn, _ref_nearn),
    "stencil": Bench("stencil", stencil, _mk_stencil, _ref_stencil),
    "spmv": Bench("spmv", spmv, _mk_spmv, _ref_spmv, atol=1e-3),
    "spmv_csr": Bench("spmv_csr", spmv_csr, _mk_spmv_csr, _ref_spmv_csr,
                      atol=1e-3),
    # same kernel, pareto-tail degree distribution (row compaction target)
    "spmv_tail": Bench("spmv_tail", spmv_csr, _mk_spmv_tail,
                       _ref_spmv_csr, atol=1e-3),
    "bfs_frontier": Bench("bfs_frontier", bfs_frontier, _mk_bfs_frontier,
                          _ref_bfs_frontier),
    "cfd_like": Bench("cfd_like", cfd_like, _mk_cfd, _ref_cfd),
    "srad_flag": Bench("srad_flag", srad_flag, _mk_srad, _ref_srad,
                       atol=1e-3),
    "gc_like": Bench("gc_like", gc_like, _mk_gc, _ref_gc),
    # CUDA (Case Study 1)
    "vote_hw": Bench("vote_hw", vote_hw, _mk_vote, _ref_vote,
                     uses_shared=False),
    "vote_sw": Bench("vote_sw", vote_sw, _mk_vote, _ref_vote,
                     uses_shared=True),
    "shuffle_hw": Bench("shuffle_hw", shuffle_hw, _mk_shuffle, _ref_shuffle,
                        atol=1e-3),
    "shuffle_sw": Bench("shuffle_sw", shuffle_sw, _mk_shuffle, _ref_shuffle,
                        atol=1e-3, uses_shared=True),
    "bscan_hw": Bench("bscan_hw", bscan_hw, _mk_bscan, _ref_bscan),
    "atomic_naive": Bench("atomic_naive", atomic_naive, _mk_atomic,
                          _ref_atomic),
    "atomic_agg": Bench("atomic_agg", atomic_agg, _mk_atomic, _ref_atomic),
}


def get_bench(name: str) -> Bench:
    return BENCHES[name]
