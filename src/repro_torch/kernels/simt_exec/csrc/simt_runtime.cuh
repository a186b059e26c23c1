// Runtime helpers for the VIR kernels that codegen.py emits.
//
// One CUDA thread runs one SIMT lane and one CTA runs one workgroup. The
// helpers reproduce the reference lowering's arithmetic (jnp on int32 and
// float32), which differs from plain C in the places noted below.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

// ---------------------------------------------------------------------------
// int32 arithmetic: two's-complement wraparound (signed overflow is
// undefined in C, it wraps in XLA)
// ---------------------------------------------------------------------------
__device__ __forceinline__ int vx_iadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int vx_isub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int vx_imul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int vx_ineg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int vx_iabs(int a) { return a < 0 ? vx_ineg(a) : a; }

// floor division and modulo (jnp `//` and `%`); a zero divisor gives 0.
// C `/` and `%` truncate toward zero instead.
__device__ __forceinline__ int vx_idiv(int a, int b) {
  if (b == 0) return 0;
  if (b == -1) return vx_ineg(a);  // INT_MIN / -1 wraps
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int vx_imod(int a, int b) {
  if (b == 0 || b == -1) return 0;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ float vx_fdiv(float a, float b) {
  return b != 0.0f ? a / b : 0.0f;
}
__device__ __forceinline__ float vx_fmod(float a, float b) {
  if (b == 0.0f) return 0.0f;
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

// shifts follow XLA: a count outside [0, 32) shifts everything out
// (left: 0; arithmetic right: the sign fills)
__device__ __forceinline__ int vx_shl(int a, int b) {
  return ((unsigned)b >= 32u) ? 0 : (int)((unsigned)a << b);
}
__device__ __forceinline__ int vx_shr(int a, int b) {
  return ((unsigned)b >= 32u) ? (a < 0 ? -1 : 0) : (a >> b);
}

// float min/max propagate NaN (jnp.minimum), fminf/fmaxf drop it
__device__ __forceinline__ float vx_fmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float vx_fmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ---------------------------------------------------------------------------
// SIMT intrinsics: the 1-D table of the tiled kernel (reference
// simt_exec.py:77-96). One CTA is one workgroup of LS lanes; the y
// dimension is 1 (local_id 1 = 0), and core_id is group_id % 4.
// ---------------------------------------------------------------------------
template <int LS>
__device__ __forceinline__ int vx_local_id() { return (int)threadIdx.x % LS; }
template <int WS>
__device__ __forceinline__ int vx_lane_id() { return (int)threadIdx.x % WS; }
template <int WS>
__device__ __forceinline__ int vx_warp_id() { return (int)threadIdx.x / WS; }
__device__ __forceinline__ int vx_group_id() { return (int)blockIdx.x; }
__device__ __forceinline__ int vx_num_groups() { return (int)gridDim.x; }
__device__ __forceinline__ int vx_core_id() { return (int)blockIdx.x % 4; }
template <int LS>
__device__ __forceinline__ int vx_global_id() {
  return vx_iadd(vx_imul((int)blockIdx.x, LS), vx_local_id<LS>());
}
template <int LS>
__device__ __forceinline__ int vx_global_size() {
  return vx_imul((int)gridDim.x, LS);
}

// ---------------------------------------------------------------------------
// unary ops
// ---------------------------------------------------------------------------
__device__ __forceinline__ float vx_sqrt(float a) { return sqrtf(vx_fmax(a, 0.0f)); }
__device__ __forceinline__ float vx_log(float a) { return logf(a > 0.0f ? a : 1.0f); }
__device__ __forceinline__ float vx_itof(int a) { return __int2float_rn(a); }
// truncating, saturating, NaN -> 0 (XLA's float -> int32 convert)
__device__ __forceinline__ int vx_ftoi(float a) { return __float2int_rz(a); }
__device__ __forceinline__ int vx_popc(int a) { return __popc((unsigned)a); }
// 1-based index of the lowest set bit, 0 for 0
__device__ __forceinline__ int vx_ffs(int a) { return __ffs(a); }

// ---------------------------------------------------------------------------
// tile windows. A load clamps its index into the window (it never drops:
// x[gid-1] at a tile's first lane reads the tile's first element); a store
// drops inactive lanes and lanes outside the window.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T vx_load(const T* tile, int ix, int len) {
  ix = ix < 0 ? 0 : (ix > len - 1 ? len - 1 : ix);
  return tile[ix];
}
template <typename T>
__device__ __forceinline__ void vx_store(T* tile, int ix, int len, bool m, T v) {
  if (m && ix >= 0 && ix < len) tile[ix] = v;
}

// ---------------------------------------------------------------------------
// collectives, workgroup-wide (one CTA). Every thread reaches each call:
// the emitted code is lockstep-predicated, so control flow is uniform.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool vx_vote_any(bool v, bool m) {
  return __syncthreads_or(v && m) != 0;
}
__device__ __forceinline__ bool vx_vote_all(bool v, bool m) {
  return __syncthreads_and(v || !m) != 0;
}
// bit k set for each active lane k whose value is true (W <= 32: the CTA
// is one warp and the lane is threadIdx.x)
template <int W>
__device__ __forceinline__ int vx_ballot(bool v, bool m) {
  static_assert(W <= 32, "ballot needs a workgroup of at most 32 lanes");
  const unsigned full = W == 32 ? 0xffffffffu : ((1u << W) - 1u);
  return (int)__ballot_sync(full, v && m);
}
// v of lane src mod W, staged through shared memory between two barriers
template <int W>
__device__ __forceinline__ int vx_shfl_i(int v, int src, int* stage) {
  __syncthreads();
  stage[threadIdx.x] = v;
  __syncthreads();
  return stage[vx_imod(src, W)];
}
template <int W>
__device__ __forceinline__ float vx_shfl_f(float v, int src, int* stage) {
  return __int_as_float(vx_shfl_i<W>(__float_as_int(v), src, stage));
}
