// The SwiGLU pass of the grouped expert FF's gradient. Over the (E, C)
// rows of an expert FF, from the up product gu = x @ wi (the gate g in
// columns [0, f), the up part u in [f, 2f)) and dh = dy @ wo^T, in float32:
//
//   s   = sigmoid(g),  silu(g) = g * s,  silu'(g) = s * (1 + g * (1 - s))
//   dgu = [dh * u * silu'(g), dh * silu(g)]     (E, C, 2f), gu's type
//   h   = silu(g) * u                           (E, C, f),  gu's type
//
// Rows at or past counts[e] (where counts is given) are written as zeros
// and not read: the forward took them as zero rows of x, so they get no
// gradient whatever x holds there.
//
// No TPU kernel stands behind it: the reference differentiates the
// einsums of repro/models/moe.py:moe_ff with jax.grad, and its Pallas
// grouped_expert_ff (repro/kernels/moe_dispatch/moe_dispatch.py) has no
// custom_vjp. The five products of the backward (gu again, dh, dwo =
// h^T dy, dwi = x^T dgu, dx = dgu wi^T) are plain batched products
// outside any kernel, as XLA does them for the reference; this is the
// elementwise pass between them.
//
// Bound: bytes. A live row reads g, u and dh and writes dgu and h, 6f
// elements, for about 20 operations an element of h. One CTA of 128
// threads takes a row at a time (rows blockIdx.x, blockIdx.x + gridDim.x,
// ...), neighbouring threads on neighbouring 16-byte vectors (8 bf16 or 4
// float32) where f is a whole number of vectors and every pointer is on
// 16 bytes; one element a thread otherwise. No shared memory, no
// reduction: each output element is written once by one thread.
//
// The float32 instantiation compiles with g++ against the stand-in
// runtime in tests/cuda_host, which runs it on the CPU.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
#include "vec16.cuh"

#ifndef VX_LAUNCH
#define VX_LAUNCH(K, G, B, S, ...) \
  K<<<(G), (B), 0, (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxGrid = 1 << 20;

__device__ __forceinline__ void swiglu_grad(float g, float u, float dh,
                                            float& dg, float& du,
                                            float& h) {
  const float s = 1.f / (1.f + expf(-g));
  const float silu = g * s;
  h = silu * u;
  du = dh * silu;
  dg = dh * u * (s * (1.f + g * (1.f - s)));
}

__device__ __forceinline__ bool live_row(const int* counts, long long r,
                                         int C) {
  return counts == nullptr || (int)(r % C) < counts[r / C];
}

// 16-byte vectors: f a multiple of 16 / sizeof(T), pointers on 16 bytes
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_vec(const T* __restrict__ gu, const T* __restrict__ dh,
               const int* __restrict__ counts, T* __restrict__ dgu,
               T* __restrict__ h, long long rows, int C, int f) {
  constexpr int V = 16 / sizeof(T);
  const int nv = f / V;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const bool live = live_row(counts, r, C);
    const T* g_row = gu + r * 2 * f;
    const T* dh_row = dh + r * f;
    T* dg_row = dgu + r * 2 * f;
    T* h_row = h + r * f;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      const int j = v * V;
      uint4 og{0u, 0u, 0u, 0u}, ou{0u, 0u, 0u, 0u}, oh{0u, 0u, 0u, 0u};
      if (live) {
        float g[V], u[V], d[V], dg[V], du[V], hv[V];
        unpack(*reinterpret_cast<const uint4*>(g_row + j), g, g_row);
        unpack(*reinterpret_cast<const uint4*>(g_row + f + j), u, g_row);
        unpack(*reinterpret_cast<const uint4*>(dh_row + j), d, g_row);
#pragma unroll
        for (int i = 0; i < V; ++i) swiglu_grad(g[i], u[i], d[i], dg[i],
                                                du[i], hv[i]);
        og = pack(dg, g_row);
        ou = pack(du, g_row);
        oh = pack(hv, g_row);
      }
      *reinterpret_cast<uint4*>(dg_row + j) = og;
      *reinterpret_cast<uint4*>(dg_row + f + j) = ou;
      *reinterpret_cast<uint4*>(h_row + j) = oh;
    }
  }
}

// one element a thread: any f, any alignment
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_rows(const T* __restrict__ gu, const T* __restrict__ dh,
                const int* __restrict__ counts, T* __restrict__ dgu,
                T* __restrict__ h, long long rows, int C, int f) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const bool live = live_row(counts, r, C);
    for (int j = threadIdx.x; j < f; j += kThreads) {
      float dg = 0.f, du = 0.f, hv = 0.f;
      if (live)
        swiglu_grad(to_f32(gu[r * 2 * f + j]), to_f32(gu[r * 2 * f + f + j]),
                    to_f32(dh[r * f + j]), dg, du, hv);
      store_f32(dg, dgu + r * 2 * f + j);
      store_f32(du, dgu + r * 2 * f + f + j);
      store_f32(hv, h + r * f + j);
    }
  }
}

template <typename T>
int launch(const void* gu, const void* dh, const void* counts, void* dgu,
           void* h, int E, int C, int f, void* stream) {
  const long long rows = (long long)E * C;
  if (rows <= 0 || f <= 0) return 0;
  const int grid = (int)(rows < kMaxGrid ? rows : kMaxGrid);
  constexpr int V = 16 / sizeof(T);
  if (f % V == 0 && ((uintptr_t)gu | (uintptr_t)dh | (uintptr_t)dgu |
                     (uintptr_t)h) % 16 == 0) {
    auto k = swiglu_bwd_vec<T>;
    VX_LAUNCH(k, grid, kThreads, stream, (const T*)gu, (const T*)dh,
              (const int*)counts, (T*)dgu, (T*)h, rows, C, f);
  } else {
    auto k = swiglu_bwd_rows<T>;
    VX_LAUNCH(k, grid, kThreads, stream, (const T*)gu, (const T*)dh,
              (const int*)counts, (T*)dgu, (T*)h, rows, C, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// gu: (E, C, 2f), dh: (E, C, f); dgu: (E, C, 2f), h: (E, C, f), all
// contiguous, of one type; counts: (E,) int32 or null (every row live).
extern "C" int swiglu_bwd_f32(const void* gu, const void* dh,
                              const void* counts, void* dgu, void* h, int E,
                              int C, int f, void* stream) {
  return launch<float>(gu, dh, counts, dgu, h, E, C, f, stream);
}

#ifdef __CUDACC__
extern "C" int swiglu_bwd_bf16(const void* gu, const void* dh,
                               const void* counts, void* dgu, void* h, int E,
                               int C, int f, void* stream) {
  return launch<__nv_bfloat16>(gu, dh, counts, dgu, h, E, C, f, stream);
}
#endif
