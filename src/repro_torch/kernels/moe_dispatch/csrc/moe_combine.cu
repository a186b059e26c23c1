// The MoE layer's combine as a gather: for every token t,
//
//   out[t, :] = sum over j = 0, 1, ..., k-1 of src[slots[t, j], :]
//
// in float32, in that order (the token's gate rank), stored in src's
// type; a slot at or past M (an assignment the capacity dropped) adds
// nothing. src holds the M = E * C capacity slots of the expert FF's
// output, each already scaled by its gate weight; slots is the inverse of
// the dispatch table (models/moe.py:dispatch). The same gather sums
// the dispatch's gradient (each slot's dx back to its token).
//
// No TPU kernel stands behind it: the reference combines with a
// scatter-add (repro/models/moe.py:moe_ff, `.at[table].add`), which torch
// would run as index_add_, with float atomics in any order on the card.
// Here each output row is summed by one thread group in one fixed order,
// so two calls give the same bits, and its gradient is a plain gather
// (each slot has one token).
//
// Bound: bytes. The live slots' rows are read once and out written once.
// One CTA of 128 threads takes a token at a time (tokens blockIdx.x,
// blockIdx.x + gridDim.x, ...), neighbouring threads on neighbouring
// 16-byte vectors of the row where d is a whole number of them and the
// pointers are on 16 bytes; one element a thread otherwise.
//
// The float32 instantiation compiles with g++ against the stand-in
// runtime in tests/cuda_host, which runs it on the CPU.
#include <cuda_runtime.h>
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
constexpr int kMaxGrid = 1 << 20;
constexpr int kMaxK = 64;           // gate ranks a token may have

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_sum_vec(const T* __restrict__ src, const int* __restrict__ slots,
               T* __restrict__ out, int n_tok, int k, int M, int d) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V;
  for (int t = blockIdx.x; t < n_tok; t += gridDim.x) {
    const int* st = slots + (long long)t * k;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int j = 0; j < k; ++j) {
        const int s = st[j];
        if (s < 0 || s >= M) continue;
        const T* row = src + (long long)s * d + v * V;
        float x[V];
        unpack(*reinterpret_cast<const uint4*>(row), x, row);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += x[i];
      }
      T* o = out + (long long)t * d + v * V;
      *reinterpret_cast<uint4*>(o) = pack(acc, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_sum_rows(const T* __restrict__ src, const int* __restrict__ slots,
                T* __restrict__ out, int n_tok, int k, int M, int d) {
  for (int t = blockIdx.x; t < n_tok; t += gridDim.x) {
    const int* st = slots + (long long)t * k;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) {
        const int s = st[j];
        if (s >= 0 && s < M) acc += to_f32(src[(long long)s * d + c]);
      }
      store_f32(acc, out + (long long)t * d + c);
    }
  }
}

template <typename T>
int launch(const void* src, const void* slots, void* out, int n_tok, int k,
           int M, int d, void* stream) {
  if (k < 1 || k > kMaxK || d < 1) return 1;   // cudaErrorInvalidValue
  if (n_tok <= 0) return 0;
  const int grid = n_tok < kMaxGrid ? n_tok : kMaxGrid;
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && ((uintptr_t)src | (uintptr_t)out) % 16 == 0) {
    auto kern = gather_sum_vec<T>;
    VX_LAUNCH(kern, grid, kThreads, stream, (const T*)src,
              (const int*)slots, (T*)out, n_tok, k, M, d);
  } else {
    auto kern = gather_sum_rows<T>;
    VX_LAUNCH(kern, grid, kThreads, stream, (const T*)src,
              (const int*)slots, (T*)out, n_tok, k, M, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src: (M, d), out: (n_tok, d), contiguous, of one type; slots: (n_tok, k)
// int32, contiguous, each a row of src or any value outside [0, M) for
// none; 1 <= k <= 64.
extern "C" int gather_sum_f32(const void* src, const void* slots, void* out,
                              int n_tok, int k, int M, int d, void* stream) {
  return launch<float>(src, slots, out, n_tok, k, M, d, stream);
}

#ifdef __CUDACC__
extern "C" int gather_sum_bf16(const void* src, const void* slots, void* out,
                               int n_tok, int k, int M, int d, void* stream) {
  return launch<__nv_bfloat16>(src, slots, out, n_tok, k, M, d, stream);
}
#endif
