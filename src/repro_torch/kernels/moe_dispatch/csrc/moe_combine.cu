// The MoE layer's combine as a gather: for every token t,
//
//   out[t, :] = sum over j = 0, 1, ..., k-1 of w[s_j] * src[s_j, :],
//   s_j = slots[t, j],
//
// in float32, in that order (the token's gate rank), each product
// rounded to float32 on its own (__fmul_rn, never fused into the sum),
// stored once in out's type; w is 1 and no product is taken where no
// weights are given. A slot outside [0, M) (an assignment the capacity
// dropped) adds nothing. For the combine, src holds the M = E * C
// capacity slots of the expert FF's output in its own type (bf16 on the
// paths) and w their gate weights; slots is the inverse of the dispatch
// table (models/moe.py:dispatch). Unweighted, the same gather sums the
// dispatch's gradient (each slot's dx back to its token).
//
// No TPU kernel stands behind it: the reference combines with a
// scatter-add (repro/models/moe.py:moe_ff, `.at[table].add`), which torch
// would run as index_add_, with float atomics in any order on the card.
// Here each output element is summed by one thread in one fixed order,
// so two calls give the same bits, and its gradient is a plain gather
// (each slot has one token).
//
// Bound: bytes. The kept slots' rows are read once, in their own type,
// and out written once; the weights and slots are a few bytes a row. The
// weighting and both casts live here, so no float32 copy of the E * C
// slots (free ones too) is written and read again. A thread takes one
// 16-byte vector of a token's row (8 bf16 or 4 float32): neighbouring
// threads on neighbouring vectors, a 256-thread CTA on one token's row
// of 2,048 bf16 or on several narrower ones, and as many CTAs as the
// (token, vector) pairs need, up to 2^20, so the card is full. The
// thread reads a chunk of up to kChunk of the token's slots, then their
// weights and row vectors, all issued before the first is summed (8 x 16
// bytes in flight a thread at top-8), then sums them in gate-rank order.
// Where d is not a whole number of vectors or a pointer is not on 16
// bytes, a thread takes one element.
//
// The float32 instantiations compile with g++ against the stand-in
// runtime in tests/cuda_host, which runs them on the CPU.
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

constexpr int kThreads = 256;
constexpr int kMaxGrid = 1 << 20;
constexpr int kMaxK = 64;           // gate ranks a token may have
constexpr int kChunk = 8;           // slots whose loads are issued together

// V float32 sums stored as V elements of O, 16 bytes at a time
template <int V, typename O>
__device__ __forceinline__ void store_vec(const float* acc, O* o) {
  constexpr int per = 16 / (int)sizeof(O);
#pragma unroll
  for (int q = 0; q < V / per; ++q)
    reinterpret_cast<uint4*>(o)[q] = pack(acc + q * per, o);
}

template <typename T, typename O, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
gather_sum_vec(const T* __restrict__ src, const int* __restrict__ slots,
               const float* __restrict__ w, O* __restrict__ out, int n_tok,
               int k, int M, int d) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V;
  const long long n = (long long)n_tok * nv;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int t = (int)(i / nv), v = (int)(i - (long long)t * nv);
    const int* st = slots + (long long)t * k;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kChunk) {
      int s[kChunk];
      float ws[kChunk];
      uint4 r[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = j0 + j < k ? st[j0 + j] : -1;
        if (s[j] >= M) s[j] = -1;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        r[j] = uint4{};
        ws[j] = 1.f;
        if (s[j] >= 0) {
          r[j] = *reinterpret_cast<const uint4*>(src + (long long)s[j] * d +
                                                 v * V);
          if (kWeighted) ws[j] = w[s[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (s[j] < 0) continue;
        float x[V];
        unpack(r[j], x, src);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] += kWeighted ? __fmul_rn(x[e], ws[j]) : x[e];
      }
    }
    store_vec<V>(acc, out + (long long)t * d + v * V);
  }
}

template <typename T, typename O, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
gather_sum_rows(const T* __restrict__ src, const int* __restrict__ slots,
                const float* __restrict__ w, O* __restrict__ out, int n_tok,
                int k, int M, int d) {
  const long long n = (long long)n_tok * d;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int t = (int)(i / d), c = (int)(i - (long long)t * d);
    const int* st = slots + (long long)t * k;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int s = st[j];
      if (s < 0 || s >= M) continue;
      const float x = to_f32(src[(long long)s * d + c]);
      acc += kWeighted ? __fmul_rn(x, w[s]) : x;
    }
    store_f32(acc, out + i);
  }
}

template <typename T, typename O, bool kWeighted>
void launch_route(bool vec, int grid, const void* src, const void* slots,
                  const void* w, void* out, int n_tok, int k, int M, int d,
                  void* stream) {
  auto kern = vec ? gather_sum_vec<T, O, kWeighted>
                  : gather_sum_rows<T, O, kWeighted>;
  VX_LAUNCH(kern, grid, kThreads, stream, (const T*)src, (const int*)slots,
            (const float*)w, (O*)out, n_tok, k, M, d);
}

template <typename T, typename O>
int launch(const void* src, const void* slots, const void* w, void* out,
           int n_tok, int k, int M, int d, void* stream) {
  if (k < 1 || k > kMaxK || d < 1) return 1;   // cudaErrorInvalidValue
  if (n_tok <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      d % V == 0 && ((uintptr_t)src | (uintptr_t)out) % 16 == 0;
  const long long work = (long long)n_tok * (vec ? d / V : d);
  const long long ctas = (work + kThreads - 1) / kThreads;
  const int grid = ctas < kMaxGrid ? (int)ctas : kMaxGrid;
  if (w != nullptr)
    launch_route<T, O, true>(vec, grid, src, slots, w, out, n_tok, k, M, d,
                             stream);
  else
    launch_route<T, O, false>(vec, grid, src, slots, w, out, n_tok, k, M, d,
                              stream);
  return (int)cudaGetLastError();
}

}  // namespace

// src: (M, d), out: (n_tok, d), contiguous, of one type; slots: (n_tok, k)
// int32, contiguous, each a row of src or any value outside [0, M) for
// none; 1 <= k <= 64. Unweighted.
extern "C" int gather_sum_f32(const void* src, const void* slots, void* out,
                              int n_tok, int k, int M, int d, void* stream) {
  return launch<float, float>(src, slots, nullptr, out, n_tok, k, M, d,
                              stream);
}

// As above, with w: (M,) float32, contiguous, each slot's weight, or null
// for none; out in the type the name's last part gives.
extern "C" int gather_sum_w_f32(const void* src, const void* slots,
                                const void* w, void* out, int n_tok, int k,
                                int M, int d, void* stream) {
  return launch<float, float>(src, slots, w, out, n_tok, k, M, d, stream);
}

#ifdef __CUDACC__
extern "C" int gather_sum_bf16(const void* src, const void* slots, void* out,
                               int n_tok, int k, int M, int d, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(src, slots, nullptr, out,
                                              n_tok, k, M, d, stream);
}

extern "C" int gather_sum_w_bf16(const void* src, const void* slots,
                                 const void* w, void* out, int n_tok, int k,
                                 int M, int d, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(src, slots, w, out, n_tok, k,
                                              M, d, stream);
}

extern "C" int gather_sum_w_bf16_f32(const void* src, const void* slots,
                                     const void* w, void* out, int n_tok,
                                     int k, int M, int d, void* stream) {
  return launch<__nv_bfloat16, float>(src, slots, w, out, n_tok, k, M, d,
                                      stream);
}
#endif
