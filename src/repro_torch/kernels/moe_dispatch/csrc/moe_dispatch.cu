// Grouped SwiGLU expert feed-forward: for every expert e and capacity row,
//   y[e] = (silu(x[e] @ wi[e][:, :f]) * (x[e] @ wi[e][:, f:])) @ wo[e],
// float32 inside, stored in x's type. One CTA per (expert, block of 16
// capacity rows); the row blocks of one expert are adjacent in launch
// order, so the CTAs that run together share that expert's weights in L2.
//
// Replaces repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff
// (the Pallas TPU kernel, grid (E, C / 128), the (128, 2f) hidden tile in
// VMEM). That tile is 1 MB in float32 at olmoe's f = 1024, several times
// what a CTA can hold, so the kernel is thought through again:
//
//   * Phase 1, the gate and up products: the CTA walks the hidden columns
//     in chunks of 256, one column per thread. A thread keeps its
//     column's 16 gate and 16 up sums in registers, reads its two weights
//     of each k from device memory (neighbouring threads on neighbouring
//     columns) and x^T from a 64 x 16 tile staged in shared memory, read
//     as float4 broadcasts. silu(g) * u goes to the hidden tile h, (f, 16)
//     float32 in dynamic shared memory (64 KB at f = 1024). The hidden
//     never goes to device memory.
//   * Phase 2, the down product: one output column per thread, 16 row
//     sums in registers, wo read once per CTA, h read as float4
//     broadcasts.
//
// Any C, d and f: rows past C are zero on the way in and not stored, and
// the column loops are masked. Shared memory is 64 f + 5 KB, so f is at
// most 3552 (the wrapper refuses more).
//
// Bound: at prefill (C = 1280 at olmoe's 8192 tokens) operations, 6 E C d f
// FLOP; at decode (C = 1) bytes, every expert's weights read once. This
// kernel uses the CUDA cores, not the tensor cores, so at prefill it runs
// far below the bf16 bound; each CTA reads its expert's weights from L2,
// E * ceil(C / 16) times in all. At decode 15 of the 16 rows are padding
// and every expert's weights are still read. wgmma, TMA and skipping
// all-pad row blocks are later changes.
//
// The float32 instantiation compiles with g++ against the stand-in
// runtime in tests/cuda_host, which runs it on the CPU.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#ifndef VX_LAUNCH_SMEM
#define VX_LAUNCH_SMEM(K, G, B, M, S, ...) \
  K<<<(G), (B), (M), (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif
#ifndef VX_DYN_SMEM
#define VX_DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

constexpr int BM = 16;           // capacity rows per CTA
constexpr int kThreads = 256;    // hidden (phase 1) or output (phase 2) columns
constexpr int KT = 64;           // k rows of x^T staged at a time
constexpr int XS = BM + 4;       // x^T row stride: fewer bank conflicts
constexpr int kMaxSmem = 232448; // the H100's opt-in maximum per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
#ifdef __CUDACC__
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
#endif

__device__ __forceinline__ void fma16(float (&acc)[BM], const float* col,
                                      float w) {
  const float4* c = reinterpret_cast<const float4*>(col);
#pragma unroll
  for (int q = 0; q < BM / 4; ++q) {
    const float4 v = c[q];
    acc[4 * q] += v.x * w;
    acc[4 * q + 1] += v.y * w;
    acc[4 * q + 2] += v.z * w;
    acc[4 * q + 3] += v.w * w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_ff_kernel(const T* __restrict__ x, const T* __restrict__ wi,
              const T* __restrict__ wo, T* __restrict__ y, int C, int d,
              int f, int n_mb) {
  VX_DYN_SMEM(smem);
  float* hs = reinterpret_cast<float*>(smem);   // (f, BM): h transposed
  float* xs = hs + (long long)f * BM;           // (KT, XS): x^T tile
  const int e = (int)(blockIdx.x / n_mb);
  const int row0 = (int)(blockIdx.x % n_mb) * BM;
  const int rows = min(BM, C - row0);
  const T* xe = x + ((long long)e * C + row0) * d;
  const T* wie = wi + (long long)e * d * 2 * f;
  const T* woe = wo + (long long)e * f * d;
  T* ye = y + ((long long)e * C + row0) * d;
  const int tid = threadIdx.x;
  const long long ld = 2LL * f;                 // a row of wi

  // phase 1: h[:, j] = silu(x @ wi[:, j]) * (x @ wi[:, f + j])
  for (int j0 = 0; j0 < f; j0 += kThreads) {
    const int j = j0 + tid;
    const bool jin = j < f;
    float g[BM], u[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) g[r] = u[r] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KT) {
      const int kn = min(KT, d - k0);
      __syncthreads();   // the last tile of xs is read
      for (int i = tid; i < KT * BM; i += kThreads) {
        const int r = i / KT, kk = i % KT;
        xs[kk * XS + r] = r < rows && kk < kn
                              ? to_f32(xe[(long long)r * d + k0 + kk])
                              : 0.f;
      }
      __syncthreads();
      if (jin) {
        const T* wg = wie + (long long)k0 * ld + j;
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          const float a = to_f32(wg[kk * ld]);
          const float b = to_f32(wg[kk * ld + f]);
          fma16(g, xs + kk * XS, a);
          fma16(u, xs + kk * XS, b);
        }
      }
    }
    if (jin) {
#pragma unroll
      for (int r = 0; r < BM; ++r)
        hs[(long long)j * BM + r] = g[r] / (1.f + expf(-g[r])) * u[r];
    }
  }
  __syncthreads();

  // phase 2: y[:, n] = h @ wo[:, n]
  for (int n0 = 0; n0 < d; n0 += kThreads) {
    const int n = n0 + tid;
    if (n >= d) break;
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    const T* wc = woe + n;
#pragma unroll 8
    for (int jj = 0; jj < f; ++jj)
      fma16(acc, hs + (long long)jj * BM, to_f32(wc[(long long)jj * d]));
    for (int r = 0; r < rows; ++r)
      store_f32(acc[r], ye + (long long)r * d + n);
  }
}

template <typename T>
int launch(const void* x, const void* wi, const void* wo, void* y, int E,
           int C, int d, int f, void* stream) {
  const int n_mb = (C + BM - 1) / BM;
  const size_t smem = ((size_t)f * BM + KT * XS) * sizeof(float);
  auto kernel = moe_ff_kernel<T>;
  // once per instantiation: allow up to the card's maximum
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, E * n_mb, kThreads, smem, stream, (const T*)x,
                 (const T*)wi, (const T*)wo, (T*)y, C, d, f, n_mb);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, C, d), wi: (E, d, 2f), wo: (E, f, d), y: (E, C, d), all
// contiguous, of one type. E, C, d, f >= 1; E * ceil(C / 16) < 2^31;
// (16 f + 1280) * 4 <= 232448 bytes of shared memory.
extern "C" int moe_ff_f32(const void* x, const void* wi, const void* wo,
                          void* y, int E, int C, int d, int f,
                          void* stream) {
  return launch<float>(x, wi, wo, y, E, C, d, f, stream);
}

#ifdef __CUDACC__
extern "C" int moe_ff_bf16(const void* x, const void* wi, const void* wo,
                           void* y, int E, int C, int d, int f,
                           void* stream) {
  return launch<__nv_bfloat16>(x, wi, wo, y, E, C, d, f, stream);
}
#endif
