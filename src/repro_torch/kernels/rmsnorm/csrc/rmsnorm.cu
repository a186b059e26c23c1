// RMSNorm over the rows of an (N, d) array.
//
// Replaces repro/kernels/rmsnorm/rmsnorm.py:rmsnorm (the Pallas TPU
// kernel, 128 rows per grid program). Per row: the float32 mean of
// squares, then x * rsqrt(var + eps) * scale in float32, stored in x's
// type. Where rstd is not null, the row's rsqrt(var + eps) is stored there
// too, in float32: the backward (rmsnorm_bwd.cu) reads it.
//
// Bound: bytes. Each element is read and written once and costs a few
// operations. The design: one CTA of 256 threads a row. Each thread reads
// its part of the row once, in 16-byte vectors (8 bf16 or 4 float32 a
// load), neighbouring threads on neighbouring vectors, keeps it in
// registers for the second pass, and reads scale's vectors the same way
// (from L2: every row shares them). The sum of squares is reduced by warp
// shuffles, then across the warps in shared memory. A row whose length is
// not a whole number of vectors, whose pointers are not on 16 bytes, or of
// more than 8 vectors a thread takes the scalar route: 2 or 4 bytes a
// thread a load, the row read twice (the second time from L1 or L2).
// (A warp a row, eight rows a CTA, was tried at d = 2048 and not kept: its
// 1,024 CTAs make 1.6 waves of the H100.)
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

constexpr int kThreads = 256;

// the sum over the row's kThreads threads (one CTA): each warp's by
// shuffles, then the warps' through shared memory
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

// one CTA of kThreads a row; each thread holds at most NV vectors of it,
// neighbouring threads on neighbouring vectors
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec(const T* __restrict__ x, const T* __restrict__ scale,
            T* __restrict__ out, float* __restrict__ rstd, int d,
            float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int t = threadIdx.x, nvec = d / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(
      x + (long long)blockIdx.x * d);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* outr = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * d);
  uint4 v[NV];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * kThreads;
    if (i < nvec) {
      v[j] = xr[i];
      float f[kVec];
      unpack(v[j], f, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) ss += f[k] * f[k];
    }
  }
  const float r = rsqrtf(row_sum(ss) / (float)d + eps);
  if (rstd != nullptr && t == 0) rstd[blockIdx.x] = r;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * kThreads;
    if (i < nvec) {
      float f[kVec], g[kVec];
      unpack(v[j], f, x);
      unpack(sr[i], g, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = f[k] * r * g[k];
      outr[i] = pack(f, x);
    }
  }
}

// the scalar route: one CTA of kThreads a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, float* __restrict__ rstd, int d,
               float eps) {
  const T* xr = x + (long long)blockIdx.x * d;
  T* outr = out + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(row_sum(ss) / (float)d + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = r;
  for (int i = threadIdx.x; i < d; i += kThreads)
    store_f32(to_f32(xr[i]) * r * to_f32(scale[i]), outr + i);
}

// the vector route where the row is a whole number of vectors, at most 8
// a thread, and every pointer is on 16 bytes (NV the fewest of 1, 2, 4, 8
// that hold it); else the scalar route
template <typename T>
int launch(const void* x, const void* scale, void* out, float* rstd,
           int n, int d, float eps, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  if (d % kVec == 0 && nvec <= 8 * kThreads &&
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 == 0) {
    auto kernel = nvec <= kThreads ? rmsnorm_vec<T, 1>
        : nvec <= 2 * kThreads ? rmsnorm_vec<T, 2>
        : nvec <= 4 * kThreads ? rmsnorm_vec<T, 4> : rmsnorm_vec<T, 8>;
    VX_LAUNCH(kernel, n, kThreads, stream, (const T*)x, (const T*)scale,
              (T*)out, rstd, d, eps);
  } else {
    auto kernel = rmsnorm_kernel<T>;
    VX_LAUNCH(kernel, n, kThreads, stream, (const T*)x, (const T*)scale,
              (T*)out, rstd, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, scale, out: contiguous (n, d), (d,), (n, d) of one type; n >= 1;
// rstd: null, or (n,) float32 for each row's rsqrt(var + eps)
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           void* rstd, int n, int d, float eps,
                           void* stream) {
  return launch<float>(x, scale, out, (float*)rstd, n, d, eps, stream);
}

#ifdef __CUDACC__
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            void* rstd, int n, int d, float eps,
                            void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, (float*)rstd, n, d, eps,
                               stream);
}
#endif
