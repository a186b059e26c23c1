// RMSNorm over the rows of an (N, d) array: one CTA per row.
//
// Replaces repro/kernels/rmsnorm/rmsnorm.py:rmsnorm (the Pallas TPU
// kernel, 128 rows per grid program). Per row: the float32 mean of
// squares, then x * rsqrt(var + eps) * scale in float32, stored in x's
// type.
//
// Bound: bytes. Each element is read and written once and costs a few
// operations. The simple design: 256 threads per row, neighbouring
// threads on neighbouring elements, a float32 sum of squares reduced by
// warp shuffles and then across the 8 warps in shared memory. The second
// pass reads the row again, from L1 or L2 (a row of d = 2048 bf16 is
// 4 KB), so device memory still sees each byte once. Loads are 2 or 4
// bytes a thread; vector loads are a later change.
//
// The float32 instantiation compiles with g++ against the stand-in
// runtime in tests/cuda_host, which runs it on the CPU.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#ifndef VX_LAUNCH
#define VX_LAUNCH(K, G, B, S, ...) \
  K<<<(G), (B), 0, (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const T* xr = x + (long long)blockIdx.x * d;
  T* outr = out + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    store_f32(to_f32(xr[i]) * r * to_f32(scale[i]), outr + i);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int n, int d,
           float eps, void* stream) {
  auto kernel = rmsnorm_kernel<T>;
  VX_LAUNCH(kernel, n, kThreads, stream, (const T*)x, (const T*)scale,
            (T*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, scale, out: contiguous (n, d), (d,), (n, d) of one type; n >= 1.
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           int n, int d, float eps, void* stream) {
  return launch<float>(x, scale, out, n, d, eps, stream);
}

#ifdef __CUDACC__
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int n, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, n, d, eps, stream);
}
#endif
