// The gradient of RMSNorm over the rows of an (N, d) array.
//
// No TPU kernel stands behind it: the reference trains through plain jnp
// (repro/models/layers.py:rmsnorm under jax.grad), and its Pallas
// rmsnorm (repro/kernels/rmsnorm/rmsnorm.py) has no custom_vjp. This is
// the backward of the port's forward (rmsnorm.cu), which stores each
// row's r = rsqrt(mean(x^2) + eps). Per row, in float32, with
// g = scale * dy:
//
//   dx     = r * g - x * r^3 * mean(x * g)          (cast to x's type)
//   dscale = sum over the rows of dy * x * r        (cast to scale's type)
//
// Bound: bytes. x and dy are read and dx written once; a few operations
// an element. The design: rmsnorm_bwd_rows runs one CTA of 256 threads
// over the rows blockIdx.x, blockIdx.x + gridDim.x, ...; each thread
// holds J columns (c = t + 256 j) of the row and of the CTA's dscale
// partial sums in registers, and writes its partials once at the end to
// a (parts, d) float32 scratch. rmsnorm_bwd_reduce then sums each column
// over the parts in one fixed order. No float atomics: two calls on the
// same inputs give the same bits. Loads are one element a thread,
// neighbouring threads on neighbouring elements (16-byte vectors are a
// later change).
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

// the sum over the CTA's kThreads threads, the same in every thread; the
// closing barrier lets the next row reuse the shared slots
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// dx for the rows of this CTA, and its dscale partials in partial[cta]
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale,
                 const float* __restrict__ rstd, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ partial, int n,
                 int d) {
  const int t = threadIdx.x;
  float s[J], ds[J], xv[J], gv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * kThreads;
    s[j] = c < d ? to_f32(scale[c]) : 0.f;
    ds[j] = 0.f;
  }
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + (long long)row * d;
    const T* dyr = dy + (long long)row * d;
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = t + j * kThreads;
      xv[j] = gv[j] = 0.f;
      if (c < d) {
        const float xc = to_f32(xr[c]), dyc = to_f32(dyr[c]);
        xv[j] = xc;
        gv[j] = s[j] * dyc;
        dot += xc * gv[j];
        ds[j] += dyc * xc * r;
      }
    }
    const float mean = row_sum(dot) / (float)d;
    const float r3m = r * r * r * mean;
    T* dxr = dx + (long long)row * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = t + j * kThreads;
      if (c < d) store_f32(r * gv[j] - xv[j] * r3m, dxr + c);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * kThreads;
    if (c < d) partial[(long long)blockIdx.x * d + c] = ds[j];
  }
}

// dscale[c] = the sum of partial[0..parts)[c], in that order
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_reduce(const float* __restrict__ partial, T* __restrict__ dscale,
                   int parts, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += partial[(long long)p * d + c];
  store_f32(acc, dscale + c);
}

// J, the columns a thread holds, is the fewest of 1, 2, 4, ..., 32 that
// cover d; d > 256 * 32 is refused (the wrapper checks it first)
template <typename T>
int launch(const void* x, const void* scale, const void* rstd,
           const void* dy, void* dx, void* dscale, void* partial, int n,
           int d, int parts, void* stream) {
  const int j = (d + kThreads - 1) / kThreads;
  auto rows = j <= 1 ? rmsnorm_bwd_rows<T, 1>
      : j <= 2 ? rmsnorm_bwd_rows<T, 2>
      : j <= 4 ? rmsnorm_bwd_rows<T, 4>
      : j <= 8 ? rmsnorm_bwd_rows<T, 8>
      : j <= 16 ? rmsnorm_bwd_rows<T, 16> : rmsnorm_bwd_rows<T, 32>;
  if (j > 32 || parts < 1) return 1;   // cudaErrorInvalidValue
  VX_LAUNCH(rows, parts, kThreads, stream, (const T*)x, (const T*)scale,
            (const float*)rstd, (const T*)dy, (T*)dx, (float*)partial, n,
            d);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto reduce = rmsnorm_bwd_reduce<T>;
  VX_LAUNCH(reduce, (d + kThreads - 1) / kThreads, kThreads, stream,
            (const float*)partial, (T*)dscale, parts, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: contiguous (n, d); scale, dscale: (d,), all of one type;
// rstd: (n,) float32 from the forward; partial: (parts, d) float32
// scratch, 1 <= parts <= n; d <= 8192
extern "C" int rmsnorm_bwd_f32(const void* x, const void* scale,
                               const void* rstd, const void* dy, void* dx,
                               void* dscale, void* partial, int n, int d,
                               int parts, void* stream) {
  return launch<float>(x, scale, rstd, dy, dx, dscale, partial, n, d, parts,
                       stream);
}

#ifdef __CUDACC__
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale,
                                const void* rstd, const void* dy, void* dx,
                                void* dscale, void* partial, int n, int d,
                                int parts, void* stream) {
  return launch<__nv_bfloat16>(x, scale, rstd, dy, dx, dscale, partial, n,
                               d, parts, stream);
}
#endif
