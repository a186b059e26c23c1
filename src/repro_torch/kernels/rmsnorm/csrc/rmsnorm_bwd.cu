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
// an element. The design: one CTA of 256 threads runs over the rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; each thread holds its columns
// of the row and of the CTA's dscale partial sums in registers, and
// writes its partials once at the end to a (parts, d) float32 scratch.
// rmsnorm_bwd_reduce then sums each column over the parts in one fixed
// order. No float atomics: two calls on the same inputs give the same
// bits. Rows wider than 8192 columns (command-r-plus's 12288, llama3's
// 16384) would need more registers a thread than the CTA can give: there
// a CTA has 512 threads, each holding only its partials (at most 32
// columns) between the rows, and the pass that writes dx reads x, dy and
// scale again, from L1 or L2 (a row of x and dy is at most 128 KB).
// Two routes, as the forward (rmsnorm.cu) has them:
//   * rmsnorm_bwd_vec, where the row is a whole number of 16-byte vectors
//     and every pointer is on 16 bytes: x, dy and scale are read and dx
//     written in 16-byte vectors (8 bf16 or 4 float32), neighbouring
//     threads on neighbouring vectors (x, dy and dx at (8192, 2048) bf16
//     move at about the forward's rate; loading the next row's vectors
//     ahead of this row's reduction was tried and gained nothing);
//   * rmsnorm_bwd_rows, the scalar route for any other row: one element a
//     thread a load, neighbouring threads on neighbouring elements.
// rmsnorm_bwd_reduce sums a column's partials one after another, part 0
// first, but loads them with the whole CTA: 256 threads copy chunks of
// 128 parts x 16 columns into shared memory, two chunks in turn, while 16
// threads add the last chunk's column by column. (One thread a column
// loading its own partials, 8 CTAs at d = 2048, waited on each load; 16
// columns a CTA keep 128 CTAs loading.)
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
// rows wider than 8192 columns: 512 threads a CTA, each holding only its
// dscale partials (up to 32 columns) between the rows
constexpr int kWideThreads = 512;

// the sum over the CTA's THREADS threads, the same in every thread; the
// closing barrier lets the next row reuse the shared slots
template <int THREADS>
__device__ __forceinline__ float row_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// the scalar route: dx for the rows of this CTA, and its dscale partials
// in partial[cta]; column c = t + THREADS j. KEEP holds scale and the
// row's x and dy in registers between the two passes over the row; else
// the second pass reads them again (from L1 or L2)
template <typename T, int J, int THREADS, bool KEEP>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale,
                 const float* __restrict__ rstd, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ partial, int n,
                 int d) {
  constexpr int H = KEEP ? J : 1;   // columns held between the passes
  const int t = threadIdx.x;
  float s[H], xv[H], gv[H], ds[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * THREADS;
    if constexpr (KEEP) s[j] = c < d ? to_f32(scale[c]) : 0.f;
    ds[j] = 0.f;
  }
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + (long long)row * d;
    const T* dyr = dy + (long long)row * d;
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = t + j * THREADS;
      if constexpr (KEEP) xv[j] = gv[j] = 0.f;
      if (c < d) {
        const float xc = to_f32(xr[c]), dyc = to_f32(dyr[c]);
        float g;
        if constexpr (KEEP) {
          g = s[j] * dyc;
          xv[j] = xc;
          gv[j] = g;
        } else {
          g = to_f32(scale[c]) * dyc;
        }
        dot += xc * g;
        ds[j] += dyc * xc * r;
      }
    }
    const float mean = row_sum<THREADS>(dot) / (float)d;
    const float r3m = r * r * r * mean;
    T* dxr = dx + (long long)row * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = t + j * THREADS;
      if (c < d) {
        float xc, g;
        if constexpr (KEEP) {
          xc = xv[j];
          g = gv[j];
        } else {
          xc = to_f32(xr[c]);
          g = to_f32(scale[c]) * to_f32(dyr[c]);
        }
        store_f32(r * g - xc * r3m, dxr + c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * THREADS;
    if (c < d) partial[(long long)blockIdx.x * d + c] = ds[j];
  }
}

// the vector route: dx for the rows of this CTA, and its dscale partials
// in partial[cta]; each thread takes at most NV vectors of kVec columns
// (vector i = t + THREADS j). KEEP holds scale and the row's x and dy as
// they were loaded; else the second pass loads them again (from L1 or L2)
template <typename T, int NV, int THREADS, bool KEEP>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ scale,
                const float* __restrict__ rstd, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ partial, int n,
                int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int H = KEEP ? NV : 1;  // vectors held between the passes
  const int t = threadIdx.x, nvec = d / kVec;
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 sv[H], xv[H], gv[H];        // scale, and this row's x and dy
  float ds[NV][kVec];
  const uint4 zero = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * THREADS;
    if constexpr (KEEP) sv[j] = i < nvec ? sr[i] : zero;
#pragma unroll
    for (int k = 0; k < kVec; ++k) ds[j][k] = 0.f;
  }
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * d);
    const uint4* dyr =
        reinterpret_cast<const uint4*>(dy + (long long)row * d);
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * THREADS;
      if (i < nvec) {
        const uint4 xa = xr[i], ga = dyr[i];
        uint4 sa;
        if constexpr (KEEP) {
          xv[j] = xa;
          gv[j] = ga;
          sa = sv[j];
        } else {
          sa = sr[i];
        }
        float xf[kVec], dyf[kVec], sf[kVec];
        unpack(xa, xf, x);
        unpack(ga, dyf, x);
        unpack(sa, sf, x);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          dot += xf[k] * (sf[k] * dyf[k]);
          ds[j][k] += dyf[k] * xf[k] * r;
        }
      }
    }
    const float mean = row_sum<THREADS>(dot) / (float)d;
    const float r3m = r * r * r * mean;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (long long)row * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = t + j * THREADS;
      if (i < nvec) {
        float xf[kVec], dyf[kVec], sf[kVec], o[kVec];
        if constexpr (KEEP) {
          unpack(xv[j], xf, x);
          unpack(gv[j], dyf, x);
          unpack(sv[j], sf, x);
        } else {
          unpack(xr[i], xf, x);
          unpack(dyr[i], dyf, x);
          unpack(sr[i], sf, x);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          o[k] = r * (sf[k] * dyf[k]) - xf[k] * r3m;
        dxr[i] = pack(o, x);
      }
    }
  }
  float4* pr = reinterpret_cast<float4*>(partial + (long long)blockIdx.x * d);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * THREADS;
    if (i < nvec) {
#pragma unroll
      for (int k = 0; k < kVec / 4; ++k)
        pr[i * (kVec / 4) + k] = {ds[j][4 * k], ds[j][4 * k + 1],
                                  ds[j][4 * k + 2], ds[j][4 * k + 3]};
    }
  }
}

constexpr int kRedCols = 16;    // columns a reduce CTA sums
constexpr int kRedParts = 128;  // parts a chunk holds

// dscale[c] = the sum of partial[0..parts)[c], in that order: the CTA's
// 16 columns, chunk by chunk through shared memory (the next chunk's
// loads in flight while threads 0-15 add this one's)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_reduce(const float* __restrict__ partial, T* __restrict__ dscale,
                   int parts, int d) {
  __shared__ float tile[2][kRedParts][kRedCols];
  constexpr int kLoads = kRedParts * kRedCols / kThreads;
  const int t = threadIdx.x, c0 = blockIdx.x * kRedCols;
  const int n_chunks = (parts + kRedParts - 1) / kRedParts;
  float v[kLoads];
  // element t + 256 i of chunk k: part 128 k + (t + 256 i) / 16, column
  // c0 + t % 16; zero past the parts or d
  auto load = [&](int k) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = k * kRedParts + (t + i * kThreads) / kRedCols;
      const int c = c0 + t % kRedCols;
      v[i] = p < parts && c < d ? partial[(long long)p * d + c] : 0.f;
    }
  };
  float acc = 0.f;
  load(0);
  for (int k = 0; k < n_chunks; ++k) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      tile[k & 1][(t + i * kThreads) / kRedCols][t % kRedCols] = v[i];
    __syncthreads();
    if (k + 1 < n_chunks) load(k + 1);
    if (t < kRedCols) {
      const int rows = min(kRedParts, parts - k * kRedParts);
      for (int r = 0; r < rows; ++r) acc += tile[k & 1][r][t];
    }
  }
  if (t < kRedCols && c0 + t < d) store_f32(acc, dscale + c0 + t);
}

// The vector route where the row is a whole number of vectors and every
// pointer is on 16 bytes, else the scalar route. Rows of at most 8192
// columns take 256 threads holding the row (NV the fewest of 1, 2, 4 and
// 32 / kVec vectors that cover it, J the fewest of 1, 2, 4, ..., 32
// columns); wider rows, up to 16384, take 512 threads that read the row
// again for dx (32 / kVec vectors or 32 columns a thread: bf16 at 16384
// holds the registers of bf16 at 8192, float32 half of them). d > 16384
// is refused (the wrapper checks it first).
template <typename T>
int launch(const void* x, const void* scale, const void* rstd,
           const void* dy, void* dx, void* dscale, void* partial, int n,
           int d, int parts, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  const int j = (d + kThreads - 1) / kThreads;
  const bool wide = j > 32;
  if ((d + kWideThreads - 1) / kWideThreads > 32 || parts < 1)
    return 1;   // cudaErrorInvalidValue
  const int threads = wide ? kWideThreads : kThreads;
  if (d % kVec == 0 &&
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy | (uintptr_t)dx |
       (uintptr_t)partial) % 16 == 0) {
    auto rows = wide ? rmsnorm_bwd_vec<T, 32 / kVec, kWideThreads, false>
        : nvec <= kThreads ? rmsnorm_bwd_vec<T, 1, kThreads, true>
        : nvec <= 2 * kThreads ? rmsnorm_bwd_vec<T, 2, kThreads, true>
        : nvec <= 4 * kThreads ? rmsnorm_bwd_vec<T, 4, kThreads, true>
        : rmsnorm_bwd_vec<T, 32 / kVec, kThreads, true>;
    VX_LAUNCH(rows, parts, threads, stream, (const T*)x, (const T*)scale,
              (const float*)rstd, (const T*)dy, (T*)dx, (float*)partial, n,
              d);
  } else {
    auto rows = wide ? rmsnorm_bwd_rows<T, 32, kWideThreads, false>
        : j <= 1 ? rmsnorm_bwd_rows<T, 1, kThreads, true>
        : j <= 2 ? rmsnorm_bwd_rows<T, 2, kThreads, true>
        : j <= 4 ? rmsnorm_bwd_rows<T, 4, kThreads, true>
        : j <= 8 ? rmsnorm_bwd_rows<T, 8, kThreads, true>
        : j <= 16 ? rmsnorm_bwd_rows<T, 16, kThreads, true>
        : rmsnorm_bwd_rows<T, 32, kThreads, true>;
    VX_LAUNCH(rows, parts, threads, stream, (const T*)x, (const T*)scale,
              (const float*)rstd, (const T*)dy, (T*)dx, (float*)partial, n,
              d);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto reduce = rmsnorm_bwd_reduce<T>;
  VX_LAUNCH(reduce, (d + kRedCols - 1) / kRedCols, kThreads, stream,
            (const float*)partial, (T*)dscale, parts, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: contiguous (n, d); scale, dscale: (d,), all of one type;
// rstd: (n,) float32 from the forward; partial: (parts, d) float32
// scratch, 1 <= parts <= n; d <= 16384
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
