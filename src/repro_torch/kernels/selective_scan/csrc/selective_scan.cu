// The selective-scan (Mamba SSM) recurrence: for every batch b and channel
// c, with the state h (n values) carried along the sequence,
//   h_t = dA[b, t, c, :] * h_{t-1} + dBx[b, t, c, :],
//   y[b, t, c] = h_t . Cm[b, t, :],
// float32 inside, y stored in dA's type. h starts at zero, or at h[b, c, :]
// when the caller gives a state, which then receives the last h_t.
//
// Replaces repro/kernels/selective_scan/selective_scan.py:selective_scan
// (the Pallas TPU kernel, grid (B, S / chunk), the (d, n) state carried in
// VMEM scratch across the sequential chunk axis). On the card CTAs run in
// no order, so nothing can be carried from one CTA to the next: each
// thread owns one (b, c) and walks the whole sequence itself, its n states
// in registers. A caller that cuts the sequence into chunks hands the
// state over through h.
//
// Bound: bytes. dA and dBx are read once (n float32 or bf16 values per
// step and channel) and each step costs 4n operations (two multiply-adds
// a state). A thread reads its n values of a step as 16-byte loads; the
// 32 threads of a warp are 32 neighbouring channels, so a warp reads
// 32 * n * 4 bytes of contiguous memory per step (2 KB at n = 16 in
// float32). Cm[b, t, :] is the same for every thread of a CTA (one CTA
// never spans two batches): a broadcast. The loads of U steps are issued
// before the first of them is used; the state's dependency chain runs
// after them.
//
// n is 4, 8 or 16 (a template argument: the states live in registers).
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

constexpr int kThreads = 128;   // channels per CTA
constexpr int U = 2;            // steps loaded ahead of their use
constexpr int kBadN = 1;        // returned for an n the kernel does not take

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 w = q[i];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void store_row(const float (&v)[N], float* p) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    q[i] = float4{v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]};
}

__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }

#ifdef __CUDACC__
// two bf16 in a 32-bit word, the first in the low half: a bf16 is the top
// half of the float32 of the same value
__device__ __forceinline__ void bf16x2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// n bf16 values: 8 per 16-byte load, or 4 in one 8-byte load at n = 4
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[N]) {
  if constexpr (N % 8 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 w = q[i];
      bf16x2(w.x, v + 8 * i);
      bf16x2(w.y, v + 8 * i + 2);
      bf16x2(w.z, v + 8 * i + 4);
      bf16x2(w.w, v + 8 * i + 6);
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    bf16x2(w.x, v);
    bf16x2(w.y, v + 2);
  }
}

__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
#endif

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ dA, const T* __restrict__ dBx,
            const T* __restrict__ Cm, float* __restrict__ h,
            T* __restrict__ y, int S, int d, int n_cb) {
  const int b = (int)(blockIdx.x / n_cb);
  const int c = (int)(blockIdx.x % n_cb) * kThreads + (int)threadIdx.x;
  if (c >= d) return;                          // no barrier follows
  float hs[N];
  float* hp = h == nullptr ? nullptr : h + ((long long)b * d + c) * N;
  if (hp != nullptr) {
    load_row<N>(hp, hs);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) hs[i] = 0.f;
  }
  const long long step = (long long)d * N;     // one time step of dA
  const T* a = dA + ((long long)b * S * d + c) * N;
  const T* bx = dBx + ((long long)b * S * d + c) * N;
  const T* cm = Cm + (long long)b * S * N;
  T* yp = y + (long long)b * S * d + c;
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U][N], bv[U][N], cv[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        load_row<N>(a + (t0 + u) * step, av[u]);
        load_row<N>(bx + (t0 + u) * step, bv[u]);
        load_row<N>(cm + (long long)(t0 + u) * N, cv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          hs[i] = av[u][i] * hs[i] + bv[u][i];
          acc += hs[i] * cv[u][i];
        }
        store_f32(acc, yp + (long long)(t0 + u) * d);
      }
    }
  }
  if (hp != nullptr) store_row<N>(hs, hp);
}

template <typename T, int N>
int launch_n(const void* dA, const void* dBx, const void* Cm, void* h,
             void* y, int B, int S, int d, void* stream) {
  const int n_cb = (d + kThreads - 1) / kThreads;
  auto kernel = scan_kernel<T, N>;
  VX_LAUNCH(kernel, B * n_cb, kThreads, stream, (const T*)dA,
            (const T*)dBx, (const T*)Cm, (float*)h, (T*)y, S, d, n_cb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* dA, const void* dBx, const void* Cm, void* h,
           void* y, int B, int S, int d, int n, void* stream) {
  switch (n) {
    case 4: return launch_n<T, 4>(dA, dBx, Cm, h, y, B, S, d, stream);
    case 8: return launch_n<T, 8>(dA, dBx, Cm, h, y, B, S, d, stream);
    case 16: return launch_n<T, 16>(dA, dBx, Cm, h, y, B, S, d, stream);
    default: return kBadN;
  }
}

}  // namespace

// dA, dBx: (B, S, d, n); Cm: (B, S, n); y: (B, S, d), all contiguous, of
// one type, 16-byte aligned. h: (B, d, n) float32, contiguous and
// 16-byte aligned, read as the first state and overwritten with the last;
// or null for a zero first state that is not kept. B, S, d >= 1;
// n in {4, 8, 16}; B * ceil(d / 128) < 2^31.
extern "C" int selective_scan_f32(const void* dA, const void* dBx,
                                  const void* Cm, void* h, void* y, int B,
                                  int S, int d, int n, void* stream) {
  return launch<float>(dA, dBx, Cm, h, y, B, S, d, n, stream);
}

#ifdef __CUDACC__
extern "C" int selective_scan_bf16(const void* dA, const void* dBx,
                                   const void* Cm, void* h, void* y, int B,
                                   int S, int d, int n, void* stream) {
  return launch<__nv_bfloat16>(dA, dBx, Cm, h, y, B, S, d, n, stream);
}
#endif
