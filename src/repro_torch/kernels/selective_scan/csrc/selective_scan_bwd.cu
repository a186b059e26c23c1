// The gradient of the selective-scan recurrence (selective_scan.cu): for
// every batch b and channel c, with h_{-1} = h0[b, c, :] and
//   h_t = dA_t * h_{t-1} + dBx_t,   y[b, t, c] = h_t . Cm[b, t, :],
// from dy (B, S, d) and dh_last (the gradient of the last state, B, d, n),
// in float32, for t = S-1 down to 0:
//
//   g_t        = dy_t * Cm_t + dA_{t+1} * g_{t+1}    (g_S-1 adds dh_last)
//   d(dBx)_t   = g_t
//   d(dA)_t    = g_t * h_{t-1}
//   dCm_t[k]   = sum over the channels c of dy_t[c] * h_t[c, k]
//   dh0        = dA_0 * g_0
//
// No TPU kernel stands behind it: the reference differentiates its chunked
// scan (repro/models/ssm.py:mamba_scan_chunked, an associative scan in
// jnp) with jax.grad, and its Pallas selective_scan has no custom_vjp.
//
// The forward's layout (one thread a (b, c), the n states in registers)
// fits the backward too. Each thread walks its channel twice:
//   1. forward from h0, writing every h_t into the d(dA) output, so that
//      no scratch the size of dA is needed;
//   2. backward from t = S-1, carrying g in registers: it reads h_{t-1}
//      back from d(dA) (the one it holds, h_t, came from the step before),
//      overwrites that slot with g_t * h_{t-1}, and writes d(dBx)_t.
// dCm needs a sum over the d channels, across threads and CTAs. Each warp
// folds its 32 lanes' n products in a fixed butterfly (n shuffles, each
// lane left with one state's sum) and one lane per state writes the
// warp's partial to a (B, warps, S, n) scratch; dc_reduce then sums the
// warps of each (b, t, k) in order, warp 0 first. No float atomics: two
// calls on the same inputs give the same bits.
//
// Bound: bytes. The function reads dA and dBx and writes d(dA) and d(dBx)
// once, 16 bytes an element of (B, S, d, n) in float32; the design moves 28
// (dA twice, dBx once, h written and read back, the two outputs), against
// 4n + 2 operations a step and state. A warp's 32 threads are 32
// neighbouring channels: each step a warp reads and writes 32 * n * 4
// contiguous bytes per tensor. Cm[b, t, :] is the same for every thread of
// a CTA: a broadcast.
//
// float32 only (the model's scan inputs are float32); n is 4, 8 or 16 (a
// template argument: the states live in registers). The kernel compiles
// with g++ against the stand-in runtime in tests/cuda_host, which runs it
// on the CPU.
#include <cuda_runtime.h>

#ifndef VX_LAUNCH
#define VX_LAUNCH(K, G, B, S, ...) \
  K<<<(G), (B), 0, (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;          // channels per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kRedThreads = 128;
constexpr int kBadN = 1;               // returned for an n it does not take

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

template <int N>
__device__ __forceinline__ void zero_row(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// One level of the warp's fold of v[0..2 HALF): a lane keeps one half of
// its values and adds its partner's copy of that half (the lane that
// differs in bit `off`), then the next level folds the kept half at off / 2.
// The halves are template arguments, so every index is a constant.
template <int N, int HALF>
struct Fold {
  static __device__ __forceinline__ void run(float (&v)[N], int lane,
                                             int off, int& idx) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (upper) idx += HALF;
    Fold<N, HALF / 2>::run(v, lane, off >> 1, idx);
  }
};
template <int N>
struct Fold<N, 0> {
  static __device__ __forceinline__ void run(float (&)[N], int, int,
                                             int&) {}
};

// The sums over the warp's 32 lanes of v[0..N): log2(N) fold levels leave
// each lane one state's partial sum, which the remaining levels add over
// the other lanes. Returns the sum and sets idx to its state; the lanes
// whose low log2(32 / N) bits are 0 hold each state once. v is
// overwritten.
template <int N>
__device__ __forceinline__ float warp_fold(float (&v)[N], int lane,
                                           int& idx) {
  idx = 0;
  Fold<N, N / 2>::run(v, lane, 16, idx);
  float s = v[0];
  for (int off = 16 / N; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                const float* __restrict__ Cm, const float* __restrict__ h0,
                const float* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ ddA,
                float* __restrict__ ddBx, float* __restrict__ partial,
                float* __restrict__ dh0, int S, int d, int n_cb) {
  const int b = (int)(blockIdx.x / n_cb);
  const int cb = (int)(blockIdx.x % n_cb);
  const int c = cb * kThreads + (int)threadIdx.x;
  // lanes past d run along with zeros: every lane takes part in the folds
  const bool live = c < d;
  const int lane = (int)threadIdx.x & 31;
  const int W = n_cb * kWarps;                  // warps of one batch row
  const int w = cb * kWarps + (int)threadIdx.x / 32;
  const long long step = (long long)d * N;      // one time step of dA
  const long long base = ((long long)b * S * d + c) * N;
  const long long hoff = ((long long)b * d + c) * N;
  const float* a = dA + base;
  const float* bx = dBx + base;
  float* hs = ddA + base;                       // h_t, then d(dA)_t
  float* gs = ddBx + base;
  const float* cm = Cm + (long long)b * S * N;
  const float* dyp = dy + (long long)b * S * d + c;
  float* part = partial + ((long long)b * W + w) * S * N;

  // 1. forward: h_t into d(dA)
  float h[N];
  zero_row<N>(h);
  if (live) {
    if (h0 != nullptr) load_row<N>(h0 + hoff, h);
    for (int t = 0; t < S; ++t) {
      float av[N], bv[N];
      load_row<N>(a + t * step, av);
      load_row<N>(bx + t * step, bv);
#pragma unroll
      for (int i = 0; i < N; ++i) h[i] = av[i] * h[i] + bv[i];
      store_row<N>(h, hs + t * step);
    }
  }

  // 2. backward: h holds h_t, G the gradient reaching it from step t + 1
  float G[N];
  zero_row<N>(G);
  if (live && dh_last != nullptr) load_row<N>(dh_last + hoff, G);
  for (int t = S - 1; t >= 0; --t) {
    float hp[N], cv[N], pr[N];
    float dyv = 0.f;
    zero_row<N>(hp);
    if (live) {
      if (t > 0) {
        load_row<N>(hs + (t - 1) * step, hp);
      } else if (h0 != nullptr) {
        load_row<N>(h0 + hoff, hp);
      }
      dyv = dyp[(long long)t * d];
    }
    load_row<N>(cm + (long long)t * N, cv);
#pragma unroll
    for (int i = 0; i < N; ++i) pr[i] = dyv * h[i];
    int idx;
    const float s = warp_fold<N>(pr, lane, idx);
    if ((lane & (32 / N - 1)) == 0) part[(long long)t * N + idx] = s;
    if (live) {
      float av[N], g[N];
      load_row<N>(a + t * step, av);
#pragma unroll
      for (int i = 0; i < N; ++i) g[i] = G[i] + dyv * cv[i];
      store_row<N>(g, gs + t * step);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        G[i] = av[i] * g[i];
        g[i] *= hp[i];
      }
      store_row<N>(g, hs + t * step);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = hp[i];
  }
  if (live) store_row<N>(G, dh0 + hoff);
}

// dCm[b, t, k] = the sum over the W warps of partial[b, w, t, k], warp 0
// first; one thread an output, neighbouring threads on neighbouring
// (t, k), so every load of a warp is one contiguous row of a partial
__global__ void __launch_bounds__(kRedThreads)
dc_reduce(const float* __restrict__ partial, float* __restrict__ dC, int B,
          int W, int S, int N) {
  const long long per_b = (long long)S * N;
  const long long i = (long long)blockIdx.x * kRedThreads + threadIdx.x;
  if (i >= (long long)B * per_b) return;
  const long long b = i / per_b, r = i % per_b;
  const float* p = partial + b * W * per_b + r;
  float acc = 0.f;
  for (int w = 0; w < W; ++w) acc += p[(long long)w * per_b];
  dC[i] = acc;
}

template <int N>
int launch_n(const void* dA, const void* dBx, const void* Cm, const void* h0,
             const void* dy, const void* dh_last, void* ddA, void* ddBx,
             void* partial, void* dC, void* dh0, int B, int S, int d,
             void* stream) {
  const int n_cb = (d + kThreads - 1) / kThreads;
  auto kernel = scan_bwd_kernel<N>;
  VX_LAUNCH(kernel, B * n_cb, kThreads, stream, (const float*)dA,
            (const float*)dBx, (const float*)Cm, (const float*)h0,
            (const float*)dy, (const float*)dh_last, (float*)ddA,
            (float*)ddBx, (float*)partial, (float*)dh0, S, d, n_cb);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long outs = (long long)B * S * N;
  VX_LAUNCH(dc_reduce, (int)((outs + kRedThreads - 1) / kRedThreads),
            kRedThreads, stream, (const float*)partial, (float*)dC, B,
            n_cb * kWarps, S, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dA, dBx, ddA, ddBx: (B, S, d, n); Cm, dC: (B, S, n); dy: (B, S, d);
// h0, dh_last, dh0: (B, d, n); partial: (B, 4 * ceil(d / 128), S, n)
// scratch; all float32, contiguous, 16-byte aligned. h0 and dh_last may be
// null (zeros). B, S, d >= 1; n in {4, 8, 16}; B * ceil(d / 128) < 2^31.
extern "C" int selective_scan_bwd_f32(const void* dA, const void* dBx,
                                      const void* Cm, const void* h0,
                                      const void* dy, const void* dh_last,
                                      void* ddA, void* ddBx, void* partial,
                                      void* dC, void* dh0, int B, int S,
                                      int d, int n, void* stream) {
  switch (n) {
    case 4: return launch_n<4>(dA, dBx, Cm, h0, dy, dh_last, ddA, ddBx,
                               partial, dC, dh0, B, S, d, stream);
    case 8: return launch_n<8>(dA, dBx, Cm, h0, dy, dh_last, ddA, ddBx,
                               partial, dC, dh0, B, S, d, stream);
    case 16: return launch_n<16>(dA, dBx, Cm, h0, dy, dh_last, ddA, ddBx,
                                 partial, dC, dh0, B, S, d, stream);
    default: return kBadN;
  }
}
