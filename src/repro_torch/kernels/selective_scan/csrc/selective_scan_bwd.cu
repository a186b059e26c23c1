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
// Bound: bytes. The function reads dA and dBx and writes d(dA) and d(dBx)
// once, 16 bytes an element of (B, S, d, n) in float32, for 4n + 2
// operations a step and state. The forward (selective_scan.cu, with
// ``states``) keeps the state entering every K-th step, 4 / K bytes an
// element, and the backward reads each element once:
//
//   * Segments. It walks the sequence in segments of K steps from the
//     last. For a segment it recomputes h_t from the saved state, each
//     h_t over the dBx_t it no longer needs, then walks the segment
//     backward carrying g, writing d(dA) and d(dBx) once. Nothing is
//     written to device memory and read back: traffic is 16 + 4 / K
//     bytes an element, against 28 when h_t went through the d(dA)
//     output (the design before).
//   * The state's (channel, state) pairs are independent: only dCm sums
//     across them, over the channels. A thread takes one channel's four
//     states (one 16-byte chunk a step and tensor); a CTA of 512 threads
//     takes CH = 2048 / n channels (128 at n = 16), so a step of one
//     tensor for the CTA's channels is 8 KB of contiguous memory, one
//     chunk a thread, and the thread that copies a chunk is the one that
//     reads it.
//   * Copies. A segment's dA, dBx and saved state, and its dy and Cm,
//     go to shared memory by cp.async, in two buffers: the copies of the
//     next segment (the one before in time) are in flight while the CTA
//     works on this one. K = kSeg = 4 (scan_segment.cuh, shared with the
//     forward) and 512 threads: a buffer is 2 x 4 x 8 KB of dA and dBx,
//     8 KB of states, 4 CH floats of dy and 4 n of Cm, 73-80 KB; two
//     make 146-161 KB of the 227 KB a CTA may take.
//     Why not K = 8 at 128 channels: two buffers would be 272 KB. Why not
//     fewer channels: the CTA's warps' dCm partials are summed before
//     they leave it, so the scratch is one row a CTA, 4x smaller than one
//     a warp of 32 channels at n = 16 (8x at n = 8, 16x at n = 4). The
//     states cost 1 byte an element (6 % of the backward's traffic, and
//     12.5 % more for the forward that writes them).
//   * dCm. A warp folds its lanes' four products a step over its
//     channels in a fixed butterfly (two folding levels, then plain
//     adds), leaving each state's sum in one lane, which stores it in
//     shared memory; after the segment the CTA's warps' sums are added in
//     warp order, one row of K n floats a CTA to the (B, CTAs, S, n)
//     scratch, and dc_reduce sums the CTAs of each (b, t, k) in order.
//     No float atomics: two calls on the same inputs give the same bits.
//
// float32 only (the model's scan inputs are float32); n is 4, 8 or 16 (a
// template argument). The kernels compile with g++, -D__CUDACC__ and the
// stand-in runtime and sm90.cuh emulation in tests/cuda_host, which run
// them on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_segment.cuh"
#include "sm90.cuh"

#ifndef VX_LAUNCH
#define VX_LAUNCH(K, G, B, S, ...) \
  K<<<(G), (B), 0, (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif
#ifndef VX_LAUNCH_SMEM
#define VX_LAUNCH_SMEM(K, G, B, M, S, ...) \
  K<<<(G), (B), (M), (cudaStream_t)(S)>>>(__VA_ARGS__)
#endif
#ifndef VX_DYN_SMEM
#define VX_DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

constexpr int kThreads = 512;          // a thread a channel's four states
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // bytes a step of one tensor
constexpr int kRedThreads = 128;
constexpr int kBadArgs = 1;            // returned for an n it does not
                                       // take

// a buffer: dA, dBx (h over it) and the saved state, a 16-byte chunk a
// thread each, then the segment's dy (K x CH) and Cm (K x n)
template <int N>
struct Buf {
  static constexpr int CH = kThreads * 4 / N;   // channels a CTA
  static constexpr int A = 0;
  static constexpr int BX = kSeg * kChunk;
  static constexpr int H = 2 * kSeg * kChunk;
  static constexpr int DY = H + kChunk;
  static constexpr int CM = DY + kSeg * CH * 4;
  static constexpr int BYTES = CM + kSeg * N * 4;
  // after the two buffers, the warps' dCm sums of a segment, (warps, K,
  // n) floats
  static constexpr int RED = 2 * BYTES;
  static constexpr int SMEM = RED + kWarps * kSeg * N * 4;
};

__device__ __forceinline__ float4 ld4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(unsigned char* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The sums over the warp's channels (lanes that differ in bits QB and up,
// QB = log2(n / 4)) of this lane's four values: two folding levels (at
// lane offsets 16 and 8: a lane keeps half its values and adds its
// partner's copy of that half), then plain adds at 4 down to 2^QB. Returns
// the sum of value idx = 2 (lane bit 4) + (lane bit 3); the lanes whose
// bits QB..2 are 0 hold each (quad, idx) once.
template <int QB>
__device__ __forceinline__ float fold4(const float (&v)[4], int lane) {
  const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0;
  const float a0 = up16 ? v[2] : v[0], a1 = up16 ? v[3] : v[1];
  const float s0 = up16 ? v[0] : v[2], s1 = up16 ? v[1] : v[3];
  const float b0 = a0 + __shfl_xor_sync(0xffffffffu, s0, 16);
  const float b1 = a1 + __shfl_xor_sync(0xffffffffu, s1, 16);
  float s = (up8 ? b1 : b0) +
            __shfl_xor_sync(0xffffffffu, up8 ? b0 : b1, 8);
#pragma unroll
  for (int off = 4; off >= (1 << QB); off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// the copies of segment s (steps t0 .. t0 + k - 1) into the buffer at
// shared address sb; past d, and past k steps, zeros
template <int N>
__device__ __forceinline__ void load_segment(
    uint32_t sb, const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ states, const float* __restrict__ dy,
    const float* __restrict__ Cm, int b, int S, int d, int c0, int s, int t0,
    int k, bool live, int tid) {
  using BF = Buf<N>;
  const long long step = (long long)d * N;           // floats a step
  const long long chunk = ((long long)b * S * d + c0) * N + tid * 4;
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const bool in = live && i < k;
    const long long off = chunk + (long long)(t0 + i) * step;
    sm90::cp_async16(sb + BF::A + i * kChunk + tid * 16,
                     dA + (in ? off : 0), in);
    sm90::cp_async16(sb + BF::BX + i * kChunk + tid * 16,
                     dBx + (in ? off : 0), in);
  }
  const int n_seg = (S + kSeg - 1) / kSeg;
  const long long so = (((long long)b * n_seg + s) * d + c0) * N + tid * 4;
  sm90::cp_async16(sb + BF::H + tid * 16, states + (live ? so : 0), live);
  // dy: K rows of CH channels; Cm: K rows of n
#pragma unroll
  for (int j = tid; j < kSeg * BF::CH; j += kThreads) {
    const int i = j / BF::CH, c = c0 + j % BF::CH;
    const bool in = i < k && c < d;
    sm90::cp_async4(sb + BF::DY + j * 4,
                    dy + (in ? ((long long)b * S + t0 + i) * d + c : 0), in);
  }
  if (tid < kSeg * N) {
    const int i = tid / N;
    const bool in = i < k;
    sm90::cp_async4(sb + BF::CM + tid * 4,
                    Cm + (in ? ((long long)b * S + t0 + i) * N + tid % N : 0),
                    in);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                const float* __restrict__ Cm,
                const float* __restrict__ states,
                const float* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ ddA,
                float* __restrict__ ddBx, float* __restrict__ partial,
                float* __restrict__ dh0, int S, int d, int n_cb) {
  using BF = Buf<N>;
  constexpr int Q = N / 4;                      // threads a channel
  constexpr int QB = N == 16 ? 2 : N == 8 ? 1 : 0;
  VX_DYN_SMEM(smem);
  const int b = (int)(blockIdx.x / n_cb);
  const int cb = (int)(blockIdx.x % n_cb);
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = cb * BF::CH;
  const int cl = tid / Q, q = tid % Q;          // channel in the CTA, quad
  // threads past d run along with zeros: every lane takes part in the
  // folds and every thread in the barriers
  const bool live = c0 + cl < d;
  const uint32_t base = sm90::smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + BF::RED);
  const long long step = (long long)d * N;
  const long long own = ((long long)b * S * d + c0) * N + tid * 4;
  const long long hoff = ((long long)b * d + c0) * N + tid * 4;
  float* part = partial + ((long long)b * n_cb + cb) * S * N;

  float4 G = {0.f, 0.f, 0.f, 0.f};
  if (live && dh_last != nullptr)
    G = *reinterpret_cast<const float4*>(dh_last + hoff);
  const int n_seg = (S + kSeg - 1) / kSeg;
  load_segment<N>(base, dA, dBx, states, dy, Cm, b, S, d, c0, n_seg - 1,
                  (n_seg - 1) * kSeg, S - (n_seg - 1) * kSeg, live, tid);
  sm90::cp_async_commit();
  for (int i = 0; i < n_seg; ++i) {
    const int s = n_seg - 1 - i;
    const int t0 = s * kSeg, k = min(kSeg, S - t0);
    unsigned char* bp = smem + (i & 1) * BF::BYTES;
    if (s > 0)   // the segment before, into the other buffer
      load_segment<N>(base + ((i + 1) & 1) * BF::BYTES, dA, dBx, states, dy,
                      Cm, b, S, d, c0, s - 1, t0 - kSeg, kSeg, live, tid);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();   // this segment's copies have landed
    __syncthreads();            // everyone's: dy and Cm are shared

    // recompute h_t over dBx_t (this thread's own chunks)
    float4 h = ld4(bp + BF::H + tid * 16);
    for (int j = 0; j < k; ++j) {
      const float4 a = ld4(bp + BF::A + j * kChunk + tid * 16);
      const float4 x = ld4(bp + BF::BX + j * kChunk + tid * 16);
      h = {a.x * h.x + x.x, a.y * h.y + x.y, a.z * h.z + x.z,
           a.w * h.w + x.w};
      st4(bp + BF::BX + j * kChunk + tid * 16, h);
    }
    // backward over the segment: g, d(dBx), d(dA), dCm's products
    const float* dys = reinterpret_cast<const float*>(bp + BF::DY);
    const float* cms = reinterpret_cast<const float*>(bp + BF::CM);
    float4 ht = h;   // h_t, then h_{t-1} of the step after
    for (int j = k - 1; j >= 0; --j) {
      const float4 hp = ld4(bp + (j > 0 ? BF::BX + (j - 1) * kChunk : BF::H) +
                            tid * 16);
      const float4 a = ld4(bp + BF::A + j * kChunk + tid * 16);
      const float dyv = dys[j * BF::CH + cl];
      const float4 cv = *reinterpret_cast<const float4*>(cms + j * N + 4 * q);
      const float4 g = {G.x + dyv * cv.x, G.y + dyv * cv.y,
                        G.z + dyv * cv.z, G.w + dyv * cv.w};
      const float pr[4] = {dyv * ht.x, dyv * ht.y, dyv * ht.z, dyv * ht.w};
      const float sum = fold4<QB>(pr, lane);
      if ((lane & (7 & ~((1 << QB) - 1))) == 0)
        red[(warp * kSeg + j) * N + 4 * q + 2 * ((lane >> 4) & 1) +
            ((lane >> 3) & 1)] = sum;
      if (live) {
        const long long o = own + (long long)(t0 + j) * step;
        *reinterpret_cast<float4*>(ddBx + o) = g;
        *reinterpret_cast<float4*>(ddA + o) =
            float4{g.x * hp.x, g.y * hp.y, g.z * hp.z, g.w * hp.w};
      }
      G = {a.x * g.x, a.y * g.y, a.z * g.z, a.w * g.w};
      ht = hp;
    }
    __syncthreads();   // red is whole; the buffer is read by no one
    // the CTA's row of dCm partials for the segment, warps in order
    if (tid < k * N) {
      const int j = tid / N, kk = tid % N;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += red[(w * kSeg + j) * N + kk];
      part[(long long)(t0 + j) * N + kk] = acc;
    }
  }
  if (live) *reinterpret_cast<float4*>(dh0 + hoff) = G;
}

// dCm[b, t, k] = the sum over the W CTAs of partial[b, w, t, k], CTA 0
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
int launch_n(const void* dA, const void* dBx, const void* Cm,
             const void* states, const void* dy, const void* dh_last,
             void* ddA, void* ddBx, void* partial, void* dC, void* dh0,
             int B, int S, int d, void* stream) {
  const int n_cb = (d + Buf<N>::CH - 1) / Buf<N>::CH;
  auto kernel = scan_bwd_kernel<N>;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Buf<N>::SMEM);
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, B * n_cb, kThreads, Buf<N>::SMEM, stream,
                 (const float*)dA, (const float*)dBx, (const float*)Cm,
                 (const float*)states, (const float*)dy,
                 (const float*)dh_last, (float*)ddA, (float*)ddBx,
                 (float*)partial, (float*)dh0, S, d, n_cb);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long outs = (long long)B * S * N;
  VX_LAUNCH(dc_reduce, (int)((outs + kRedThreads - 1) / kRedThreads),
            kRedThreads, stream, (const float*)partial, (float*)dC, B, n_cb,
            S, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dA, dBx, ddA, ddBx: (B, S, d, n); Cm, dC: (B, S, n); dy: (B, S, d);
// states: (B, ceil(S / kSeg), d, n), the forward's; dh_last, dh0:
// (B, d, n); partial: (B, ceil(d / CH), S, n) scratch, CH = 2048 / n
// channels a CTA; all float32, contiguous, 16-byte aligned. dh_last may be null (zeros). B, S, d >= 1; n in {4, 8,
// 16}; B * ceil(d / CH) < 2^31.
extern "C" int selective_scan_bwd_f32(const void* dA, const void* dBx,
                                      const void* Cm, const void* states,
                                      const void* dy, const void* dh_last,
                                      void* ddA, void* ddBx, void* partial,
                                      void* dC, void* dh0, int B, int S,
                                      int d, int n, void* stream) {
  switch (n) {
    case 4: return launch_n<4>(dA, dBx, Cm, states, dy, dh_last, ddA, ddBx,
                               partial, dC, dh0, B, S, d, stream);
    case 8: return launch_n<8>(dA, dBx, Cm, states, dy, dh_last, ddA, ddBx,
                               partial, dC, dh0, B, S, d, stream);
    case 16: return launch_n<16>(dA, dBx, Cm, states, dy, dh_last, ddA,
                                 ddBx, partial, dC, dh0, B, S, d, stream);
    default: return kBadArgs;
  }
}
