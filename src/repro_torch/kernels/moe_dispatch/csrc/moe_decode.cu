// The grouped SwiGLU expert feed-forward at decode: one capacity row an
// expert (C = 1) with counts, bf16. The decode route of grouped_expert_ff
// (moe_dispatch.py: route):
//   y[e] = (silu(x[e] @ wi[e][:, :f]) * (x[e] @ wi[e][:, f:])) @ wo[e]
// for every expert whose count is at least 1, zero for the others,
// float32 sums, stored bf16.
//
// Replaces repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff
// (the Pallas TPU kernel) at decode's C = 1, beside the CUDA-core route
// (moe_dispatch.cu: moe_ff_partial), which stays for float32 and for rows
// the 16-byte copies cannot take.
//
// Bound: bytes, the weights of every live expert read once (3 d f bf16
// each), 2 FLOP a weight. At olmoe (E 64, d 2048, f 1024) the CUDA-core
// route cut f into 4 slices of 256: about 156 CTAs read weights, 1.2 an
// SM, so a quarter of the SMs carried two and set the time, and each
// CTA's down product waited for its whole up product behind a barrier
// pair per x tile. This route:
//   * Work units. A unit is one live expert and one slice of f, W = k 64
//     columns (moe_dispatch.py: decode_slicing; 64 at olmoe, about 4.7
//     units an SM). A unit walks its slice 64 columns (a chunk) at a time.
//   * Grid and work list. A persistent grid of n_ctas CTAs of 256 threads
//     (two an SM). Each CTA builds the list of live experts from counts in
//     shared memory (a ballot a warp, in expert order; no host read-back,
//     no second launch) and takes units b, b + n_ctas, ..., unit u being
//     the live expert u / n_slices and its slice u % n_slices.
//   * Weight stream. Each chunk streams wi's gate and up columns (d rows of
//     2 x 64 bf16, 64 rows a stage) and then its rows of wo (whole rows of
//     d, as many as fill a stage) through a ring of 4 stages of 16 KB in
//     shared memory fed by cp.async, 16 bytes a thread: the copies of the
//     next three stages are in flight while one is read, across the
//     boundary from the up product to the down product and from one unit
//     to the next. x's row (at most 16 KB) rides in the copy group of its
//     unit's first stage, into one of two buffers.
//   * Arithmetic. Float32 on the CUDA cores. Up: a thread takes one
//     16-byte chunk (8 gate or 8 up columns) of every 16th k row; the 16
//     k groups' sums meet in shared memory in group order, and h = silu(g)
//     u (64 floats) stays there. Down: a thread takes 8 output columns of
//     every 2048 (NP passes) for every wo row of the chunk, h[j] broadcast.
//   * Merge. A unit's float32 output partial goes to a workspace ws
//     (n_slices, E, d), and moe_decode_sum adds the slices in slice order,
//     cast to bf16, zero at an expert with no token (its rows not read).
//     Two calls give the same bits: every sum has a fixed order.
//
// Built with nvcc for the card; the host tests build it with g++ against
// the stand-in runtime and tests/cuda_host/sm90/sm90.cuh (-D__CUDACC__).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStage = 16384;          // bytes a stage
constexpr int kChunk = 64;             // hidden columns a chunk
constexpr int kKRows = 64;             // k rows of wi a stage (2 x 128 B)
constexpr int kKGroups = kThreads / 16;  // a k row is 16 chunks of 16 B
constexpr int kMaxD = 8192;            // NP <= 4 passes of 2048 columns
constexpr int kMaxE = 1024;            // the live list in shared memory
constexpr int kBadArgs = 1;
constexpr int kSumBlocksACta = 4;      // the sum's blocks a persistent CTA

// shared memory, in bytes: the ring, then x's two buffers (2 d bf16),
// the k groups' sums (16 x 128 float32), h (64 float32), and the live
// list with its count (E + 1 int32)
constexpr int kRing = kStages * kStage;
constexpr int kRed = kKGroups * 128 * 4;
constexpr int kH = kChunk * 4;
inline int smem_bytes(int d, int E) {
  return kRing + 4 * d + kRed + kH + 4 * (E + 1);
}

// where one step of a CTA's stream is: its unit (an index into the CTA's
// units), the chunk of the unit and the stage of the chunk (its up stages
// first, then its down stages)
struct Cursor {
  int u, chunk, st;
};

struct Shape {
  int d, f, W, n_slices, n_up, rows_a_down;
  // hidden columns of a chunk (the slice's last may be short)
  __device__ __forceinline__ int cols(int slice, int chunk) const {
    return min(kChunk, f - (slice * W + chunk * kChunk));
  }
  __device__ __forceinline__ int chunks(int slice) const {
    return (min(W, f - slice * W) + kChunk - 1) / kChunk;
  }
  __device__ __forceinline__ int stages(int slice, int chunk) const {
    return n_up + (cols(slice, chunk) + rows_a_down - 1) / rows_a_down;
  }
};

// the live expert and the slice of the CTA's unit number ``u`` (its
// units: blockIdx.x + u n_ctas)
__device__ __forceinline__ void unit_of(int u, const int* live,
                                        int n_slices, int& e, int& slice) {
  const int g = (int)blockIdx.x + u * (int)gridDim.x;
  e = live[g / n_slices];
  slice = g % n_slices;
}

__device__ __forceinline__ void advance(Cursor& c, const Shape& s,
                                        const int* live) {
  int e, slice;
  unit_of(c.u, live, s.n_slices, e, slice);
  if (++c.st < s.stages(slice, c.chunk)) return;
  c.st = 0;
  if (++c.chunk < s.chunks(slice)) return;
  c.chunk = 0;
  ++c.u;
}

// the copies of the stage at cursor c into ring slot ``slot``; with the
// unit's first stage also x's row into buffer u % 2
__device__ __forceinline__ void copy_stage(
    const Cursor& c, const Shape& s, const int* live, uint32_t ring,
    uint32_t xbuf, int slot, const bf16* x, const bf16* wi, const bf16* wo,
    int tid) {
  int e, slice;
  unit_of(c.u, live, s.n_slices, e, slice);
  const int j0 = slice * s.W + c.chunk * kChunk;   // the chunk's column
  const uint32_t dst = ring + slot * kStage;
  if (c.chunk == 0 && c.st == 0) {
    const bf16* xe = x + (long long)e * s.d;
    const uint32_t xd = xbuf + (c.u & 1) * 2 * s.d;
    for (int i = tid; i < s.d / 8; i += kThreads)
      sm90::cp_async16(xd + 16 * i, xe + 8 * i, true);
  }
  if (c.st < s.n_up) {
    // k rows [k0, k0 + 64) of the gate (chunks 0-7 of a row) and up
    // (8-15) columns [j0, j0 + 64): 256 bytes a row
    const int k0 = c.st * kKRows;
    const bf16* we = wi + (long long)e * s.d * 2 * s.f;
#pragma unroll
    for (int i = 0; i < kKRows * 16 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / 16, ch = q % 16;
      const int col = j0 + (ch % 8) * 8;
      const bool in = k0 + r < s.d && col < s.f;
      sm90::cp_async16(dst + 16 * q,
                       we + (in ? (long long)(k0 + r) * 2 * s.f +
                                      (ch < 8 ? 0 : s.f) + col
                                : 0),
                       in);
    }
  } else {
    // rows [r0, r0 + rows_a_down) of the chunk's rows of wo, whole rows
    const int r0 = (c.st - s.n_up) * s.rows_a_down;
    const int rows = min(s.rows_a_down, s.cols(slice, c.chunk) - r0);
    const bf16* w = wo + ((long long)e * s.f + j0 + r0) * s.d;
    for (int q = tid; q < rows * s.d / 8; q += kThreads)
      sm90::cp_async16(dst + 16 * q, w + 8 * q, true);
  }
}

// eight bf16 of a 16-byte chunk as floats
__device__ __forceinline__ void bf16x8(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The live experts (count >= 1) in expert order into live[0, n), n into
// live[E]: a ballot a warp and the warps' counts in turn, a round of 256
// experts at a time
__device__ __forceinline__ void live_list(const int* counts, int E,
                                          int* live, int* warp_n) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += kThreads) {
    const int e = e0 + tid;
    const bool on = e < E && counts[e] > 0;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_n[w] = __popc(m);
    __syncthreads();
    int off = base;
    for (int i = 0; i < w; ++i) off += warp_n[i];
    if (on) live[off + __popc(m & ((1u << lane) - 1u))] = e;
    for (int i = 0; i < kThreads / 32; ++i) base += warp_n[i];
    __syncthreads();   // warp_n is rewritten by the next round
  }
  if (tid == 0) live[E] = base;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
moe_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wi,
                  const bf16* __restrict__ wo, const int* __restrict__ counts,
                  float* __restrict__ ws, int E, int d, int f, int W,
                  int n_slices) {
  VX_DYN_SMEM(smem);
  const int tid = threadIdx.x;
  const uint32_t ring = sm90::smem_addr(smem);
  const uint32_t xbuf = ring + kRing;
  const bf16* xs0 = reinterpret_cast<const bf16*>(smem + kRing);
  float* red = reinterpret_cast<float*>(smem + kRing + 4 * d);
  float* hs = reinterpret_cast<float*>(smem + kRing + 4 * d + kRed);
  int* live = reinterpret_cast<int*>(smem + kRing + 4 * d + kRed + kH);
  __shared__ int warp_n[kThreads / 32];
  live_list(counts, E, live, warp_n);
  __syncthreads();
  const int units = live[E] * n_slices;
  // this CTA's units: blockIdx.x + u gridDim.x < units
  const int mine = units > (int)blockIdx.x
      ? (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
      : 0;
  if (mine == 0) return;
  const int rows_a_down = kStage / (2 * d);
  const Shape s{d, f, W, n_slices, (d + kKRows - 1) / kKRows, rows_a_down};

  // the producer runs kStages - 1 stages ahead of the consumer; every
  // thread keeps both cursors (the stream is the same for all)
  Cursor prod{0, 0, 0}, cons{0, 0, 0};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (prod.u < mine) {
      copy_stage(prod, s, live, ring, xbuf, i, x, wi, wo, tid);
      advance(prod, s, live);
    }
    sm90::cp_async_commit();
  }

  const int c16 = tid % 16, kg = tid / 16;   // up: chunk of a row, k group
  float part[8];                             // up: 8 gate or up sums
  float acc[NP][8];                          // down: 8 columns a pass
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;

  for (int t = 0; cons.u < mine; ++t) {
    sm90::cp_async_wait<kStages - 2>();   // stage t has landed
    __syncthreads();                      // ... for all; stage t - 1 read
    if (prod.u < mine) {
      copy_stage(prod, s, live, ring, xbuf, (t + kStages - 1) % kStages, x,
                 wi, wo, tid);
      advance(prod, s, live);
    }
    sm90::cp_async_commit();
    const unsigned char* st = smem + (t % kStages) * kStage;
    int e, slice;
    unit_of(cons.u, live, n_slices, e, slice);
    const int cols = s.cols(slice, cons.chunk);
    if (cons.st < s.n_up) {
      // up: this thread's chunk of k rows kg, kg + 16, kg + 32, kg + 48
      const bf16* xs = xs0 + (cons.u & 1) * d;
      const int k0 = cons.st * kKRows;
#pragma unroll
      for (int i = 0; i < kKRows / kKGroups; ++i) {
        const int r = kg + i * kKGroups;
        if (k0 + r >= d) break;
        float w[8];
        bf16x8(*reinterpret_cast<const uint4*>(st + r * 256 + c16 * 16), w);
        const float xv = __bfloat162float(xs[k0 + r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) part[j] = fmaf(xv, w[j], part[j]);
      }
      if (cons.st == s.n_up - 1) {   // the k groups meet: h of the chunk
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          red[kg * 128 + c16 * 8 + j] = part[j];
          part[j] = 0.f;
        }
        __syncthreads();
        if (tid < kChunk) {
          float g = 0.f, u = 0.f;
          for (int q = 0; q < kKGroups; ++q) {
            g += red[q * 128 + tid];
            u += red[q * 128 + 64 + tid];
          }
          hs[tid] = tid < cols ? g / (1.f + expf(-g)) * u : 0.f;
        }
      }
    } else {
      // down: rows [r0, r0 + n) of the chunk, 8 columns a pass
      const int r0 = (cons.st - s.n_up) * rows_a_down;
      const int n = min(rows_a_down, cols - r0);
      for (int r = 0; r < n; ++r) {
        const float hv = hs[r0 + r];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int col = (tid + p * kThreads) * 8;
          if (col >= d) break;
          float w[8];
          bf16x8(*reinterpret_cast<const uint4*>(st + (r * d + col) * 2), w);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(hv, w[j], acc[p][j]);
        }
      }
    }
    Cursor next = cons;
    advance(next, s, live);
    if (next.u != cons.u) {   // the unit's partial, to its row of ws
      float* out = ws + ((long long)slice * E + e) * d;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int col = (tid + p * kThreads) * 8;
        if (col < d) {
          *reinterpret_cast<float4*>(out + col) =
              float4{acc[p][0], acc[p][1], acc[p][2], acc[p][3]};
          *reinterpret_cast<float4*>(out + col + 4) =
              float4{acc[p][4], acc[p][5], acc[p][6], acc[p][7]};
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
      }
    }
    cons = next;
  }
  sm90::cp_async_wait<0>();
}

// y = the sum of ws over the slices, in slice order, bf16; zero at an
// expert with no token, whose rows of ws are not read
__global__ void __launch_bounds__(kThreads)
moe_decode_sum(const float* __restrict__ ws, const int* __restrict__ counts,
               bf16* __restrict__ y, int E, int d, int n_slices) {
  const long long n = (long long)E * d;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    if (counts[i / d] > 0)
      for (int s = 0; s < n_slices; ++s) acc += ws[s * n + i];
    y[i] = __float2bfloat16(acc);
  }
}

template <int NP>
int launch_np(const void* x, const void* wi, const void* wo,
              const void* counts, void* ws, int E, int d, int f, int W,
              int n_slices, int n_ctas, void* stream) {
  auto kernel = moe_decode_kernel<NP>;
  const int smem = smem_bytes(d, E);
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxD, kMaxE));
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, n_ctas, kThreads, smem, stream, (const bf16*)x,
                 (const bf16*)wi, (const bf16*)wo, (const int*)counts,
                 (float*)ws, E, d, f, W, n_slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (E, 1, d), wi: (E, d, 2f), wo: (E, f, d), y: (E, 1, d), bf16, all
// contiguous and 16-byte aligned, d and f multiples of 8, d <= 8192, E <=
// 1024; counts: int32 (E,), an expert live where its count is at least
// 1. f is cut into n_slices slices of W
// columns (W a multiple of 64, the last slice shorter): (n_slices - 1) W
// < f <= n_slices W. ws: a float32 (n_slices, E, d) scratch. n_ctas: the
// persistent grid, at least 1 (the sum takes 4 blocks for each).
extern "C" int moe_ff_decode_bf16(const void* x, const void* wi,
                                  const void* wo, const void* counts,
                                  void* ws, void* y, int E, int d, int f,
                                  int W, int n_slices, int n_ctas,
                                  void* stream) {
  if (counts == nullptr || E < 1 || E > kMaxE || d < 8 || d > kMaxD ||
      d % 8 || f < 8 || f % 8 || W < kChunk || W % kChunk ||
      n_slices < 1 || n_ctas < 1 || (long long)(n_slices - 1) * W >= f ||
      (long long)n_slices * W < f)
    return kBadArgs;
  const int np = (d + 2047) / 2048;
  const int err =
      np == 1 ? launch_np<1>(x, wi, wo, counts, ws, E, d, f, W, n_slices,
                             n_ctas, stream)
      : np == 2 ? launch_np<2>(x, wi, wo, counts, ws, E, d, f, W, n_slices,
                               n_ctas, stream)
      : np == 3 ? launch_np<3>(x, wi, wo, counts, ws, E, d, f, W, n_slices,
                               n_ctas, stream)
                : launch_np<4>(x, wi, wo, counts, ws, E, d, f, W, n_slices,
                               n_ctas, stream);
  if (err != 0) return err;
  const long long n = (long long)E * d;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = (long long)kSumBlocksACta * n_ctas;
  auto sum = moe_decode_sum;
  VX_LAUNCH(sum, (int)(want < most ? want : most), kThreads,
            stream, (const float*)ws, (const int*)counts, (bf16*)y, E, d,
            n_slices);
  return (int)cudaGetLastError();
}
