// The grouped SwiGLU expert FF's gradient. For every expert e and capacity
// row below its count (the forward took the rest as zero rows), with the
// forward's pre-activation gu = x @ wi (the gate g in columns [0, f), the
// up part u in [f, 2f)) and the output's gradient dy, float32 sums:
//
//   dh  = dy @ wo^T                               (E, C, f)
//   s   = sigmoid(g),  silu(g) = g * s,  silu'(g) = s * (1 + g * (1 - s))
//   dgu = [dh * u * silu'(g), dh * silu(g)]       (E, C, 2f), x's type
//   h   = silu(g) * u                             (E, C, f),  x's type
//   dx  = dgu @ wi^T,  dwi = x^T @ dgu,  dwo = h^T @ dy
//
// dx is zero at rows at or past the count, and x's rows there add
// nothing to dwi, whatever x holds there.
//
// No TPU kernel stands behind it: the reference differentiates the
// einsums of repro/models/moe.py:moe_ff with jax.grad, and its Pallas
// grouped_expert_ff (repro/kernels/moe_dispatch/moe_dispatch.py) has no
// custom_vjp. Two routes; the wrapper (moe_dispatch_bwd.py: route) picks
// one from the dtype and the shapes, by the forward's rule:
//
// The tensor-core route (bf16, C > 1, d and f multiples of 8),
// moe_ff_bwd_bf16_tc. Bound: operations, 12 FLOP a filled (row, d, f):
// dh 2, dx 4, dwi 4, dwo 2, which only the tensor cores reach (olmoe's
// layer, 65,536 of 81,920 rows filled: 1.65 TFLOP, 1.67 ms at 989
// TFLOP/s). The forward keeps gu (moe_dispatch.cu's moe_up_tc writes it
// from its accumulators where the caller asks), so the up product is not
// run again, and three wgmma kernels on moe_tc.cuh's ring (128 rows a
// CTA, two 128-column accumulators, 64 k a stage, four stages, copies two
// stages ahead) compute only the filled rows: a row block wholly past its
// expert's count returns before loading (moe_dx_tc writes its zeros), and
// the copies zero-fill the rows past the count, so x needs no masking
// pass:
//   * moe_dh_tc: dh over K = d (dy K-major; wo read as wo^T, K-major: a
//     row of wo is an output column's k), and in its epilogue the SwiGLU
//     backward in float32 from the tile's g and u (copied from gu into
//     the ring once the products are done): dgu and h stored in bf16 (h
//     rounded as the reference's moe.py:85), rows past the count not
//     written (nothing reads them). dh never goes to device memory, and
//     no separate elementwise pass reads gu and dh.
//   * moe_dx_tc: dx = dgu @ wi^T over K = 2f (wi read K-major as wo).
//   * moe_dw_tc: dwi[e] = x[e]^T dgu[e] (d x 2f) and dwo[e] = h[e]^T dy[e]
//     (f x d), one CTA an output tile of either, K = the expert's filled
//     rows (the last k-step zero-filled past them). A is the transpose of
//     a row-major matrix, read MN-major with wgmma's transpose bit; B
//     MN-major. No split-K: an expert with count 0 writes zeros and reads
//     nothing. (A persistent walk, a CTA an SM with the ring running on
//     from one tile into the next, was 11-13 % slower on the H100.)
// Every output element is written by one CTA from one accumulator, its
// sum over k in a fixed order: no atomics, two calls give the same bits.
//
// The CUDA-core route (float32, and bf16 the tensor-core route does not
// take): the five products are batched torch.bmm calls in the wrapper
// (gu again, dh, dwo, dwi, dx, as XLA runs the reference's), and this
// file's swiglu_bwd is the elementwise pass between them. Bound: bytes.
// A live row reads g, u and dh and writes dgu and h, 6f elements, for
// about 20 operations an element of h. One CTA of 128 threads takes a row
// at a time (rows blockIdx.x, blockIdx.x + gridDim.x, ...), neighbouring
// threads on neighbouring 16-byte vectors (8 bf16 or 4 float32) where f
// is a whole number of vectors and every pointer is on 16 bytes; one
// element a thread otherwise. Rows at or past counts[e] are written as
// zeros and not read.
//
// The float32 instantiation of swiglu_bwd compiles with g++ against the
// stand-in runtime in tests/cuda_host; the tensor-core kernels with g++,
// -D__CUDACC__ and tests/cuda_host/sm90's emulation of sm90.cuh.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
#include "vec16.cuh"
#include "moe_tc.cuh"

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

constexpr int kThreads = 128;
constexpr long long kMaxGrid = 1 << 20;

__device__ __forceinline__ void swiglu_grad(float g, float u, float dh,
                                            float& dg, float& du,
                                            float& h) {
  const float s = 1.f / (1.f + expf(-g));
  const float silu = g * s;
  h = silu * u;
  du = dh * silu;
  dg = dh * u * (s * (1.f + g * (1.f - s)));
}

__device__ __forceinline__ bool live_row(const int* counts, long long r,
                                         int C) {
  return counts == nullptr || (int)(r % C) < counts[r / C];
}

// 16-byte vectors: f a multiple of 16 / sizeof(T), pointers on 16 bytes
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_vec(const T* __restrict__ gu, const T* __restrict__ dh,
               const int* __restrict__ counts, T* __restrict__ dgu,
               T* __restrict__ h, long long rows, int C, int f) {
  constexpr int V = 16 / sizeof(T);
  const int nv = f / V;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const bool live = live_row(counts, r, C);
    const T* g_row = gu + r * 2 * f;
    const T* dh_row = dh + r * f;
    T* dg_row = dgu + r * 2 * f;
    T* h_row = h + r * f;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      const int j = v * V;
      uint4 og{0u, 0u, 0u, 0u}, ou{0u, 0u, 0u, 0u}, oh{0u, 0u, 0u, 0u};
      if (live) {
        float g[V], u[V], d[V], dg[V], du[V], hv[V];
        unpack(*reinterpret_cast<const uint4*>(g_row + j), g, g_row);
        unpack(*reinterpret_cast<const uint4*>(g_row + f + j), u, g_row);
        unpack(*reinterpret_cast<const uint4*>(dh_row + j), d, g_row);
#pragma unroll
        for (int i = 0; i < V; ++i) swiglu_grad(g[i], u[i], d[i], dg[i],
                                                du[i], hv[i]);
        og = pack(dg, g_row);
        ou = pack(du, g_row);
        oh = pack(hv, g_row);
      }
      *reinterpret_cast<uint4*>(dg_row + j) = og;
      *reinterpret_cast<uint4*>(dg_row + f + j) = ou;
      *reinterpret_cast<uint4*>(h_row + j) = oh;
    }
  }
}

// one element a thread: any f, any alignment
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_rows(const T* __restrict__ gu, const T* __restrict__ dh,
                const int* __restrict__ counts, T* __restrict__ dgu,
                T* __restrict__ h, long long rows, int C, int f) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const bool live = live_row(counts, r, C);
    for (int j = threadIdx.x; j < f; j += kThreads) {
      float dg = 0.f, du = 0.f, hv = 0.f;
      if (live)
        swiglu_grad(to_f32(gu[r * 2 * f + j]), to_f32(gu[r * 2 * f + f + j]),
                    to_f32(dh[r * f + j]), dg, du, hv);
      store_f32(dg, dgu + r * 2 * f + j);
      store_f32(du, dgu + r * 2 * f + f + j);
      store_f32(hv, h + r * f + j);
    }
  }
}

template <typename T>
int launch(const void* gu, const void* dh, const void* counts, void* dgu,
           void* h, int E, int C, int f, void* stream) {
  const long long rows = (long long)E * C;
  if (rows <= 0 || f <= 0) return 0;
  const int grid = (int)(rows < kMaxGrid ? rows : kMaxGrid);
  constexpr int V = 16 / sizeof(T);
  if (f % V == 0 && ((uintptr_t)gu | (uintptr_t)dh | (uintptr_t)dgu |
                     (uintptr_t)h) % 16 == 0) {
    auto k = swiglu_bwd_vec<T>;
    VX_LAUNCH(k, grid, kThreads, stream, (const T*)gu, (const T*)dh,
              (const int*)counts, (T*)dgu, (T*)h, rows, C, f);
  } else {
    auto k = swiglu_bwd_rows<T>;
    VX_LAUNCH(k, grid, kThreads, stream, (const T*)gu, (const T*)dh,
              (const int*)counts, (T*)dgu, (T*)h, rows, C, f);
  }
  return (int)cudaGetLastError();
}

#ifdef __CUDACC__
// ---- the tensor-core route: bf16, C > 1, d and f multiples of 8 ---------

constexpr int kBadArgs = 1;          // returned for shapes it does not take
constexpr int BW_COLS = 2 * TC_BN;   // output columns a CTA: two
                                     // 128-column accumulators
constexpr int kGuPitch = 2 * BW_COLS + 16;   // bytes a row of g or u in
                                             // moe_dh_tc's epilogue
static_assert(2 * TC_BM * kGuPitch <= RING, "g and u fit in the ring");

// the output element (row, column) of accumulator fragment entry
// acc[t][4 j + 2 r + c] of thread tid, for a tile at (row0, n0)
__device__ __forceinline__ int frag_row(int row0, int tid, int r) {
  return row0 + tid / 128 * 64 + (tid % 128) / 32 * 16 + (tid % 32) / 4 +
         8 * r;
}
__device__ __forceinline__ int frag_col(int n0, int tid, int t, int j) {
  return n0 + t * TC_BN + 8 * j + 2 * (tid % 4);
}

// the tile's 128 rows x 256 columns from (row0, n0) of a (rows x cols)
// bf16 matrix with row stride ld, from the accumulators; rows from
// ``rows`` on and columns from ``cols`` on not written
__device__ __forceinline__ void store_tile(const float (&acc)[2][64],
                                           bf16* out, long long ld,
                                           int row0, int n0, int rows,
                                           int cols, int tid) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = frag_row(row0, tid, r);
    if (row >= rows) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = frag_col(n0, tid, t, j);
        if (col >= cols) continue;
        *reinterpret_cast<uint32_t*>(out + row * ld + col) =
            sm90::pack_bf16(acc[t][4 * j + 2 * r], acc[t][4 * j + 2 * r + 1]);
      }
  }
}

// a CTA's block of the (expert, column block, row block) grid, the row
// blocks of one column block adjacent in launch order (they share its B
// tiles in L2)
struct Block {
  int e, row0, n0;
  __device__ __forceinline__ Block(int blk, int n_mb, int n_nb) {
    const int en = blk / n_mb;
    e = en / n_nb;
    row0 = (blk % n_mb) * TC_BM;
    n0 = (en % n_nb) * BW_COLS;
  }
};

// dh = dy wo^T on the filled rows of a 128-row block and 256 columns of
// f, and from it and the saved g and u, dgu and h (the note at the top)
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_dh_tc(const bf16* __restrict__ dy, const bf16* __restrict__ wo,
          const bf16* __restrict__ gu, const int* __restrict__ counts,
          bf16* __restrict__ dgu, bf16* __restrict__ h, int C, int d, int f,
          int n_mb, int n_nb) {
  VX_DYN_SMEM(smem);
  const Block k(blockIdx.x, n_mb, n_nb);
  const int tid = threadIdx.x;
  const int filled = filled_rows(counts, k.e, C);
  if (k.row0 >= filled) return;
  const u16* const a[1] = {reinterpret_cast<const u16*>(dy) +
                           ((long long)k.e * C + k.row0) * d};
  const u16* wn =
      reinterpret_cast<const u16*>(wo) + ((long long)k.e * f + k.n0) * d;
  const u16* const b[2] = {wn, wn + (long long)TC_BN * d};
  const uint32_t ring = sm90::align1024(smem);
  float acc[2][64];
  mainloop<sm90::BF16, false, false, 1, 2, STAGES, false, false>(
      acc, ring, a, d, filled - k.row0, b, d, f - k.n0, TC_BN, d, tid);
  // The tile's g and u (128 rows of 256 columns each) into the ring, free
  // now, in 16-byte chunks, all in flight at once: rows kGuPitch bytes
  // apart, so that the eight rows a warp reads at once fall on other
  // banks. (Read from device memory a pair a thread at a time, as the
  // fragments hold them, they cost as much as the tile's products.)
  __syncthreads();   // every warpgroup is done with the ring
  const uint32_t su = ring + TC_BM * kGuPitch;
  const bf16* g0 = gu + ((long long)k.e * C + k.row0) * 2 * f;
#pragma unroll 4
  for (int i = tid; i < TC_BM * 64; i += TC_THREADS) {
    const int r = i / 64, half = (i / 32) % 2, ch = i % 32;
    const int col = k.n0 + 8 * ch;
    const bool in = k.row0 + r < filled && col < f;
    sm90::cp_async16((half ? su : ring) + r * kGuPitch + 16 * ch,
                     g0 + (in ? r * 2LL * f + half * f + col : 0), in);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  const unsigned char* gs = smem + (ring - sm90::smem_addr(smem));
  const unsigned char* us = gs + TC_BM * kGuPitch;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = frag_row(k.row0, tid, r);
    if (row >= filled) continue;
    const long long er = (long long)k.e * C + row;
    const int so = (row - k.row0) * kGuPitch;
    bf16* dr = dgu + er * 2 * f;
    bf16* hr = h + er * f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = frag_col(k.n0, tid, t, j);
        if (col >= f) continue;
        const int o = so + 2 * (col - k.n0);
        const uint32_t gw = *reinterpret_cast<const uint32_t*>(gs + o);
        const uint32_t uw = *reinterpret_cast<const uint32_t*>(us + o);
        float dg[2], du[2], hv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          swiglu_grad(__uint_as_float(c ? gw & 0xffff0000u : gw << 16),
                      __uint_as_float(c ? uw & 0xffff0000u : uw << 16),
                      acc[t][4 * j + 2 * r + c], dg[c], du[c], hv[c]);
        *reinterpret_cast<uint32_t*>(dr + col) = sm90::pack_bf16(dg[0], dg[1]);
        *reinterpret_cast<uint32_t*>(dr + f + col) =
            sm90::pack_bf16(du[0], du[1]);
        *reinterpret_cast<uint32_t*>(hr + col) = sm90::pack_bf16(hv[0], hv[1]);
      }
  }
}

// dx = dgu wi^T on a 128-row block and 256 columns of d; zero at the
// rows past the count (a block wholly past it reads nothing)
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_dx_tc(const bf16* __restrict__ dgu, const bf16* __restrict__ wi,
          const int* __restrict__ counts, bf16* __restrict__ dx, int C, int d,
          int f, int n_mb, int n_nb) {
  VX_DYN_SMEM(smem);
  const Block k(blockIdx.x, n_mb, n_nb);
  const int tid = threadIdx.x;
  const int filled = filled_rows(counts, k.e, C);
  bf16* xe = dx + (long long)k.e * C * d;
  float acc[2][64];
  if (k.row0 >= filled) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
  } else {
    const u16* const a[1] = {reinterpret_cast<const u16*>(dgu) +
                             ((long long)k.e * C + k.row0) * 2 * f};
    const u16* wn = reinterpret_cast<const u16*>(wi) +
                    ((long long)k.e * d + k.n0) * 2 * f;
    const u16* const b[2] = {wn, wn + (long long)TC_BN * 2 * f};
    mainloop<sm90::BF16, false, false, 1, 2, STAGES, false, false>(
        acc, sm90::align1024(smem), a, 2LL * f, filled - k.row0, b, 2LL * f,
        d - k.n0, TC_BN, 2 * f, tid);
  }
  // the rows past the count hold zeros: their A rows were zero-filled
  store_tile(acc, xe, d, k.row0, k.n0, C, d, tid);
}

// dwi[e] = x[e]^T dgu[e] (blocks [0, n_wi)) and dwo[e] = h[e]^T dy[e]
// (the rest) on a 128 x 256 output tile, over the expert's filled rows
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_dw_tc(const bf16* __restrict__ x, const bf16* __restrict__ dgu,
          const bf16* __restrict__ h, const bf16* __restrict__ dy,
          const int* __restrict__ counts, bf16* __restrict__ dwi,
          bf16* __restrict__ dwo, int C, int d, int f, int n_wi) {
  VX_DYN_SMEM(smem);
  const int tid = threadIdx.x;
  const bool is_wi = (int)blockIdx.x < n_wi;
  // dwi: M = d, N = 2f, A = x, B = dgu; dwo: M = f, N = d, A = h, B = dy
  const int M = is_wi ? d : f, N = is_wi ? 2 * f : d;
  const int n_mb = (M + TC_BM - 1) / TC_BM;
  const int n_nb = (N + BW_COLS - 1) / BW_COLS;
  const Block k(is_wi ? blockIdx.x : blockIdx.x - n_wi, n_mb, n_nb);
  const int filled = filled_rows(counts, k.e, C);
  const long long ea = (long long)k.e * C;
  const u16* const a[1] = {
      reinterpret_cast<const u16*>(is_wi ? x : h) + ea * M + k.row0};
  const u16* bn = reinterpret_cast<const u16*>(is_wi ? dgu : dy) + ea * N +
                  k.n0;
  const u16* const b[2] = {bn, bn + TC_BN};
  float acc[2][64];
  // K = the filled rows: none, and the accumulators stay zero
  mainloop<sm90::BF16, false, false, 1, 2, STAGES, true, true>(
      acc, sm90::align1024(smem), a, M, M - k.row0, b, N, N - k.n0, TC_BN,
      filled, tid);
  bf16* out = (is_wi ? dwi : dwo) + (long long)k.e * M * N;
  store_tile(acc, out, N, k.row0, k.n0, M, N, tid);
}

int launch_bwd_tc(const void* dy, const void* x, const void* wi,
                  const void* wo, const void* gu, const void* counts,
                  void* dgu, void* h, void* dx, void* dwi, void* dwo, int E,
                  int C, int d, int f, void* stream) {
  if (C < 2 || d % 8 || f % 8) return kBadArgs;
  auto dh_k = moe_dh_tc;
  auto dx_k = moe_dx_tc;
  auto dw_k = moe_dw_tc;
  static const int attr[3] = {
      (int)cudaFuncSetAttribute(
          dh_k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM),
      (int)cudaFuncSetAttribute(
          dx_k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM),
      (int)cudaFuncSetAttribute(
          dw_k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)};
  for (int i = 0; i < 3; ++i)
    if (attr[i] != 0) return attr[i];
  const int n_mb = (C + TC_BM - 1) / TC_BM;
  const int n_fb = (f + BW_COLS - 1) / BW_COLS;
  VX_LAUNCH_SMEM(dh_k, E * n_fb * n_mb, TC_THREADS, SMEM, stream,
                 (const bf16*)dy, (const bf16*)wo, (const bf16*)gu,
                 (const int*)counts, (bf16*)dgu, (bf16*)h, C, d, f, n_mb,
                 n_fb);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_db = (d + BW_COLS - 1) / BW_COLS;
  VX_LAUNCH_SMEM(dx_k, E * n_db * n_mb, TC_THREADS, SMEM, stream,
                 (const bf16*)dgu, (const bf16*)wi, (const int*)counts,
                 (bf16*)dx, C, d, f, n_mb, n_db);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_wi = E * ((d + TC_BM - 1) / TC_BM) *
                   ((2 * f + BW_COLS - 1) / BW_COLS);
  const int n_wo = E * ((f + TC_BM - 1) / TC_BM) * n_db;
  VX_LAUNCH_SMEM(dw_k, n_wi + n_wo, TC_THREADS, SMEM, stream,
                 (const bf16*)x, (const bf16*)dgu, (const bf16*)h,
                 (const bf16*)dy, (const int*)counts, (bf16*)dwi, (bf16*)dwo,
                 C, d, f, n_wi);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

// gu: (E, C, 2f), dh: (E, C, f); dgu: (E, C, 2f), h: (E, C, f), all
// contiguous, of one type; counts: (E,) int32 or null (every row live).
extern "C" int swiglu_bwd_f32(const void* gu, const void* dh,
                              const void* counts, void* dgu, void* h, int E,
                              int C, int f, void* stream) {
  return launch<float>(gu, dh, counts, dgu, h, E, C, f, stream);
}

#ifdef __CUDACC__
extern "C" int swiglu_bwd_bf16(const void* gu, const void* dh,
                               const void* counts, void* dgu, void* h, int E,
                               int C, int f, void* stream) {
  return launch<__nv_bfloat16>(gu, dh, counts, dgu, h, E, C, f, stream);
}
#endif

#ifdef __CUDACC__
// The tensor-core route: dy, x (E, C, d), wi (E, d, 2f), wo (E, f, d), gu
// (E, C, 2f) the forward's pre-activation (its filled rows), all bf16,
// contiguous, 16-byte aligned; counts null or int32 (E,); scratch dgu
// (E, C, 2f) and h (E, C, f) bf16; out dx (E, C, d), dwi, dwo as wi, wo.
// C >= 2, d and f multiples of 8; each grid below 2^31 CTAs.
extern "C" int moe_ff_bwd_bf16_tc(const void* dy, const void* x,
                                  const void* wi, const void* wo,
                                  const void* gu, const void* counts,
                                  void* dgu, void* h, void* dx, void* dwi,
                                  void* dwo, int E, int C, int d, int f,
                                  void* stream) {
  return launch_bwd_tc(dy, x, wi, wo, gu, counts, dgu, h, dx, dwi, dwo, E,
                       C, d, f, stream);
}
#endif
