// Grouped SwiGLU expert feed-forward: for every expert e and capacity row,
//   y[e] = (silu(x[e] @ wi[e][:, :f]) * (x[e] @ wi[e][:, f:])) @ wo[e],
// float32 sums, stored in x's type.
//
// Replaces repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff
// (the Pallas TPU kernel, grid (E, C / 128), the (128, 2f) hidden tile in
// VMEM). That tile is 1 MB in float32 at olmoe's f = 1024 and 25 MB at
// jamba's f = 24576, far past what a CTA can hold, so the kernel is
// thought through again. Two routes; the wrapper (moe_dispatch.py:
// route) picks one from the dtype and the shapes:
//
// The tensor-core route (bf16, C > 1, d and f multiples of 8: rows of
// 16-byte multiples), moe_ff_bf16_tc. At prefill the function is bound
// by operations, 6 E C d f FLOP, which only the tensor cores reach. A
// 128-row hidden tile is 6.3 MB in bf16 at f = 24576; keeping it on chip
// would force the down product's partial outputs through a float32
// workspace per f-slice (4 E C d bytes a slice, more than the hidden
// itself). So the route runs two grouped GEMMs and passes the hidden
// through device memory once:
//   * moe_up_tc: one CTA per (expert, 128-column block of f, 128-row
//     block of C), the row blocks of one column block adjacent in launch
//     order so that they share its weight tile in L2. Two warpgroups of
//     64 rows keep the gate and up sums of 128 columns (two 64-register
//     accumulators a thread) and step over K = d 64 at a time; x is
//     K-major, wi (E, d, 2f) MN-major (the transpose bit). The epilogue
//     writes h = silu(g) * u as two bf16 parts, hi = bf16(h) and
//     lo = bf16(h - hi), into h (E, C, 2f): hi in its first f columns.
//   * moe_down_tc: one CTA per (expert, 128-column block of d, 128-row
//     block), hi @ wo + lo @ wo over K = f into one accumulator, wo
//     (E, f, d) MN-major and read once for both; y stored in bf16.
//   Why two parts: h rounded to bf16 alone (8 significant bits: an error
//   up to 2^-8 of each term) puts some of y more than rtol 1e-2 +
//   atol 2e-3 from the float32 function at the paths' widths
//   (tests/test_torch_moe_kernels.py holds a rounding model of both);
//   hi + lo carries h to about 2^-16. It costs a third more tensor work (the down product
//   twice) and 4 E C f bytes each way, 4 GB at jamba's prefill (1.2 ms
//   at 3.35 TB/s against a 25 ms bound).
//   Each stage of the ring holds three 16 KB tiles in the 128-byte-
//   swizzled layout of sm90.cuh (x and wi's gate and up tiles, or h's two
//   parts and wo's tile), copied by cp.async (16 bytes a thread; rows
//   past C, k past d or f and columns past the end zero-filled, so any C,
//   d, f that are multiples of 8 are taken); four stages, 192 KB, with
//   two stages of copies in flight ahead of the stage that wgmma
//   m64n128k16 reads and one wgmma group left in flight across the next
//   stage's barrier. TMA would spend no thread instructions on the
//   copies; that matters once a producer warp is split off (a later
//   change). No split-K, no atomics: the result does not depend on the
//   order in which CTAs run.
//
// The CUDA-core route (float32, decode's C = 1, and rows the copies
// cannot take), moe_ff_f32 and moe_ff_bf16. Two kernels, one call:
//   * moe_ff_partial: one CTA per (expert, slice of the hidden columns,
//     block of BM capacity rows); the row blocks of one expert slice are
//     adjacent in launch order, so the CTAs that run together share its
//     weights in L2. A CTA walks its slice in chunks of FC columns:
//       - phase 1, the gate and up products of the chunk: each thread
//         keeps VEC columns' gate and up sums for the BM rows in
//         registers, reads its weights of each k from device memory
//         (neighbouring threads on neighbouring columns) and x^T from a
//         tile staged in shared memory. silu(g) * u goes to the hidden
//         tile h, (FC, BM) float32 in dynamic shared memory. The hidden
//         never goes to device memory.
//       - phase 2, the chunk's part of the down product: VEC output
//         columns per thread, BM x VEC sums in registers, wo read once per
//         CTA, added into the CTA's own rows of a float32 workspace
//         ws[slice, e, row, :] (written by its first chunk, read and
//         written by the next: no other CTA touches those rows).
//   * moe_ff_sum: y = the sum of ws over the slices, in slice order, cast
//     to x's type. No atomics: the result does not depend on the order in
//     which CTAs run.
//
// Two tilings, picked by C:
//   * C > 1 (prefill): BM = 16 rows, VEC = 1 column a thread, FC = 1024
//     (a 64 KB hidden tile), x^T staged 64 k at a time.
//   * C = 1 (decode): BM = 1, VEC = 8 columns a thread, read as 16-byte
//     loads (bf16) where f and d are multiples of 8. In phase 1 the 256
//     threads are 8 groups of 32: a group takes an eighth of the k rows of
//     256 hidden columns, and the groups' sums meet in shared memory, so
//     every thread streams weights even in a slice of 256 columns.
//     FC = 2048, x staged 1024 k at a time. The caller cuts f into many
//     slices, so that every SM streams expert weights.
// The shared memory a CTA needs no longer grows with f: any C, d and f.
// Rows past C are zero on the way in and not stored; the column loops
// are masked.
//
// Bound: at decode bytes, every expert's weights read once; this route
// reads them at 16 bytes a thread. At decode every expert's weights are
// read even where an expert holds no token; skipping empty experts is a
// later change.
//
// The float32 instantiations compile with g++ against the stand-in
// runtime in tests/cuda_host, which runs them on the CPU.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
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

constexpr int kThreads = 256;    // threads of a CTA
constexpr int kMaxSmem = 232448; // the H100's opt-in maximum per block
constexpr int kBadArgs = 1;      // returned for a slicing that does not fit
constexpr int kSumBlocks = 132 * 8;

// the tiling for BM capacity rows a CTA: VEC hidden columns a thread,
// the k rows split over KS groups of threads, FC hidden columns in shared
// memory at a time, x^T staged KT rows at a time with row stride XS
template <int BM> struct Tile;
template <> struct Tile<16> {
  static constexpr int VEC = 1, KS = 1, FC = 1024, KT = 64, XS = 16 + 4;
};
template <> struct Tile<1> {
  static constexpr int VEC = 8, KS = 8, FC = 2048, KT = 1024, XS = 1;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 w = q[i];
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
#ifdef __CUDACC__
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// two bf16 in a 32-bit word, the first in the low half: a bf16 is the
// top half of the float32 of the same value
__device__ __forceinline__ void bf16x2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  if constexpr (V % 8 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const uint4 w = q[i];
      bf16x2(w.x, v + 8 * i);
      bf16x2(w.y, v + 8 * i + 2);
      bf16x2(w.z, v + 8 * i + 4);
      bf16x2(w.w, v + 8 * i + 6);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
#endif

// V values from p: one vector load where all V are in range and aligned,
// else element by element, zero past ``valid``
template <int V, typename T>
__device__ __forceinline__ void load_cols(const T* p, int valid, bool vec,
                                          float (&v)[V]) {
  if (vec && valid >= V) {
    load_vec<V>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

// the BM floats of one row of a (., BM) shared tile: float4 broadcasts
template <int BM>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[BM]) {
  load_vec<BM>(p, v);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
moe_ff_partial(const T* __restrict__ x, const T* __restrict__ wi,
               const T* __restrict__ wo, float* __restrict__ ws, int E,
               int C, int d, int f, int fs, int n_slices, int n_mb) {
  using TL = Tile<BM>;
  constexpr int VEC = TL::VEC, KS = TL::KS, FC = TL::FC, KT = TL::KT,
                XS = TL::XS;
  constexpr int CT = kThreads / KS;             // column threads
  constexpr int PW = CT * VEC;                  // hidden columns a pass
  static_assert(KS == 1 || BM == 1, "k groups are for one row");
  VX_DYN_SMEM(smem);
  float* hs = reinterpret_cast<float*>(smem);   // (FC, BM): h transposed
  float* xs = hs + FC * BM;                     // (KT, XS): x^T tile
  float* red = xs + KT * XS;                    // (KS, 2, PW): k groups' sums
  const int mb = (int)(blockIdx.x % n_mb);
  const int es = (int)(blockIdx.x / n_mb);
  const int e = es / n_slices, s = es % n_slices;
  const int row0 = mb * BM;
  const int rows = min(BM, C - row0);
  const int j_end = min(f, (s + 1) * fs);
  const T* xe = x + ((long long)e * C + row0) * d;
  const T* wie = wi + (long long)e * d * 2 * f;
  const T* woe = wo + (long long)e * f * d;
  float* wse = ws + (((long long)s * E + e) * C + row0) * d;
  const int tid = threadIdx.x;
  const int kg = tid / CT, ct = tid % CT;       // k group, column thread
  const long long ld = 2LL * f;                 // a row of wi
  const bool vec_wi = f % VEC == 0, vec_wo = d % VEC == 0;

  for (int c0 = s * fs; c0 < j_end; c0 += FC) {
    const int c1 = min(j_end, c0 + FC);

    // phase 1: h[:, j] = silu(x @ wi[:, j]) * (x @ wi[:, f + j])
    for (int p0 = c0; p0 < c1; p0 += PW) {
      const int jb = p0 + ct * VEC;
      const int jn = min(VEC, c1 - jb);         // <= 0: no column here
      float g[BM][VEC], u[BM][VEC];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) g[r][v] = u[r][v] = 0.f;
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
        if (jn > 0) {
          // this thread's k group takes its share of the tile's rows
          const int k_lo = min(kn, kg * (KT / KS));
          const int k_hi = min(kn, (kg + 1) * (KT / KS));
          const T* wg = wie + (long long)k0 * ld + jb;
#pragma unroll 8
          for (int kk = k_lo; kk < k_hi; ++kk) {
            float a[VEC], b[VEC], xv[BM];
            load_cols<VEC>(wg + kk * ld, jn, vec_wi, a);
            load_cols<VEC>(wg + kk * ld + f, jn, vec_wi, b);
            load_rows<BM>(xs + kk * XS, xv);
#pragma unroll
            for (int r = 0; r < BM; ++r)
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                g[r][v] += xv[r] * a[v];
                u[r][v] += xv[r] * b[v];
              }
          }
        }
      }
      if constexpr (KS == 1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (v < jn) {
#pragma unroll
            for (int r = 0; r < BM; ++r)
              hs[(jb - c0 + v) * BM + r] =
                  g[r][v] / (1.f + expf(-g[r][v])) * u[r][v];
          }
      } else {
        // the k groups' sums meet in shared memory; the next pass writes
        // red only after the barriers of its k loop
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          red[(2 * kg) * PW + ct * VEC + v] = g[0][v];
          red[(2 * kg + 1) * PW + ct * VEC + v] = u[0][v];
        }
        __syncthreads();
        for (int c = tid; c < PW && p0 + c < c1; c += kThreads) {
          float gs = 0.f, us = 0.f;
          for (int q = 0; q < KS; ++q) {
            gs += red[(2 * q) * PW + c];
            us += red[(2 * q + 1) * PW + c];
          }
          hs[p0 - c0 + c] = gs / (1.f + expf(-gs)) * us;
        }
      }
    }
    __syncthreads();

    // phase 2: ws[:, n] (+)= h @ wo[c0:c1, n]
    const int cn = c1 - c0;
    const bool first = c0 == s * fs;
    for (int nb0 = 0; nb0 < d; nb0 += kThreads * VEC) {
      const int nb = nb0 + tid * VEC;
      const int nn = min(VEC, d - nb);
      if (nn <= 0) break;
      float acc[BM][VEC];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
      const T* wc = woe + (long long)c0 * d + nb;
#pragma unroll 8
      for (int jj = 0; jj < cn; ++jj) {
        float w[VEC], hv[BM];
        load_cols<VEC>(wc + (long long)jj * d, nn, vec_wo, w);
        load_rows<BM>(hs + jj * BM, hv);
#pragma unroll
        for (int r = 0; r < BM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] += hv[r] * w[v];
      }
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (r < rows && v < nn) {
            float* p = wse + (long long)r * d + nb + v;
            *p = first ? acc[r][v] : *p + acc[r][v];
          }
    }
    __syncthreads();   // h is rewritten by the next chunk
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_ff_sum(const float* __restrict__ ws, T* __restrict__ y, long long n,
           int n_slices) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int s = 0; s < n_slices; ++s) acc += ws[s * n + i];
    store_f32(acc, y + i);
  }
}

template <typename T, int BM>
int launch_partial(const void* x, const void* wi, const void* wo, void* ws,
                   int E, int C, int d, int f, int fs, int n_slices,
                   void* stream) {
  using TL = Tile<BM>;
  const int n_mb = (C + BM - 1) / BM;
  const size_t red = TL::KS == 1 ? 0 : 2 * kThreads * TL::VEC;
  const size_t smem =
      ((size_t)TL::FC * BM + TL::KT * TL::XS + red) * sizeof(float);
  auto kernel = moe_ff_partial<T, BM>;
  // once per instantiation: allow up to the card's maximum
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, E * n_slices * n_mb, kThreads, smem, stream,
                 (const T*)x, (const T*)wi, (const T*)wo, (float*)ws, E, C,
                 d, f, fs, n_slices, n_mb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wi, const void* wo, void* ws, void* y,
           int E, int C, int d, int f, int fs, int n_slices, void* stream) {
  if (fs < 1 || n_slices < 1 || (long long)(n_slices - 1) * fs >= f ||
      (long long)n_slices * fs < f)
    return kBadArgs;
  const int err = C == 1
      ? launch_partial<T, 1>(x, wi, wo, ws, E, C, d, f, fs, n_slices, stream)
      : launch_partial<T, 16>(x, wi, wo, ws, E, C, d, f, fs, n_slices,
                              stream);
  if (err != 0) return err;
  const long long n = (long long)E * C * d;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSumBlocks ? want : kSumBlocks);
  auto sum = moe_ff_sum<T>;
  VX_LAUNCH(sum, blocks, kThreads, stream, (const float*)ws, (T*)y, n,
            n_slices);
  return (int)cudaGetLastError();
}


#ifdef __CUDACC__
// ---- the tensor-core route: bf16, C > 1, d and f multiples of 8 ---------

using bf16 = __nv_bfloat16;
constexpr int TC_BM = 128;       // capacity rows a CTA: two warpgroups
constexpr int TC_BN = 128;       // output columns a CTA
constexpr int TC_BK = 64;        // k a stage: one 128-byte row
constexpr int TC_THREADS = 256;
constexpr int A_BYTES = TC_BM * TC_BK * 2;   // 16 KB
constexpr int B_BYTES = TC_BK * TC_BN * 2;   // 16 KB
constexpr int B_BLOCK = TC_BK * 128;         // its 64-column blocks: 8 KB

// the A tile: rows < ``rows`` and k < ``kn`` of src (ld elements a row),
// K-major
__device__ __forceinline__ void copy_a(uint32_t dst, const bf16* src,
                                       long long ld, int rows, int kn,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < TC_BM * 8 / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c >> 3, ch = c & 7;
    const bool in = r < rows && ch * 8 < kn;
    sm90::cp_async16(dst + sm90::swz(r, ch),
                     src + (in ? r * ld + ch * 8 : 0), in);
  }
}

// a B tile: k rows < ``kn`` and columns < ``cols`` of src, MN-major, as
// two blocks of 64 columns
__device__ __forceinline__ void copy_b(uint32_t dst, const bf16* src,
                                       long long ld, int kn, int cols,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < TC_BK * (TC_BN / 8) / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c >> 4, ch = c & 15;
    const bool in = r < kn && ch * 8 < cols;
    sm90::cp_async16(dst + (ch >> 3) * B_BLOCK + sm90::swz(r, ch & 7),
                     src + (in ? r * ld + ch * 8 : 0), in);
  }
}

// acc[j] = sum over i of A_i B_j, over K: A_i's rows from a[i] (lda
// apart, ``rows`` of them), B_j's k rows from b[j] (ldb apart, ``cols``
// columns); a ring of STAGES stages at smem, copies two stages ahead
template <int NA, int NB, int STAGES>
__device__ __forceinline__ void
mainloop(float (&acc)[NB][64], uint32_t smem, const bf16* const (&a)[NA],
         long long lda, int rows, const bf16* const (&b)[NB],
         long long ldb, int cols, int K, int tid) {
  static_assert(STAGES >= 3, "two stages ahead and one read");
  constexpr int STAGE = NA * A_BYTES + NB * B_BYTES;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int wg = tid / 128;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  auto load = [&](int kt) {
    const uint32_t st = smem + (kt % STAGES) * STAGE;
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      copy_a(st + i * A_BYTES, a[i] + k0, lda, rows, K - k0, tid);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      copy_b(st + NA * A_BYTES + j * B_BYTES, b[j] + k0 * ldb, ldb, K - k0,
             cols, tid);
  };
  for (int kt = 0; kt < STAGES - 2; ++kt) {
    if (kt < nk) load(kt);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 3>();   // stage kt has landed
    sm90::fence_async_smem();
    // every copy of stage kt is visible; every warpgroup has waited for
    // its products of stage kt - 2, whose buffer the next copy reuses
    __syncthreads();
    if (kt + STAGES - 2 < nk) load(kt + STAGES - 2);
    sm90::cp_async_commit();
    const uint32_t st = smem + (kt % STAGES) * STAGE;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const uint64_t da =
            sm90::desc(st + i * A_BYTES + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          sm90::Mma<128, 1>::ss(
              acc[j], da,
              sm90::desc(st + NA * A_BYTES + j * B_BYTES + kk * 2048,
                         B_BLOCK, 1024),
              1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NB; ++j) sm90::fence_regs(acc[j]);
}

constexpr int STAGES = 4;        // 4 x 48 KB: x and wi's gate and up
                                 // tiles, or h's two parts and wo's tile
constexpr int SMEM = STAGES * 3 * A_BYTES + 1024;
static_assert(A_BYTES == B_BYTES, "three 16 KB tiles a stage");

// h[e, rows, cols] = silu(x wi_gate) * (x wi_up), as bf16 hi and lo
// parts: h (E, C, 2f) holds hi in its first f columns, lo in the rest
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_up_tc(const bf16* __restrict__ x, const bf16* __restrict__ wi,
          bf16* __restrict__ h, int C, int d, int f, int n_mb, int n_nb) {
  VX_DYN_SMEM(smem);
  const int mb = (int)(blockIdx.x % n_mb);
  const int en = (int)(blockIdx.x / n_mb);
  const int nb = en % n_nb, e = en / n_nb;
  const int row0 = mb * TC_BM, j0 = nb * TC_BN, tid = threadIdx.x;
  const bf16* we = wi + (long long)e * d * 2 * f + j0;
  const bf16* const a[1] = {x + ((long long)e * C + row0) * d};
  const bf16* const b[2] = {we, we + f};
  float acc[2][64];
  mainloop<1, 2, STAGES>(acc, sm90::align1024(smem), a, d, C - row0, b,
                         2LL * f, f - j0, d, tid);
  const int lane = tid % 32;
  const int r0 = row0 + tid / 128 * 64 + (tid % 128) / 32 * 16 + lane / 4;
  bf16* he = h + (long long)e * C * 2 * f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j0 + 8 * j + 2 * (lane & 3);
      if (col >= f) continue;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float g = acc[0][4 * j + 2 * r + c];
        v[c] = g / (1.f + expf(-g)) * acc[1][4 * j + 2 * r + c];
      }
      uint32_t hi, lo;
      sm90::split_bf16(v[0], v[1], hi, lo);
      bf16* hr = he + (long long)row * 2 * f + col;
      *reinterpret_cast<uint32_t*>(hr) = hi;
      *reinterpret_cast<uint32_t*>(hr + f) = lo;
    }
  }
}

// y[e, rows, cols] = (h_hi + h_lo) wo, bf16
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_down_tc(const bf16* __restrict__ h, const bf16* __restrict__ wo,
            bf16* __restrict__ y, int C, int d, int f, int n_mb,
            int n_nb) {
  VX_DYN_SMEM(smem);
  const int mb = (int)(blockIdx.x % n_mb);
  const int en = (int)(blockIdx.x / n_mb);
  const int nb = en % n_nb, e = en / n_nb;
  const int row0 = mb * TC_BM, n0 = nb * TC_BN, tid = threadIdx.x;
  const bf16* he = h + ((long long)e * C + row0) * 2 * f;
  const bf16* const a[2] = {he, he + f};
  const bf16* const b[1] = {wo + (long long)e * f * d + n0};
  float acc[1][64];
  mainloop<2, 1, STAGES>(acc, sm90::align1024(smem), a, 2LL * f, C - row0,
                         b, d, d - n0, f, tid);
  const int lane = tid % 32;
  const int r0 = row0 + tid / 128 * 64 + (tid % 128) / 32 * 16 + lane / 4;
  bf16* ye = y + (long long)e * C * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= d) continue;
      *reinterpret_cast<uint32_t*>(ye + (long long)row * d + col) =
          sm90::pack_bf16(acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
    }
  }
}

int launch_tc(const void* x, const void* wi, const void* wo, void* h,
              void* y, int E, int C, int d, int f, void* stream) {
  if (C < 2 || d % 8 || f % 8) return kBadArgs;
  const int n_mb = (C + TC_BM - 1) / TC_BM;
  auto up = moe_up_tc;
  static const int up_attr = (int)cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (up_attr != 0) return up_attr;
  const int n_fb = (f + TC_BN - 1) / TC_BN;
  VX_LAUNCH_SMEM(up, E * n_fb * n_mb, TC_THREADS, SMEM, stream,
                 (const bf16*)x, (const bf16*)wi, (bf16*)h, C, d, f, n_mb,
                 n_fb);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto down = moe_down_tc;
  static const int down_attr = (int)cudaFuncSetAttribute(
      down, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (down_attr != 0) return down_attr;
  const int n_db = (d + TC_BN - 1) / TC_BN;
  VX_LAUNCH_SMEM(down, E * n_db * n_mb, TC_THREADS, SMEM, stream,
                 (const bf16*)h, (const bf16*)wo, (bf16*)y, C, d, f, n_mb,
                 n_db);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

// x: (E, C, d), wi: (E, d, 2f), wo: (E, f, d), y: (E, C, d), all
// contiguous, 16-byte aligned and of one type; ws: (n_slices, E, C, d)
// float32 scratch. The hidden columns are cut into n_slices slices of fs
// (the last may be shorter): (n_slices - 1) fs < f <= n_slices fs.
// E, C, d, f >= 1; E * n_slices * ceil(C / 16) < 2^31.
extern "C" int moe_ff_f32(const void* x, const void* wi, const void* wo,
                          void* ws, void* y, int E, int C, int d, int f,
                          int fs, int n_slices, void* stream) {
  return launch<float>(x, wi, wo, ws, y, E, C, d, f, fs, n_slices, stream);
}

#ifdef __CUDACC__
extern "C" int moe_ff_bf16(const void* x, const void* wi, const void* wo,
                           void* ws, void* y, int E, int C, int d, int f,
                           int fs, int n_slices, void* stream) {
  return launch<__nv_bfloat16>(x, wi, wo, ws, y, E, C, d, f, fs, n_slices,
                               stream);
}

// The tensor-core route: x, wi, wo, y as above, bf16, C >= 2, d and f
// multiples of 8; h: (E, C, 2f) bf16 scratch for the hidden's two parts.
// E * ceil(C / 128) * ceil(max(d, f) / 128) < 2^31.
extern "C" int moe_ff_bf16_tc(const void* x, const void* wi, const void* wo,
                              void* h, void* y, int E, int C, int d, int f,
                              void* stream) {
  return launch_tc(x, wi, wo, h, y, E, C, d, f, stream);
}
#endif
