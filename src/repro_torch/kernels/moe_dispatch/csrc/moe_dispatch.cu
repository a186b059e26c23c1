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
// Every route takes an optional int32 counts[E]: the rows of each expert
// that hold a token (the router's dispatch fills an expert's slots from
// row 0 and points the rest at a zero row). Rows at or past the count are
// taken as zero rows, so their output is zero (silu(0) * 0 = 0), and a
// block of rows wholly past its expert's count reads no weights: at
// decode (C = 1) an expert that no token chose costs nothing but its
// zeros. With counts null every row is computed, as the TPU kernel does.
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
//     K-major, wi (E, d, 2f) MN-major (the transpose bit), both bf16. The
//     epilogue writes h = silu(g) * u as one fp16 part into h (E, C, f).
//     Where the caller passes gu (training), it first stores g and u of
//     the filled rows there in bf16 (E, C, 2f), the pre-activation that
//     the backward (moe_dispatch_bwd.cu) would otherwise compute again.
//   * moe_down_tc: one CTA per (expert, 256-column block of d, 128-row
//     block), h @ wo over K = f in fp16, wo (E, f, d) MN-major, two
//     128-column accumulators a thread as in moe_up_tc, so that a tile of
//     h is read once for 256 output columns; wgmma
//     does not mix types, so each thread rewrites the chunks of a wo tile
//     it copied as fp16 once they land (sm90::bf16_to_f16), before the
//     barrier that hands the stage to wgmma. y stored in bf16.
//   Why fp16 and not bf16. h rounded to bf16 alone (8 significant bits:
//   an error up to 2^-8 of each term) puts some of y more than rtol 1e-2
//   + atol 2e-3 from the float32 function at the paths' widths; fp16
//   keeps 11 bits (2^-11), which stays inside
//   (tests/test_torch_moe_kernels.py holds a rounding model of each).
//   bf16 wo converts to fp16 exactly for 6.1e-5 <= |w| <= 65504 (smaller
//   weights keep fewer bits, an absolute error under 2^-25). One down
//   product in place of the two of a bf16 hi + lo split, and half its
//   hidden's bytes (2 E C f each way).
//   Values past fp16's range. bf16's range reaches 3.4e38, so an |h| or
//   |w| of 65520 or more is kept in range by powers of two, which are
//   exact (sm90::f16_exponent: 0 wherever the values are in range, so
//   the common path stores what it always stored):
//     - h: moe_up_tc stores each (row, 64-column tile) of h as h * 2^-e
//       with e in a byte of hexp (E, C, ceil(f / 64)), and where e > 0
//       raises the row's largest, hmax (E, C), by an integer atomicMax
//       (order-free; the launcher zeroes hmax first, with no host sync).
//     - wo: the thread that converts a chunk of a wo tile also keeps its
//       largest magnitudes (one max.xorsign.abs.bf16x2 a word).
//     - moe_down_tc reads its rows' hmax once, and the barrier that hands
//       each stage to wgmma becomes a vote (__syncthreads_or) on a wo
//       element past fp16's range or, with the first stage, a row of h
//       with an exponent: the common path adds nothing else. A CTA that
//       votes yes stops, sets its block's redo flag and leaves the block
//       to a second kernel, compiled apart (moe_down_scaled: 132 CTAs
//       that read the flags 256 at a time, so the common path pays that
//       launch and the read, and no registers or instructions in its
//       loop). There the tiles of a row of h whose e is below the row's
//       largest are rescaled in shared memory before the wgmma that reads
//       them; each stage finds its wo columns' largest exponents, keeps a
//       running one a column (as the softmax keeps its max), scales the
//       accumulator's columns where theirs grew and converts the stage's
//       wo tiles from device memory at their columns' exponents; the
//       epilogue multiplies each row by 2^hmax and each column by 2^its
//       exponent.
//   The output is bf16, so a value past bf16's range is inf, as in the
//   plain version.
//   Each stage of the ring (moe_tc.cuh, shared with the backward) holds
//   three 16 KB tiles in the 128-byte-swizzled layout of sm90.cuh (x and
//   wi's gate and up tiles, or a tile of h and two of wo; four stages,
//   192 KB), copied by cp.async (16 bytes a thread; rows past C or the
//   count, k past d or f
//   and columns past the end zero-filled, so any C, d, f that are
//   multiples of 8 are taken), with the copies of all but the last two
//   stages in flight ahead of the stage that wgmma m64n128k16 reads and
//   one wgmma group left in flight across the next stage's barrier. TMA
//   would spend no thread instructions on the copies; that matters once a
//   producer warp is split off (a later change). No split-K, no atomics:
//   the result does not depend on the order in which CTAs run.
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
// Bound: at decode bytes, the weights of every expert that holds a token
// read once; this route reads them at 16 bytes a thread. The CTAs of an
// empty expert return before reading anything, and moe_ff_sum writes
// their rows' zeros without reading the workspace.
//
// The float32 instantiations compile with g++ against the stand-in
// runtime in tests/cuda_host, which runs them on the CPU.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
#include "sm90.cuh"
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

// at C = 1 three CTAs an SM (at most 85 registers a thread): kimi-k2's
// 384 experts in one slice are 384 CTAs, one wave of 3 x 132
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, BM == 1 ? 3 : 1)
moe_ff_partial(const T* __restrict__ x, const T* __restrict__ wi,
               const T* __restrict__ wo, const int* __restrict__ counts,
               float* __restrict__ ws, int E, int C, int d, int f, int fs,
               int n_slices, int n_mb) {
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
  // rows of x at or past the expert's count are taken as zero; a block
  // with none before it reads nothing (moe_ff_sum writes its zeros)
  const int live = counts ? max(0, min(rows, counts[e] - row0)) : rows;
  if (live == 0) return;
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
          xs[kk * XS + r] = r < live && kk < kn
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

// y = the sum of ws over the slices; zero at rows at or past the count,
// whose workspace rows are not read
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_ff_sum(const float* __restrict__ ws, const int* __restrict__ counts,
           T* __restrict__ y, long long n, int C, int d, int n_slices) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / d;
    float acc = 0.f;
    if (counts == nullptr || row % C < counts[row / C])
      for (int s = 0; s < n_slices; ++s) acc += ws[s * n + i];
    store_f32(acc, y + i);
  }
}

template <typename T, int BM>
int launch_partial(const void* x, const void* wi, const void* wo,
                   const void* counts, void* ws, int E, int C, int d, int f,
                   int fs, int n_slices, void* stream) {
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
                 (const T*)x, (const T*)wi, (const T*)wo,
                 (const int*)counts, (float*)ws, E, C, d, f, fs, n_slices,
                 n_mb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wi, const void* wo,
           const void* counts, void* ws, void* y, int E, int C, int d,
           int f, int fs, int n_slices, void* stream) {
  if (fs < 1 || n_slices < 1 || (long long)(n_slices - 1) * fs >= f ||
      (long long)n_slices * fs < f)
    return kBadArgs;
  const int err = C == 1
      ? launch_partial<T, 1>(x, wi, wo, counts, ws, E, C, d, f, fs,
                             n_slices, stream)
      : launch_partial<T, 16>(x, wi, wo, counts, ws, E, C, d, f, fs,
                              n_slices, stream);
  if (err != 0) return err;
  const long long n = (long long)E * C * d;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSumBlocks ? want : kSumBlocks);
  auto sum = moe_ff_sum<T>;
  VX_LAUNCH(sum, blocks, kThreads, stream, (const float*)ws,
            (const int*)counts, (T*)y, n, C, d, n_slices);
  return (int)cudaGetLastError();
}


#ifdef __CUDACC__
// ---- the tensor-core route: bf16, C > 1, d and f multiples of 8 ---------
// (the tiles, the ring and mainloop are moe_tc.cuh's)

constexpr int DOWN_SMEM = SMEM + EX_BYTES;
constexpr int SCALED_CTAS = 132;   // moe_down_scaled's: one an SM
constexpr int DOWN_BN = DOWN_COLS;

// h[e, rows, cols] = silu(x wi_gate) * (x wi_up) as fp16, h (E, C, f);
// rows past the count are not written (moe_down_tc does not read them).
// Where gu is given (training), the pre-activation too: gu[e, row, col]
// = g and gu[e, row, f + col] = u in bf16, (E, C, 2f), for the backward
// (moe_dispatch_bwd.cu), rows past the count not written.
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_up_tc(const bf16* __restrict__ x, const bf16* __restrict__ wi,
          const int* __restrict__ counts, __half* __restrict__ h,
          uint8_t* __restrict__ hexp, int* __restrict__ hmax,
          bf16* __restrict__ gu, int C, int d, int f, int n_mb, int n_nb) {
  VX_DYN_SMEM(smem);
  const int mb = (int)(blockIdx.x % n_mb);
  const int en = (int)(blockIdx.x / n_mb);
  const int nb = en % n_nb, e = en / n_nb;
  const int row0 = mb * TC_BM, j0 = nb * TC_BN, tid = threadIdx.x;
  const int filled = filled_rows(counts, e, C);
  if (row0 >= filled) return;
  const u16* we =
      reinterpret_cast<const u16*>(wi) + (long long)e * d * 2 * f + j0;
  const u16* const a[1] = {reinterpret_cast<const u16*>(x) +
                           ((long long)e * C + row0) * d};
  const u16* const b[2] = {we, we + f};
  float acc[2][64];
  mainloop<sm90::BF16, false, false, 1, 2, STAGES>(
      acc, sm90::align1024(smem), a, d, filled - row0, b, 2LL * f, f - j0,
      0, d, tid);
  const int lane = tid % 32;
  const int r0 = row0 + tid / 128 * 64 + (tid % 128) / 32 * 16 + lane / 4;
  if (gu != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= filled) continue;
      bf16* gr = gu + ((long long)e * C + row) * 2 * f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j0 + 8 * j + 2 * (lane & 3);
        if (col >= f) continue;
        *reinterpret_cast<uint32_t*>(gr + col) =
            sm90::pack_bf16(acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(gr + f + col) =
            sm90::pack_bf16(acc[1][4 * j + 2 * r], acc[1][4 * j + 2 * r + 1]);
      }
    }
  }
  // h = silu(g) * u, in place of g
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float g = acc[0][i];
    acc[0][i] = g / (1.f + expf(-g)) * acc[1][i];
  }
  const int nt = (f + 63) / 64;
  __half* he = h + (long long)e * C * f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
#pragma unroll
    for (int t = 0; t < 2; ++t) {   // a 64-column tile of h
      // its exponent: the quad of threads holding the row holds the tile
      float mx = 0.f;
#pragma unroll
      for (int j = 8 * t; j < 8 * t + 8; ++j)
        mx = fmaxf(mx, fmaxf(fabsf(acc[0][4 * j + 2 * r]),
                             fabsf(acc[0][4 * j + 2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const int ex = sm90::f16_exponent(mx);
      if (row >= filled || j0 + 64 * t >= f) continue;
      const long long er = (long long)e * C + row;
      if ((lane & 3) == 0) {
        hexp[er * nt + j0 / 64 + t] = (uint8_t)ex;
        if (ex > 0) atomicMax(hmax + er, ex);
      }
      const float sc = sm90::pow2(-ex);
#pragma unroll
      for (int j = 8 * t; j < 8 * t + 8; ++j) {
        const int col = j0 + 8 * j + 2 * (lane & 3);
        if (col >= f) continue;
        *reinterpret_cast<uint32_t*>(he + (long long)row * f + col) =
            sm90::pack_f16(acc[0][4 * j + 2 * r] * sc,
                           acc[0][4 * j + 2 * r + 1] * sc);
      }
    }
  }
}

// y[e, rows, cols] = h wo in fp16, stored bf16, 256 columns a block (two
// accumulators, as the up kernel's gate and up): h's tile is read once
// for both; zero at rows past the count. Two kernels over one grid of
// blocks: moe_down_tc (SCALED false, a CTA a block) computes every block
// whose rows of h have no exponent and whose wo tiles hold nothing past
// fp16's range, and sets each block's redo flag; moe_down_scaled (a few
// CTAs walking the blocks) computes the blocks flagged, at the exponents
// (rare). Returns with every thread done with shared memory.
template <bool SCALED>
__device__ __forceinline__ void
down_block(unsigned char* smem, int blk, const __half* __restrict__ h,
           const uint8_t* __restrict__ hexp, const int* __restrict__ hmax,
           const bf16* __restrict__ wo, const int* __restrict__ counts,
           bf16* __restrict__ y, int* __restrict__ redo, int C, int d,
           int f, int n_mb, int n_nb) {
  const int mb = blk % n_mb;
  const int en = blk / n_mb;
  const int nb = en % n_nb, e = en / n_nb;
  const int row0 = mb * TC_BM, n0 = nb * DOWN_BN, tid = threadIdx.x;
  const int filled = filled_rows(counts, e, C);
  bf16* ye = y + (long long)e * C * d;
  if (!SCALED && row0 >= filled) {   // no token: zeros, no weight read
    for (int i = tid; i < TC_BM * DOWN_BN / 2; i += TC_THREADS) {
      const int row = row0 + i / (DOWN_BN / 2);
      const int col = n0 + 2 * (i % (DOWN_BN / 2));
      if (row < C && col < d)
        *reinterpret_cast<uint32_t*>(ye + (long long)row * d + col) = 0u;
    }
    if (tid == 0) redo[blk] = 0;
    return;
  }
  const u16* const a[1] = {reinterpret_cast<const u16*>(h) +
                           ((long long)e * C + row0) * f};
  const u16* wn = reinterpret_cast<const u16*>(wo) + (long long)e * f * d +
                  n0;
  const u16* const b[2] = {wn, wn + TC_BN};
  const uint32_t ring = sm90::align1024(smem);
  // the hidden's row exponents: hmax of the rows this thread copies (the
  // common path reads them with its first stage's vote, so their latency
  // hides behind the first copies)
  DownScale ds;
  int any = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tid / 8 + 32 * i;
    ds.ra[i] = row < filled ? hmax[(long long)e * C + row] : 0;
    any |= ds.ra[i];
  }
  if constexpr (SCALED) {
    ds.nt = (f + 63) / 64;
    ds.hexp = hexp + ((long long)e * C + row0) * ds.nt;
    ds.ex = smem + (ring - sm90::smem_addr(smem)) + RING;
    ds.ex[tid] = 0;   // the columns' exponents
    ds.rows = __syncthreads_or(any) != 0;
  }
  float acc[2][64];
  const bool done = mainloop<sm90::F16, true, SCALED, 1, 2, STAGES>(
      acc, ring, a, f, filled - row0, b, d, d - n0, TC_BN, f, tid, &ds,
      any != 0);
  if constexpr (SCALED) {
    __syncthreads();   // every column's last exponent is stored
  } else {
    if (tid == 0) redo[blk] = done ? 0 : 1;
    if (!done) return;
  }
  const int lane = tid % 32;
  const int r0 = row0 + tid / 128 * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= C) continue;
    float rs = 1.f;
    if constexpr (SCALED)
      if (row < filled) rs = sm90::pow2(hmax[(long long)e * C + row]);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cc = t * TC_BN + 8 * j + 2 * (lane & 3);
        const int col = n0 + cc;
        if (col >= d) continue;
        float v0 = acc[t][4 * j + 2 * r], v1 = acc[t][4 * j + 2 * r + 1];
        if constexpr (SCALED) {   // back from the exponents
          v0 *= rs * sm90::pow2(ds.ex[cc]);
          v1 *= rs * sm90::pow2(ds.ex[cc + 1]);
        }
        *reinterpret_cast<uint32_t*>(ye + (long long)row * d + col) =
            sm90::pack_bf16(v0, v1);
      }
  }
  if constexpr (SCALED) __syncthreads();   // ds.ex read by every thread
}

__global__ void __launch_bounds__(TC_THREADS, 1)
moe_down_tc(const __half* __restrict__ h, const uint8_t* __restrict__ hexp,
            const int* __restrict__ hmax, const bf16* __restrict__ wo,
            const int* __restrict__ counts, bf16* __restrict__ y,
            int* __restrict__ redo, int C, int d, int f, int n_mb,
            int n_nb) {
  VX_DYN_SMEM(smem);
  down_block<false>(smem, (int)blockIdx.x, h, hexp, hmax, wo, counts, y,
                    redo, C, d, f, n_mb, n_nb);
}

// the blocks that moe_down_tc flagged, a few CTAs walking all n blocks a
// window of TC_THREADS flags at a time (one a thread, then a vote): where
// none is flagged, a CTA reads its windows' flags and returns
__global__ void __launch_bounds__(TC_THREADS, 1)
moe_down_scaled(const __half* __restrict__ h,
                const uint8_t* __restrict__ hexp,
                const int* __restrict__ hmax, const bf16* __restrict__ wo,
                const int* __restrict__ counts, bf16* __restrict__ y,
                int* __restrict__ redo, int C, int d, int f, int n_mb,
                int n_nb, int n) {
  VX_DYN_SMEM(smem);
  for (int base = (int)blockIdx.x * TC_THREADS; base < n;
       base += (int)gridDim.x * TC_THREADS) {
    const int mine = (int)threadIdx.x + base;
    if (!__syncthreads_or(mine < n && redo[mine] != 0)) continue;
    for (int blk = base; blk < min(n, base + TC_THREADS); ++blk)
      if (redo[blk])
        down_block<true>(smem, blk, h, hexp, hmax, wo, counts, y, redo, C,
                         d, f, n_mb, n_nb);
  }
}

int launch_tc(const void* x, const void* wi, const void* wo,
              const void* counts, void* h, void* hexp, void* hmax,
              void* redo, void* gu, void* y, int E, int C, int d, int f,
              void* stream) {
  if (C < 2 || d % 8 || f % 8) return kBadArgs;
  const int n_mb = (C + TC_BM - 1) / TC_BM;
  int err = (int)cudaMemsetAsync(hmax, 0, (size_t)E * C * sizeof(int),
                                 (cudaStream_t)stream);
  if (err != 0) return err;
  auto up = moe_up_tc;
  static const int up_attr = (int)cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (up_attr != 0) return up_attr;
  const int n_fb = (f + TC_BN - 1) / TC_BN;
  VX_LAUNCH_SMEM(up, E * n_fb * n_mb, TC_THREADS, SMEM, stream,
                 (const bf16*)x, (const bf16*)wi, (const int*)counts,
                 (__half*)h, (uint8_t*)hexp, (int*)hmax, (bf16*)gu, C, d,
                 f, n_mb, n_fb);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto down = moe_down_tc;
  auto scaled = moe_down_scaled;
  static const int down_attr = (int)cudaFuncSetAttribute(
      down, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (down_attr != 0) return down_attr;
  static const int scaled_attr = (int)cudaFuncSetAttribute(
      scaled, cudaFuncAttributeMaxDynamicSharedMemorySize, DOWN_SMEM);
  if (scaled_attr != 0) return scaled_attr;
  const int n_db = (d + DOWN_BN - 1) / DOWN_BN;
  const int n = E * n_db * n_mb;
  VX_LAUNCH_SMEM(down, n, TC_THREADS, SMEM, stream, (const __half*)h,
                 (const uint8_t*)hexp, (const int*)hmax, (const bf16*)wo,
                 (const int*)counts, (bf16*)y, (int*)redo, C, d, f, n_mb,
                 n_db);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  VX_LAUNCH_SMEM(scaled, n < SCALED_CTAS ? n : SCALED_CTAS, TC_THREADS,
                 DOWN_SMEM, stream, (const __half*)h, (const uint8_t*)hexp,
                 (const int*)hmax, (const bf16*)wo, (const int*)counts,
                 (bf16*)y, (int*)redo, C, d, f, n_mb, n_db, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

// x: (E, C, d), wi: (E, d, 2f), wo: (E, f, d), y: (E, C, d), all
// contiguous, 16-byte aligned and of one type; counts: null, or int32
// (E,), the rows of each expert that hold a token (rows at or past it are
// taken as zero rows); ws: (n_slices, E, C, d) float32 scratch. The
// hidden columns are cut into n_slices slices of fs (the last may be
// shorter): (n_slices - 1) fs < f <= n_slices fs. E, C, d, f >= 1;
// E * n_slices * ceil(C / 16) < 2^31.
extern "C" int moe_ff_f32(const void* x, const void* wi, const void* wo,
                          const void* counts, void* ws, void* y, int E,
                          int C, int d, int f, int fs, int n_slices,
                          void* stream) {
  return launch<float>(x, wi, wo, counts, ws, y, E, C, d, f, fs, n_slices,
                       stream);
}

#ifdef __CUDACC__
extern "C" int moe_ff_bf16(const void* x, const void* wi, const void* wo,
                           const void* counts, void* ws, void* y, int E,
                           int C, int d, int f, int fs, int n_slices,
                           void* stream) {
  return launch<__nv_bfloat16>(x, wi, wo, counts, ws, y, E, C, d, f, fs,
                               n_slices, stream);
}

// The tensor-core route: x, wi, wo, counts, y as above, bf16, C >= 2, d
// and f multiples of 8; scratch: h (E, C, f) fp16, hexp (E, C,
// ceil(f / 64)) uint8 and hmax (E, C) int32 (zeroed here) for the
// hidden, redo int32, one a CTA of the down product, E * ceil(C / 128) *
// ceil(d / 256). gu: null, or (E, C, 2f) bf16 that receives the gate and
// up products of the filled rows (the backward's saved pre-activation).
// E * ceil(C / 128) * ceil(max(d, f) / 128) < 2^31.
extern "C" int moe_ff_bf16_tc(const void* x, const void* wi, const void* wo,
                              const void* counts, void* h, void* hexp,
                              void* hmax, void* redo, void* gu, void* y,
                              int E, int C, int d, int f, void* stream) {
  return launch_tc(x, wi, wo, counts, h, hexp, hmax, redo, gu, y, E, C, d,
                   f, stream);
}
#endif
