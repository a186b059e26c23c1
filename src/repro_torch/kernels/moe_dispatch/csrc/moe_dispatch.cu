// Grouped SwiGLU expert feed-forward: for every expert e and capacity row,
//   y[e] = (silu(x[e] @ wi[e][:, :f]) * (x[e] @ wi[e][:, f:])) @ wo[e],
// float32 inside, stored in x's type.
//
// Replaces repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff
// (the Pallas TPU kernel, grid (E, C / 128), the (128, 2f) hidden tile in
// VMEM). That tile is 1 MB in float32 at olmoe's f = 1024 and 25 MB at
// jamba's f = 24576, far past what a CTA can hold, so the kernel is
// thought through again. Two kernels, one call:
//
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
// Bound: at prefill operations, 6 E C d f FLOP; at decode bytes, every
// expert's weights read once. This kernel uses the CUDA cores, not the
// tensor cores, so at prefill it runs far below the bf16 bound; each CTA
// reads its expert slice's weights from L2, ceil(C / 16) times in all.
// At decode every expert's weights are read even where an expert holds
// no token. wgmma, TMA and skipping empty experts are later changes.
//
// The float32 instantiations compile with g++ against the stand-in
// runtime in tests/cuda_host, which runs them on the CPU.
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

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
#endif
