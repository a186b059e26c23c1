// Attention forward with an online softmax, in two routes:
//   * tensor cores (bf16, head dim 64, 112 or 128, rows of 16-byte
//     multiples): fa_tc_kernel, one CTA per (batch, head, 64-row query
//     tile);
//   * CUDA cores (float32, bf16 at head dim 32 or with rows the copies
//     cannot take): fa_kernel, one CTA per (batch, head, 64-row tile).
// The wrapper (flash_attention.py: route) picks the entry from the dtype,
// the head dim and the row alignment; nothing is tried and given up.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:
// flash_attention (_fa_kernel): softmax(q k^T / sqrt(D), causal mask
// -1e30) v, with the running max m, sum l and accumulator in float32 and
// the output in q's type. Where lse is not null, both routes also store
// each row's log-sum-exp of the scaled scores, log(sum_k exp(s_k / sqrt(D)))
// = m + log(l), float32 (B, H, Sq): the backward (flash_attention_bwd.cu)
// recomputes the softmax weights from it. Serving passes null; the output
// is the same either way.
//
// Bound: operations. At S = 2048, D = 64 a query row does 2 * S * D
// multiply-adds against 4 * D bytes of its own q and o, far past the
// H100's 295 bf16 FLOP per byte of device memory: only the tensor cores
// reach the bound.
//
// The tensor-core route (sm90.cuh has the wgmma and copy helpers and the
// tile layout). One warpgroup of 128 threads takes 64 query rows; two
// CTAs share an SM at D = 112 and 128 (shared memory allows no third)
// and four at D = 64, so that one CTA's softmax runs while another's
// products keep the tensor cores busy:
//   * q's rows are copied once into shared memory; K and V come in tiles
//     of 64 keys through a ring of two stages, the next tile's copies in
//     flight while the current one is used: 41 KB of dynamic shared
//     memory at D = 64, 81 KB at D = 112 and 128. Copies are cp.async, 16
//     bytes a thread, written to the 128-byte-swizzled layout (rows past
//     the end zero-filled): they read q and k through their strides (v's
//     fp16 copy is contiguous) and mask ragged rows one by one, where TMA
//     would need a tensor map made on the host for every call. TMA's
//     gain, copies that cost no thread instructions, matters once a
//     producer warp is split off (a later change).
//   * D = 112: a row is 14 chunks of 16 bytes. The tiles take the layout
//     of D = 128, two column blocks of 64, and the two chunks past the
//     row in the second block are zero-filled by cp.async's zero-fill
//     size. Q K^T stops after 7 k16 steps; P V runs N = 128 (the zero
//     columns of V give zero columns of O) and the epilogue stores 112.
//   * S = Q K^T by wgmma m64n64k16 from shared memory (K K-major, bf16),
//     into 32 float32 registers a thread.
//   * the online softmax runs on that fragment: a row's max and sum are
//     reduced over the 4 threads that hold it (__shfl_xor_sync), 2^x by
//     ex2.approx with the scale pre-multiplied by log2 e. The causal and
//     k >= Sk mask is applied only on tiles that cross the diagonal or
//     the end; tiles above the diagonal are never loaded.
//   * P stays in registers: the accumulator fragment of S is the A
//     fragment of O += P V (the register form, RS), so P needs no shared
//     tile, no proxy fence and no barrier. V is read MN-major (the
//     transpose bit). P goes in as one fp16 part, one product: wgmma does
//     not mix types, so V goes in as fp16 too. A small kernel launched
//     first (v_to_f16) converts v once a call into a contiguous fp16
//     scratch, 2 B Hkv Sk D bytes each way (16.8 MB read and written at
//     jamba's shape), where converting each tile in shared memory would
//     cost every CTA that reads the tile again: at D = 128, 8 chunks a
//     thread a tile, about as many instructions as the softmax.
//   * V past fp16's range. v_to_f16 takes one CTA a 64-key tile of a
//     (batch, KV head), the tile the products read: it finds the tile's
//     largest |v| and stores the tile as v * 2^-e, with e (f16_exponent)
//     the smallest power of two that brings it under 2^15, and e in a
//     byte beside it. e is 0 wherever the tile is in range, as at every
//     path's shapes, and the tile is then converted as before. The
//     attention kernel keeps its accumulator at the largest exponent E of
//     the tiles read so far, like the running max of the softmax: a tile
//     with e > E scales the accumulator by 2^(E - e) with the softmax's
//     correction, one with e < E goes in with P times 2^(e - E) (at most
//     1), and the epilogue multiplies by 2^E. Powers of two are exact in
//     float32, so the only cost is fp16's subnormals for the small values
//     of a scaled tile. A tile with e > 0 also raises a flag of its
//     (batch, KV head), an integer atomicMax on a word the launcher zeroes
//     (cudaMemsetAsync, no host sync): the attention kernel reads it once
//     and runs one of two instantiations of its body, so the common path
//     adds one load a CTA and is otherwise the unscaled loop. No other
//     route. The backward reads v in bf16 and has no such limit.
//   * Why fp16 and not bf16. P lies in [0, 1] (each weight is 2^(s - m)
//     against the running max). bf16 keeps 8 significant bits: P rounded
//     to bf16 alone (an error up to 2^-8 of each weight) puts the output
//     more than rtol 1e-2 + atol 2e-3 from the float32 softmax in rows
//     whose weight sits on a few keys of about equal score, as in the
//     first rows of a causal head. fp16 keeps 11 bits (an error up to
//     2^-11), which stays inside (tests/test_torch_lm_kernels.py holds a
//     rounding model of each). bf16 V converts to fp16 exactly for
//     6.1e-5 <= |v| <= 65504; smaller |v| keep fewer bits (an absolute
//     error under 2^-25), and a larger |v| is scaled first (below). The
//     row sum l is the
//     float32 sum of the unrounded P. One product in place of the two of
//     a bf16 hi + lo split: two thirds of that design's tensor work, and
//     no registers for lo.
//   * the epilogue divides by max(l, 1e-20), multiplies by 2^E, casts
//     and stores the rows below Sq.
// The longest causal query tiles are launched first (blockIdx.x from the
// last tile down across all heads); heads that share a KV head are
// adjacent, so their K/V tiles meet in L2.
//
// The CUDA-core route: the query tile stays in shared memory, 32-key
// tiles of K and V are loaded into shared memory in turn, and four
// threads share a query row. Each thread computes 8 scores of the row,
// the row's max and sum are reduced over the four threads by warp
// shuffles, the probabilities go through shared memory, and each thread
// keeps 1/4 of the row's output accumulator in registers, float32 on
// the CUDA cores.
//
// What both routes change from the TPU kernel, on purpose:
//   * A causal loop bound in place of @pl.when: key tiles past the last
//     query row of the tile are never loaded.
//   * Any Sq and Sk: rows past Sq are not stored, keys past Sk are masked
//     (as attention_chunked masks a short last chunk).
//   * K and V may have fewer heads than q (Hkv dividing H): head h reads
//     KV head h / (H / Hkv), so the 4x copy of _repeat_kv is not made.
//   * q, k and v are read through their strides (the last dimension must
//     be contiguous); the output is a contiguous (B, H, Sq, D).
//
// Head dims 32, 64, 112 and 128 on the CUDA cores. At D = 112 and 128 the
// four float32 tiles come to 66,176 and 74,368 bytes, over the 48 KB of
// static shared memory, so those instantiations take the same tiles from
// dynamic shared memory (fa_kernel_dyn, after cudaFuncSetAttribute);
// D = 32 and 64 keep their static tiles (fa_kernel). Both run one body,
// fa_body. D = 32 stays on the CUDA cores in bf16 too: its 64-byte rows
// would need a second swizzle mode, and no path of the port uses it.
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

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 32;         // keys per tile
constexpr int kThreads = 256;  // four threads per query row
constexpr float kMasked = -1e30f;
constexpr int kStaticD = 64;   // larger head dims take dynamic tiles

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

struct Strides {   // elements between batches, heads and rows
  long long b, h, s;
};

// +1 columns: the 8 rows a warp reads at once fall in distinct banks
template <int D>
struct Tiles {
  float Q[BQ][D + 1];
  float K[BK][D + 1];
  float V[BK][D];
  float P[BQ][BK + 1];
};

template <typename T, int D>
__device__ __forceinline__ void
fa_body(float (&Qs)[BQ][D + 1], float (&Ks)[BK][D + 1],
        float (&Vs)[BK][D], float (&Ps)[BQ][BK + 1],
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
        int H, int Hkv, int Sq, int Sk, int n_qt, Strides qs, Strides ks,
        Strides vs, int causal, float sm_scale) {
  // the longest causal tiles first: block 0 takes the last query tile
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int bh = (int)(blockIdx.x / n_qt);
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int tid = threadIdx.x;
  const int r = tid >> 2;     // query row of the tile
  const int c4 = tid & 3;     // this thread's quarter of the row
  const int qrow = q0 + r;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int rr = e / D, dd = e % D;
    Qs[rr][dd] = q0 + rr < Sq ? to_f32(qb[(q0 + rr) * qs.s + dd]) : 0.f;
  }
  float m = kMasked, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(Sk, min(q0 + BQ, Sq)) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // Qs written; the last tile's Ks, Vs, Ps read
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = e / D, dd = e % D;
      const bool in = k0 + j < Sk;
      Ks[j][dd] = in ? to_f32(kb[(k0 + j) * ks.s + dd]) : 0.f;
      Vs[j][dd] = in ? to_f32(vb[(k0 + j) * vs.s + dd]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + c4 + 4i
    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qd = Qs[r][dd];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] += qd * Ks[c4 + 4 * i][dd];
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kpos = k0 + c4 + 4 * i;
      const bool valid = kpos < Sk && (!causal || kpos <= qrow);
      s[i] = valid ? s[i] * sm_scale : kMasked;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = expf(s[i] - mx);
      sum += p;
      Ps[r][c4 + 4 * i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = mx;
    __syncwarp();      // the row's probabilities come from its own warp

#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int c = c4 + 4 * i;
      float a = 0.f;
      for (int j = 0; j < BK; ++j) a += Ps[r][j] * Vs[j][c];
      acc[i] = acc[i] * corr + a;
    }
  }
  if (qrow < Sq) {
    const float denom = fmaxf(l, 1e-20f);
    T* orow = o + (((long long)b * H + h) * Sq + qrow) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      store_f32(acc[i] / denom, orow + c4 + 4 * i);
    if (lse != nullptr && c4 == 0)
      lse[((long long)b * H + h) * Sq + qrow] = m + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int n_qt,
          Strides qs, Strides ks, Strides vs, int causal, float sm_scale) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];
  fa_body<T, D>(Qs, Ks, Vs, Ps, q, k, v, o, lse, H, Hkv, Sq, Sk, n_qt, qs,
                ks, vs, causal, sm_scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel_dyn(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
              int n_qt, Strides qs, Strides ks, Strides vs, int causal,
              float sm_scale) {
  VX_DYN_SMEM(smem);
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem);
  fa_body<T, D>(t.Q, t.K, t.V, t.P, q, k, v, o, lse, H, Hkv, Sq, Sk, n_qt,
                qs, ks, vs, causal, sm_scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int H, int Hkv, int Sq, int Sk, long long qsb,
           long long qsh, long long qss, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss,
           int causal, float sm_scale, void* stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  if constexpr (D <= kStaticD) {
    auto kernel = fa_kernel<T, D>;
    VX_LAUNCH(kernel, B * H * n_qt, kThreads, stream, (const T*)q,
              (const T*)k, (const T*)v, (T*)o, lse, H, Hkv, Sq, Sk, n_qt, qs,
              ks, vs, causal, sm_scale);
  } else {
    auto kernel = fa_kernel_dyn<T, D>;
    constexpr int smem = (int)sizeof(Tiles<D>);
    static const int attr = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != 0) return attr;
    VX_LAUNCH_SMEM(kernel, B * H * n_qt, kThreads, smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, Hkv,
                   Sq, Sk, n_qt, qs, ks, vs, causal, sm_scale);
  }
  return (int)cudaGetLastError();
}

#ifdef __CUDACC__
// ---- the tensor-core route: bf16, D = 64, 112 or 128 --------------------

using bf16 = __nv_bfloat16;
constexpr int TC_BQ = 64;         // query rows per CTA: one warpgroup
constexpr int TC_THREADS = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct TcTiles {
  static constexpr int BK = 64;                  // keys a tile
  // columns of a tile: whole blocks of 64 (D = 112 takes D = 128's)
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int Q_BYTES = TC_BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;    // one of K, V
  // Q, two stages of K and V, and room to align the start to 1024: 41 KB
  // at D = 64, 81 KB at D = 112 and 128
  static constexpr int SMEM = Q_BYTES + 2 * 2 * KV_BYTES + 1024;
  // CTAs an SM holds, as registers and shared memory allow: four at
  // D = 64 (at most 128 registers a thread), two at D = 112 and 128 (81
  // KB of shared memory a CTA)
  static constexpr int MIN_CTAS = DP == 64 ? 4 : 2;
};

// v (B, Hkv, Sk, D) bf16, read through its strides, as a contiguous fp16
// (B, Hkv, Sk, D) at vh: the operand type of the P V product, made once
// a call instead of once a tile in every CTA that reads it. One CTA a
// 64-key tile of a (batch, KV head), tiles in key order: the tile is
// stored as v * 2^-e and e (f16_exponent of its largest |v|) goes to
// vexp (B, Hkv, ceil(Sk / 64)); where e > 0 it also goes to vmax (B, Hkv),
// zeroed by the launcher.
template <int D>
__global__ void __launch_bounds__(256)
v_to_f16(const bf16* __restrict__ v, __half* __restrict__ vh,
         uint8_t* __restrict__ vexp, int* __restrict__ vmax, int Hkv,
         int Sk, Strides vs, int n_kt) {
  constexpr int CPR = D / 8;                     // 16-byte chunks a row
  constexpr int N = (64 * CPR + 255) / 256;      // chunks a thread
  __shared__ float red[8];
  const int kt = (int)(blockIdx.x % n_kt);
  const long long bh = blockIdx.x / n_kt;
  const int s0 = kt * 64, tid = threadIdx.x;
  const int rows = min(64, Sk - s0);
  const bf16* vb = v + bh / Hkv * vs.b + bh % Hkv * vs.h;
  uint4 w[N];
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = tid + i * 256, r = c / CPR;
    w[i] = uint4{0u, 0u, 0u, 0u};
    if (c < 64 * CPR && r < rows)
      w[i] = *reinterpret_cast<const uint4*>(vb + (s0 + r) * vs.s +
                                             c % CPR * 8);
    mx = fmaxf(mx, fmaxf(fmaxf(sm90::bf16x2_absmax(w[i].x),
                               sm90::bf16x2_absmax(w[i].y)),
                         fmaxf(sm90::bf16x2_absmax(w[i].z),
                               sm90::bf16x2_absmax(w[i].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) mx = fmaxf(mx, red[i]);
  const int e = sm90::f16_exponent(mx);
  if (tid == 0) {
    vexp[blockIdx.x] = (uint8_t)e;
    if (e > 0) atomicMax(vmax + bh, e);
  }
  const float scale = sm90::pow2(-e);
  __half* ob = vh + (bh * Sk + s0) * D;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = tid + i * 256, r = c / CPR;
    if (c >= 64 * CPR || r >= rows) continue;
    uint4 o;
    if (e == 0) {   // in range: converted exactly, as it was
      o = {sm90::bf16x2_to_f16x2(w[i].x), sm90::bf16x2_to_f16x2(w[i].y),
           sm90::bf16x2_to_f16x2(w[i].z), sm90::bf16x2_to_f16x2(w[i].w)};
    } else {
      o = {sm90::bf16x2_to_f16x2_scaled(w[i].x, scale),
           sm90::bf16x2_to_f16x2_scaled(w[i].y, scale),
           sm90::bf16x2_to_f16x2_scaled(w[i].z, scale),
           sm90::bf16x2_to_f16x2_scaled(w[i].w, scale)};
    }
    *reinterpret_cast<uint4*>(ob + r * D + c % CPR * 8) = o;
  }
}

// The kernel's body; SCALED where a tile of its (batch, KV head)'s V has
// an exponent above 0 (the common path, SCALED false, has no trace of it)
template <int D, bool SCALED>
__device__ __forceinline__ void
fa_tc_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const __half* __restrict__ vh, const uint8_t* __restrict__ vexp,
           bf16* __restrict__ o, float* __restrict__ lse, int H, int Hkv,
           int Sq, int Sk, int n_bh, Strides qs, Strides ks, int causal,
           float scale_log2) {
  using TL = TcTiles<D>;
  constexpr int BK = TL::BK, DP = TL::DP;
  VX_DYN_SMEM(smem);
  const uint32_t sq = sm90::align1024(smem);
  const uint32_t skv = sq + TL::Q_BYTES;   // stage s: K, then V
  // the longest causal tiles first, over all heads
  const int qt = (int)(gridDim.x / n_bh) - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * TC_BQ;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const __half* vb = vh + ((long long)b * Hkv + hk) * Sk * D;
  const uint8_t* ve = vexp + ((long long)b * Hkv + hk) * ((Sk + BK - 1) / BK);
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = q0 + tid / 32 * 16 + lane / 4;   // rows r0 and r0 + 8
  const int kv_end = causal ? min(Sk, min(q0 + TC_BQ, Sq)) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  sm90::copy_rows<TC_BQ, D, TC_THREADS>(
      sq, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, Sq - q0, tid);
  sm90::copy_rows<BK, D, TC_THREADS>(skv, kb, ks.s, kv_end, tid);
  sm90::copy_rows<BK, D, TC_THREADS>(skv + TL::KV_BYTES, vb, D, kv_end,
                                     tid);
  sm90::cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int E = 0;   // the accumulator holds the output times 2^-E

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int et = SCALED ? ve[t] : 0;   // the tile holds v * 2^-et
    const uint32_t sk = skv + (t & 1) * 2 * TL::KV_BYTES;
    const uint32_t sv = sk + TL::KV_BYTES;
    if (t + 1 < n_tiles) {   // the stage the last tile used
      const uint32_t nk = skv + ((t + 1) & 1) * 2 * TL::KV_BYTES;
      const int left = kv_end - k0 - BK;
      sm90::copy_rows<BK, D, TC_THREADS>(nk, kb + (k0 + BK) * ks.s, ks.s,
                                         left, tid);
      sm90::copy_rows<BK, D, TC_THREADS>(
          nk + TL::KV_BYTES, vb + (k0 + BK) * D, D, left, tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();   // this tile (and q) have landed
    sm90::fence_async_smem();
    __syncthreads();

    // S = Q K^T (bf16), D / 16 k-steps: the zero columns past D are not
    // read
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::Mma<BK, 0>::ss(
          s, sm90::desc(sq + (kk >> 2) * (TC_BQ * 128) + (kk & 3) * 32, 16,
                        1024),
          sm90::desc(sk + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024),
          1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        if (col >= Sk || (causal && col > row)) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = mn == -INFINITY ? 1.f : sm90::ex2(m[r] - mn);
      base[r] = mn == -INFINITY ? 0.f : mn;
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = sm90::ex2(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += s[i];
    }
    // each thread keeps its part of l; the quad's parts meet at the end
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
    if (SCALED && et != E) {   // a tile of V scaled (uniform)
      if (et > E) {  // the accumulator moves to the tile's scale
        const float f = sm90::pow2(E - et);
        corr[0] *= f;
        corr[1] *= f;
        E = et;
      } else {       // P goes in at the accumulator's scale
        const float f = sm90::pow2(et - E);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= f;
      }
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    // P as the fp16 A fragments of the next product
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        pf[kk][w] = sm90::pack_f16(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1]);

    // O += P V (fp16), N = DP
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::Mma<DP, 1, sm90::F16>::rs(
          acc, pf[kk], sm90::desc(sv + kk * 2048, BK * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncthreads();   // the stage is free for the tile after next
  }

  bf16* ob = o + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    float inv = 1.f / fmaxf(l[r], 1e-20f);
    if constexpr (SCALED) inv *= sm90::pow2(E);
    const int row = r0 + 8 * r;
    if (row < Sq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * D + j * 8 +
                                     (lane & 3) * 2) =
            sm90::pack_bf16(acc[4 * j + 2 * r] * inv,
                            acc[4 * j + 2 * r + 1] * inv);
      // m is in log2 units of the scaled scores
      if (lse != nullptr && (lane & 3) == 0)
        lse[((long long)b * H + h) * Sq + row] =
            (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcTiles<D>::MIN_CTAS)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const __half* __restrict__ vh,
             const uint8_t* __restrict__ vexp, const int* __restrict__ vmax,
             bf16* __restrict__ o, float* __restrict__ lse, int H, int Hkv,
             int Sq, int Sk, int n_bh, Strides qs, Strides ks, int causal,
             float scale_log2) {
  const int bh = (int)(blockIdx.x % n_bh);
  const int hk = bh % H / (H / Hkv), b = bh / H;
  if (vmax[b * Hkv + hk] != 0)   // a tile of this V has e > 0 (uniform)
    fa_tc_body<D, true>(q, k, vh, vexp, o, lse, H, Hkv, Sq, Sk, n_bh, qs,
                        ks, causal, scale_log2);
  else
    fa_tc_body<D, false>(q, k, vh, vexp, o, lse, H, Hkv, Sq, Sk, n_bh, qs,
                         ks, causal, scale_log2);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* vh,
              void* vexp, void* vmax, void* o, float* lse, int B, int H,
              int Hkv,
              int Sq, int Sk, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, int causal, float sm_scale,
              void* stream) {
  const int n_qt = (Sq + TC_BQ - 1) / TC_BQ;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const int n_kt = (Sk + TcTiles<D>::BK - 1) / TcTiles<D>::BK;
  int err = (int)cudaMemsetAsync(vmax, 0, (size_t)B * Hkv * sizeof(int),
                                 (cudaStream_t)stream);
  if (err != 0) return err;
  auto conv = v_to_f16<D>;
  VX_LAUNCH(conv, B * Hkv * n_kt, 256, stream, (const bf16*)v,
            (__half*)vh, (uint8_t*)vexp, (int*)vmax, Hkv, Sk, vs, n_kt);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto kernel = fa_tc_kernel<D>;
  constexpr int smem = TcTiles<D>::SMEM;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, B * H * n_qt, TC_THREADS, smem, stream,
                 (const bf16*)q, (const bf16*)k, (const __half*)vh,
                 (const uint8_t*)vexp, (const int*)vmax, (bf16*)o, lse, H,
                 Hkv, Sq, Sk, B * H, qs, ks, causal,
                 sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

// q: (B, H, Sq, D), k and v: (B, Hkv, Sk, D), each read through its
// strides (in elements, last dimension contiguous); o: contiguous
// (B, H, Sq, D); lse: null, or a contiguous float32 (B, H, Sq) for each
// row's log-sum-exp. B * H * ceil(Sq / 64) < 2^31, Sq, Sk >= 1. The
// tensor-core entries (_tc_) also need q, k, v and their strides in
// elements to be 16-byte aligned, and take vh, a contiguous fp16
// (B, Hkv, Sk, D) scratch for v, vexp, a uint8 (B, Hkv, ceil(Sk / 64))
// scratch for its tiles' exponents (each written before it is read), and
// vmax, an int32 (B, Hkv) scratch (zeroed here).
#define VX_FA_ENTRY(NAME, T, D)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,        \
                      void* o, void* lse, int B, int H, int Hkv, int Sq,  \
                      int Sk, long long qsb, long long qsh, long long qss,\
                      long long ksb, long long ksh, long long kss,        \
                      long long vsb, long long vsh, long long vss,        \
                      int causal, float sm_scale, void* stream) {         \
    return launch<T, D>(q, k, v, o, (float*)lse, B, H, Hkv, Sq, Sk, qsb,  \
                        qsh, qss, ksb, ksh, kss, vsb, vsh, vss, causal,   \
                        sm_scale, stream);                                \
  }
#define VX_FA_TC_ENTRY(NAME, D)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,        \
                      void* vh, void* vexp, void* vmax, void* o,          \
                      void* lse, int B, int H, int Hkv, int Sq, int Sk,   \
                      long long qsb,                                      \
                      long long qsh, long long qss, long long ksb,        \
                      long long ksh, long long kss, long long vsb,        \
                      long long vsh, long long vss, int causal,           \
                      float sm_scale, void* stream) {                     \
    return launch_tc<D>(q, k, v, vh, vexp, vmax, o, (float*)lse, B, H,   \
                        Hkv, Sq, Sk,                                      \
                        qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,      \
                        causal, sm_scale, stream);                        \
  }

VX_FA_ENTRY(flash_attention_f32_d32, float, 32)
VX_FA_ENTRY(flash_attention_f32_d64, float, 64)
VX_FA_ENTRY(flash_attention_f32_d112, float, 112)
VX_FA_ENTRY(flash_attention_f32_d128, float, 128)
#ifdef __CUDACC__
VX_FA_ENTRY(flash_attention_bf16_d32, __nv_bfloat16, 32)
VX_FA_ENTRY(flash_attention_bf16_d64, __nv_bfloat16, 64)
VX_FA_ENTRY(flash_attention_bf16_d112, __nv_bfloat16, 112)
VX_FA_ENTRY(flash_attention_bf16_d128, __nv_bfloat16, 128)
VX_FA_TC_ENTRY(flash_attention_bf16_tc_d64, 64)
VX_FA_TC_ENTRY(flash_attention_bf16_tc_d112, 112)
VX_FA_TC_ENTRY(flash_attention_bf16_tc_d128, 128)
#endif
