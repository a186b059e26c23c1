// Attention forward at one query row (Sq = 1): the decode route of
// flash_attention (flash_attention.py: route). A decoder's cross-attention
// at decode reads one query row a head against every key of the encoder's
// output (seamless-m4t: 8 slots, 16 heads, 2048 keys of 64).
//
// Replaces repro/kernels/flash_attention/flash_attention.py:
// flash_attention (_fa_kernel) at Sq = 1: softmax(q k^T / sqrt(D), causal
// mask -1e30) v for one row, float32 sums, the output in q's type, and
// where lse is not null the row's log-sum-exp of the scaled scores. The
// causal convention is the plain version's (flash_attention_plain): query
// row i sees keys 0..i, so a causal row 0 sees key 0 alone.
//
// Bound: bytes. Each key's K and V rows are read once for G query rows,
// 2 G D multiply-adds against 4 D bytes (bf16): far under the card's 295
// FLOP per byte. The prefill route spent a 64-row wgmma tile on one row,
// one CTA a (batch, head) walking every key alone, behind a pre-pass that
// converted all of V to fp16. This route:
//   * Grid. One CTA per (batch, KV head, block of up to GP query rows of
//     its group, split of the keys), 128 threads. The wrapper picks the
//     splits (flash_attention.py: decode_splits) so that the grid fills
//     the CTAs the card holds at once (flash_attention_decode_ctas: 3 an
//     SM at G 1, 2 at G 8, by registers and shared memory) in one wave,
//     each split at least 128 keys: one more split would start a second
//     wave, whose CTAs find the card's bandwidth taken by the first.
//   * GQA. A CTA takes GP = min(G, 8) rounded up to a power of two of
//     the G = H / Hkv query rows that share its KV head, so every K and V
//     byte is read once for them (twice, from L2, where G > 8).
//   * Copies. K and V tiles of BK keys (16 KB a stage or less) come into
//     a ring of STAGES = 4 shared-memory stages by cp.async, 16 bytes a
//     thread, three stages in flight while one is read: up to 48 KB in
//     flight a CTA, three CTAs an SM at head dim 64. Each thread copies
//     the chunks it reads itself, so the loop has no block barrier: a
//     warp waits on its own copies only.
//   * Arithmetic. Float32 on the CUDA cores, straight from q's type: no
//     fp16 V and no pre-pass (so no exponent scratch either: float32 holds
//     bf16's range). The 128 threads are key groups of LPK lanes, LPK the
//     16-byte chunks of a row rounded up to a power of two: a lane holds
//     its chunk of every one of the CTA's query rows (pre-scaled by
//     log2(e) / sqrt(D)), multiplies it with its chunk of a key row, and
//     the group's lanes sum the parts by shuffles. Each key group keeps
//     its own running max m, sum l and its chunk of the output
//     accumulator over the keys it reads (every KG-th key of a tile), one
//     rescale a tile; at the end the CTA's groups meet in shared memory,
//     in group order.
//   * Merge. With one split the CTA writes o (q's type) and the lse. With
//     more, each split writes its partial (m, l, o) in float32 to a
//     workspace ws and counts itself done on its group's counter (an
//     atomicAdd after a __threadfence); the CTA that counts last merges
//     the group's splits in split order, reading them from L2, writes o
//     and the lse and sets the counter back to 0 for the next launch. So
//     a call is one launch: no second kernel, no memset (the wrapper keeps
//     the counters, zeroed once, beside the partials). Every order is
//     fixed, whichever CTA merges: two calls give the same bits.
//
// Built with nvcc for the card; the host tests build it with g++ against
// the stand-in runtime and tests/cuda_host/sm90/sm90.cuh (-D__CUDACC__),
// float32 and bf16 alike.
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
constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kBadArgs = 1;       // returned for a split that does not fit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {   // elements between batches, heads and rows
  long long b, h, s;
};

__device__ __forceinline__ void store_val(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_val(float v, bf16* p) {
  *p = __float2bfloat16(v);
}

// a 16-byte chunk as floats: eight bf16 or four float32
__device__ __forceinline__ void chunk_f32(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void chunk_f32(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

template <typename T, int D, int GP>
struct Dec {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int CPR = D / EPC;               // chunks a row
  // lanes a key: the chunks rounded up to a power of two (D = 112: 14
  // chunks of bf16 on 16 lanes, two of them idle)
  static constexpr int LPK = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16
                                                                     : 32;
  static constexpr int KG = kThreads / LPK;         // key groups
  // keys a stage: 8 KB of K (and of V) or less
  static constexpr int BK0 = 8192 / (D * (int)sizeof(T));
  static constexpr int BK = BK0 >= 64 ? 64 : BK0 >= 32 ? 32 : 16;
  static constexpr int KPG = BK / KG;               // keys a group a tile
  static constexpr int ROW = D * (int)sizeof(T);    // bytes a row
  static constexpr int STAGE = 2 * BK * ROW;        // K, then V
  static constexpr int RING = kStages * STAGE;
  // the groups' (m, l) and output chunks, met after the loop
  static constexpr int MERGE = KG * GP * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
  static_assert(CPR * EPC == D && CPR <= 32, "whole chunks, one warp");
  static_assert(KPG >= 1 && BK % KG == 0, "every group reads a key a tile");
};

// This thread's chunks of a stage: chunk c of K's and V's rows grp,
// grp + KG, ... of keys [k0, k0 + BK) (rows at or past ``end``
// zero-filled and not read) into the stage at shared address dst. A
// thread copies exactly what it reads, so its own cp.async.wait_group
// orders the copy before the read: no barrier a tile.
template <typename T, int D, int GP>
__device__ __forceinline__ void copy_stage(uint32_t dst, const T* kb,
                                           const T* vb, long long ks,
                                           long long vs, int k0, int end,
                                           int grp, int c) {
  using C = Dec<T, D, GP>;
  if (c >= C::CPR) return;   // an idle lane (D = 112)
#pragma unroll
  for (int i = 0; i < C::KPG; ++i) {
    const int r = grp + i * C::KG;
    const bool in = k0 + r < end;
    sm90::cp_async16(dst + r * C::ROW + c * 16,
                     kb + (in ? (k0 + r) * ks : 0) + c * C::EPC, in);
    sm90::cp_async16(dst + C::BK * C::ROW + r * C::ROW + c * 16,
                     vb + (in ? (k0 + r) * vs : 0) + c * C::EPC, in);
  }
}

// One CTA: query rows [g0, g0 + GP) of the group of KV head hk (those
// below G), keys [s0, s1) of split ``split``. n_split 1: o and lse
// written; else the split's partial (m, l, unnormalised o) into ws, and
// the group's last split to finish merges them all (the note).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
fa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ ws,
                 int* __restrict__ done, int B, int H, int Hkv, int kv_end,
                 int n_gb, int n_split, int split_len, Strides qs,
                 Strides ks, Strides vs, float scale_log2) {
  using C = Dec<T, D, GP>;
  constexpr int EPC = C::EPC, LPK = C::LPK, KG = C::KG, BK = C::BK;
  VX_DYN_SMEM(smem);
  const uint32_t ring = sm90::smem_addr(smem);
  const int G = H / Hkv;
  const int split = (int)(blockIdx.x % n_split);
  const int rest = (int)(blockIdx.x / n_split);
  const int gb = rest % n_gb, bk = rest / n_gb;    // bk = b * Hkv + hk
  const int hk = bk % Hkv, b = bk / Hkv;
  const int g0 = gb * GP;
  const int s0 = split * split_len;
  const int s1 = min(kv_end, s0 + split_len);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int tid = threadIdx.x, lane = tid % 32;
  const int c = lane % LPK;                        // this lane's chunk
  const int grp = tid / LPK;                       // its key group
  const bool has = c < C::CPR;
  const int n_tiles = (s1 - s0 + BK - 1) / BK;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      copy_stage<T, D, GP>(ring + st * C::STAGE, kb, vb, ks.s, vs.s,
                           s0 + st * BK, s1, grp, c);
    sm90::cp_async_commit();
  }

  // this lane's chunk of each query row, pre-scaled to log2 units
  float qr[GP][EPC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    float f[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) f[e] = 0.f;
    if (has && g0 + g < G)
      chunk_f32(*reinterpret_cast<const uint4*>(
                    q + b * qs.b + (long long)(hk * G + g0 + g) * qs.h +
                    c * EPC),
                f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) qr[g][e] = f[e] * scale_log2;
  }
  float m[GP], l[GP], acc[GP][EPC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    sm90::cp_async_wait<kStages - 2>();   // this thread's tile t landed
    if (t + kStages - 1 < n_tiles)        // into the slot it read last
      copy_stage<T, D, GP>(ring + (t + kStages - 1) % kStages * C::STAGE,
                           kb, vb, ks.s, vs.s, s0 + (t + kStages - 1) * BK,
                           s1, grp, c);
    sm90::cp_async_commit();
    const unsigned char* st = smem + t % kStages * C::STAGE;
    const int k0 = s0 + t * BK;

    // the group's keys of this tile: grp, grp + KG, ...
    float s[C::KPG][GP];
#pragma unroll
    for (int i = 0; i < C::KPG; ++i) {
      const int r = grp + i * KG;
      float kf[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) kf[e] = 0.f;
      if (has)
        chunk_f32(*reinterpret_cast<const uint4*>(st + r * C::ROW + c * 16),
                  kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) p = fmaf(qr[g][e], kf[e], p);
#pragma unroll
        for (int w = 1; w < LPK; w <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, w);
        s[i][g] = k0 + r < s1 ? p : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < C::KPG; ++i) mx = fmaxf(mx, s[i][g]);
      // a group with no key yet keeps m at -inf: base 0 makes its
      // weights and correction 0, not NaN
      const float base = mx == -INFINITY ? 0.f : mx;
      const float corr = sm90::ex2(m[g] - base);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < C::KPG; ++i) {
        s[i][g] = sm90::ex2(s[i][g] - base);
        sum += s[i][g];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < C::KPG; ++i) {
      const int r = grp + i * KG;
      float vf[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) vf[e] = 0.f;
      if (has)
        chunk_f32(*reinterpret_cast<const uint4*>(st + BK * C::ROW +
                                                  r * C::ROW + c * 16),
                  vf);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[g][e] = fmaf(s[i][g], vf[e], acc[g][e]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();   // the ring is read: it holds the groups' parts now

  // the groups meet: (m, l) of group grp and row g at ml[(grp GP + g) 2],
  // its output chunks at part[(grp GP + g) D + column]
  float* ml = reinterpret_cast<float*>(smem);
  float* part = ml + KG * GP * 2;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (c == 0) {
      ml[(grp * GP + g) * 2] = m[g];
      ml[(grp * GP + g) * 2 + 1] = l[g];
    }
    if (has)
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        part[(grp * GP + g) * D + c * EPC + e] = acc[g][e];
  }
  __syncthreads();
  const long long bh0 = (long long)b * H + hk * G + g0;
  for (int i = tid; i < GP * D; i += kThreads) {
    const int g = i / D, col = i % D;
    if (g0 + g >= G) continue;
    float M = -INFINITY;
    for (int j = 0; j < KG; ++j) M = fmaxf(M, ml[(j * GP + g) * 2]);
    float L = 0.f, O = 0.f;
    for (int j = 0; j < KG; ++j) {
      const float w = sm90::ex2(ml[(j * GP + g) * 2] - M);
      L = fmaf(ml[(j * GP + g) * 2 + 1], w, L);
      O = fmaf(part[(j * GP + g) * D + col], w, O);
    }
    if (n_split == 1) {
      store_val(O / fmaxf(L, 1e-20f), o + (bh0 + g) * D + col);
      if (lse != nullptr && col == 0) lse[bh0 + g] = (M + log2f(L)) * kLn2;
    } else {
      const long long row = (bh0 + g) * n_split + split;
      ws[row * D + col] = O;
      if (col == 0) {   // the (m, l) pairs follow every split's o
        float* wml = ws + (long long)B * H * n_split * D;
        wml[row * 2] = M;
        wml[row * 2 + 1] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the group's splits: count this one done; the last merges them all
  __shared__ int last;
  __threadfence();   // this CTA's partials, seen by every CTA
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + rest, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();   // every split's partials, seen here
  const float* wml = ws + (long long)B * H * n_split * D;
  for (int i = tid; i < GP * D; i += kThreads) {
    const int g = i / D, col = i % D;
    if (g0 + g >= G) continue;
    const long long row0 = (bh0 + g) * n_split;
    float M = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp)
      M = fmaxf(M, __ldcg(wml + (row0 + sp) * 2));
    float L = 0.f, O = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float w = sm90::ex2(__ldcg(wml + (row0 + sp) * 2) - M);
      L = fmaf(__ldcg(wml + (row0 + sp) * 2 + 1), w, L);
      O = fmaf(__ldcg(ws + (row0 + sp) * D + col), w, O);
    }
    store_val(O / fmaxf(L, 1e-20f), o + (bh0 + g) * D + col);
    if (lse != nullptr && col == 0) lse[bh0 + g] = (M + log2f(L)) * kLn2;
  }
  if (tid == 0) done[rest] = 0;   // ready for the next launch
}

// the instantiation's shared memory allowed, once
template <typename T, int D, int GP>
int prepare() {
  static const int attr = (int)cudaFuncSetAttribute(
      fa_decode_kernel<T, D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dec<T, D, GP>::SMEM);
  return attr;
}

// CTAs of the instantiation an SM holds at once (its registers and shared
// memory); <= 0 where it cannot be asked
template <typename T, int D, int GP>
int ctas_per_sm() {
  int n = 0;
  if (prepare<T, D, GP>() != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fa_decode_kernel<T, D, GP>, kThreads, Dec<T, D, GP>::SMEM) != 0)
    return -1;
  return n;
}

template <typename T, int D>
int ctas_for(int G) {
  return G == 1 ? ctas_per_sm<T, D, 1>() : G == 2 ? ctas_per_sm<T, D, 2>()
       : G <= 4 ? ctas_per_sm<T, D, 4>() : ctas_per_sm<T, D, 8>();
}

template <typename T, int D, int GP>
int launch_gp(const void* q, const void* k, const void* v, void* o,
              float* lse, float* ws, int* done, int B, int H, int Hkv,
              int kv_end,
              int n_split, int split_len, const Strides& qs,
              const Strides& ks, const Strides& vs, float scale_log2,
              void* stream) {
  using C = Dec<T, D, GP>;
  const int n_gb = (H / Hkv + GP - 1) / GP;
  auto kernel = fa_decode_kernel<T, D, GP>;
  const int attr = prepare<T, D, GP>();
  if (attr != 0) return attr;
  VX_LAUNCH_SMEM(kernel, B * Hkv * n_gb * n_split, kThreads, C::SMEM,
                 stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                 ws, done, B, H, Hkv, kv_end, n_gb, n_split, split_len, qs,
                 ks, vs, scale_log2);
  return (int)cudaGetLastError();
}

// the query rows a CTA takes: G up to 8, rounded up to a power of two
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* ws, int* done, int B, int H, int Hkv, int Sk,
           long long qsb,
           long long qsh, long long ksb, long long ksh, long long kss,
           long long vsb, long long vsh, long long vss, int causal,
           float sm_scale, int n_split, int split_len, void* stream) {
  const int kv_end = causal ? min(Sk, 1) : Sk;
  if (Hkv < 1 || H % Hkv || n_split < 1 || split_len < 1 ||
      (long long)(n_split - 1) * split_len >= kv_end ||
      (long long)n_split * split_len < kv_end ||
      (n_split > 1 && (ws == nullptr || done == nullptr)))
    return kBadArgs;
  const Strides qs{qsb, qsh, 0}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const float sl = sm_scale * kLog2e;
  const int G = H / Hkv;
  if (G == 1)
    return launch_gp<T, D, 1>(q, k, v, o, lse, ws, done, B, H, Hkv, kv_end,
                              n_split, split_len, qs, ks, vs, sl, stream);
  if (G == 2)
    return launch_gp<T, D, 2>(q, k, v, o, lse, ws, done, B, H, Hkv, kv_end,
                              n_split, split_len, qs, ks, vs, sl, stream);
  if (G <= 4)
    return launch_gp<T, D, 4>(q, k, v, o, lse, ws, done, B, H, Hkv, kv_end,
                              n_split, split_len, qs, ks, vs, sl, stream);
  return launch_gp<T, D, 8>(q, k, v, o, lse, ws, done, B, H, Hkv, kv_end,
                            n_split, split_len, qs, ks, vs, sl, stream);
}

}  // namespace

// q: (B, H, 1, D), k and v: (B, Hkv, Sk, D), each read through its
// strides (in elements; each row and stride on 16 bytes, the last
// dimension contiguous); o: contiguous (B, H, 1, D); lse: null, or a
// contiguous float32 (B, H, 1). The keys are cut into n_split splits of
// split_len ((n_split - 1) split_len < keys <= n_split split_len, the
// keys being Sk, or 1 where causal). Where n_split > 1: ws, a float32
// scratch of B H n_split (D + 2), and done, B Hkv ceil(G / 8) int32
// counters that are 0 on entry and are left 0 (null where n_split is 1).
// Sk >= 1, Hkv dividing H, B * Hkv * ceil(G / 8) * n_split < 2^31.
#define VX_FA_DEC_ENTRY(NAME, T, D)                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v,         \
                      void* o, void* lse, void* ws, void* done, int B,     \
                      int H, int Hkv, int Sk, long long qsb, long long qsh,\
                      long long ksb, long long ksh, long long kss,         \
                      long long vsb, long long vsh, long long vss,         \
                      int causal, float sm_scale, int n_split,             \
                      int split_len, void* stream) {                       \
    return launch<T, D>(q, k, v, o, (float*)lse, (float*)ws, (int*)done,  \
                        B, H, Hkv, Sk, qsb, qsh, ksb, ksh, kss, vsb, vsh,  \
                        vss, causal, sm_scale, n_split, split_len,         \
                        stream);                                           \
  }

VX_FA_DEC_ENTRY(flash_attention_decode_f32_d32, float, 32)
VX_FA_DEC_ENTRY(flash_attention_decode_f32_d64, float, 64)
VX_FA_DEC_ENTRY(flash_attention_decode_f32_d112, float, 112)
VX_FA_DEC_ENTRY(flash_attention_decode_f32_d128, float, 128)
VX_FA_DEC_ENTRY(flash_attention_decode_bf16_d32, __nv_bfloat16, 32)
VX_FA_DEC_ENTRY(flash_attention_decode_bf16_d64, __nv_bfloat16, 64)
VX_FA_DEC_ENTRY(flash_attention_decode_bf16_d112, __nv_bfloat16, 112)
VX_FA_DEC_ENTRY(flash_attention_decode_bf16_d128, __nv_bfloat16, 128)

// CTAs an SM holds of the decode kernel for float32 (bf16 0) or bf16 (1)
// at head dim D with G query rows a KV head: the wrapper's splits fill
// the card's slots with them. <= 0 where it cannot be asked.
extern "C" int flash_attention_decode_ctas(int bf16, int D, int G) {
  switch (D) {
    case 32: return bf16 ? ctas_for<__nv_bfloat16, 32>(G)
                         : ctas_for<float, 32>(G);
    case 64: return bf16 ? ctas_for<__nv_bfloat16, 64>(G)
                         : ctas_for<float, 64>(G);
    case 112: return bf16 ? ctas_for<__nv_bfloat16, 112>(G)
                          : ctas_for<float, 112>(G);
    case 128: return bf16 ? ctas_for<__nv_bfloat16, 128>(G)
                          : ctas_for<float, 128>(G);
  }
  return -1;
}
