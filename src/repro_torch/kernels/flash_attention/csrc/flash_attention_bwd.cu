// The gradient of attention: dq, dk and dv from q, k, v, the output o,
// its gradient do and the forward's row log-sum-exp lse.
//
// No TPU kernel stands behind it: the reference trains through plain jnp
// (repro/models/layers.py:attention_chunked under jax.grad), and its
// Pallas flash_attention (repro/kernels/flash_attention/flash_attention.py)
// has no custom_vjp. This is the backward of the port's forward
// (flash_attention.cu), from the row log-sum-exp it stores. With
// s = q k^T / sqrt(D) under the forward's mask (causal: key <= query, the
// same origin for both; keys past Sk never count), all in float32:
//
//   P     = exp(s - lse)              (0 where masked)
//   delta = rowsum(do * o)            (one number a query row)
//   dv    = P^T do
//   dS    = P * (do v^T - delta)
//   dq    = dS k / sqrt(D),  dk = dS^T q / sqrt(D)
//
// K and V may have Hkv heads, Hkv dividing H: dk and dv of KV head hk sum
// over its H / Hkv query heads. Every tensor is read through its strides
// (the last dimension contiguous); dq, dk and dv are written contiguous in
// the inputs' type.
//
// Bound: operations, five products of a 64-key tile with a 64-query tile
// for each pair under the mask; the design computes seven. Three kernels
// a call, none with a float atomic, so two calls on the same inputs give
// the same bits:
//   * fa_bwd_delta: one warp a query row, delta = rowsum(do * o);
//   * dk and dv: one CTA a (batch, KV head, 64-key tile). K and V's tiles
//     stay in shared memory; the CTA walks the group's query heads and,
//     for each, the query tiles the mask lets see the key tile (from the
//     key tile's own on, causal), and accumulates dk and dv in registers
//     in that fixed order;
//   * dq: one CTA a (batch, head, 64-query tile). Q and do's tiles stay in
//     shared memory; the CTA walks the key tiles up to the diagonal and
//     accumulates dq in registers.
// Both recompute S and do v^T for each tile pair: dk/dv and dq each need
// the whole of dS, and keeping them apart is what makes the sums fixed
// in order without atomics. Two routes, which the wrapper picks from the
// dtype, the head dim and the rows' alignment (flash_attention_bwd.py:
// route); nothing is tried and given up:
//
// The tensor-core route (bf16, D = 64, 112 or 128, rows of 16-byte
// multiples): fa_bwd_dkdv_tc and fa_bwd_dq_tc, one warpgroup of 128
// threads a CTA, every product a wgmma (bf16 in, float32 accumulators in
// registers; sm90.cuh has the helpers and the tile layout).
//   * dkdv: K and V's tiles are copied once; the (Q, do) tiles of the
//     walk, with their 64 lse and delta, come through a ring of two
//     cp.async stages, the next pair's copies in flight while the current
//     one is used. Per pair: S^T = K Q^T and dP^T = V do^T (both operands
//     from shared memory, K-major), 32 + 32 float32 registers a thread;
//     P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//     delta) on the accumulator fragments, masked only on pairs that
//     cross the diagonal or an end; each is packed to bf16 pairs as it is
//     formed, and is the A operand of dV += P^T do and dK += dS^T Q in the
//     register form (RS): the accumulator fragment of a product is the A
//     fragment of the next, so P and dS need no shared tile and no
//     barrier. do and Q are read MN-major (the transpose bit) from the
//     same swizzled tiles that the first two products read K-major.
//     dK and dV stay in registers: 32 + 32 floats a thread at D = 64,
//     64 + 64 at D = 112 and 128.
//   * dq: Q and do's tiles are copied once, K and V's come through the
//     two-stage ring. Per key tile: S = Q K^T and dP = do V^T, dS in
//     registers, dQ += dS K (RS; K read MN-major).
//   * bf16, not fp16, for P and dS. The mean loss over B S tokens divides
//     every gradient by B S (8,192 at granite's training batch), so do
//     and dS sit near or below fp16's smallest normal, 6.1e-5, where fp16
//     keeps fewer bits; bf16 has float32's range. P and dS rounded to bf16
//     (2^-9 of each element) stay within the card's tolerance: the CPU
//     tests hold a rounding model of the route against the float32 plain
//     version, with do at that scale too. The forward's reason for fp16 P
//     (an elementwise tolerance on o) does not carry over to sums of
//     thousands of terms held to their largest value.
//   * D = 112 takes the tiles of D = 128 (two column blocks of 64) with
//     the two chunks past the row zero-filled: the products over D stop
//     after 7 k16 steps; dK, dV and dQ accumulate at N = 128 and store
//     112 columns.
//   * The longest causal tiles are launched first: the low key tiles in
//     dkdv, the high query tiles in dq, across all heads; heads that share
//     a KV head are adjacent.
//   * Shared memory: six 64-row tiles, 49 KB at D = 64, 97 KB at D = 112
//     and 128 (dkdv adds 1 KB of lse and delta): two CTAs an SM at D = 112
//     and 128. At D = 64 registers set it: dkdv two, dq three (at most
//     168 registers a thread; ptxas's counts are printed by chip_smoke.py).
//
// The CUDA-core route (float32; bf16 at D = 32 or with rows the copies
// cannot take): fa_bwd_dkdv and fa_bwd_dq, 256 threads a CTA, float32 on
// the CUDA cores. Each thread computes a 4 x 4 block of a 64 x 64 product
// (rows ta + 16 i, columns tb + 16 j, so that the 16 lanes reading
// distinct rows hit distinct banks of a row pitch of D + 1 floats), then 4
// rows by D / 16 columns of the 64 x D accumulators. The float32 tiles (q,
// do, k, v and two 64 x 64 tiles) take 98-162 KB of dynamic shared memory
// at D = 64-128.
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

constexpr int BT = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// the float32 tiles of a CTA; +1 columns keep the 16 rows that a warp
// reads at once in distinct banks
template <int D>
struct Tiles {
  float Q[BT][D + 1];
  float dO[BT][D + 1];
  float K[BT][D + 1];
  float V[BT][D + 1];
  float P[BT][BT + 1];
  float dS[BT][BT + 1];
  float lse[BT];
  float delta[BT];
};

// rows [r0, r0 + 64) of one head as float32 into tile, zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (&tile)[BT][D + 1],
                                          const T* base, long long ld,
                                          int r0, int rows) {
  for (int e = threadIdx.x; e < BT * D; e += kThreads) {
    const int r = e / D, c = e % D;
    tile[r][c] = r0 + r < rows ? to_f32(base[(r0 + r) * ld + c]) : 0.f;
  }
}

// delta[row] = sum_d do[row, d] * o[row, d]: one warp a (b, h, i) row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
             float* __restrict__ delta, int H, int Sq, Strides os,
             Strides dos, long long n_rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;   // a whole warp returns
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(orow[c]) * to_f32(drow[c]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// s[i][j] = A[ta + 16 i] . B[tb + 16 j] and t[i][j] = C[ta + 16 i] .
// E[tb + 16 j] over D: two 64 x 64 products of the tiles, 4 x 4 of each a
// thread
template <int D>
__device__ __forceinline__ void two_products(
    const float (&A)[BT][D + 1], const float (&Bm)[BT][D + 1],
    const float (&C)[BT][D + 1], const float (&E)[BT][D + 1], int ta,
    int tb, float (&s)[4][4], float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    float a[4], bb[4], cc[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[ta + 16 * i][c];
      cc[i] = C[ta + 16 * i][c];
      bb[i] = Bm[tb + 16 * i][c];
      e[i] = E[tb + 16 * i][c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bb[j];
        t[i][j] += cc[i] * e[j];
      }
  }
}

// dk and dv of one (batch, KV head, 64-key tile)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
            int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
            int causal, float sm_scale) {
  VX_DYN_SMEM(smem);
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem);
  const int n_kt = (Sk + BT - 1) / BT;
  const int kt = (int)(blockIdx.x % n_kt);
  const int bh = (int)(blockIdx.x / n_kt);    // b * Hkv + hk
  const int hk = bh % Hkv, b = bh / Hkv;
  const int G = H / Hkv;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, ta = tid / 16, tb = tid % 16;
  constexpr int NC = D / 16;                 // columns a thread holds

  load_tile<T, D>(t.K, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
  load_tile<T, D>(t.V, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_qt = (Sq + BT - 1) / BT;
  const int qt0 = causal ? k0 / BT : 0;   // query tiles before see no key
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();   // the last tile pair's Q, dO, P, dS are read
      load_tile<T, D>(t.Q, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<T, D>(t.dO, dO + b * dos.b + h * dos.h, dos.s, q0, Sq);
      if (tid < BT) {
        const bool in = q0 + tid < Sq;
        t.lse[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        t.delta[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // keys ta + 16 i (rows of K, V) against queries tb + 16 j
      float s[4][4], dp[4][4];
      two_products<D>(t.K, t.Q, t.V, t.dO, ta, tb, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ta + 16 * i, qr = tb + 16 * j;
          const int kpos = k0 + kr, qpos = q0 + qr;
          const bool valid = kpos < Sk && qpos < Sq &&
                             (!causal || kpos <= qpos);
          const float p =
              valid ? expf(s[i][j] * sm_scale - t.lse[qr]) : 0.f;
          t.P[kr][qr] = p;
          t.dS[kr][qr] = p * (dp[i][j] - t.delta[qr]);
        }
      __syncthreads();

      // dv += P^T do, dk += dS^T q, over the tile's 64 queries
      for (int r = 0; r < BT; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = t.P[ta + 16 * i][r];
          ds[i] = t.dS[ta + 16 * i][r];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float dov = t.dO[r][tb + 16 * j];
          const float qv = t.Q[r][tb + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] += p[i] * dov;
            adk[i][j] += ds[i] * qv;
          }
        }
      }
    }
  }
  const long long out0 = ((long long)b * Hkv + hk) * Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ta + 16 * i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const long long at = (out0 + kpos) * D + tb + 16 * j;
      store_f32(adk[i][j] * sm_scale, dk + at);
      store_f32(adv[i][j], dv + at);
    }
  }
}

// dq of one (batch, head, 64-query tile)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, Strides qs,
          Strides ks, Strides vs, Strides dos, int causal, float sm_scale) {
  VX_DYN_SMEM(smem);
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem);
  const int n_qt = (Sq + BT - 1) / BT;
  const int qt = (int)(blockIdx.x % n_qt);
  const int bh = (int)(blockIdx.x / n_qt);    // b * H + h
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BT;
  const int tid = threadIdx.x, ta = tid / 16, tb = tid % 16;
  constexpr int NC = D / 16;
  const long long row0 = (long long)bh * Sq;

  load_tile<T, D>(t.Q, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<T, D>(t.dO, dO + b * dos.b + h * dos.h, dos.s, q0, Sq);
  if (tid < BT) {
    const bool in = q0 + tid < Sq;
    t.lse[tid] = in ? lse[row0 + q0 + tid] : 0.f;
    t.delta[tid] = in ? delta[row0 + q0 + tid] : 0.f;
  }
  float adq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) adq[i][j] = 0.f;

  const int kv_end = causal ? min(Sk, min(q0 + BT, Sq)) : Sk;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();   // Q, dO written; the last key tile's K and dS read
    load_tile<T, D>(t.K, kb, ks.s, k0, Sk);
    load_tile<T, D>(t.V, vb, vs.s, k0, Sk);
    __syncthreads();

    // queries ta + 16 i against keys tb + 16 j
    float s[4][4], dp[4][4];
    two_products<D>(t.Q, t.K, t.dO, t.V, ta, tb, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ta + 16 * i, kr = tb + 16 * j;
        const int kpos = k0 + kr, qpos = q0 + qr;
        const bool valid = kpos < Sk && qpos < Sq &&
                           (!causal || kpos <= qpos);
        const float p = valid ? expf(s[i][j] * sm_scale - t.lse[qr]) : 0.f;
        t.dS[qr][kr] = p * (dp[i][j] - t.delta[qr]);
      }
    __syncthreads();

    // dq += dS k over the tile's 64 keys
    for (int r = 0; r < BT; ++r) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = t.dS[ta + 16 * i][r];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = t.K[r][tb + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][j] += ds[i] * kv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ta + 16 * i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store_f32(adq[i][j] * sm_scale,
                dq + (row0 + qpos) * D + tb + 16 * j);
  }
}

// delta = rowsum(do * o), the pre-pass of both routes
template <typename T, int D>
int launch_delta(const void* o, const void* dO, void* delta, int B, int H,
                 int Sq, Strides os, Strides dos, void* stream) {
  const long long n_rows = (long long)B * H * Sq;
  auto kd = fa_bwd_delta<T, D>;
  VX_LAUNCH(kd, (int)((n_rows + kWarps - 1) / kWarps), kThreads, stream,
            (const T*)o, (const T*)dO, (float*)delta, H, Sq, os, dos,
            n_rows);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int Sq, int Sk,
           const long long* st, int causal, float sm_scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  int err = launch_delta<T, D>(o, dO, delta, B, H, Sq, os, dos, stream);
  if (err != 0) return err;

  constexpr int smem = (int)sizeof(Tiles<D>);
  auto kkv = fa_bwd_dkdv<T, D>;
  static const int attr_kv = (int)cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_kv != 0) return attr_kv;
  VX_LAUNCH_SMEM(kkv, B * Hkv * ((Sk + BT - 1) / BT), kThreads, smem,
                 stream, (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
                 (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H,
                 Hkv, Sq, Sk, qs, ks, vs, dos, causal, sm_scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto kq = fa_bwd_dq<T, D>;
  static const int attr_q = (int)cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_q != 0) return attr_q;
  VX_LAUNCH_SMEM(kq, B * H * ((Sq + BT - 1) / BT), kThreads, smem, stream,
                 (const T*)q, (const T*)k, (const T*)v, (const T*)dO,
                 (const float*)lse, (const float*)delta, (T*)dq, H, Hkv, Sq,
                 Sk, qs, ks, vs, dos, causal, sm_scale);
  return (int)cudaGetLastError();
}

#ifdef __CUDACC__
// ---- the tensor-core route: bf16, D = 64, 112 or 128 --------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;   // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcTiles {
  // columns of a tile: whole blocks of 64 (D = 112 takes D = 128's)
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int TILE = BT * DP * 2;        // one 64-row bf16 tile
  // dkdv: K, V, two stages of (Q, do), then lse and delta of each stage
  // (64 floats each); dq: Q, do, two stages of (K, V); and room to align
  // the start to 1024
  static constexpr int SMEM_KV = 6 * TILE + 2 * 2 * BT * 4 + 1024;
  static constexpr int SMEM_Q = 6 * TILE + 1024;
  // CTAs an SM holds: two by shared memory at D = 112 and 128; at D = 64
  // dq three (at most 168 registers a thread), dkdv two (it holds dK and
  // dV beside S^T and dP^T)
  static constexpr int DQ_MIN_CTAS = DP == 64 ? 3 : 2;
};

// The accumulator fragment of wgmma m64n64k16 (sm90.cuh): element e of a
// thread (warp w, lane l) is row 16 w + l / 4 + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2 (l % 4) + (e & 1). Elements 4 j .. 4 j + 3 are the
// column pair 8 j + 2 (l % 4) + {0, 1} of the two rows, and, packed
// pairwise, words 2 (j % 2) and 2 (j % 2) + 1 of the A fragment of k16
// step j / 2.
__device__ __forceinline__ void pack_pairs(uint32_t (&a)[BT / 16][4], int j,
                                           const float (&x)[4]) {
  a[j >> 1][2 * (j & 1)] = sm90::pack_bf16(x[0], x[1]);
  a[j >> 1][2 * (j & 1) + 1] = sm90::pack_bf16(x[2], x[3]);
}

// dk and dv of one (batch, KV head, 64-key tile), one warpgroup
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
fa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
               int n_bkv, Strides qs, Strides ks, Strides vs, Strides dos,
               int causal, float sm_scale, float scale_log2) {
  using TL = TcTiles<D>;
  constexpr int DP = TL::DP, TILE = TL::TILE;
  VX_DYN_SMEM(smem);
  const uint32_t s_k = sm90::align1024(smem);
  const uint32_t s_v = s_k + TILE;
  const uint32_t s_ring = s_v + TILE;      // stage st: Q, then do
  const uint32_t s_rows = s_ring + 4 * TILE;   // stage st: lse, delta
  const float* rows = reinterpret_cast<const float*>(
      smem + (s_rows - sm90::smem_addr(smem)));
  // the lowest key tiles, which see the most query tiles, first
  const int kt = (int)(blockIdx.x / n_bkv);
  const int bkv = (int)(blockIdx.x % n_bkv);     // b * Hkv + hk
  const int hk = bkv % Hkv, b = bkv / Hkv;
  const int G = H / Hkv;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kr0 = k0 + tid / 32 * 16 + lane / 4;   // keys kr0, kr0 + 8
  const int n_qt = (Sq + BT - 1) / BT;
  const int qt0 = causal ? kt : 0;   // query tiles before see no key
  const int per_g = n_qt > qt0 ? n_qt - qt0 : 0;
  const int n_it = G * per_g;        // head g, then query tile qt

  // the (Q, do) tiles, lse and delta of step it into stage st
  auto load = [&](int it, int st) {
    const int h = hk * G + it / per_g;
    const int q0 = (qt0 + it % per_g) * BT;
    const uint32_t dst = s_ring + st * 2 * TILE;
    sm90::copy_rows<BT, D, TC_THREADS>(
        dst, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, Sq - q0, tid);
    sm90::copy_rows<BT, D, TC_THREADS>(
        dst + TILE, dO + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
        Sq - q0, tid);
    // threads 0-63 copy a row's lse, 64-127 its delta
    const float* src = (tid < BT ? lse : delta) +
                       ((long long)b * H + h) * Sq + q0;
    const int r = tid % BT;
    const bool in = q0 + r < Sq;
    sm90::cp_async4(s_rows + st * 2 * BT * 4 + tid * 4, src + (in ? r : 0),
                    in);
  };
  if (n_it > 0) {
    sm90::copy_rows<BT, D, TC_THREADS>(
        s_k, k + b * ks.b + hk * ks.h + k0 * ks.s, ks.s, Sk - k0, tid);
    sm90::copy_rows<BT, D, TC_THREADS>(
        s_v, v + b * vs.b + hk * vs.h + k0 * vs.s, vs.s, Sk - k0, tid);
    load(0, 0);
  }
  sm90::cp_async_commit();

  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load(it + 1, st ^ 1);   // the stage the last used
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();   // this step's tiles (and K, V) have landed
    sm90::fence_async_smem();
    __syncthreads();
    const int q0 = (qt0 + it % per_g) * BT;
    const uint32_t s_q = s_ring + st * 2 * TILE, s_do = s_q + TILE;

    // S^T = K Q^T and dP^T = V do^T over D: D / 16 k-steps each, the
    // zero columns past D not read
    float s[BT / 2], dp[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
      sm90::Mma<BT, 0>::ss(s, sm90::desc(s_k + off, 16, 1024),
                           sm90::desc(s_q + off, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
      sm90::Mma<BT, 0>::ss(dp, sm90::desc(s_v + off, 16, 1024),
                           sm90::desc(s_do + off, 16, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T and dS^T: rows are keys, columns queries (lse, delta by column)
    const float* lse_t = rows + st * 2 * BT;
    const float* delta_t = lse_t + BT;
    const bool edge =
        k0 + BT > Sk || q0 + BT > Sq || (causal && q0 < k0 + BT);
    uint32_t pf[BT / 16][4], df[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        float pe = sm90::ex2(fmaf(s[4 * j + e], scale_log2, -l * kLog2e));
        if (edge) {
          const int key = kr0 + 8 * ((e >> 1) & 1), qry = q0 + c + (e & 1);
          if (key >= Sk || qry >= Sq || (causal && key > qry)) pe = 0.f;
        }
        p[e] = pe;
        ds[e] = pe * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      pack_pairs(pf, j, p);
      pack_pairs(df, j, ds);
    }

    // dV += P^T do and dK += dS^T Q over the tile's 64 queries (RS; do
    // and Q MN-major), N = DP
    sm90::fence_regs(adv);
    sm90::fence_regs(adk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      sm90::Mma<DP, 1>::rs(adv, pf[kk],
                           sm90::desc(s_do + kk * 2048, BT * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      sm90::Mma<DP, 1>::rs(adk, df[kk],
                           sm90::desc(s_q + kk * 2048, BT * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(adv);
    sm90::fence_regs(adk);
    __syncthreads();   // the stage is free for the step after next
  }

  const long long out0 = ((long long)b * Hkv + hk) * Sk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr0 + 8 * r;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long at = (out0 + key) * D + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dk + at) = sm90::pack_bf16(
          adk[4 * j + 2 * r] * sm_scale, adk[4 * j + 2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          sm90::pack_bf16(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

// dq of one (batch, head, 64-query tile), one warpgroup
template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcTiles<D>::DQ_MIN_CTAS)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int n_bh,
             Strides qs, Strides ks, Strides vs, Strides dos, int causal,
             float sm_scale, float scale_log2) {
  using TL = TcTiles<D>;
  constexpr int DP = TL::DP, TILE = TL::TILE;
  VX_DYN_SMEM(smem);
  const uint32_t s_q = sm90::align1024(smem);
  const uint32_t s_do = s_q + TILE;
  const uint32_t s_kv = s_do + TILE;   // stage st: K, then V
  // the highest query tiles, which see the most key tiles, first
  const int qt = (int)(gridDim.x / n_bh) - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);       // b * H + h
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BT;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int tid = threadIdx.x, lane = tid % 32;
  const int qr0 = q0 + tid / 32 * 16 + lane / 4;   // queries qr0, qr0 + 8
  const int kv_end = causal ? min(Sk, min(q0 + BT, Sq)) : Sk;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const long long row0 = (long long)bh * Sq;

  sm90::copy_rows<BT, D, TC_THREADS>(
      s_q, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, Sq - q0, tid);
  sm90::copy_rows<BT, D, TC_THREADS>(
      s_do, dO + b * dos.b + h * dos.h + q0 * dos.s, dos.s, Sq - q0, tid);
  sm90::copy_rows<BT, D, TC_THREADS>(s_kv, kb, ks.s, kv_end, tid);
  sm90::copy_rows<BT, D, TC_THREADS>(s_kv + TILE, vb, vs.s, kv_end, tid);
  sm90::cp_async_commit();
  float lse_l2[2], dlt[2];   // of the thread's two query rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr0 + 8 * r;
    lse_l2[r] = row < Sq ? lse[row0 + row] * kLog2e : 0.f;
    dlt[r] = row < Sq ? delta[row0 + row] : 0.f;
  }

  float adq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adq[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    const uint32_t s_k = s_kv + (t & 1) * 2 * TILE, s_v = s_k + TILE;
    if (t + 1 < n_tiles) {   // the stage the last tile used
      const uint32_t nk = s_kv + ((t + 1) & 1) * 2 * TILE;
      const int left = kv_end - k0 - BT;
      sm90::copy_rows<BT, D, TC_THREADS>(nk, kb + (k0 + BT) * ks.s, ks.s,
                                         left, tid);
      sm90::copy_rows<BT, D, TC_THREADS>(nk + TILE, vb + (k0 + BT) * vs.s,
                                         vs.s, left, tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();   // this tile (and Q, do) have landed
    sm90::fence_async_smem();
    __syncthreads();

    // S = Q K^T and dP = do V^T over D
    float s[BT / 2], dp[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
      sm90::Mma<BT, 0>::ss(s, sm90::desc(s_q + off, 16, 1024),
                           sm90::desc(s_k + off, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (BT * 128) + (kk & 3) * 32;
      sm90::Mma<BT, 0>::ss(dp, sm90::desc(s_do + off, 16, 1024),
                           sm90::desc(s_v + off, 16, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // dS: rows are queries, columns keys (lse, delta by row)
    const bool edge = k0 + BT > Sk || q0 + BT > Sq ||
                      (causal && k0 + BT - 1 > q0);
    uint32_t df[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e >> 1) & 1;
        float pe = sm90::ex2(fmaf(s[4 * j + e], scale_log2, -lse_l2[r]));
        if (edge) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qry = qr0 + 8 * r;
          if (key >= Sk || qry >= Sq || (causal && key > qry)) pe = 0.f;
        }
        ds[e] = pe * (dp[4 * j + e] - dlt[r]);
      }
      pack_pairs(df, j, ds);
    }

    // dQ += dS K over the tile's 64 keys (RS; K MN-major), N = DP
    sm90::fence_regs(adq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      sm90::Mma<DP, 1>::rs(adq, df[kk],
                           sm90::desc(s_k + kk * 2048, BT * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(adq);
    __syncthreads();   // the stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + (row0 + row) * D + j * 8 +
                                   (lane & 3) * 2) =
          sm90::pack_bf16(adq[4 * j + 2 * r] * sm_scale,
                          adq[4 * j + 2 * r + 1] * sm_scale);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dO, const void* lse, void* delta, void* dq,
              void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
              const long long* st, int causal, float sm_scale,
              void* stream) {
  using TL = TcTiles<D>;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  int err = launch_delta<bf16, D>(o, dO, delta, B, H, Sq, os, dos, stream);
  if (err != 0) return err;

  auto kkv = fa_bwd_dkdv_tc<D>;
  static const int attr_kv = (int)cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_KV);
  if (attr_kv != 0) return attr_kv;
  VX_LAUNCH_SMEM(kkv, B * Hkv * ((Sk + BT - 1) / BT), TC_THREADS,
                 TL::SMEM_KV, stream, (const bf16*)q, (const bf16*)k,
                 (const bf16*)v, (const bf16*)dO, (const float*)lse,
                 (const float*)delta, (bf16*)dk, (bf16*)dv, H, Hkv, Sq, Sk,
                 B * Hkv, qs, ks, vs, dos, causal, sm_scale,
                 sm_scale * kLog2e);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto kq = fa_bwd_dq_tc<D>;
  static const int attr_q = (int)cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_Q);
  if (attr_q != 0) return attr_q;
  VX_LAUNCH_SMEM(kq, B * H * ((Sq + BT - 1) / BT), TC_THREADS, TL::SMEM_Q,
                 stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                 (const bf16*)dO, (const float*)lse, (const float*)delta,
                 (bf16*)dq, H, Hkv, Sq, Sk, B * H, qs, ks, vs, dos, causal,
                 sm_scale, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

// q, o, do: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), Hkv dividing H; each
// read through its strides (in elements, last dimension contiguous):
// strides holds 15 numbers, (batch, head, row) of q, k, v, o, do in
// turn. lse: contiguous float32 (B, H, Sq) from the forward; delta: a
// float32 (B, H, Sq) scratch; dq: contiguous (B, H, Sq, D); dk, dv:
// contiguous (B, Hkv, Sk, D), all in the inputs' type. Sq, Sk >= 1 and
// B * H * ceil(Sq / 64), B * Hkv * ceil(Sk / 64) < 2^31. The tensor-core
// entries (_tc_) also need q, k, v, do and their strides in elements to
// be 16-byte aligned.
#define VX_FA_BWD_ENTRY(NAME, LAUNCH)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,        \
                      const void* o, const void* dO, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv, int B,   \
                      int H, int Hkv, int Sq, int Sk,                     \
                      const long long* strides, int causal,               \
                      float sm_scale, void* stream) {                     \
    return LAUNCH(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv, Sq,  \
                  Sk, strides, causal, sm_scale, stream);                 \
  }

VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d32, (launch<float, 32>))
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d64, (launch<float, 64>))
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d112, (launch<float, 112>))
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d128, (launch<float, 128>))
#ifdef __CUDACC__
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d32, (launch<bf16, 32>))
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d64, (launch<bf16, 64>))
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d112, (launch<bf16, 112>))
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d128, (launch<bf16, 128>))
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_tc_d64, launch_tc<64>)
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_tc_d112, launch_tc<112>)
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_tc_d128, launch_tc<128>)
#endif
