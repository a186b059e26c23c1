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
// Bound: operations (five products of a 64-key tile with a 64-query tile
// for each pair under the mask). This first version runs them on the CUDA
// cores in float32; tensor cores are a later change. Three kernels, none
// with a float atomic, so two calls on the same inputs give the same bits:
//   * fa_bwd_delta: one warp a query row, delta = rowsum(do * o);
//   * fa_bwd_dkdv: one CTA a (batch, KV head, 64-key tile). K and V's
//     tiles stay in shared memory; the CTA walks the group's query heads
//     and, for each, the query tiles the mask lets see the key tile (from
//     the key tile's own on, causal), and accumulates dk and dv in
//     registers in that fixed order;
//   * fa_bwd_dq: one CTA a (batch, head, 64-query tile). Q and do's tiles
//     stay in shared memory; the CTA walks the key tiles up to the
//     diagonal and accumulates dq in registers.
// Both recompute S and do v^T for each tile pair: dk/dv and dq each need
// the whole of dS, and keeping them apart is what makes the sums fixed
// in order without atomics. 256 threads a CTA; each thread computes a 4 x
// 4 block of a 64 x 64 product (rows ta + 16 i, columns tb + 16 j, so
// that the 16 lanes reading distinct rows hit distinct banks of a row
// pitch of D + 1 floats), then 4 rows by D / 16 columns of the 64 x D
// accumulators. The float32 tiles (q, do, k, v and two 64 x 64 tiles)
// take 98-162 KB of dynamic shared memory at D = 64-128.
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int Sq, int Sk,
           const long long* st, int causal, float sm_scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  const long long n_rows = (long long)B * H * Sq;
  auto kd = fa_bwd_delta<T, D>;
  VX_LAUNCH(kd, (int)((n_rows + kWarps - 1) / kWarps), kThreads, stream,
            (const T*)o, (const T*)dO, (float*)delta, H, Sq, os, dos,
            n_rows);
  int err = (int)cudaGetLastError();
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

}  // namespace

// q, o, do: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), Hkv dividing H; each
// read through its strides (in elements, last dimension contiguous):
// strides holds 15 numbers, (batch, head, row) of q, k, v, o, do in
// turn. lse: contiguous float32 (B, H, Sq) from the forward; delta: a
// float32 (B, H, Sq) scratch; dq: contiguous (B, H, Sq, D); dk, dv:
// contiguous (B, Hkv, Sk, D), all in the inputs' type. Sq, Sk >= 1 and
// B * H * ceil(Sq / 64), B * Hkv * ceil(Sk / 64) < 2^31.
#define VX_FA_BWD_ENTRY(NAME, T, D)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,        \
                      const void* o, const void* dO, const void* lse,     \
                      void* delta, void* dq, void* dk, void* dv, int B,   \
                      int H, int Hkv, int Sq, int Sk,                     \
                      const long long* strides, int causal,               \
                      float sm_scale, void* stream) {                     \
    return launch<T, D>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H,     \
                        Hkv, Sq, Sk, strides, causal, sm_scale, stream);  \
  }

VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d32, float, 32)
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d64, float, 64)
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d112, float, 112)
VX_FA_BWD_ENTRY(flash_attention_bwd_f32_d128, float, 128)
#ifdef __CUDACC__
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d32, __nv_bfloat16, 32)
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d64, __nv_bfloat16, 64)
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d112, __nv_bfloat16, 112)
VX_FA_BWD_ENTRY(flash_attention_bwd_bf16_d128, __nv_bfloat16, 128)
#endif
