// Attention forward with an online softmax: one CTA per (batch, head,
// 64-row query tile).
//
// Replaces repro/kernels/flash_attention/flash_attention.py:
// flash_attention (_fa_kernel): softmax(q k^T / sqrt(D), causal mask
// -1e30) v, with the running max m, sum l and accumulator in float32 and
// the output in q's type.
//
// Bound: operations. At S = 2048, D = 64 a query row does 2 * S * D
// multiply-adds against 4 * D bytes of its own q and o; the tensor cores
// would make it bound by bytes only at a few hundred FLOP per byte, and
// this kernel does not use them. The simple design: the query tile stays
// in shared memory, 32-key tiles of K and V are loaded into shared memory
// in turn, and four threads share a query row. Each thread computes 8
// scores of the row, the row's max and sum are reduced over the four
// threads by warp shuffles, the probabilities go through shared memory,
// and each thread keeps 1/4 of the row's output accumulator in
// registers. All arithmetic is float32 on the CUDA cores; wgmma, TMA and
// a pipeline of tiles are later changes.
//
// What differs from the TPU kernel, on purpose:
//   * A causal loop bound in place of @pl.when: key tiles past the last
//     query row of the tile are never loaded.
//   * Any Sq and Sk: rows past Sq are not stored, keys past Sk are masked
//     to -1e30 (as attention_chunked masks a short last chunk).
//   * K and V may have fewer heads than q (Hkv dividing H): head h reads
//     KV head h / (H / Hkv), so the 4x copy of _repeat_kv is not made.
//   * q, k and v are read through their strides (the last dimension must
//     be contiguous); the output is a contiguous (B, H, Sq, D).
//
// Head dims 32, 64 and 128. At D = 128 the four float32 tiles come to
// 74,368 bytes, over the 48 KB of static shared memory, so that
// instantiation takes the same tiles from dynamic shared memory
// (fa_kernel_dyn, after cudaFuncSetAttribute); D = 32 and 64 keep their
// static tiles (fa_kernel). Both run one body, fa_body.
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
        const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int Sq,
        int Sk, int n_qt, Strides qs, Strides ks, Strides vs, int causal,
        float sm_scale) {
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
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
          int Sq, int Sk, int n_qt, Strides qs, Strides ks, Strides vs,
          int causal, float sm_scale) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];
  fa_body<T, D>(Qs, Ks, Vs, Ps, q, k, v, o, H, Hkv, Sq, Sk, n_qt, qs, ks,
                vs, causal, sm_scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel_dyn(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Sk, int n_qt, Strides qs, Strides ks, Strides vs,
              int causal, float sm_scale) {
  VX_DYN_SMEM(smem);
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem);
  fa_body<T, D>(t.Q, t.K, t.V, t.P, q, k, v, o, H, Hkv, Sq, Sk, n_qt, qs,
                ks, vs, causal, sm_scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, long long qsb, long long qsh,
           long long qss, long long ksb, long long ksh, long long kss,
           long long vsb, long long vsh, long long vss, int causal,
           float sm_scale, void* stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  if constexpr (D <= kStaticD) {
    auto kernel = fa_kernel<T, D>;
    VX_LAUNCH(kernel, B * H * n_qt, kThreads, stream, (const T*)q,
              (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Sk, n_qt, qs, ks,
              vs, causal, sm_scale);
  } else {
    auto kernel = fa_kernel_dyn<T, D>;
    constexpr int smem = (int)sizeof(Tiles<D>);
    static const int attr = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != 0) return attr;
    VX_LAUNCH_SMEM(kernel, B * H * n_qt, kThreads, smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq,
                   Sk, n_qt, qs, ks, vs, causal, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, Sq, D), k and v: (B, Hkv, Sk, D), each read through its
// strides (in elements, last dimension contiguous); o: contiguous
// (B, H, Sq, D). B * H * ceil(Sq / 64) < 2^31, Sq, Sk >= 1.
#define VX_FA_ENTRY(NAME, T, D)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,        \
                      void* o, int B, int H, int Hkv, int Sq, int Sk,     \
                      long long qsb, long long qsh, long long qss,        \
                      long long ksb, long long ksh, long long kss,        \
                      long long vsb, long long vsh, long long vss,        \
                      int causal, float sm_scale, void* stream) {         \
    return launch<T, D>(q, k, v, o, B, H, Hkv, Sq, Sk, qsb, qsh, qss,     \
                        ksb, ksh, kss, vsb, vsh, vss, causal, sm_scale,   \
                        stream);                                          \
  }

VX_FA_ENTRY(flash_attention_f32_d32, float, 32)
VX_FA_ENTRY(flash_attention_f32_d64, float, 64)
VX_FA_ENTRY(flash_attention_f32_d128, float, 128)
#ifdef __CUDACC__
VX_FA_ENTRY(flash_attention_bf16_d32, __nv_bfloat16, 32)
VX_FA_ENTRY(flash_attention_bf16_d64, __nv_bfloat16, 64)
VX_FA_ENTRY(flash_attention_bf16_d128, __nv_bfloat16, 128)
#endif
