// Hopper (sm_90a) building blocks shared by the tensor-core routes of
// flash_attention.cu, flash_attention_bwd.cu and moe_dispatch.cu:
// shared-memory matrix descriptors, wgmma (warpgroup matrix
// multiply-accumulate, bf16 or fp16 in, float32 accumulators in
// registers), bf16 -> fp16 conversion (of a word, and of a tile in shared
// memory in place), and cp.async copies into tiles in the
// 128-byte-swizzled layout that wgmma reads (copy_rows).
//
// The tile layout. A 16-bit operand tile (bf16 or fp16) is kept as
// column blocks of 64 elements: a block holds R rows of 128 bytes, row r
// at r * 128, and the eight 16-byte chunks of a row are permuted as
// chunk ^ (r % 8), the 128-byte swizzle. The swizzle is a function of
// the address bits, so a block must start at a multiple of 1024 bytes.
// The same physical layout serves both majors:
//   * K-major (the reduction dimension contiguous: q, k, x, h): the
//     rows are the M or N index, the 64 elements of a row are K. A k16
//     step advances the start address by 32 bytes inside the row; the
//     eight-row groups are 1024 bytes apart (SBO).
//   * MN-major (the output dimension contiguous: v, wi, wo; the
//     transpose bit set): the rows are K, the 64 elements of a row are N.
//     A k16 step advances by 16 rows (2048 bytes); eight-row groups of K
//     are 1024 bytes apart (SBO), and 64-wide blocks of N are LBO apart.
//
// Accumulator fragment of wgmma m64nNk16 (float32), thread t of the
// warpgroup, warp w = t / 32, lane l: d[4j + 2i + c] holds row
// 16w + l / 4 + 8i, column 8j + 2(l % 4) + c. The A fragment that the
// register form (RS) reads, m64k16 of 16-bit pairs in four words, has the
// same rows: a[0] columns 2(l % 4) + {0, 1} of row 16w + l / 4, a[1] the
// same of row + 8, a[2] and a[3] the same eight columns on. So the
// accumulator of one product, rounded pairwise to bf16 or fp16, is the A
// operand of the next with no data movement.
//
// Everything sits under __CUDACC__: the float32 kernels of the files that
// include this header also compile with g++ for the host tests.
#pragma once
#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

// ---- layout and conversions -------------------------------------------

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled block
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as an fp16 pair, the first in the low half, rounded to
// nearest: 11 significant bits; |x| >= 65520 becomes inf, |x| < 6.1e-5
// keeps fewer bits (subnormal). The callers keep their operands in range
// by a power-of-two exponent (f16_exponent), which is exact.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^k as a float, exactly, for -126 <= k <= 127
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// The exponent e >= 0 that takes a set of values whose largest magnitude
// is m (a float, NaN ignored by the fmaxf that found it) into fp16's
// range: every x * 2^-e rounds to a finite fp16. 0 where m < 65520, as
// every such value already rounds finite, so a set in range is stored as
// it was; else floor(log2 m) - 14, which leaves m * 2^-e < 2^15. At most
// 114 (m inf).
__device__ __forceinline__ int f16_exponent(float m) {
  return m < 65520.f ? 0 : ((__float_as_int(m) >> 23) & 0xff) - 141;
}

// the larger magnitude of the bf16 pair in a word, as a float
__device__ __forceinline__ float bf16x2_absmax(uint32_t w) {
  return fmaxf(__uint_as_float((w << 16) & 0x7fff0000u),
               __uint_as_float(w & 0x7fff0000u));
}

// a bf16 pair as an fp16 pair times 2^-e (the float products are exact)
__device__ __forceinline__ uint32_t bf16x2_to_f16x2_scaled(uint32_t w,
                                                           float scale) {
  return pack_f16(__uint_as_float(w << 16) * scale,
                  __uint_as_float(w & 0xffff0000u) * scale);
}

// a bf16 pair (one word, the first in the low half) as an fp16 pair:
// bf16 -> float is exact (a bf16 is the top half of its float), float ->
// fp16 as pack_f16
__device__ __forceinline__ uint32_t bf16x2_to_f16x2(uint32_t w) {
  return pack_f16(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// nonzero where a bf16 of the pair in w has a magnitude of 65536 or more
// (inf and NaN included), which fp16 cannot hold: |b| >= 0x4780 sets bit
// 15 of |b| + 0x3880, and no carry crosses into the other half
__device__ __forceinline__ uint32_t bf16x2_past_f16(uint32_t w) {
  return ((w & 0x7fff7fffu) + 0x38803880u) & 0x80008000u;
}

// ---- the hardware: shared addresses, wgmma, cp.async (inline PTX) -----
// The host tests build the kernels against tests/cuda_host/sm90/sm90.cuh,
// which defines SM90_HOST_EMULATION and emulates these in its place.
#ifndef SM90_HOST_EMULATION

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 2^x by the special function unit, denormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma ordering ----------------------------------------------------

// before a wgmma reads registers or shared memory written by other
// instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across a wait or a wgmma (the asm names every register)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- wgmma m64nNk16, bf16 or fp16 inputs, float32 accumulators --------

// the operand type of a product: both operands bf16, or both fp16 (wgmma
// does not mix them)
struct BF16;
struct F16;

#define SM90_D4(j) \
  "+f"(d[4 * (j)]), "+f"(d[4 * (j) + 1]), "+f"(d[4 * (j) + 2]), \
      "+f"(d[4 * (j) + 3])
#define SM90_D32                                                     \
  SM90_D4(0), SM90_D4(1), SM90_D4(2), SM90_D4(3), SM90_D4(4),        \
      SM90_D4(5), SM90_D4(6), SM90_D4(7)
#define SM90_D64                                                     \
  SM90_D32, SM90_D4(8), SM90_D4(9), SM90_D4(10), SM90_D4(11),        \
      SM90_D4(12), SM90_D4(13), SM90_D4(14), SM90_D4(15)
#define SM90_R32                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "     \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31"
#define SM90_R64                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "     \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "     \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "     \
  "%62, %63"

// Mma<N, TB, T, TA>: D (+)= A B over one k16 step, operands of type T.
//   ss: A and B in shared memory; A K-major (TA = 0) or MN-major (TA = 1,
//       wgmma's transpose bit for A); B K-major (TB = 0) or MN-major
//       (TB = 1); accumulate unless scale_d is 0.
//   rs: A from registers, four words of pairs (the fragment above; TA
//       unused).
template <int N, int TB, typename T = BF16, int TA = 0> struct Mma;

// one specialization: N, the type tag and its PTX name, the accumulator
// operands, and the operand numbers of the scale predicate and the rest
// in the SS and RS forms
#define SM90_MMA(NN, T, TS, REGS, DOUT, SS_P, SS_REST, RS_P, RS_REST)     \
  template <int TB, int TA> struct Mma<NN, TB, T, TA> {                   \
    __device__ __forceinline__ static void ss(float (&d)[NN / 2],         \
                                              uint64_t a, uint64_t b,     \
                                              int scale_d) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"      \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TS  \
                   "." TS " {" REGS "}, " SS_REST ";\n}\n"                \
                   : DOUT                                                 \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));     \
    }                                                                     \
    __device__ __forceinline__ static void rs(float (&d)[NN / 2],         \
                                              const uint32_t (&a)[4],     \
                                              uint64_t b, int scale_d) {  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"      \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TS  \
                   "." TS " {" REGS "}, " RS_REST ";\n}\n"                \
                   : DOUT                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),  \
                     "r"(scale_d), "n"(TB));                              \
    }                                                                     \
  };

#define SM90_MMA_64(T, TS)                                                \
  SM90_MMA(64, T, TS, SM90_R32, SM90_D32, "%34",                          \
           "%32, %33, p, 1, 1, %35, %36", "%37",                          \
           "{%32, %33, %34, %35}, %36, p, 1, 1, %38")
#define SM90_MMA_128(T, TS)                                               \
  SM90_MMA(128, T, TS, SM90_R64, SM90_D64, "%66",                         \
           "%64, %65, p, 1, 1, %67, %68", "%69",                          \
           "{%64, %65, %66, %67}, %68, p, 1, 1, %70")

SM90_MMA_64(BF16, "bf16")
SM90_MMA_128(BF16, "bf16")
SM90_MMA_64(F16, "f16")
SM90_MMA_128(F16, "f16")

#undef SM90_MMA_64
#undef SM90_MMA_128
#undef SM90_MMA
#undef SM90_D4
#undef SM90_D32
#undef SM90_D64
#undef SM90_R32
#undef SM90_R64

// each half of mx raised to the larger magnitude of its half and w's
// (bf16 pairs; the sign bits are their xor): one instruction
__device__ __forceinline__ uint32_t absmax_bf16x2(uint32_t mx, uint32_t w) {
  uint32_t d;
  asm("max.xorsign.abs.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(mx), "r"(w));
  return d;
}

// the 16-byte chunk at shared address a, eight bf16, rewritten in place as
// eight fp16. A tile that an fp16 product reads goes through this after
// its copy lands: the layout is unchanged, only the element type. The
// thread that copied the chunk converts it, so no barrier sits between
// the two. Raises each half of mx to the chunk's largest magnitude there
// (absmax_bf16x2; bf16x2_past_f16 of it tells an element that became
// inf).
__device__ __forceinline__ void bf16_to_f16(uint32_t a, uint32_t& mx) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(a)
               : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx = absmax_bf16x2(mx, w[i]);
    w[i] = bf16x2_to_f16x2(w[i]);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// the 16-byte chunk at shared address a, eight fp16, times 2^k in place
// (k <= 0: fp16 keeps the products exactly down to its subnormals)
__device__ __forceinline__ void f16_scale(uint32_t a, int k) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(a)
               : "memory");
  const float s = pow2(k);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(*reinterpret_cast<__half2*>(&w[i]));
    w[i] = pack_f16(v.x * s, v.y * s);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 16 bytes to shared address a
__device__ __forceinline__ void st_shared16(uint32_t a,
                                            const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// ---- cp.async: 16-byte copies into shared memory -----------------------

// copies 16 bytes, or writes 16 zero bytes where ``full`` is false (src
// is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// copies 4 bytes (src on 4 bytes), or writes 4 zero bytes where ``full``
// is false (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
// orders this thread's shared-memory writes (cp.async included) before
// reads by the async proxy, which is how wgmma reads its operands
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#endif  // SM90_HOST_EMULATION

// ---- tiles ------------------------------------------------------------

// the first 1024-byte boundary at or past p, as a shared address
__device__ __forceinline__ uint32_t align1024(const void* p) {
  return (smem_addr(p) + 1023u) & ~1023u;
}

// R rows of D 16-bit elements (bf16 or fp16) from src (ld elements
// apart) into a tile at dst: ceil(D / 64) column blocks of 64, R * 128
// bytes each, in the swizzled layout. The THREADS threads of the CTA
// share the 16-byte chunks; rows from ``valid`` on, and the chunks of a
// block past D, are zero-filled and not read.
template <int R, int D, int THREADS, typename T>
__device__ __forceinline__ void copy_rows(uint32_t dst, const T* src,
                                          long long ld, int valid,
                                          int tid) {
  constexpr int CPR = D / 8;                   // 16-byte chunks a row
  constexpr int SLOTS = (D + 63) / 64 * 8;     // chunks a tile row holds
  static_assert(R * SLOTS % THREADS == 0, "whole passes of the CTA");
#pragma unroll
  for (int i = 0; i < R * SLOTS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / SLOTS, ch = c % SLOTS;
    const bool in = r < valid && ch < CPR;
    cp_async16(dst + (ch >> 3) * (R * 128) + swz(r, ch & 7),
               src + (in ? r * ld + ch * 8 : 0), in);
  }
}

}  // namespace sm90
#endif  // __CUDACC__
