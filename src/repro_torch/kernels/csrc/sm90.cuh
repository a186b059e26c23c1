// Hopper (sm_90a) building blocks shared by the tensor-core routes of
// flash_attention.cu and moe_dispatch.cu: shared-memory matrix
// descriptors, wgmma (warpgroup matrix multiply-accumulate, bf16 in,
// float32 accumulators in registers) and cp.async copies into tiles in
// the 128-byte-swizzled layout that wgmma reads.
//
// The tile layout. A bf16 operand tile is kept as column blocks of 64
// elements: a block holds R rows of 128 bytes, row r at r * 128, and the
// eight 16-byte chunks of a row are permuted as chunk ^ (r % 8), the
// 128-byte swizzle. The swizzle is a function of the address bits, so a
// block must start at a multiple of 1024 bytes. The same physical layout
// serves both majors:
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
// register form (RS) reads, m64k16 bf16 in four 32-bit words, has the
// same rows: a[0] columns 2(l % 4) + {0, 1} of row 16w + l / 4, a[1] the
// same of row + 8, a[2] and a[3] the same eight columns on. So the
// accumulator of one product, rounded pairwise to bf16, is the A operand
// of the next with no data movement.
//
// Everything sits under __CUDACC__: the float32 kernels of the files that
// include this header also compile with g++ for the host tests.
#pragma once
#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// ---- wgmma m64nNk16, bf16 inputs, float32 accumulators -----------------

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

// D (+)= A B with A and B in shared memory (SS); A K-major; B K-major
// (TB = 0) or MN-major (TB = 1); accumulate unless scale_d is 0
template <int N, int TB> struct Mma;

template <int TB> struct Mma<64, TB> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_D32
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  // A from registers (RS): four words of bf16 pairs, the fragment above
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(TB));
  }
};

template <int TB> struct Mma<128, TB> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_D64
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(TB));
  }
};

#undef SM90_D4
#undef SM90_D32
#undef SM90_D64
#undef SM90_R32
#undef SM90_R64

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as bf16 pairs hi + lo: hi the floats rounded, lo what hi
// misses, rounded; hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
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
// orders this thread's shared-memory writes (cp.async included) before
// reads by the async proxy, which is how wgmma reads its operands
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the first 1024-byte boundary at or past p, as a shared address
__device__ __forceinline__ uint32_t align1024(const void* p) {
  return (smem_addr(p) + 1023u) & ~1023u;
}

}  // namespace sm90
#endif  // __CUDACC__
