// Host stand-in for the hardware half of
// src/repro_torch/kernels/csrc/sm90.cuh, so that the tensor-core routes
// of the hand-written kernels compile with g++ (-D__CUDACC__, this
// directory ahead of the real header's on the include path) and run on
// the CPU under the stand-in runtime (../cuda_runtime.h). It defines
// SM90_HOST_EMULATION and the real header's inline-PTX helpers, then
// includes the real header for the rest (the swizzle, the descriptors,
// the bf16 and fp16 packing, copy_rows). What each helper does here:
//   * shared memory is the stand-in's dynamic buffer, a shared address
//     the byte offset into it; cp.async copies at once (or writes zeros);
//     commits, waits and fences do nothing (the kernels' barriers order
//     the copies);
//   * wgmma reads its operands through the descriptor as the hardware
//     does: 128-byte swizzle (chunk bits 4-6 of an address XOR its row
//     bits 7-9), K-major rows SBO apart in groups of eight, MN-major rows
//     of K SBO apart in groups of eight and 64-wide blocks of M or N LBO
//     apart (A MN-major with the transpose bit, TA = 1); each thread
//     computes its accumulator fragment (the layout in
//     the real header's note) in float32. The register form's A fragments
//     meet in a 64 x 16 tile between two block barriers: the block must
//     be one warpgroup of 128 threads, every thread calling it together,
//     as wgmma's .sync.aligned requires;
//   * 2^x is exp2 (no flush of denormals);
//   * the shared-memory rewrites of fp16 and bf16 chunks (bf16_to_f16,
//     f16_scale, st_shared16) are plain copies through the buffer.
// It checks the kernels' tiles, fragments, masks and order of work, not
// their speed, and not the real header's PTX.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "cuda_bf16.h"
#include "cuda_fp16.h"
#include "cuda_runtime.h"

#define SM90_HOST_EMULATION

namespace sm90 {

struct BF16;
struct F16;

namespace host {
inline unsigned char* smem(uint32_t a) {
  return reinterpret_cast<unsigned char*>(vx_host::dyn_smem.data()) + a;
}
// the 16-bit element at shared address a (before the swizzle) as float
template <typename T>
inline float elem(uint32_t a) {
  uint16_t b;
  std::memcpy(&b, smem(a ^ (((a >> 7) & 7) << 4)), 2);
  if constexpr (std::is_same_v<T, F16>) return vx_host_f16_value(b);
  return __uint_as_float((uint32_t)b << 16);
}
// a descriptor's start address, leading and stride byte offsets
inline uint32_t start(uint64_t d) { return (uint32_t)(d & 0x3FFF) << 4; }
inline uint32_t lbo(uint64_t d) {
  return (uint32_t)((d >> 16) & 0x3FFF) << 4;
}
inline uint32_t sbo(uint64_t d) {
  return (uint32_t)((d >> 32) & 0x3FFF) << 4;
}
// element (m, k) of a K-major A; (k, n) of B, K-major (tb 0) or MN-major
// (an MN-major A's (m, k) is b_elem's (k, m) with tb 1)
template <typename T>
inline float a_elem(uint64_t d, int m, int k) {
  return elem<T>(start(d) + (m / 8) * sbo(d) + (m % 8) * 128 + k * 2);
}
template <typename T>
inline float b_elem(uint64_t d, int tb, int k, int n) {
  if (tb == 0)
    return elem<T>(start(d) + (n / 8) * sbo(d) + (n % 8) * 128 + k * 2);
  return elem<T>(start(d) + (n / 64) * lbo(d) + (k / 8) * sbo(d) +
                 (k % 8) * 128 + (n % 64) * 2);
}
// a word of two 16-bit values (the first in the low half) as floats
template <typename T>
inline void unpack(uint32_t w, float* f) {
  if constexpr (std::is_same_v<T, F16>) {
    f[0] = vx_host_f16_value((uint16_t)(w & 0xffff));
    f[1] = vx_host_f16_value((uint16_t)(w >> 16));
  } else {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
}
// the A operand of the register form, gathered from the warpgroup
inline float a_tile[64][16];
}  // namespace host

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)(reinterpret_cast<const unsigned char*>(p) -
                    host::smem(0));
}

inline float ex2(float x) { return std::exp2(x); }

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int N>
inline void fence_regs(float (&)[N]) {}

template <int N, int TB, typename T = BF16, int TA = 0>
struct Mma {
  // this thread's accumulator fragment of D (+)= A B over one k16 step
  template <typename A>
  static void product(float (&d)[N / 2], A a, uint64_t b, int scale_d) {
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    for (int e = 0; e < N / 2; ++e) {
      const int row = 16 * w + l / 4 + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + 2 * (l % 4) + (e & 1);
      float acc = 0.f;
      for (int k = 0; k < 16; ++k)
        acc += a(row, k) * host::b_elem<T>(b, TB, k, col);
      d[e] = (scale_d ? d[e] : 0.f) + acc;
    }
  }
  static void ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
    // an MN-major A (TA = 1) is laid out as an MN-major B
    product(d, [a](int m, int k) {
      return TA ? host::b_elem<T>(a, 1, k, m) : host::a_elem<T>(a, m, k);
    }, b, scale_d);
  }
  static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                 int scale_d) {
    const int t = threadIdx.x % 128, l = t % 32;
    const int r = 16 * (t / 32) + l / 4, c = 2 * (l % 4);
    host::unpack<T>(a[0], &host::a_tile[r][c]);
    host::unpack<T>(a[1], &host::a_tile[r + 8][c]);
    host::unpack<T>(a[2], &host::a_tile[r][c + 8]);
    host::unpack<T>(a[3], &host::a_tile[r + 8][c + 8]);
    __syncthreads();
    product(d, [](int m, int k) { return host::a_tile[m][k]; }, b, scale_d);
    __syncthreads();   // the tile is free for the next call
  }
};

inline void cp_async16(uint32_t dst, const void* src, bool full) {
  if (full)
    std::memcpy(host::smem(dst), src, 16);
  else
    std::memset(host::smem(dst), 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool full) {
  if (full)
    std::memcpy(host::smem(dst), src, 4);
  else
    std::memset(host::smem(dst), 0, 4);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void fence_async_smem() {}

}  // namespace sm90

#include "../../../src/repro_torch/kernels/csrc/sm90.cuh"

namespace sm90 {
// max.xorsign.abs.bf16x2: each half the larger magnitude (a NaN loses),
// its sign the xor of the two
inline uint32_t absmax_bf16x2(uint32_t mx, uint32_t w) {
  uint32_t d = 0;
  for (int s = 0; s < 32; s += 16) {
    const uint32_t a = (mx >> s) & 0xffffu, b = (w >> s) & 0xffffu;
    const float fa = std::fabs(__uint_as_float(a << 16));
    const float fb = std::fabs(__uint_as_float(b << 16));
    const uint32_t m = (fb > fa || fa != fa) ? (b & 0x7fffu) : (a & 0x7fffu);
    d |= (m | ((a ^ b) & 0x8000u)) << s;
  }
  return d;
}
// after the real header: these convert with its bf16x2_to_f16x2, pow2
// and pack_f16
inline void bf16_to_f16(uint32_t a, uint32_t& mx) {
  uint32_t w[4];
  std::memcpy(w, host::smem(a), 16);
  for (int i = 0; i < 4; ++i) {
    mx = absmax_bf16x2(mx, w[i]);
    w[i] = bf16x2_to_f16x2(w[i]);
  }
  std::memcpy(host::smem(a), w, 16);
}
inline void f16_scale(uint32_t a, int k) {
  uint32_t w[4];
  std::memcpy(w, host::smem(a), 16);
  const float s = pow2(k);
  for (int i = 0; i < 4; ++i) {
    float v[2];
    host::unpack<F16>(w[i], v);
    w[i] = pack_f16(v[0] * s, v[1] * s);
  }
  std::memcpy(host::smem(a), w, 16);
}
inline void st_shared16(uint32_t a, const uint32_t (&w)[4]) {
  std::memcpy(host::smem(a), w, 16);
}
}  // namespace sm90
