// Host stand-in for the bf16 types and conversions that the hand-written
// kernels and sm90.cuh use, for g++ builds of their bf16 code (with
// sm90.cuh beside it). A bf16 is the top 16 bits of a float32; float32 ->
// bf16 rounds to nearest, ties to even.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline unsigned short vx_host_bf16_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)(u >> 16 | 64);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (unsigned short)(u >> 16);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float((uint32_t)h.x << 16);
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  return __nv_bfloat16{vx_host_bf16_bits(f)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  return __float2bfloat16(f);
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16(lo), __float2bfloat16(hi)};
}
