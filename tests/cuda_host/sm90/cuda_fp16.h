// Host stand-in for the fp16 types and conversions that the hand-written
// kernels and sm90.cuh use; values go through the compiler's _Float16
// (round to nearest, ties to even).
#pragma once
#include <cstdint>
#include <cstring>

struct __half {
  unsigned short x;
};
struct __half2 {
  __half x, y;
};

inline unsigned short vx_host_f16_bits(float f) {
  const _Float16 h = (_Float16)f;
  unsigned short b;
  std::memcpy(&b, &h, 2);
  return b;
}
inline float vx_host_f16_value(unsigned short b) {
  _Float16 h;
  std::memcpy(&h, &b, 2);
  return (float)h;
}
inline __half2 __floats2half2_rn(float lo, float hi) {
  return {__half{vx_host_f16_bits(lo)}, __half{vx_host_f16_bits(hi)}};
}
