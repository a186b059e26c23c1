// Element access for the rmsnorm kernels (rmsnorm.cu, rmsnorm_bwd.cu):
// one element widened to float32 and stored back in its type, and 16
// bytes (4 float32 or 8 bf16) unpacked to float32 and packed back, the
// type picked by a tag pointer of the element type. The float32 helpers
// also compile with g++ against the stand-in runtime in tests/cuda_host.
#pragma once
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
// 16 bytes as 4 float32, and back
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const float*) {
  f[0] = __int_as_float((int)r.x);
  f[1] = __int_as_float((int)r.y);
  f[2] = __int_as_float((int)r.z);
  f[3] = __int_as_float((int)r.w);
}
__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  uint4 r;
  r.x = (unsigned)__float_as_int(f[0]);
  r.y = (unsigned)__float_as_int(f[1]);
  r.z = (unsigned)__float_as_int(f[2]);
  r.w = (unsigned)__float_as_int(f[3]);
  return r;
}
#ifdef __CUDACC__
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// a 32-bit word as its two bf16 (the first in the low half) widened to
// float32, exactly, and two float32 rounded to nearest into one word
__device__ __forceinline__ void unpack2(unsigned w, float* f) {
  f[0] = __int_as_float((int)(w << 16));
  f[1] = __int_as_float((int)(w & 0xffff0000u));
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
// 16 bytes as 8 bf16 widened to float32, and back
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const __nv_bfloat16*) {
  unpack2(r.x, f);
  unpack2(r.y, f + 2);
  unpack2(r.z, f + 4);
  unpack2(r.w, f + 6);
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint4 r;
  r.x = pack2(f[0], f[1]);
  r.y = pack2(f[2], f[3]);
  r.z = pack2(f[4], f[5]);
  r.w = pack2(f[6], f[7]);
  return r;
}
#endif

}  // namespace
