// Host stand-in for the parts of the CUDA runtime that the simt_exec
// kernels use, so that their emitted source compiles with g++ and runs on
// the CPU: one std::thread per CUDA thread, the blocks of a grid in turn,
// std::barrier for __syncthreads and the block-wide votes. The float32
// instantiations of the hand-written kernels (rmsnorm, flash_attention,
// moe_dispatch) run on it too: warp shuffles and __syncwarp are
// block-wide exchanges, so every thread of the block must reach them, as
// those kernels do. Dynamic shared memory is one buffer, sized by the
// launch and shared by the threads of the block that runs. It checks the
// code's semantics, not its speed.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim, blockDim;

namespace vx_host {
inline std::barrier<>* bar = nullptr;
inline int acc_or = 0, acc_and = 1;
inline unsigned acc_ballot = 0;
inline float xchg[1024];
inline std::vector<float4> dyn_smem;
}  // namespace vx_host

inline void __syncthreads() { vx_host::bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  vx_host::bar->arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask,
                             int = 32) {
  vx_host::bar->arrive_and_wait();
  vx_host::xchg[threadIdx.x] = v;
  vx_host::bar->arrive_and_wait();
  return vx_host::xchg[threadIdx.x ^ lane_mask];
}

inline int __syncthreads_or(int p) {
  vx_host::bar->arrive_and_wait();
  if (threadIdx.x == 0) vx_host::acc_or = 0;
  vx_host::bar->arrive_and_wait();
  if (p) __atomic_store_n(&vx_host::acc_or, 1, __ATOMIC_SEQ_CST);
  vx_host::bar->arrive_and_wait();
  int r = vx_host::acc_or;
  vx_host::bar->arrive_and_wait();
  return r;
}

inline int __syncthreads_and(int p) {
  vx_host::bar->arrive_and_wait();
  if (threadIdx.x == 0) vx_host::acc_and = 1;
  vx_host::bar->arrive_and_wait();
  if (!p) __atomic_store_n(&vx_host::acc_and, 0, __ATOMIC_SEQ_CST);
  vx_host::bar->arrive_and_wait();
  int r = vx_host::acc_and;
  vx_host::bar->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned mask, int p) {
  vx_host::bar->arrive_and_wait();
  if (threadIdx.x == 0) vx_host::acc_ballot = 0;
  vx_host::bar->arrive_and_wait();
  if (p) __atomic_fetch_or(&vx_host::acc_ballot, 1u << (threadIdx.x % 32),
                           __ATOMIC_SEQ_CST);
  vx_host::bar->arrive_and_wait();
  unsigned r = vx_host::acc_ballot & mask;
  vx_host::bar->arrive_and_wait();
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
inline float __int2float_rn(int x) { return (float)x; }
inline int __float2int_rz(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f < -2147483648.0f) return (-2147483647 - 1);
  return (int)f;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::max;
using std::min;

inline int cudaGetLastError() { return 0; }
template <typename F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

// kernel<<<grid, block, 0, stream>>>(args) is rewritten to this call; the
// hand-written kernels launch through VX_LAUNCH, which comes to the same
#define VX_LAUNCH(K, G, B, S, ...) \
  vx_host_launch((G), (B), [&] { K(__VA_ARGS__); })
// with M bytes of dynamic shared memory, which VX_DYN_SMEM names
#define VX_LAUNCH_SMEM(K, G, B, M, S, ...) \
  vx_host_launch((G), (B), [&] { K(__VA_ARGS__); }, (M))
#define VX_DYN_SMEM(name) \
  unsigned char* name = reinterpret_cast<unsigned char*>( \
      vx_host::dyn_smem.data())

inline void vx_host_launch(int grid, int block, std::function<void()> body,
                           size_t smem_bytes = 0) {
  vx_host::dyn_smem.assign((smem_bytes + 15) / 16, float4{});
  gridDim.x = grid;
  blockDim.x = block;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(block);
    vx_host::bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([t, &body] { threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
}
