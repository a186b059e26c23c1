// Host stand-in for the parts of the CUDA runtime that the simt_exec
// kernels use, so that their emitted source compiles with g++ and runs on
// the CPU: one std::thread per CUDA thread, the blocks of a grid in turn,
// std::barrier for __syncthreads and the block-wide votes. It checks the
// generated code's semantics, not its speed.
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
#define __launch_bounds__(n)
#define __shared__ static

struct dim3 { unsigned x = 0, y = 0, z = 0; };
typedef void* cudaStream_t;

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim, blockDim;

namespace vx_host {
inline std::barrier<>* bar = nullptr;
inline int acc_or = 0, acc_and = 1;
inline unsigned acc_ballot = 0;
}  // namespace vx_host

inline void __syncthreads() { vx_host::bar->arrive_and_wait(); }

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
using std::max;
using std::min;

inline int cudaGetLastError() { return 0; }

// kernel<<<grid, block, 0, stream>>>(args) is rewritten to this call
inline void vx_host_launch(int grid, int block, std::function<void()> body) {
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
