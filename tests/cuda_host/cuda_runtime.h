// Host stand-in for the parts of the CUDA runtime that the simt_exec
// kernels use, so that their emitted source compiles with g++ and runs on
// the CPU: one std::thread per CUDA thread of a block, the blocks of a
// grid in turn on the same threads, std::barrier for __syncthreads and
// the block-wide votes. The warp-level calls (__syncwarp,
// __shfl_*_sync, __any_sync, __all_sync, __ballot_sync) are scoped to the
// warp, as on the card: one std::barrier for each 32 threads of the
// block, so the warps of a block may reach them a different number of
// times, and a warp may return early. Every thread of a warp must reach
// them, as the kernels' code does. The float32
// instantiations of the hand-written kernels (rmsnorm, flash_attention,
// moe_dispatch, selective_scan) run on it too. Dynamic shared memory is
// one buffer, sized by the launch and shared by the threads of the block
// that runs. It checks the code's semantics, not its speed.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim, blockDim;

namespace vx_host {
inline std::barrier<>* bar = nullptr;
inline std::vector<std::barrier<>*> warp_bars;
inline int acc_or = 0, acc_and = 1;
inline unsigned warp_acc[32];
inline unsigned xchg[1024];
inline std::vector<float4> dyn_smem;
inline int last_grid = 0, last_block = 0;
// the SMs the device reports: an H100's 132 unless a test sets it
inline int sm_count = 132;

inline std::barrier<>& warp_bar() { return *warp_bars[threadIdx.x / 32]; }

// every thread of the warp writes its 32 bits, then reads lane src's
inline unsigned warp_exchange(unsigned bits, int src) {
  warp_bar().arrive_and_wait();
  xchg[threadIdx.x] = bits;
  warp_bar().arrive_and_wait();
  return xchg[(threadIdx.x & ~31u) | ((unsigned)src & 31u)];
}

// OP over the warp's p: 0 any, 1 all, 2 ballot
inline unsigned warp_reduce(int p, int op) {
  unsigned& acc = warp_acc[threadIdx.x / 32];
  warp_bar().arrive_and_wait();
  if (threadIdx.x % 32 == 0) acc = op == 1 ? 1u : 0u;
  warp_bar().arrive_and_wait();
  if (op == 0 && p) __atomic_store_n(&acc, 1u, __ATOMIC_SEQ_CST);
  if (op == 1 && !p) __atomic_store_n(&acc, 0u, __ATOMIC_SEQ_CST);
  if (op == 2 && p)
    __atomic_fetch_or(&acc, 1u << (threadIdx.x % 32), __ATOMIC_SEQ_CST);
  warp_bar().arrive_and_wait();
  unsigned r = acc;
  warp_bar().arrive_and_wait();
  return r;
}
}  // namespace vx_host

inline void __syncthreads() { vx_host::bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  vx_host::warp_bar().arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask, int = 32) {
  unsigned b;
  std::memcpy(&b, &v, 4);
  b = vx_host::warp_exchange(b, (threadIdx.x % 32) ^ lane_mask);
  std::memcpy(&v, &b, 4);
  return v;
}
inline int __shfl_sync(unsigned, int v, int src, int = 32) {
  return (int)vx_host::warp_exchange((unsigned)v, src);
}
inline float __shfl_sync(unsigned, float v, int src, int = 32) {
  unsigned b;
  std::memcpy(&b, &v, 4);
  b = vx_host::warp_exchange(b, src);
  std::memcpy(&v, &b, 4);
  return v;
}
inline int __any_sync(unsigned, int p) {
  return (int)vx_host::warp_reduce(p, 0);
}
inline int __all_sync(unsigned, int p) {
  return (int)vx_host::warp_reduce(p, 1);
}
inline unsigned __ballot_sync(unsigned mask, int p) {
  return vx_host::warp_reduce(p, 2) & mask;
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

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
inline float __int2float_rn(int x) { return (float)x; }
inline float __fmul_rn(float a, float b) { return a * b; }
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
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t = 0) {
  std::memset(p, v, n);
  return 0;
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
// the blocks run one after another, each thread's stores seen by all
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
template <typename T>
inline T __ldcg(const T* p) { return *p; }
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = vx_host::sm_count;
  return 0;
}
template <typename F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// the blocks a multiprocessor holds: vx_host_set_sm_count's companion,
// fixed at 2 here (the host runs one block at a time)
template <typename F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                         size_t) {
  *n = 2;
  return 0;
}

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
  vx_host::last_grid = grid;
  vx_host::last_block = block;
  gridDim.x = grid;
  blockDim.x = block;
  blockIdx.x = 0;
  if (grid < 1) return;
  std::barrier<> bar(block);
  vx_host::bar = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  vx_host::warp_bars.clear();
  for (int w = 0; w * 32 < block; ++w) {
    warps.push_back(std::make_unique<std::barrier<>>(
        std::min(32, block - w * 32)));
    vx_host::warp_bars.push_back(warps.back().get());
  }
  // one thread per CUDA thread of a block, kept for every block of the
  // grid: the blocks run in turn, the next one's index set once all of
  // this one's threads have returned from the kernel
  auto next = []() noexcept { ++blockIdx.x; };
  std::barrier<decltype(next)> done(block, next);
  std::vector<std::thread> ts;
  for (int t = 0; t < block; ++t)
    ts.emplace_back([t, grid, &body, &done] {
      threadIdx.x = t;
      for (int b = 0; b < grid; ++b) {
        body();
        done.arrive_and_wait();
      }
    });
  for (auto& th : ts) th.join();
}

// the geometry of the last launch: which 0 gives its grid, 1 its block
extern "C" int vx_host_last_launch(int which) {
  return which == 0 ? vx_host::last_grid : vx_host::last_block;
}
// the SM count that cudaDeviceGetAttribute reports from now on
extern "C" void vx_host_set_sm_count(int n) { vx_host::sm_count = n; }
