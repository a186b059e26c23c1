// The grouped GEMM machinery of the expert FF's tensor-core routes, shared
// by the forward (moe_dispatch.cu: moe_up_tc, moe_down_tc) and the
// backward (moe_dispatch_bwd.cu: moe_dh_tc, moe_dx_tc, moe_dw_tc): the
// tile copies, the ring of stages and its wgmma loop (mainloop), and the
// forward's fp16 exponents of wo's columns. Everything sits under
// __CUDACC__; the host tests build it with g++ against
// tests/cuda_host/sm90, which emulates sm90.cuh's hardware half.
//
// A CTA computes a 128-row tile (two warpgroups of 64 rows) of NB
// 128-column accumulators, over K in steps of 64, both operands bf16 or
// fp16 in shared memory in the 128-byte-swizzled layout of sm90.cuh. Each
// operand comes in either major:
//   * A K-major (x, dy, dgu: the reduction dimension contiguous): a tile
//     of 128 rows of 64 k, the rows zero-filled from ``rows`` on;
//   * A MN-major (the weight gradients' x^T and h^T: the rows of a
//     capacity block are K, the output rows contiguous): 64 k rows of 128
//     columns as two 64-column blocks, one a warpgroup, read with wgmma's
//     transpose bit; k rows from K on zero-filled, which is how the weight
//     gradients sum over an expert's filled rows only;
//   * B MN-major (wi, wo, dgu, dy: the output columns contiguous): 64 k
//     rows of 128 columns, transpose bit set, as the forward reads them;
//   * B K-major (wo and wi read as wo^T and wi^T by the backward: an
//     output column's k contiguous): 128 rows of 64 k, as A's tile.
#pragma once
#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using u16 = uint16_t;            // a 16-bit element, bf16 or fp16: the
                                 // copies move bytes
constexpr int TC_BM = 128;       // capacity rows a CTA: two warpgroups
constexpr int TC_BN = 128;       // output columns a CTA
constexpr int TC_BK = 64;        // k a stage: one 128-byte row
constexpr int TC_THREADS = 256;
constexpr int A_BYTES = TC_BM * TC_BK * 2;   // 16 KB
constexpr int B_BYTES = TC_BK * TC_BN * 2;   // 16 KB
constexpr int B_BLOCK = TC_BK * 128;         // its 64-column blocks: 8 KB
constexpr int B_CHUNKS = TC_BK * (TC_BN / 8) / TC_THREADS;  // a thread's
constexpr int DOWN_COLS = 2 * TC_BN;   // output columns a down CTA

// the A tile: rows < ``rows`` and k < ``kn`` of src (ld elements a row),
// K-major
__device__ __forceinline__ void copy_a(uint32_t dst, const u16* src,
                                       long long ld, int rows, int kn,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < TC_BM * 8 / TC_THREADS; ++i) {
    const int c = tid + i * TC_THREADS;
    const int r = c >> 3, ch = c & 7;
    const bool in = r < rows && ch * 8 < kn;
    sm90::cp_async16(dst + sm90::swz(r, ch),
                     src + (in ? r * ld + ch * 8 : 0), in);
  }
}

// the shared offset of chunk i of this thread in a B tile: k row r,
// 16-byte chunk ch of the tile's 128 columns
__device__ __forceinline__ uint32_t b_slot(int i, int tid, int& r,
                                           int& ch) {
  const int c = tid + i * TC_THREADS;
  r = c >> 4;
  ch = c & 15;
  return (ch >> 3) * B_BLOCK + sm90::swz(r, ch & 7);
}

// a B tile: k rows < ``kn`` and columns < ``cols`` of src, MN-major, as
// two blocks of 64 columns
__device__ __forceinline__ void copy_b(uint32_t dst, const u16* src,
                                       long long ld, int kn, int cols,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    int r, ch;
    const uint32_t off = b_slot(i, tid, r, ch);
    const bool in = r < kn && ch * 8 < cols;
    sm90::cp_async16(dst + off, src + (in ? r * ld + ch * 8 : 0), in);
  }
}

// the chunks of a B tile that copy_b gave this thread, bf16 to fp16 in
// place, once they have landed; mx's halves raised to their largest
// magnitudes
__device__ __forceinline__ void b_to_f16(uint32_t dst, int tid,
                                         uint32_t& mx) {
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    int r, ch;
    sm90::bf16_to_f16(dst + b_slot(i, tid, r, ch), mx);
  }
}

// What moe_down_tc's mainloop needs to keep h and wo in fp16's range (the
// note at the top): the hidden's exponents and, in shared memory, the
// columns'.
struct DownScale {
  const uint8_t* hexp;   // the CTA's row 0 in hexp; nt bytes a row
  int nt;                // 64-column tiles of f
  int ra[4];             // hmax of the rows whose A chunks this thread
                         // copies, rows tid / 8 + 32 i (0 past the count)
  bool rows;             // some row of the CTA has hmax > 0
  unsigned char* ex;     // shared: the columns' exponents (256 bytes),
                         // the next ones (256) and the stage's parts
                         // (16 x 256)
};
constexpr int EX_BYTES = 512 + 16 * DOWN_COLS;

// Stage kt's A chunks of this thread (rows tid / 8 + 32 i, stored at
// their own tile's exponent) moved to their row's largest, in place.
__device__ __forceinline__ void a_rows_to_hmax(uint32_t sa, int kt,
                                               const DownScale& ds,
                                               int tid) {
#pragma unroll
  for (int i = 0; i < TC_BM * 8 / TC_THREADS; ++i) {
    const int r = tid / 8 + 32 * i;
    if (ds.ra[i] == 0) continue;
    const int et = ds.hexp[(long long)r * ds.nt + kt];
    if (et != ds.ra[i]) sm90::f16_scale(sa + sm90::swz(r, tid & 7),
                                        et - ds.ra[i]);
  }
}

// Stage kt's wo tiles (NB of them at sb, MN-major, k rows from k0) at the
// columns' running exponents: the stage's largest exponent a column
// joins the running one, the accumulator's columns whose exponent grew
// are scaled down to it, and this thread's chunks are converted again
// from device memory at their columns' exponents. Every thread of the
// CTA calls it, after the stage's products before it have completed.
template <int NB>
__device__ __forceinline__ void
b_cols_to_exponents(float (&acc)[NB][64], uint32_t sb,
                    const u16* const (&b)[NB], long long ldb, int cols,
                    int col_step, int kn, int k0, unsigned char* ex,
                    int tid) {
  unsigned char *cur = ex, *nxt = ex + 256, *part = ex + 512;
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float cm[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int r, ch = 0;
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      b_slot(i, tid, r, ch);
      if (r >= kn || ch * 8 >= cols - j * col_step) continue;
      const uint4 w = *reinterpret_cast<const uint4*>(
          b[j] + (long long)(k0 + r) * ldb + ch * 8);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cm[2 * q] = fmaxf(cm[2 * q],
                          fabsf(__uint_as_float(ws[q] << 16)));
        cm[2 * q + 1] = fmaxf(cm[2 * q + 1],
                              fabsf(__uint_as_float(ws[q] & 0xffff0000u)));
      }
    }
    // the 16 threads of one column group (tid % 16) hold its 64 k rows
#pragma unroll
    for (int c = 0; c < 8; ++c)
      part[(tid >> 4) * 256 + j * 128 + ch * 8 + c] =
          (unsigned char)sm90::f16_exponent(cm[c]);
  }
  __syncthreads();
  {
    int m = cur[tid];
#pragma unroll
    for (int q = 0; q < 16; ++q) m = max(m, (int)part[q * 256 + tid]);
    nxt[tid] = (unsigned char)m;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = t * 128 + 8 * jj + 2 * (lane & 3) + c;
        if (cur[col] != nxt[col]) {
          const float f = sm90::pow2((int)cur[col] - (int)nxt[col]);
          acc[t][4 * jj + c] *= f;
          acc[t][4 * jj + 2 + c] *= f;
        }
      }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      int r, ch;
      const uint32_t off = b_slot(i, tid, r, ch);
      const bool in = r < kn && ch * 8 < cols - j * col_step;
      uint4 w = {0u, 0u, 0u, 0u};
      if (in)
        w = *reinterpret_cast<const uint4*>(
            b[j] + (long long)(k0 + r) * ldb + ch * 8);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = j * 128 + ch * 8 + 2 * q;
        o[q] = sm90::pack_f16(
            __uint_as_float(ws[q] << 16) * sm90::pow2(-(int)nxt[col]),
            __uint_as_float(ws[q] & 0xffff0000u) *
                sm90::pow2(-(int)nxt[col + 1]));
      }
      sm90::st_shared16(sb + j * B_BYTES + off, o);
    }
  sm90::fence_async_smem();
  __syncthreads();
  cur[tid] = nxt[tid];   // read again only past a barrier
}

// acc[j] = sum over i of A_i B_j, over K, operands of type T (sm90::BF16
// or F16): A_i's rows from a[i] (lda apart, ``rows`` of them), B_j's k rows
// from b[j] (ldb apart, cols - j * col_step columns: B_j lies col_step
// columns past B_0, or 0 where each B_j is its own matrix); a ring of
// STAGES stages at smem, copies two stages ahead. With CVT_B (moe_down_tc)
// the B tiles arrive as bf16 and go to fp16: as they are, where a vote a
// stage finds none past fp16's range nor ``flag`` (h's rows with an
// exponent) set, else (false returned at once, the CTA left to the
// SCALED launch) with SCALED at their columns' exponents and h's rows at
// their largest, as ``ds`` says. A_MN and B_MN pick the operands' majors
// (the note at the top): K-major A and MN-major B are the forward's; with
// A_MN, ``rows`` counts A's valid columns (the output rows) and a[i] its
// k row 0; with B_MN false, b[j] is B_j's first output column, a row of
// ldb elements of k.
template <typename T, bool CVT_B, bool SCALED, int NA, int NB, int STAGES,
          bool A_MN = false, bool B_MN = true>
__device__ __forceinline__ bool
mainloop(float (&acc)[NB][64], uint32_t smem, const u16* const (&a)[NA],
         long long lda, int rows, const u16* const (&b)[NB],
         long long ldb, int cols, int col_step, int K, int tid,
         const DownScale* ds = nullptr, bool flag = false) {
  static_assert(STAGES >= 3, "two stages ahead and one read");
  static_assert(CVT_B || !SCALED, "exponents are the down product's");
  constexpr int STAGE = NA * A_BYTES + NB * B_BYTES;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int wg = tid / 128;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  auto load = [&](int kt) {
    const uint32_t st = smem + (kt % STAGES) * STAGE;
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if constexpr (A_MN)
        copy_b(st + i * A_BYTES, a[i] + k0 * lda, lda, K - k0, rows, tid);
      else
        copy_a(st + i * A_BYTES, a[i] + k0, lda, rows, K - k0, tid);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint32_t sb = st + NA * A_BYTES + j * B_BYTES;
      if constexpr (B_MN)
        copy_b(sb, b[j] + k0 * ldb, ldb, K - k0, cols - j * col_step, tid);
      else
        copy_a(sb, b[j] + k0, ldb, cols - j * col_step, K - k0, tid);
    }
  };
  for (int kt = 0; kt < STAGES - 2; ++kt) {
    if (kt < nk) load(kt);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t st = smem + (kt % STAGES) * STAGE;
    sm90::cp_async_wait<STAGES - 3>();   // stage kt has landed
    uint32_t mx = 0;
    if constexpr (SCALED) {
      if (ds->rows) a_rows_to_hmax(st, kt, *ds, tid);
    } else if constexpr (CVT_B) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        b_to_f16(st + NA * A_BYTES + j * B_BYTES, tid, mx);
    }
    sm90::fence_async_smem();
    // every copy of stage kt is visible; every warpgroup has waited for
    // its products of stage kt - 2, whose buffer the next copy reuses
    if constexpr (CVT_B && !SCALED) {
      // the vote: a wo element of the stage past fp16's range
      if (__syncthreads_or(sm90::bf16x2_past_f16(mx) != 0 || flag)) {
        sm90::cp_async_wait<0>();
        sm90::wgmma_wait<0>();
        return false;
      }
    } else {
      __syncthreads();
    }
    if constexpr (SCALED) {
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NB; ++j) sm90::fence_regs(acc[j]);
      b_cols_to_exponents<NB>(acc, st + NA * A_BYTES, b, ldb, cols,
                              col_step, K - kt * TC_BK, kt * TC_BK, ds->ex,
                              tid);
    }
    if (kt + STAGES - 2 < nk) load(kt + STAGES - 2);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        // the warpgroup's 64 rows: K-major, rows 64 wg on; MN-major, the
        // 64-column block wg, its k16 step 16 rows (2048 bytes) on
        const uint32_t sa = st + i * A_BYTES;
        const uint64_t da =
            A_MN ? sm90::desc(sa + wg * B_BLOCK + kk * 2048, B_BLOCK, 1024)
                 : sm90::desc(sa + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t sb = st + NA * A_BYTES + j * B_BYTES;
          sm90::Mma<128, B_MN ? 1 : 0, T, A_MN ? 1 : 0>::ss(
              acc[j], da,
              B_MN ? sm90::desc(sb + kk * 2048, B_BLOCK, 1024)
                   : sm90::desc(sb + kk * 32, 16, 1024),
              1);
        }
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NB; ++j) sm90::fence_regs(acc[j]);
  return true;
}

// a stage: a tile of A and two of B, 48 KB (up: x, wi's gate and up
// tiles; down: h, two 128-column tiles of wo); four stages, 192 KB; the
// down kernel's column exponents after them
constexpr int STAGES = 4;
constexpr int RING = STAGES * (A_BYTES + 2 * B_BYTES);
constexpr int SMEM = RING + 1024;

// the rows of expert e that hold a token (all C where counts is null)
__device__ __forceinline__ int filled_rows(const int* counts, int e,
                                           int C) {
  return counts ? min(C, counts[e]) : C;
}

}  // namespace
#endif  // __CUDACC__
