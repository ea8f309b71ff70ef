// Pieces shared by the flash-attention kernels' fp32 route (flash_fwd.cu,
// flash_bwd.cu; the bf16 kernels are built from hopper.cuh and
// flash_hopper.cuh), in scalar fp32 FMAs, which keep the fp32 case exact
// rather than rounding it through TF32: asynchronous tile copies, the thread
// grids of the register-blocked products, and the products themselves.
// Shared-memory strides (`LD*`) are in elements.

#pragma once

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // as the TPU kernels: avoids inf - inf

// -- fp32, register-blocked (the forward's and the backward's fp32 kernels) --
//
// A CTA of F32_THREADS threads.  A product's output tile is spread over a
// grid of TY x TX threads; each warp holds a 4 x 8 block of that grid, so
// that a 16-byte operand read by a warp touches 4 rows of one operand and
// 8 of the other: one shared-memory wavefront each, with rows padded by 16
// bytes (operand tiles) or 32 bytes (score tiles) against bank conflicts.
// Thread (ty, tx) owns output rows ty + a * TY and columns tx + b * TX
// (scalars) or float4 columns (tx + v * TX) * 4 (O and the gradient
// products).  Each output element is one chain of FMAs in a fixed order, so
// results are the same bits from run to run.

constexpr int F32_THREADS = 128;

// Start copying rows [row0, row0 + ROWS) of one head of a [b, s, heads, D]
// fp32 tensor into shared rows of D + 4 floats; rows at or past
// `rows_valid` are zero-filled.  Not committed.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                long long row_stride,
                                                int row0, int rows_valid) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += F32_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool ok = row0 + r < rows_valid;
    hopper::cp_async16(dst + r * (D + 4) + c,
                       src + (long long)(ok ? row0 + r : 0) * row_stride + c,
                       ok);
  }
}

// Grids for an R x C scalar product (NT) and an R x D product in float4
// columns (NN) over THREADS threads: TY from {4, 8, 16}, the one with the
// fewest operand reads a step (TM + TN rows; TM + 4 TV for NN), given that
// each warp is a 4 x 8 block of the grid.
constexpr int grid_ty(int r, int c, bool nn, int threads) {
  int best = 0, cost = 1 << 30;
  for (int ty = 4; ty <= 16; ty *= 2) {
    const int tx = threads / ty;
    if (tx < 8 || tx % 8 || r % ty || c % tx) continue;
    const int reads = r / ty + (nn ? 4 : 1) * (c / tx);
    if (reads < cost) {
      cost = reads;
      best = ty;
    }
  }
  return best;
}

template <int R, int C, int THREADS = F32_THREADS>
struct NtGrid {
  static constexpr int TY = grid_ty(R, C, false, THREADS);
  static constexpr int TX = THREADS / TY;
  static_assert(TY > 0, "no thread grid for this tile");
  static constexpr int TM = R / TY, TN = C / TX;
};

template <int R, int D, int THREADS = F32_THREADS>
struct NnGrid {
  static constexpr int TY = grid_ty(R, D / 4, true, THREADS);
  static constexpr int TX = THREADS / TY;
  static_assert(TY > 0, "no thread grid for this tile");
  static constexpr int TM = R / TY, TV = D / 4 / TX;
};

// Thread `t`'s (tx, ty) in a grid TX threads wide, warps as 4 x 8 blocks.
template <int TX>
__device__ __forceinline__ int2 grid_pos(int t) {
  const int warp = t >> 5, lane = t & 31;
  return make_int2((warp % (TX / 8)) * 8 + (lane & 7),
                   (warp / (TX / 8)) * 4 + (lane >> 3));
}

__device__ __forceinline__ float part(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// s = A0 . B0^T and t = A1 . B1^T over D, for this thread's TM x TN
// elements: A rows ty + i * TY, B rows tx + j * TX, both D + 4 floats
// apart.  The two products share the loop, so a thread runs 2 TM TN
// independent chains.
template <int D, int TM, int TN, int TY, int TX>
__device__ __forceinline__ void nt_pair(float (&s)[TM][TN],
                                        float (&t)[TM][TN], const float* a0,
                                        const float* b0, const float* a1,
                                        const float* b1, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(a0 + (ty + i * TY) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(b0 + (tx + j * TX) * LD + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          s[i][j] = fmaf(part(a[i], e), part(b[j], e), s[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(a1 + (ty + i * TY) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(b1 + (tx + j * TX) * LD + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          t[i][j] = fmaf(part(a[i], e), part(b[j], e), t[i][j]);
  }
}

// s = A . B^T over D, for this thread's TM x TN elements: A rows
// ty + i * TY, B rows tx + j * TX, both D + 4 floats apart.
template <int D, int TM, int TN, int TY, int TX>
__device__ __forceinline__ void nt_prod(float (&s)[TM][TN], const float* a,
                                        const float* b, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + i * TY) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + j * TX) * LD + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          s[i][j] = fmaf(part(av[i], e), part(bv[j], e), s[i][j]);
  }
}

// acc += A . B over N: A rows ty + a * TY of N (+ padding, LDA floats
// apart), B N rows of D + 4 floats, this thread's float4 columns
// (tx + v * TX) * 4.
template <int N, int LDA, int D, int TM, int TV, int TY, int TX>
__device__ __forceinline__ void nn_acc(float4 (&acc)[TM][TV], const float* a,
                                       const float* b, int ty, int tx) {
  constexpr int LDB = D + 4;
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + i * TY) * LDA + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 bv[TV];
#pragma unroll
      for (int v = 0; v < TV; ++v)
        bv[v] = *reinterpret_cast<const float4*>(b + (n + e) * LDB +
                                                 (tx + v * TX) * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = part(av[i], e);
#pragma unroll
        for (int v = 0; v < TV; ++v) {
          acc[i][v].x = fmaf(x, bv[v].x, acc[i][v].x);
          acc[i][v].y = fmaf(x, bv[v].y, acc[i][v].y);
          acc[i][v].z = fmaf(x, bv[v].z, acc[i][v].z);
          acc[i][v].w = fmaf(x, bv[v].w, acc[i][v].w);
        }
      }
    }
  }
}

}  // namespace flash
