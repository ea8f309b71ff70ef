// Pieces shared by the flash-attention kernels' fp32 route (flash_fwd.cu,
// flash_bwd.cu; the bf16 kernels are built from hopper.cuh and
// flash_hopper.cuh): tile loads into shared memory and the warp-level
// products, in scalar fp32 FMAs, which keep the fp32 case exact rather
// than rounding it through TF32.
//
// A CTA has four warps; a warp's products cover 16 rows of its operand A
// against a 64-row tile B shared by the whole CTA.  Shared-memory strides
// (`ld*`) are in elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;  // rows of the CTA's own tile, 16 per warp
constexpr int BLOCK_N = 64;  // rows of the tile the CTA walks over
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;  // as the TPU kernels: avoids inf - inf

// Copy rows [row0, row0 + ROWS) of one head of a [b, s, heads, D] tensor
// into shared memory, 16 bytes a thread; rows at or past `rows_valid` are
// zero-filled so that padding never feeds a NaN into a product.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_valid)
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// One warp: out[16, BLOCK_N] = a[16, D] . b[BLOCK_N, D]^T.
template <int D>
__device__ __forceinline__ void warp_nt(const float* a, int lda,
                                        const float* b, int ldb, float* out,
                                        int ldo, int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * (BLOCK_N / 2);
  const float* ar = a + r * lda;
  for (int j = 0; j < BLOCK_N / 2; ++j) {
    const float* br = b + (c0 + j) * ldb;
    float dot = 0.0f;
    for (int d = 0; d < D; ++d) dot = fmaf(ar[d], br[d], dot);
    out[r * ldo + c0 + j] = dot;
  }
}

// One warp: out[16, D] = a[16, BLOCK_N] . b[BLOCK_N, D].
template <int D>
__device__ __forceinline__ void warp_nn(const float* a, int lda,
                                        const float* b, int ldb, float* out,
                                        int ldo, int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * (D / 2);
  const float* ar = a + r * lda;
  for (int j = 0; j < D / 2; ++j) {
    float dot = 0.0f;
    for (int n = 0; n < BLOCK_N; ++n)
      dot = fmaf(ar[n], b[n * ldb + c0 + j], dot);
    out[r * ldo + c0 + j] = dot;
  }
}

}  // namespace flash
