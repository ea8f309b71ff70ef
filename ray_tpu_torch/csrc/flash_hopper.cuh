// Pieces shared by the Hopper flash-attention kernels (the bf16 forward in
// flash_fwd.cu, the bf16 backward in flash_bwd.cu): the tile sizes, the
// exponential and the packing of fp32 pairs into bf16 A fragments, the
// consumers' turns and ring releases, the persistent schedule of items over
// the grid, and the error strings of the C interfaces.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

#include <cstdio>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int HM = 128;          // q rows of a q tile, 64 per consumer
constexpr int HN = 128;          // keys of a K/V tile
constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int HOPPER_THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int BOX_BYTES = 128;   // one row of a 64-column box
constexpr int CONSUMER_WARPS = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator registers 8k .. 8k + 7 of a product, rounded to bf16 in
// pairs, are the A fragment of k16 step k of the next (hopper.cuh).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// The consumers' turns to issue their products (ping-pong): consumer cw
// waits on named barrier 1 + cw for the other's pass; begin() gives
// consumer 0 the first turn.  Both must take the same number of turns.
struct Turns {
  int cw;
  __device__ __forceinline__ void begin() const {
    if (cw == 0) hopper::named_bar_arrive(1, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void wait() const {
    hopper::named_bar_sync(1 + cw, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void pass() const {
    hopper::named_bar_arrive(2 - cw, 2 * WG_THREADS);
  }
};

// This warp is done with a ring's stage (its empty barrier counts the
// consumers' CONSUMER_WARPS warps).
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// The work of a forward or dQ launch: one item per (batch, head, 128-row q
// tile), numbered with the heads and batches fastest and, under causality,
// the longest walks (the last q tiles) first.
struct Work {
  int bh, n_qt, h, h_kv, s_q, s_kv, causal;
  __host__ __device__ int total() const { return bh * n_qt; }
};

struct Item {
  int bb, hh, kvh, q0, n_tiles;
};

__device__ __forceinline__ Item item_of(const Work& w, int index) {
  const int rank = index / w.bh, bh = index % w.bh;
  Item it;
  it.bb = bh / w.h;
  it.hh = bh % w.h;
  it.kvh = it.hh / (w.h / w.h_kv);
  it.q0 = (w.causal ? w.n_qt - 1 - rank : rank) * HM;
  it.n_tiles = (w.s_kv + HN - 1) / HN;
  if (w.causal) {  // skip k-tiles wholly above the diagonal of this q tile
    const int last_key = min(it.q0 + HM, w.s_q) - 1 + (w.s_kv - w.s_q);
    it.n_tiles = last_key < 0 ? 0 : min(it.n_tiles, last_key / HN + 1);
  }
  return it;
}

// The CTA's r-th item of `total`: round r of the grid, in reverse every
// other round, so that each CTA's sum of walks comes out near the mean (the
// items run from the longest walk down).  → -1 past the last item.
__device__ __forceinline__ int item_index(int total, int r) {
  const int g = gridDim.x, c = blockIdx.x;
  const int index = r * g + ((r & 1) ? g - 1 - c : c);
  return index < total ? index : -1;
}

// SMs of each device, read once
inline int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device];
}

// The text of a code the C interfaces return: a cudaError_t or a refused
// tensor map (hopper::TMAP_ERROR + the CUresult).
inline const char* error_string(int code) {
  if (code == hopper::TMAP_ERROR)
    return "cuTensorMapEncodeTiled not found in the driver";
  if (code > hopper::TMAP_ERROR) {
    static thread_local char msg[80];
    std::snprintf(msg, sizeof msg,
                  "cuTensorMapEncodeTiled refused the map (CUresult %d)",
                  code - hopper::TMAP_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace flash
