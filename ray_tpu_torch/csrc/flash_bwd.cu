// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, exported through a plain C interface and bound with ctypes
// (ray_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// ray_tpu/ops/flash_attention.py (both launched by `_flash_bwd`).  They
// compute the same function from the forward's residuals (Q, K, V, O, LSE)
// and dO, with delta = rowsum(dO * O) computed in fp32 by the caller:
//   S  = Q K^T * sm_scale, masked (bottom-right causal, keys < s_kv)
//   P  = exp(S - LSE)                      (a dead row has LSE = 0: P = 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * sm_scale, rounded to the input type
//   dQ = dS K,  dK = dS^T Q,  dV = round(P)^T dO
// S and dP are fp32 products of input-type operands; P is rounded to the
// input type before it goes into dV and dS before both dQ and dK, as the TPU
// kernels do.  A query head h reads KV head h / (h / h_kv) (GQA without
// repeating K or V).  Outputs are in the input type.
//
// Bound at the main shape (llama-1b training: b=4, s_q = s_kv = 1024, h=32,
// h_kv=8, d=64, causal, bf16): 524,800 visible (row, key) pairs per head,
// 67.17 M in all.  dQ does three products (S, dP, dQ), 6*d FLOP a pair:
// 25.8 GFLOP, 26.1 us at 989 TFLOP/s; it moves 59.8 MB, 17.8 us at
// 3.35 TB/s.  dK/dV does four (S, dP, dV, dK), 8*d a pair: 34.4 GFLOP,
// 34.8 us; it moves 51.4 MB, 15.3 us.  Both are bound by the tensor cores'
// operations, not by bytes.
//
// What the design does about it.  The TPU kernels carry their sums in VMEM
// scratch across sequential grid steps; here each CTA owns one output tile
// and walks the other operand itself, so the fp32 sums stay in registers
// and only the outputs go back to device memory.
//  - dQ: one CTA per (batch, head, 64-row q tile).  Q, dO, LSE and delta of
//    its rows stay on chip while it walks the 64-key tiles up to the causal
//    diagonal; K and V tiles are staged in shared memory once for all four
//    warps.  CTAs are issued from the last q tile down, so the longest walks
//    start first.
//  - dK/dV: one CTA per (batch, KV head, 64-key tile).  The TPU kernel's
//    sequential (group, q-block) grid axes become a loop inside the CTA over
//    the group's query heads and the q tiles from the first one that sees
//    this key tile.  Each warp owns 16 keys and computes S^T and dP^T
//    directly (K Q^T, V dO^T), so GQA needs neither atomics nor a KV repeat
//    and the sums are deterministic.
// Products run through WMMA `mma.sync` (bf16) or scalar FMAs (fp32), see
// flash_common.cuh; each product's result goes through shared memory to the
// lane that owns it (lane l: row l / 2 of the warp's 16, half l % 2 of the
// columns).  The ragged last tiles are zero-filled on load, and rows
// >= s_q and keys >= s_kv are masked explicitly rather than left to cancel:
// a padded row would read LSE = 0 and S = 0 and give P = 1.  Like the
// forward, this first version neither overlaps loads with compute nor uses
// wgmma or TMA; those are the known distance to the bound.

#include "flash_common.cuh"

namespace {

using namespace flash;

// Shared-memory layout: A and B are the CTA's own tiles (Q, dO for dQ;
// K, V for dK/dV), C and E the tiles it walks over (K, V; Q, dO); F the
// fp32 products, one 16-row slice per warp; P and DS the rounded P and dS;
// R the LSE and delta of the current q tile (dK/dV only).
template <typename T, int D, bool DKV>
struct Layout {
  static constexpr int LDT = D + 16 / sizeof(T);
  static constexpr int LDP = BLOCK_N + 16 / sizeof(T);
  static constexpr int LDF = (D > BLOCK_N ? D : BLOCK_N) + 4;
  static constexpr size_t tile = sizeof(T) * 64 * LDT;
  static constexpr size_t a_off = 0;
  static constexpr size_t b_off = a_off + tile;
  static constexpr size_t c_off = b_off + tile;
  static constexpr size_t e_off = c_off + tile;
  static constexpr size_t f_off = e_off + tile;
  static constexpr size_t ds_off = f_off + sizeof(float) * 64 * LDF;
  static constexpr size_t p_off = ds_off + sizeof(T) * 64 * LDP;
  static constexpr size_t r_off = p_off + (DKV ? sizeof(T) * 64 * LDP : 0);
  static constexpr size_t bytes = r_off + (DKV ? sizeof(float) * 2 * 64 : 0);
};

// Grid: (ceil(s_q / BLOCK_M), h, b).  Inputs are contiguous [b, s, heads, D]
// (q, dout, dq: h heads; k, v: h_kv heads); LSE and delta are [b, h, s_q].
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int h, int h_kv, int s_q, int s_kv, int causal,
                    float sm_scale) {
  using L = Layout<T, D, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::a_off);
  T* do_s = reinterpret_cast<T*>(smem + L::b_off);
  T* k_s = reinterpret_cast<T*>(smem + L::c_off);
  T* v_s = reinterpret_cast<T*>(smem + L::e_off);
  float* f_s = reinterpret_cast<float*>(smem + L::f_off);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds_off);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;  // longest first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (h / h_kv);
  const int q_offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int q_idx = q0 + warp * 16 + r;
  const bool row_ok = q_idx < s_q;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const long long q_base = (long long)bb * s_q * q_stride + (long long)hh * D;
  const long long kv_base = (long long)bb * s_kv * kv_stride + (long long)kvh * D;
  const long long stat = ((long long)bb * h + hh) * s_q + q_idx;
  const float lse_r = row_ok ? lse[stat] : 0.0f;
  const float delta_r = row_ok ? delta[stat] : 0.0f;

  load_tile<T, D, BLOCK_M>(q_s, L::LDT, q + q_base, q_stride, q0, s_q);
  load_tile<T, D, BLOCK_M>(do_s, L::LDT, dout + q_base, q_stride, q0, s_q);

  int n_tiles = (s_kv + BLOCK_N - 1) / BLOCK_N;
  if (causal) {  // skip k-tiles wholly above the diagonal of this q tile
    const int last_key = min(q0 + BLOCK_M, s_q) - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BLOCK_N + 1);
  }

  const T* q_w = q_s + warp * 16 * L::LDT;
  const T* do_w = do_s + warp * 16 * L::LDT;
  T* ds_w = ds_s + warp * 16 * L::LDP;
  float* f_w = f_s + warp * 16 * L::LDF;
  const float* frow = f_w + r * L::LDF + half * (BLOCK_N / 2);
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K, V tile
    load_tile<T, D, BLOCK_N>(k_s, L::LDT, k + kv_base, kv_stride, k0, s_kv);
    load_tile<T, D, BLOCK_N>(v_s, L::LDT, v + kv_base, kv_stride, k0, s_kv);
    __syncthreads();

    warp_nt<D>(q_w, L::LDT, k_s, L::LDT, f_w, L::LDF, lane);  // S
    __syncwarp();
    float p[BLOCK_N / 2];
    const int row_pos = q_idx + q_offset;
#pragma unroll
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      const int col = k0 + half * (BLOCK_N / 2) + j;
      const bool visible = row_ok && col < s_kv && (!causal || row_pos >= col);
      p[j] = visible ? expf(frow[j] * sm_scale - lse_r) : 0.0f;
    }
    __syncwarp();
    warp_nt<D>(do_w, L::LDT, v_s, L::LDT, f_w, L::LDF, lane);  // dP
    __syncwarp();
    T* dsrow = ds_w + r * L::LDP + half * (BLOCK_N / 2);
#pragma unroll
    for (int j = 0; j < BLOCK_N / 2; ++j)
      dsrow[j] = from_float<T>(p[j] * (frow[j] - delta_r) * sm_scale);
    __syncwarp();
    warp_nn<D>(ds_w, L::LDP, k_s, L::LDT, f_w, L::LDF, lane);  // dS K
    __syncwarp();
    const float* part = f_w + r * L::LDF + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] += part[j];
  }

  if (row_ok) {
    T* out = dq + q_base + (long long)q_idx * q_stride + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) out[j] = from_float<T>(acc[j]);
  }
}

// Grid: (ceil(s_kv / BLOCK_N), h_kv, b).  Layouts as the dQ kernel; dk and
// dv are [b, s_kv, h_kv, D].  Here a warp's 16 rows are keys and the
// columns of S^T and dP^T are the q tile's rows.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int h_kv, int s_q, int s_kv,
                     int causal, float sm_scale) {
  using L = Layout<T, D, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::a_off);
  T* v_s = reinterpret_cast<T*>(smem + L::b_off);
  T* q_s = reinterpret_cast<T*>(smem + L::c_off);
  T* do_s = reinterpret_cast<T*>(smem + L::e_off);
  float* f_s = reinterpret_cast<float*>(smem + L::f_off);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds_off);
  T* p_s = reinterpret_cast<T*>(smem + L::p_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::r_off);
  float* delta_s = lse_s + BLOCK_M;

  const int k0 = blockIdx.x * BLOCK_N, kvh = blockIdx.y, bb = blockIdx.z;
  const int group = h / h_kv;
  const int q_offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int key = k0 + warp * 16 + r;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const long long kv_base = (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  load_tile<T, D, BLOCK_N>(k_s, L::LDT, k + kv_base, kv_stride, k0, s_kv);
  load_tile<T, D, BLOCK_N>(v_s, L::LDT, v + kv_base, kv_stride, k0, s_kv);

  // the first q tile with a row that sees key k0: row + q_offset >= k0
  const int n_q = (s_q + BLOCK_M - 1) / BLOCK_M;
  int qt0 = 0;
  if (causal) qt0 = k0 - q_offset <= 0 ? 0 : (k0 - q_offset) / BLOCK_M;

  const T* k_w = k_s + warp * 16 * L::LDT;
  const T* v_w = v_s + warp * 16 * L::LDT;
  T* p_w = p_s + warp * 16 * L::LDP;
  T* ds_w = ds_s + warp * 16 * L::LDP;
  float* f_w = f_s + warp * 16 * L::LDF;
  const float* frow = f_w + r * L::LDF + half * (BLOCK_M / 2);
  T* prow = p_w + r * L::LDP + half * (BLOCK_M / 2);
  T* dsrow = ds_w + r * L::LDP + half * (BLOCK_M / 2);
  const float* part = f_w + r * L::LDF + half * (D / 2);
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_k[j] = acc_v[j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int hh = kvh * group + g;
    const long long q_base = (long long)bb * s_q * q_stride + (long long)hh * D;
    const long long stat = ((long long)bb * h + hh) * s_q;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BLOCK_M;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<T, D, BLOCK_M>(q_s, L::LDT, q + q_base, q_stride, q0, s_q);
      load_tile<T, D, BLOCK_M>(do_s, L::LDT, dout + q_base, q_stride, q0,
                               s_q);
      for (int i = threadIdx.x; i < BLOCK_M; i += THREADS) {
        const bool ok = q0 + i < s_q;
        lse_s[i] = ok ? lse[stat + q0 + i] : 0.0f;
        delta_s[i] = ok ? delta[stat + q0 + i] : 0.0f;
      }
      __syncthreads();

      warp_nt<D>(k_w, L::LDT, q_s, L::LDT, f_w, L::LDF, lane);  // S^T
      __syncwarp();
      float p[BLOCK_M / 2];
#pragma unroll
      for (int j = 0; j < BLOCK_M / 2; ++j) {
        const int i = half * (BLOCK_M / 2) + j, row = q0 + i;
        const bool visible = key < s_kv && row < s_q &&
                             (!causal || row + q_offset >= key);
        p[j] = visible ? expf(frow[j] * sm_scale - lse_s[i]) : 0.0f;
        prow[j] = from_float<T>(p[j]);
      }
      __syncwarp();
      warp_nt<D>(v_w, L::LDT, do_s, L::LDT, f_w, L::LDF, lane);  // dP^T
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BLOCK_M / 2; ++j) {
        const int i = half * (BLOCK_M / 2) + j;
        dsrow[j] = from_float<T>(p[j] * (frow[j] - delta_s[i]) * sm_scale);
      }
      __syncwarp();
      warp_nn<D>(p_w, L::LDP, do_s, L::LDT, f_w, L::LDF, lane);  // P^T dO
      __syncwarp();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_v[j] += part[j];
      __syncwarp();
      warp_nn<D>(ds_w, L::LDP, q_s, L::LDT, f_w, L::LDF, lane);  // dS^T Q
      __syncwarp();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_k[j] += part[j];
    }
  }

  if (key < s_kv) {
    const long long off = kv_base + (long long)key * kv_stride + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dk[off + j] = from_float<T>(acc_k[j]);
      dv[off + j] = from_float<T>(acc_v[j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int h, int h_kv, int s_q, int s_kv,
                      int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D, false>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), h, h_kv, s_q, s_kv, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int h, int h_kv, int s_q,
                       int s_kv, int causal, float sm_scale,
                       cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D, true>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_kv + BLOCK_N - 1) / BLOCK_N, h_kv, b);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, h_kv, s_q, s_kv, causal,
      sm_scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int h, int h_kv, int s_q, int s_kv) {
  return b < 1 || h < 1 || h_kv < 1 || h % h_kv || s_q < 1 || s_kv < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32.  Each returns the cudaError_t of its launch.
int ray_tpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int dtype, int b, int h, int h_kv, int s_q,
                         int s_kv, int d, int causal, float sm_scale,
                         int device, void* stream) {
  if (bad_shape(b, h, h_kv, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ(T, D)                                                            \
  return (int)launch_dq<T, D>(q, k, v, dout, lse, delta, dq, b, h, h_kv,    \
                              s_q, s_kv, causal, sm_scale, st)
  if (dtype == 0 && d == 64) DQ(bf16, 64);
  if (dtype == 0 && d == 128) DQ(bf16, 128);
  if (dtype == 1 && d == 64) DQ(float, 64);
  if (dtype == 1 && d == 128) DQ(float, 128);
#undef DQ
  return (int)cudaErrorInvalidValue;
}

int ray_tpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int dtype,
                          int b, int h, int h_kv, int s_q, int s_kv, int d,
                          int causal, float sm_scale, int device,
                          void* stream) {
  if (bad_shape(b, h, h_kv, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV(T, D)                                                           \
  return (int)launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, b, h,     \
                               h_kv, s_q, s_kv, causal, sm_scale, st)
  if (dtype == 0 && d == 64) DKV(bf16, 64);
  if (dtype == 0 && d == 128) DKV(bf16, 128);
  if (dtype == 1 && d == 64) DKV(float, 64);
  if (dtype == 1 && d == 128) DKV(float, 128);
#undef DKV
  return (int)cudaErrorInvalidValue;
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
