// Flash-attention forward for Hopper (sm_90a), exported through a plain C
// interface and bound with ctypes (ray_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// ray_tpu/ops/flash_attention.py (launched by `_flash_fwd`).  It computes
// the same function: O = softmax(Q K^T * sm_scale, masked) V with an online
// softmax whose running max, running sum and accumulator stay in fp32; P is
// rounded to the input type before P V, as the TPU kernel does; a query head
// h reads KV head h / (h / h_kv) (GQA without repeating K or V); the causal
// mask is bottom-right aligned (q_offset = s_kv - s_q); a row that sees no
// key gets O = 0 and LSE = 0.  Outputs: O in the input type, LSE in fp32.
//
// Bound at the main shape (llama-1b whole-prompt prefill: b=1, h=32, h_kv=8,
// d=64, s_q = s_kv = 2048, causal, bf16): the visible (row, key) pairs are
// s(s+1)/2 = 2,098,176 per head, so the work is 4*b*h*d*2,098,176 =
// 17.19 GFLOP, 17.4 us at the card's 989 TFLOP/s in bf16; q, k, v, o and
// lse move 21.2 MB, 6.3 us at 3.35 TB/s.  The kernel is bound by the tensor
// cores' operations, not by bytes.
//
// What the design does about it.  The TPU kernel carries its sums in VMEM
// scratch from one grid step to the next; here one CTA owns one
// (batch, head, 64-row q tile) and walks the k-tiles itself, so the sums
// live in registers and nothing but O and LSE goes back to device memory.
// Each of the four warps owns 16 query rows.  Q stays in shared memory for
// the whole walk; each 64-key tile of K and V is staged in shared memory
// once and read by all four warps.  For bf16 the two products (Q K^T and
// P V) run on the tensor cores through WMMA `mma.sync` 16x16x16 tiles with
// fp32 accumulation; fp32 inputs take scalar fp32 FMAs, which keeps the
// fp32 case exact rather than rounding it through TF32.  k-tiles wholly
// above the causal diagonal are never loaded, which halves the work of a
// causal prompt.  Any s_q and s_kv are taken: the ragged last tiles are
// zero-filled on load and masked.  This first version keeps the products'
// results in shared memory between the WMMA steps and the softmax, and
// neither overlaps loads with compute nor uses wgmma or TMA; those are the
// known distance to the bound.

#include "flash_common.cuh"

namespace {

using namespace flash;

// Shared-memory layout.  Rows carry 16 bytes of padding against bank
// conflicts; every region and every 16-row warp slice starts on a 32-byte
// boundary, as WMMA loads and stores require.
template <typename T, int D>
struct Layout {
  static constexpr int LDT = D + 16 / sizeof(T);        // Q, K, V rows
  static constexpr int LDP = BLOCK_N + 16 / sizeof(T);  // P rows
  static constexpr int LDF = (D > BLOCK_N ? D : BLOCK_N) + 4;  // fp32 rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BLOCK_M * LDT;
  static constexpr size_t v_off = k_off + sizeof(T) * BLOCK_N * LDT;
  static constexpr size_t p_off = v_off + sizeof(T) * BLOCK_N * LDT;
  static constexpr size_t f_off = p_off + sizeof(T) * BLOCK_M * LDP;
  static constexpr size_t bytes = f_off + sizeof(float) * BLOCK_M * LDF;
};

// Grid: (ceil(s_q / BLOCK_M), h, b).  Inputs are contiguous
// [b, s, heads, D]; O is [b, s_q, h, D]; LSE is [b, h, s_q].  Lane l of a
// warp owns row l / 2 of the warp's 16 and half l % 2 of that row's keys
// (in the softmax) and of its D output columns (in the accumulator).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int h, int h_kv, int s_q, int s_kv,
                 int causal, float sm_scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  T* p_s = reinterpret_cast<T*>(smem + L::p_off);
  float* f_s = reinterpret_cast<float*>(smem + L::f_off);

  const int q0 = blockIdx.x * BLOCK_M, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (h / h_kv);
  const int q_offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int q_idx = q0 + warp * 16 + r;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const T* q_b = q + (long long)bb * s_q * q_stride + (long long)hh * D;
  const T* k_b = k + (long long)bb * s_kv * kv_stride + (long long)kvh * D;
  const T* v_b = v + (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  load_tile<T, D, BLOCK_M>(q_s, L::LDT, q_b, q_stride, q0, s_q);

  int n_tiles = (s_kv + BLOCK_N - 1) / BLOCK_N;
  if (causal) {  // skip k-tiles wholly above the diagonal of this q tile
    const int last_key = min(q0 + BLOCK_M, s_q) - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BLOCK_N + 1);
  }

  const T* q_w = q_s + warp * 16 * L::LDT;
  T* p_w = p_s + warp * 16 * L::LDP;
  float* f_w = f_s + warp * 16 * L::LDF;
  float m = NEG_INF, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K, V tile
    load_tile<T, D, BLOCK_N>(k_s, L::LDT, k_b, kv_stride, k0, s_kv);
    load_tile<T, D, BLOCK_N>(v_s, L::LDT, v_b, kv_stride, k0, s_kv);
    __syncthreads();

    warp_nt<D>(q_w, L::LDT, k_s, L::LDT, f_w, L::LDF, lane);
    __syncwarp();

    // online softmax over this lane's 32 keys of row r
    float* srow = f_w + r * L::LDF + half * (BLOCK_N / 2);
    const int row_pos = q_idx + q_offset;
    float mx = NEG_INF;
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      const int col = k0 + half * (BLOCK_N / 2) + j;
      const bool visible = col < s_kv && (!causal || row_pos >= col);
      const float sv = visible ? srow[j] * sm_scale : NEG_INF;
      srow[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    // a row with nothing visible yet keeps P = 0 instead of exp(0) = 1
    const bool dead = m_new <= NEG_INF * 0.5f;
    T* prow = p_w + r * L::LDP + half * (BLOCK_N / 2);
    float rowsum = 0.0f;
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      const float p = dead ? 0.0f : expf(srow[j] - m_new);
      rowsum += p;
      prow[j] = from_float<T>(p);
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    l = alpha * l + rowsum;
    m = m_new;
    __syncwarp();  // P complete; the scores' scratch is free for P V

    warp_nn<D>(p_w, L::LDP, v_s, L::LDT, f_w, L::LDF, lane);
    __syncwarp();
    const float* pv = f_w + r * L::LDF + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = acc[j] * alpha + pv[j];
  }

  if (q_idx < s_q) {
    const float safe_l = l == 0.0f ? 1.0f : l;
    T* orow = o + ((long long)bb * s_q + q_idx) * q_stride +
              (long long)hh * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) orow[j] = from_float<T>(acc[j] / safe_l);
    if (half == 0)
      lse[((long long)bb * h + hh) * s_q + q_idx] =
          m <= NEG_INF * 0.5f ? 0.0f : m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int h, int h_kv, int s_q, int s_kv,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      h, h_kv, s_q, s_kv, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32.  Returns the cudaError_t of the launch.
int ray_tpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int dtype, int b, int h, int h_kv, int s_q,
                      int s_kv, int d, int causal, float sm_scale, int device,
                      void* stream) {
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv || s_q < 1 || s_kv < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return (int)launch<bf16, 64>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                 causal, sm_scale, st);
  if (dtype == 0 && d == 128)
    return (int)launch<bf16, 128>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                  causal, sm_scale, st);
  if (dtype == 1 && d == 64)
    return (int)launch<float, 64>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                  causal, sm_scale, st);
  if (dtype == 1 && d == 128)
    return (int)launch<float, 128>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                   causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
