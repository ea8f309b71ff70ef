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
// Bound at the main shapes (llama-1b, h=32, h_kv=8, d=64, causal, bf16:
// whole-prompt prefill b=1, s=2048; training b=4, s=1024): the visible
// (row, key) pairs are s(s+1)/2 per head, so the work is 4*b*h*d*pairs =
// 17.19 GFLOP at both, 17.4 us at the card's 989 TFLOP/s in bf16; q, k, v,
// o and lse move about 21 MB, 6.3 us at 3.35 TB/s.  The kernel is bound by
// the tensor cores' operations, not by bytes.
//
// What the design does about it (bf16; fp32 below).  The work is cut into
// items of one (batch, head, 128-row q tile), and a persistent grid of one
// CTA per SM walks them: items are numbered with the heads fastest and,
// under causality, the longest walks first, and CTA c takes items c,
// 2G-1-c, 2G+c, ... of a grid of G, so that each CTA's sum of walks comes
// out near the mean.  An item walks the 128-key tiles up to the causal
// diagonal of its last live row, so the online-softmax sums live in
// registers and only O and LSE go back to device memory.  The CTA is three
// warpgroups:
//  - a producer, which gives its registers up (setmaxnreg) and uses one
//    thread: it TMA-loads each item's Q tile into a ring of two (the next
//    item's loads while this one runs) and keeps a ring of two K/V stages
//    in flight, K and V on separate full/empty mbarriers so that Q K^T
//    starts before V lands and K is given back before P V is done;
//  - two consumers of 64 query rows each.  S = Q K^T is one chain of
//    wgmma m64n128k16 from shared memory (both operands K-major); the
//    softmax runs on the fp32 accumulators in registers (exp2, the scale
//    folded into the exponent's FFMA, row max over the 4-lane quad, the
//    masks only on the diagonal tiles and the ragged last key tile); P is
//    rounded to bf16 straight into the A registers of wgmma m64n{d}k16,
//    whose layout is the accumulator's, and multiplies V read MN-major from
//    shared memory.  P never touches shared memory.  At d = 64 a consumer
//    overlaps tile t's softmax with tile t-1's P V; the two consumers take
//    turns (ping-pong on two named barriers) to issue their products, so
//    that one's softmax runs while the other's products hold the tensor
//    cores.
// TMA zero-fills rows past s_q and s_kv; keys >= s_kv are still masked.
// Shared memory is 2 x Q 16 KB + 2 x (K 16 + V 16) KB at d 64, 2 x 32 +
// 2 x (32 + 32) KB at d 128.  What holds it back (PERF.md): at d 64 the
// exponentials (one MUFU.EX2 per score, 16 a clock on an SM) take as long
// as the products, and the two barely overlap within an SM; each item's
// first tile and its last P V and epilogue overlap nothing.
//
// fp32 inputs take scalar fp32 FMAs: wgmma has no exact fp32 form (TF32
// would break fp32's 1e-4 tolerance).  That route is the first design: one
// CTA per (batch, head, 64-row q tile), four warps of 16 rows, K and V tiles
// of 64 keys loaded synchronously, scores and P V through shared memory.

#include "flash_hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

// -- bf16: the Hopper kernel -------------------------------------------------

constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int Q_STAGES = 2;    // Q tiles: this item's and the next one's

// Shared memory: each tile is D / 64 boxes of rows x 128 bytes (see
// hopper.cuh), every box on a 1024-byte boundary; the mbarriers last.
template <int D>
struct HopperSmem {
  static constexpr int BOXES = D / 64;
  static constexpr uint32_t Q_BYTES = HM * D * 2;
  static constexpr uint32_t KV_BYTES = HN * D * 2;  // one K or one V tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + Q_STAGES * Q_BYTES;
  static constexpr size_t v_off = k_off + STAGES * KV_BYTES;
  static constexpr size_t bar_off = v_off + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 * Q_STAGES + 4 * STAGES;  // full, empty
  static constexpr size_t bytes = bar_off + 8 * N_BARS + 1024;  // + align
};

// One k-tile of a consumer's online softmax on its S accumulator, in place:
// mask (MASK: the diagonal and ragged tiles), update the running max m (in
// units of scaled scores, log2 base) and the thread's share of the running
// sum l for its two rows, and turn S into P in fp32.  FOLD (sm_scale >= 0):
// the max is taken over the raw scores and the scale folded into the
// exponent's FFMA; a negative scale reverses the order, so each score is
// scaled first.  → alpha, the factor the rows' O must be rescaled by
// before P V is added.
template <bool MASK, bool FOLD>
__device__ __forceinline__ void softmax_tile(float (&s)[HN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int row_pos0, int s_kv,
                                             int causal, float scale_log2,
                                             int lane) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) {
    float x = FOLD ? s[i] : s[i] * scale_log2;
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const int row_pos = row_pos0 + 8 * ((i / 2) % 2);
      if (col >= s_kv || (causal && col > row_pos)) x = NEG_INF;
    }
    s[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
  float m_sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mq = quad_max(mx[r]);
    if (FOLD) mq = mq <= NEG_INF * 0.5f ? NEG_INF : mq * scale_log2;
    const float m_new = fmaxf(m[r], mq);
    // a row with nothing visible yet keeps P = 0 instead of exp2(0) = 1
    m_sub[r] = MASK && m_new <= NEG_INF * 0.5f ? 0.0f : m_new;
    alpha[r] = ex2(m[r] - m_sub[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) {
    const float m_i = m_sub[(i / 2) % 2];
    const float p = ex2(FOLD ? fmaf(s[i], scale_log2, -m_i) : s[i] - m_i);
    s[i] = MASK && FOLD && s[i] == NEG_INF ? 0.0f : p;
    sum[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
}

// Persistent: a grid of at most one CTA per SM walks the items.  O is
// [b, s_q, h, D]; LSE is [b, h, s_q].  Warpgroup 0 is the producer, 1 and 2
// the consumers of rows 0-63 and 64-127 of each item's q tile.
template <int D, bool FOLD>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        bf16* __restrict__ o, float* __restrict__ lse,
                        const Work work, float sm_scale) {
  using L = HopperSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_empty = q_full + Q_STAGES;
  uint64_t* k_full = q_empty + Q_STAGES;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  if (threadIdx.x == 0) {
    for (int st = 0; st < Q_STAGES; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], CONSUMER_WARPS);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], CONSUMER_WARPS);
      mbar_init(&v_empty[st], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer ------------------------------------------------------------
    // Q, K and V run through their rings across items: the next item's Q
    // loads while this one's last tiles are still in use.
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      RingPos<STAGES> pos;
      RingPos<Q_STAGES> qpos;
      for (int r = 0;; ++r) {
        const int index = item_index(work.total(), r);
        if (index < 0) break;
        const Item it = item_of(work, index);
        unsigned char* q_s = smem + L::q_off + qpos.stage * L::Q_BYTES;
        mbar_wait(&q_empty[qpos.stage], qpos.phase ^ 1);
        mbar_arrive_expect_tx(&q_full[qpos.stage], L::Q_BYTES);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load_4d(q_s + j * HM * BOX_BYTES, &tm_q, &q_full[qpos.stage],
                      64 * j, it.hh, it.q0, it.bb);
        qpos.advance();
        for (int t = 0; t < it.n_tiles; ++t) {
          unsigned char* k_s = smem + L::k_off + pos.stage * L::KV_BYTES;
          unsigned char* v_s = smem + L::v_off + pos.stage * L::KV_BYTES;
          mbar_wait(&k_empty[pos.stage], pos.phase ^ 1);
          mbar_arrive_expect_tx(&k_full[pos.stage], L::KV_BYTES);
          for (int j = 0; j < L::BOXES; ++j)
            tma_load_4d(k_s + j * HN * BOX_BYTES, &tm_k, &k_full[pos.stage],
                        64 * j, it.kvh, t * HN, it.bb);
          mbar_wait(&v_empty[pos.stage], pos.phase ^ 1);
          mbar_arrive_expect_tx(&v_full[pos.stage], L::KV_BYTES);
          for (int j = 0; j < L::BOXES; ++j)
            tma_load_4d(v_s + j * HN * BOX_BYTES, &tm_v, &v_full[pos.stage],
                        64 * j, it.kvh, t * HN, it.bb);
          pos.advance();
        }
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  // At d = 64 each step overlaps work of two tiles: it issues
  // S_t = Q K_t^T, rescales O by tile t-1's alpha while S_t runs, issues
  // O += P_{t-1} V_{t-1}, waits for S_t alone and runs its softmax while
  // P V runs, then packs P_t.  At d = 128 that needs more registers than a
  // thread of three warpgroups has, so each tile runs its steps in turn.
  constexpr bool OVERLAP = D == 64;
  regs_alloc<240>();
  const int cw = wg - 1;                       // rows 64 cw .. 64 cw + 63
  // Ping-pong: the two consumers take turns to issue their products, each
  // waiting on its own named barrier (1 + cw) for the other's arrival, so
  // that one's softmax runs while the other's products use the tensor
  // cores.  Consumer 0 takes the first turn.
  const Turns turn{cw};
  turn.begin();
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32;
  const int row_in = cw * 64 + warp * 16 + lane / 4;  // and row_in + 8
  const int q_offset = work.s_kv - work.s_q;
  const float scale_log2 = sm_scale * LOG2E;

  float acc[D / 2];
  float m[2], l[2], alpha[2];
  uint32_t p[HN / 16][4];      // P of the previous tile, the A of P V
  RingPos<STAGES> kpos, vpos;  // the next K tile, the next V tile
  RingPos<Q_STAGES> qpos;

  auto issue_qk = [&](float (&s)[HN / 2]) {
    const unsigned char* q_s =
        smem + L::q_off + qpos.stage * L::Q_BYTES + cw * 64 * BOX_BYTES;
    const unsigned char* k_s = smem + L::k_off + kpos.stage * L::KV_BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss<0>(
          s, wgmma_desc_kmajor(q_s + (kk / 4) * HM * BOX_BYTES + (kk % 4) * 32),
          wgmma_desc_kmajor(k_s + (kk / 4) * HN * BOX_BYTES + (kk % 4) * 32),
          kk > 0);
    wgmma_commit();
    fence_regs(s);
  };
  auto issue_pv = [&]() {
    const unsigned char* v_s = smem + L::v_off + vpos.stage * L::KV_BYTES;
    fence_regs(p);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HN / 16; ++kk) {
      const uint64_t desc = wgmma_desc_mnmajor(v_s + kk * 16 * BOX_BYTES,
                                               HN * BOX_BYTES);
      if constexpr (D == 64)
        wgmma_m64n64k16_rs<1>(acc, p[kk], desc, 1);
      else
        wgmma_m64n128k16_rs<1>(acc, p[kk], desc, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    fence_regs(p);
  };
  auto wait_pv = [&]() {
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
  };
  // P rounded to bf16 into the A registers of P V
  auto pack_p = [&](const float (&s)[HN / 2]) { pack_a<HN>(p, s); };

  for (int r = 0;; ++r) {
    const int index = item_index(work.total(), r);
    if (index < 0) break;
    const Item it = item_of(work, index);
    const int row0 = it.q0 + row_in;
    const int first_row_pos = it.q0 + cw * 64 + q_offset;
    // the softmax of tile t on its S: P (fp32, in place), m, l, alpha
    auto softmax = [&](int t, float (&s)[HN / 2]) {
      const int k0 = t * HN;
      if (k0 + HN > work.s_kv || (work.causal && k0 + HN - 1 > first_row_pos))
        softmax_tile<true, FOLD>(s, m, l, alpha, k0, row0 + q_offset,
                                 work.s_kv, work.causal, scale_log2, lane);
      else
        softmax_tile<false, FOLD>(s, m, l, alpha, k0, row0 + q_offset,
                                  work.s_kv, work.causal, scale_log2, lane);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.0f;

    mbar_wait(&q_full[qpos.stage], qpos.phase);
    if (OVERLAP && it.n_tiles > 0) {
      float s[HN / 2];
      mbar_wait(&k_full[kpos.stage], kpos.phase);
      turn.wait();
      issue_qk(s);
      turn.pass();
      wgmma_wait<0>();
      fence_regs(s);
      release(&k_empty[kpos.stage], lane);
      kpos.advance();
      softmax(0, s);  // O is still 0: no rescale
      pack_p(s);
    }
    for (int t = OVERLAP ? 1 : 0; t < it.n_tiles; ++t) {
      float s[HN / 2];
      mbar_wait(&k_full[kpos.stage], kpos.phase);
      turn.wait();
      issue_qk(s);
      if (OVERLAP) {
        rescale();  // while S_t runs
        mbar_wait(&v_full[vpos.stage], vpos.phase);
        issue_pv();
        turn.pass();
        wgmma_wait<1>();  // S_t is done, P_{t-1} V_{t-1} may still run
      } else {
        turn.pass();
        wgmma_wait<0>();
      }
      fence_regs(s);
      release(&k_empty[kpos.stage], lane);
      kpos.advance();
      softmax(t, s);
      if (OVERLAP) {
        wait_pv();
        release(&v_empty[vpos.stage], lane);
        vpos.advance();
      } else {
        rescale();
      }
      pack_p(s);
      if (!OVERLAP) {
        mbar_wait(&v_full[vpos.stage], vpos.phase);
        issue_pv();
        wait_pv();
        release(&v_empty[vpos.stage], lane);
        vpos.advance();
      }
    }
    release(&q_empty[qpos.stage], lane);  // every Q K^T of the item is done
    qpos.advance();
    if (OVERLAP && it.n_tiles > 0) {
      rescale();
      mbar_wait(&v_full[vpos.stage], vpos.phase);
      issue_pv();
      wait_pv();
      release(&v_empty[vpos.stage], lane);
      vpos.advance();
    }

    // epilogue: O = acc / l in bf16 and LSE in natural-log units
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      const float lr = quad_sum(l[rr]);
      if (row >= work.s_q) continue;
      const float inv_l = lr == 0.0f ? 1.0f : 1.0f / lr;
      bf16* orow = o + ((long long)it.bb * work.s_q + row) * work.h * D +
                   (long long)it.hh * D + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * rr] * inv_l,
                                  acc[4 * j + 2 * rr + 1] * inv_l);
      if (lane % 4 == 0)
        lse[((long long)it.bb * work.h + it.hh) * work.s_q + row] =
            m[rr] <= NEG_INF * 0.5f ? 0.0f
                                    : m[rr] * LN2 + logf(fmaxf(lr, 1e-30f));
    }
  }
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int h, int h_kv, int s_q, int s_kv,
                  int causal, float sm_scale, int device,
                  cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_head_map(&tm_q, q, b, s_q, h, D, HM);
  if (!err) err = encode_head_map(&tm_k, k, b, s_kv, h_kv, D, HN);
  if (!err) err = encode_head_map(&tm_v, v, b, s_kv, h_kv, D, HN);
  if (err) return err;
  const auto kernel = sm_scale >= 0.0f ? flash_fwd_hopper_kernel<D, true>
                                       : flash_fwd_hopper_kernel<D, false>;
  constexpr size_t smem = HopperSmem<D>::bytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const Work work{b * h, (s_q + HM - 1) / HM, h, h_kv, s_q, s_kv, causal};
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = work.total() < sms ? work.total() : sms;
  kernel<<<grid, HOPPER_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), work,
      sm_scale);
  return (int)cudaGetLastError();
}

// -- fp32: scalar FMAs -------------------------------------------------------

// Shared-memory layout.  Rows carry 16 bytes of padding against bank
// conflicts.
template <int D>
struct Fp32Layout {
  static constexpr int LDT = D + 4;                            // Q, K, V rows
  static constexpr int LDP = BLOCK_N + 4;                      // P rows
  static constexpr int LDF = (D > BLOCK_N ? D : BLOCK_N) + 4;  // product rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + 4 * BLOCK_M * LDT;
  static constexpr size_t v_off = k_off + 4 * BLOCK_N * LDT;
  static constexpr size_t p_off = v_off + 4 * BLOCK_N * LDT;
  static constexpr size_t f_off = p_off + 4 * BLOCK_M * LDP;
  static constexpr size_t bytes = f_off + 4 * BLOCK_M * LDF;
};

// Grid: (ceil(s_q / BLOCK_M), h, b).  Lane l of a warp owns row l / 2 of
// the warp's 16 and half l % 2 of that row's keys (in the softmax) and of
// its D output columns (in the accumulator).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int h, int h_kv, int s_q,
                      int s_kv, int causal, float sm_scale) {
  using L = Fp32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);
  float* f_s = reinterpret_cast<float*>(smem + L::f_off);

  const int q0 = blockIdx.x * BLOCK_M, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (h / h_kv);
  const int q_offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int q_idx = q0 + warp * 16 + r;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const float* q_b = q + (long long)bb * s_q * q_stride + (long long)hh * D;
  const float* k_b = k + (long long)bb * s_kv * kv_stride + (long long)kvh * D;
  const float* v_b = v + (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  load_tile<float, D, BLOCK_M>(q_s, L::LDT, q_b, q_stride, q0, s_q);

  int n_tiles = (s_kv + BLOCK_N - 1) / BLOCK_N;
  if (causal) {  // skip k-tiles wholly above the diagonal of this q tile
    const int last_key = min(q0 + BLOCK_M, s_q) - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BLOCK_N + 1);
  }

  const float* q_w = q_s + warp * 16 * L::LDT;
  float* p_w = p_s + warp * 16 * L::LDP;
  float* f_w = f_s + warp * 16 * L::LDF;
  float m = NEG_INF, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K, V tile
    load_tile<float, D, BLOCK_N>(k_s, L::LDT, k_b, kv_stride, k0, s_kv);
    load_tile<float, D, BLOCK_N>(v_s, L::LDT, v_b, kv_stride, k0, s_kv);
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
    float* prow = p_w + r * L::LDP + half * (BLOCK_N / 2);
    float rowsum = 0.0f;
    for (int j = 0; j < BLOCK_N / 2; ++j) {
      const float p = dead ? 0.0f : expf(srow[j] - m_new);
      rowsum += p;
      prow[j] = p;
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
    float* orow = o + ((long long)bb * s_q + q_idx) * q_stride +
                  (long long)hh * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) orow[j] = acc[j] / safe_l;
    if (half == 0)
      lse[((long long)bb * h + hh) * s_q + q_idx] =
          m <= NEG_INF * 0.5f ? 0.0f : m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int h, int h_kv, int s_q, int s_kv,
                int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Fp32Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_fwd_fp32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), h, h_kv, s_q, s_kv, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32.  Returns 0, a cudaError_t, or a tensor-map
// error (hopper::TMAP_ERROR + the CUresult of the refused encode).
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
    return launch_hopper<64>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv, causal,
                             sm_scale, device, st);
  if (dtype == 0 && d == 128)
    return launch_hopper<128>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv, causal,
                              sm_scale, device, st);
  if (dtype == 1 && d == 64)
    return launch_fp32<64>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv, causal,
                           sm_scale, st);
  if (dtype == 1 && d == 128)
    return launch_fp32<128>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv, causal,
                            sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ray_tpu_cuda_error_string(int code) {
  return flash::error_string(code);
}

}  // extern "C"
