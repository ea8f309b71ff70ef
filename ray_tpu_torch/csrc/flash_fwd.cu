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
// fp32 inputs take their own kernel (flash_fwd_fp32_kernel), the same
// function in exact fp32 FMAs on the CUDA cores: wgmma has no exact fp32
// form, and TF32 (or 3xTF32) would break fp32's 1e-4 tolerance.  Bounds (67
// TFLOP/s fp32, 3.35 TB/s): at the Decision Transformer's shape (b 64, s 60,
// one head of 128, causal) 0.0024 ms of bytes (its FMAs at peak take 0.0009
// ms), at b 1 0.00004 ms (launch latency sets it in practice); at b 1, s
// 1024, 32/8 heads, d 64, causal (524,800 visible pairs a head, 4.30 GFLOP)
// 0.0641 ms of operations.  The design (flash_common.cuh, the
// register-blocked section):
//  - The grid fills the card without sums across CTAs: a CTA owns 64 q
//    rows at d 64 (32 at d 128), halved down to 16 while the grid would not
//    give each SM two CTAs (DT: 256 CTAs of 16 rows, DT at b 1: 4); CTAs are
//    numbered with the heads fastest and the longest causal walks first.
//  - S = Q K^T and O += P V are register-blocked (up to 4 x 8 scores and 8
//    float4 of O a thread), reading 16-byte operands from padded rows; the
//    score grid is the one with the fewest operand reads, 8 threads wide on
//    a tie so that a row's max and sum are shuffles within a warp (where a
//    row spans warps, their halves meet in shared memory).  P and each
//    row's rescale factor reach P V's grid through shared memory.
//  - K and V walk in tiles of 64 keys at d 64 (32 at d 128) through two
//    cp.async stages, the next tile in flight while this one is used.
//  - The exponent is one FFMA and one EX2, the scale folded in for a scale
//    >= 0 (scaled first for a negative one), the running max in log2 units.
// 46% of the bound at the long shape, 24% at DT (PERF.md): what is left is
// issue and shared-memory operand traffic, two barriers a key tile, and
// the causal walks' tail.

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

// -- fp32: register-blocked scalar FMAs -------------------------------------

// A CTA owns BM q rows of one (batch, head) and walks the keys in tiles of
// BN (64 at d 64, 32 at d 128); K and V tiles stream through two cp.async
// stages.  S = Q K^T runs on ScoreGrid's grid, where the 8 lanes of a warp
// that share a score row take its max and sum by shuffles; where a row
// spans two warps (W = 2), the warps' halves meet in shared memory behind
// one more barrier.  O += P V runs on NnGrid's grid, whose rows are other
// threads', so P and each row's rescale factor go through shared memory,
// under the one barrier P needs anyway.  Shared memory: Q (BM rows),
// 2 x (K, V) (BN rows), P (BM x BN, rows padded by 8 floats), alpha, l and
// the warps' halves (BM, BM and BM x W floats).

// NtGrid's grid (the fewest operand reads), or on a tie the one 8 threads
// wide, whose rows each lie in one warp.
template <int R, int C>
struct ScoreGrid {
  using Nt = NtGrid<R, C>;
  static constexpr bool ROW_IN_WARP =
      R % 16 == 0 && R / 16 + C / 8 <= Nt::TM + Nt::TN;
  static constexpr int TY = ROW_IN_WARP ? 16 : Nt::TY, TX = F32_THREADS / TY;
  static constexpr int TM = R / TY, TN = C / TX, W = TX / 8;
};

template <int D, int BM>
struct FwdFp32 {
  static constexpr int BN = D == 64 ? 64 : 32;
  static constexpr int LDT = D + 4, LDP = BN + 8;
  using S = ScoreGrid<BM, BN>;  // S, P: rows x keys
  using G = NnGrid<BM, D>;      // O: rows x D
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BM * LDT;
  static constexpr size_t v_off = k_off + sizeof(float) * 2 * BN * LDT;
  static constexpr size_t p_off = v_off + sizeof(float) * 2 * BN * LDT;
  static constexpr size_t a_off = p_off + sizeof(float) * BM * LDP;
  static constexpr size_t l_off = a_off + sizeof(float) * BM;
  static constexpr size_t x_off = l_off + sizeof(float) * BM;
  static constexpr size_t bytes = x_off + sizeof(float) * BM * S::W;
};

// Two CTAs an SM (8 warps): every configuration fits twice into the SM's
// 228 KB.
static_assert(2 * (FwdFp32<64, 64>::bytes + 1024) <= 233472 &&
                  2 * (FwdFp32<64, 16>::bytes + 1024) <= 233472 &&
                  2 * (FwdFp32<128, 32>::bytes + 1024) <= 233472,
              "an fp32 forward configuration no longer fits twice an SM");

// over the 8 lanes of a warp that share a score row
__device__ __forceinline__ float row_max8(float x) {
  x = quad_max(x);
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x = quad_sum(x);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Grid: one CTA per (batch, head, BM-row q tile), numbered with the heads
// and batches fastest and, under causality, the last q tiles (the longest
// walks) first.  O is [b, s_q, h, D]; LSE is [b, h, s_q].  FOLD (sm_scale
// >= 0): the running max is taken over the raw scores and the scale folded
// into the exponent's FFMA; a negative scale reverses the scores' order, so
// each score is scaled first.  m is in log2 units of scaled scores.
template <int D, int BM, bool FOLD>
__global__ void __launch_bounds__(F32_THREADS, 2)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int h, int h_kv, int s_q,
                      int s_kv, int causal, float sm_scale) {
  using L = FwdFp32<D, BM>;
  using S = typename L::S;
  using G = typename L::G;
  constexpr int BN = L::BN, W = S::W;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* x_s = reinterpret_cast<float*>(smem + L::x_off);

  const int n_qt = (s_q + BM - 1) / BM, bh_all = gridDim.x / n_qt;
  const int rank = blockIdx.x / bh_all, bh = blockIdx.x % bh_all;
  const int q0 = (causal ? n_qt - 1 - rank : rank) * BM;
  const int hh = bh % h, bb = bh / h;
  const int kvh = hh / (h / h_kv);
  const int q_offset = s_kv - s_q;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const float* q_b = q + (long long)bb * s_q * q_stride + (long long)hh * D;
  const float* k_b = k + (long long)bb * s_kv * kv_stride + (long long)kvh * D;
  const float* v_b = v + (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  int n_tiles = (s_kv + BN - 1) / BN;
  if (causal) {  // skip key tiles wholly above the diagonal of these rows
    const int last_key = min(q0 + BM, s_q) - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BN + 1);
  }
  load_tile_async<D, BM>(q_s, q_b, q_stride, q0, s_q);
  if (n_tiles > 0) {
    load_tile_async<D, BN>(k_s, k_b, kv_stride, 0, s_kv);
    load_tile_async<D, BN>(v_s, v_b, kv_stride, 0, s_kv);
  }
  cp_async_commit();

  const int2 sp = grid_pos<S::TX>(threadIdx.x);
  const int2 gp = grid_pos<G::TX>(threadIdx.x);
  const float scale_log2 = sm_scale * LOG2E;
  // per row of S: the running max, and this thread's share of the sum
  float m[S::TM], l[S::TM];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }
  float4 acc[G::TM][G::TV];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every thread is done with tile t - 1's stage,
    // P, alpha and the warps' halves
    cp_async_wait<0>();
    __syncthreads();
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int nx = (st ^ 1) * BN * L::LDT;
      load_tile_async<D, BN>(k_s + nx, k_b, kv_stride, (t + 1) * BN,
                                 s_kv);
      load_tile_async<D, BN>(v_s + nx, v_b, kv_stride, (t + 1) * BN,
                                 s_kv);
    }
    cp_async_commit();
    const float* k_t = k_s + st * BN * L::LDT;
    const float* v_t = v_s + st * BN * L::LDT;

    float s[S::TM][S::TN];
    nt_prod<D, S::TM, S::TN, S::TY, S::TX>(s, q_s, k_t, sp.y, sp.x);
    const int k0 = t * BN;
    float mxs[S::TM];  // each row's max over this warp's columns
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = sp.y + i * S::TY, row_pos = q0 + r + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        const int col = k0 + sp.x + j * S::TX;
        const bool visible = col < s_kv && (!causal || row_pos >= col);
        s[i][j] = visible ? (FOLD ? s[i][j] : s[i][j] * scale_log2) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mxs[i] = row_max8(mx);
      if (W > 1 && (sp.x & 7) == 0) x_s[r * W + sp.x / 8] = mxs[i];
    }
    if (W > 1) __syncthreads();
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = sp.y + i * S::TY;
      float mx = mxs[i];
      if (W > 1) {
        mx = x_s[r * W];
#pragma unroll
        for (int w = 1; w < W; ++w) mx = fmaxf(mx, x_s[r * W + w]);
      }
      if (FOLD) mx = mx <= NEG_INF * 0.5f ? NEG_INF : mx * scale_log2;
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        // a hidden key, and every key of a row that sees none yet, gets 0
        const float p =
            s[i][j] == NEG_INF
                ? 0.0f
                : ex2(FOLD ? fmaf(s[i][j], scale_log2, -m_new) : s[i][j] - m_new);
        p_s[r * L::LDP + sp.x + j * S::TX] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum;
      if (sp.x == 0) a_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const float alpha = a_s[gp.y + i * G::TY];
#pragma unroll
      for (int j = 0; j < G::TV; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    nn_acc<BN, L::LDP, D, G::TM, G::TV, G::TY, G::TX>(acc, p_s, v_t, gp.y,
                                                          gp.x);
  }

  // each row's sum to shared memory (the warps' halves added in order), LSE
  // from its first thread; then O = acc / l (a row that saw no key: l = 0,
  // O = 0, LSE = 0)
  cp_async_wait<0>();
  float ls[S::TM];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    ls[i] = row_sum8(l[i]);
    if (W > 1 && (sp.x & 7) == 0) x_s[(sp.y + i * S::TY) * W + sp.x / 8] = ls[i];
  }
  if (W > 1) __syncthreads();
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int r = sp.y + i * S::TY, row = q0 + r;
    float lr = ls[i];
    if (W > 1) {
      lr = x_s[r * W];
#pragma unroll
      for (int w = 1; w < W; ++w) lr += x_s[r * W + w];
    }
    if (sp.x == 0) {
      l_s[r] = lr;
      if (row < s_q)
        lse[((long long)bb * h + hh) * s_q + row] =
            m[i] <= NEG_INF * 0.5f ? 0.0f
                                   : (m[i] + log2f(fmaxf(lr, 1e-30f))) * LN2;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int r = gp.y + i * G::TY, row = q0 + r;
    if (row >= s_q) continue;
    const float lr = l_s[r] == 0.0f ? 1.0f : l_s[r];
    float* out = o + (long long)bb * s_q * q_stride + (long long)hh * D +
                 (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < G::TV; ++j)
      *reinterpret_cast<float4*>(out + (gp.x + j * G::TX) * 4) =
          make_float4(acc[i][j].x / lr, acc[i][j].y / lr, acc[i][j].z / lr,
                      acc[i][j].w / lr);
  }
}

template <int D, int BM>
int launch_fp32_rows(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int h, int h_kv, int s_q, int s_kv,
                     int causal, float sm_scale, cudaStream_t stream) {
  const auto kernel = sm_scale >= 0.0f ? flash_fwd_fp32_kernel<D, BM, true>
                                       : flash_fwd_fp32_kernel<D, BM, false>;
  constexpr size_t smem = FwdFp32<D, BM>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (s_q + BM - 1) / BM * b * h;
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), h, h_kv, s_q, s_kv, causal, sm_scale);
  return (int)cudaGetLastError();
}

// The largest slice (BM q rows: 64 at d 64, 32 at d 128) that still gives
// two CTAs for each SM, halved down to 16 while it does not.
template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int h, int h_kv, int s_q, int s_kv,
                int causal, float sm_scale, int device, cudaStream_t stream) {
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const auto fills = [&](int rows) {
    return (long long)b * h * ((s_q + rows - 1) / rows) >= 2LL * sms;
  };
  if constexpr (D == 64)
    if (fills(64))
      return launch_fp32_rows<D, 64>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                     causal, sm_scale, stream);
  if (fills(32))
    return launch_fp32_rows<D, 32>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                   causal, sm_scale, stream);
  return launch_fp32_rows<D, 16>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv,
                                 causal, sm_scale, stream);
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
                           sm_scale, device, st);
  if (dtype == 1 && d == 128)
    return launch_fp32<128>(q, k, v, o, lse, b, h, h_kv, s_q, s_kv, causal,
                            sm_scale, device, st);
  return (int)cudaErrorInvalidValue;
}

const char* ray_tpu_cuda_error_string(int code) {
  return flash::error_string(code);
}

}  // extern "C"
