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
// repeating K or V).  Outputs are in the input type.  There are no atomics:
// each output tile is written once by the CTA that owns it, so the results
// are the same bits from run to run, as the TPU pair's are.
//
// Bound at the main shape (llama-1b training: b=4, s_q = s_kv = 1024, h=32,
// h_kv=8, d=64, causal, bf16): 524,800 visible (row, key) pairs per head,
// 67.17 M in all.  dQ does three products (S, dP, dQ), 6*d FLOP a pair:
// 25.8 GFLOP, 26.1 us at 989 TFLOP/s; it moves 59.8 MB, 17.8 us at
// 3.35 TB/s.  dK/dV does four (S, dP, dV, dK), 8*d a pair: 34.4 GFLOP,
// 34.8 us; it moves 51.4 MB, 15.3 us.  Both are bound by the tensor cores'
// operations, not by bytes.
//
// What the design does about it (bf16; fp32 below).  The TPU kernels carry
// their sums in VMEM scratch across sequential grid steps; here each item of
// work owns one output tile and walks the other operand itself, so the fp32
// sums stay in registers and only the outputs go back to device memory.  A
// persistent grid of at most one CTA per SM takes the items longest walk
// first, in the forward's snake order (flash_hopper.cuh).  A CTA is three
// warpgroups, as the forward's: a producer that gives its registers up
// (setmaxnreg) and TMA-loads every tile into mbarrier rings from one
// thread, and two consumers that take turns (ping-pong on two named
// barriers) to issue their wgmma products, so that one's elementwise work
// runs while the other's products hold the tensor cores.  Every product is
// wgmma: the two score-like products (S or S^T, dP or dP^T) from shared
// memory, then the gradient products with P and dS as A operands straight
// from the score accumulators' registers (one cvt per pair; they never
// touch shared memory).  Masks run only on the diagonal and ragged tiles.
//  - dK/dV: one item per (batch, KV head, 128-key tile), each consumer
//    owning 64 keys.  The TPU kernel's sequential (group, q-block) grid axes
//    are the loop inside the item: for each query head of the group, each
//    q tile from the first one that sees the item's keys.  The producer
//    loads K and V once per item (a ring of two items) and streams the Q
//    and dO tiles through a ring of two, on separate barriers so that S^T
//    starts before dO lands; a second producer warp copies each step's LSE
//    and delta into shared memory beside Q, where the consumers read them
//    per column.  In the transposed orientation an accumulator's row is a
//    key and its column a query row: S^T = K Q^T and dP^T = V dO^T read Q
//    and dO K-major, then dV += round(P^T) dO and dK += round(dS^T) Q read
//    the same 128B-swizzled boxes MN-major.  A step takes two turns: S^T
//    and dP^T, then dV and dK.  At d 64 a q tile is 128 rows; at d 128,
//    where dK and dV alone hold 128 registers a thread, it is 64 rows
//    (wgmma m64n64k16).
//  - dQ: one item per (batch, head, 128-row q tile), the forward's items;
//    each consumer owns 64 rows.  Q and dO stay resident (a ring of two
//    items at d 64, one at d 128); K and V stream through rings on
//    separate barriers, V given back as soon as dP is done.  Each thread
//    holds LSE and delta of its two rows in registers.  S = Q K^T and
//    dP = dO V^T read K and V K-major; dQ += round(dS) K reads K MN-major.
//    A tile takes one turn: the last tile's dQ product, then S and dP, so
//    that a consumer's products run back to back (K's ring holds three).
// The exponent is exp2(S * sm_scale * log2 e - LSE * log2 e), one FFMA and
// one MUFU.EX2 a score: there is no running max, so the fused form holds
// for a scale of any sign.  TMA zero-fills rows past s_q and s_kv, and LSE
// and delta read as 0 there, so a padded score would give P = exp(0) = 1:
// keys >= s_kv, and in dK/dV rows >= s_q, are masked explicitly (dQ's
// padded rows get dS = 0 and are not stored), as are rows that see no key.
// Shared memory, dK/dV: 2 x (K + V) + 2 x (Q + dO) + 2 x (LSE + delta) =
// 64 + 64 + 2 KB at d 64, 128 + 64 + 1 KB at d 128; dQ: Q and dO, 3 x K,
// 2 x V = 64 + 48 + 32 KB at d 64, 64 + 96 + 64 KB at d 128.
//
// fp32 inputs take their own kernels (flash_bwd_dq_fp32_kernel,
// flash_bwd_dkv_fp32_kernel), the same two TPU kernels' function in exact
// fp32 FMAs on the CUDA cores: wgmma has no exact fp32 form, and TF32 (or
// 3xTF32) would break fp32's 1e-4 tolerance.  Bounds (67 TFLOP/s fp32,
// 3.35 TB/s): at the Decision Transformer's shape (b 64, s 60, one head of
// 128, causal) dQ 0.0029 ms and dK/dV 0.0035 ms, both bytes (its FMAs at
// peak take 1.3 and 1.8 us); at b 1, s 1024, 32/8 heads, d 64, causal (16.8
// M visible pairs) dQ 0.0962 ms (6.45 GFLOP) and dK/dV 0.1283 ms (8.6
// GFLOP), both operations.  The first design (one CTA of 4 warps per 64-row
// tile, a lane per row, every product written to shared memory and read
// back, synchronous loads) filled 64 of 132 SMs at the DT shape with one
// 4-warp CTA each (186-204 KB of shared memory), and ran each output as one
// chain of D dependent FMAs with two shared loads an FMA: 3-8% of the
// bound at both shapes.  Here (flash_common.cuh, the register-blocked section):
//  - The grid fills the card without sums across CTAs: a dQ CTA owns 64 q
//    rows at d 64 (32 at d 128), halved down to 16 while the grid would
//    not give each SM two CTAs; a dK/dV CTA owns 32 keys, or 16 on such
//    grids (DT: 256 CTAs of 16 rows or keys).  CTAs are numbered with the
//    heads fastest and the longest causal walks first.
//  - Products are register-blocked: each thread accumulates a micro-tile
//    (up to 4 x 4 of S and of dP in dQ; 4 x 4 of S^T or of dP^T in dK/dV,
//    where one half of the CTA computes each; 32 floats of dK and of dV,
//    the q rows of each tile split between warp groups whose sums are
//    added once at the end; up to 8 x 4 of dQ), reading 16-byte
//    operands from rows padded against bank conflicts.  dQ forms P and dS
//    in registers and writes only dS to shared memory; dK/dV writes P^T and
//    dP^T, and dS^T forms in an elementwise pass.
//  - The next K/V tile (dQ) or Q/dO/LSE/delta tile (dK/dV) is copied with
//    cp.async into the second of two stages while the current one is used.
//    46-112 KB of shared memory a CTA: two CTAs (8 warps) an SM.
//  - The exponent is the bf16 kernels' one FFMA and one EX2.
// Still bound by issue and by shared-memory operand traffic (PERF.md): at
// b 1, s 1024, d 64 dK/dV holds 8 floats of S^T and dP^T a thread a key
// step, where an 8 x 8 micro-tile would need 4 x the q rows in shared
// memory.

#include "flash_hopper.cuh"

#include <type_traits>

namespace {

using namespace flash;
using namespace hopper;

// -- bf16: the Hopper kernels ------------------------------------------------

constexpr int STAGES = 2;  // rings: K / V items, Q / dO tiles (dK/dV); V (dQ)
// Registers a thread after setmaxnreg.  A launch holds 168 a thread (one
// CTA of 384 threads an SM), so producer + 2 x consumer must stay within
// 504, or a consumer's setmaxnreg.inc waits forever.  The splits are those
// at which ptxas spills in no instance: the dK/dV producer's stats warp
// needs more than 32, a dQ consumer at d 128 more than 224.
struct RegSplit {
  int producer, consumer;
};
constexpr RegSplit DKV_REGS{48, 224};
constexpr RegSplit DQ_REGS{40, 232};
static_assert(DKV_REGS.producer + 2 * DKV_REGS.consumer <= 3 * 168 &&
                  DQ_REGS.producer + 2 * DQ_REGS.consumer <= 3 * 168,
              "setmaxnreg: more registers than the launch holds");

// acc (64 x N) = A (64 x D) . B (N x D)^T, both K-major in shared memory:
// a and b point at the first of their D / 64 boxes of a_rows and b_rows
// rows.  Issued and committed as one group.
template <int D, int N>
__device__ __forceinline__ void issue_nt(float (&acc)[N / 2],
                                         const unsigned char* a, int a_rows,
                                         const unsigned char* b, int b_rows) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0, N>(
        acc,
        wgmma_desc_kmajor(a + (kk / 4) * a_rows * BOX_BYTES + (kk % 4) * 32),
        wgmma_desc_kmajor(b + (kk / 4) * b_rows * BOX_BYTES + (kk % 4) * 32),
        kk > 0);
  wgmma_commit();
  fence_regs(acc);
}

// acc (64 x D) += A (64 x K, registers) . B (K x D), B MN-major in shared
// memory: K rows of D / 64 boxes, b_rows apart.  Not committed.
template <int D, int K>
__device__ __forceinline__ void issue_nn(float (&acc)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         const unsigned char* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<1, D>(acc, a[kk],
                   wgmma_desc_mnmajor(b + kk * 16 * BOX_BYTES,
                                      b_rows * BOX_BYTES),
                   1);
}

// Write a 64 x D fp32 accumulator as bf16 rows of a [b, s, heads, D]
// tensor: `row0` is this thread's first row (the second is row0 + 8),
// `out` the head's row 0, rows past `rows` are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           const float (&acc)[D / 2],
                                           int row0, int rows, int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= rows) continue;
    bf16* dst = out + (long long)row * row_stride + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// The work of a dK/dV launch: one item per (batch, KV head, 128-key tile),
// numbered with the batches and heads fastest and, under causality, the
// first key tiles (the longest walks) first.
struct KvWork {
  int bhkv, n_kt, n_qt, h, h_kv, s_q, s_kv, causal;
  __host__ __device__ int total() const { return bhkv * n_kt; }
};

struct KvItem {
  int bb, kvh, k0, qt0;  // walks q tiles qt0 .. n_qt - 1 of each head
};

template <int QM>
__device__ __forceinline__ KvItem kv_item_of(const KvWork& w, int index) {
  const int bh = index % w.bhkv;
  KvItem it;
  it.bb = bh / w.h_kv;
  it.kvh = bh % w.h_kv;
  it.k0 = index / w.bhkv * HN;
  // the first row that sees key k0: row + (s_kv - s_q) >= k0
  const int first_row = w.causal ? max(0, it.k0 - (w.s_kv - w.s_q)) : 0;
  it.qt0 = first_row / QM;
  return it;
}

// Shared memory of the dK/dV kernel; every tile on a 1024-byte boundary,
// then the row statistics of each Q stage, the mbarriers last.
template <int D, int QM>
struct DkvSmem {
  static constexpr uint32_t KV_BYTES = HN * D * 2;  // one K or one V tile
  static constexpr uint32_t Q_BYTES = QM * D * 2;   // one Q or one dO tile
  static constexpr uint32_t STAT_BYTES = QM * 4;    // its LSE or delta
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + STAGES * KV_BYTES;
  static constexpr size_t q_off = v_off + STAGES * KV_BYTES;
  static constexpr size_t do_off = q_off + STAGES * Q_BYTES;
  static constexpr size_t lse_off = do_off + STAGES * Q_BYTES;
  static constexpr size_t delta_off = lse_off + STAGES * STAT_BYTES;
  static constexpr size_t bar_off = delta_off + STAGES * STAT_BYTES;
  static constexpr int N_BARS = 6 * STAGES;  // K/V, Q, dO: full and empty
  static constexpr size_t bytes = bar_off + 8 * N_BARS + 1024;  // + align
};

// P^T of one q tile in place on the S^T accumulator: register i is key
// key0 + 8 ((i / 2) % 2) and query row q0 + 8 (i / 4) + col_in + i % 2.
// MASK (the diagonal and ragged tiles): keys >= s_kv, rows >= s_q and keys
// a row does not see get P = 0.
template <bool MASK, int QM>
__device__ __forceinline__ void probs_t(float (&s)[QM / 2],
                                        const float* lse_s, int key0, int q0,
                                        int col_in, const KvWork& w,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < QM / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + col_in);
    const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = ex2(fmaf(s[i], scale_log2, nl[e % 2]));
      if (MASK) {
        const int key = key0 + 8 * (e / 2);
        const int row = q0 + 8 * j + col_in + e % 2;
        if (key >= w.s_kv || row >= w.s_q ||
            (w.causal && key > row + (w.s_kv - w.s_q)))
          p = 0.0f;
      }
      s[i] = p;
    }
  }
}

// Warpgroup 0 is the producer, 1 and 2 the consumers of keys 0-63 and
// 64-127 of each item.  dk and dv are [b, s_kv, h_kv, D].
template <int D, int QM>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            const KvWork work, float sm_scale) {
  using L = DkvSmem<D, QM>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_empty = kv_full + STAGES;
  uint64_t* q_full = kv_empty + STAGES;
  uint64_t* q_empty = q_full + STAGES;
  uint64_t* do_full = q_empty + STAGES;
  uint64_t* do_empty = do_full + STAGES;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&kv_full[st], 1);
      mbar_init(&kv_empty[st], CONSUMER_WARPS);
      mbar_init(&q_full[st], 2);  // the TMA thread and the stats warp
      mbar_init(&q_empty[st], CONSUMER_WARPS);
      mbar_init(&do_full[st], 1);
      mbar_init(&do_empty[st], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int group = work.h / work.h_kv;
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer ------------------------------------------------------------
    // Thread 0 TMA-loads the tiles; warp 1 copies each step's LSE and delta
    // into the Q stage's row statistics (zeros past s_q) and arrives on its
    // full barrier beside the TMA thread.
    regs_dealloc<DKV_REGS.producer>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      RingPos<STAGES> kvpos, pos;
      for (int r = 0;; ++r) {
        const int index = item_index(work.total(), r);
        if (index < 0) break;
        const KvItem it = kv_item_of<QM>(work, index);
        uint64_t* bar = &kv_full[kvpos.stage];
        mbar_wait(&kv_empty[kvpos.stage], kvpos.phase ^ 1);
        mbar_arrive_expect_tx(bar, 2 * L::KV_BYTES);
        for (int j = 0; j < BOXES; ++j) {
          const size_t off = kvpos.stage * L::KV_BYTES + j * HN * BOX_BYTES;
          tma_load_4d(smem + L::k_off + off, &tm_k, bar, 64 * j, it.kvh,
                      it.k0, it.bb);
          tma_load_4d(smem + L::v_off + off, &tm_v, bar, 64 * j, it.kvh,
                      it.k0, it.bb);
        }
        kvpos.advance();
        for (int hh = it.kvh * group; hh < (it.kvh + 1) * group; ++hh)
          for (int q0 = it.qt0 * QM; q0 < work.s_q; q0 += QM) {
            const int st = pos.stage;
            mbar_wait(&q_empty[st], pos.phase ^ 1);
            mbar_arrive_expect_tx(&q_full[st], L::Q_BYTES);
            for (int j = 0; j < BOXES; ++j)
              tma_load_4d(
                  smem + L::q_off + st * L::Q_BYTES + j * QM * BOX_BYTES,
                  &tm_q, &q_full[st], 64 * j, hh, q0, it.bb);
            mbar_wait(&do_empty[st], pos.phase ^ 1);
            mbar_arrive_expect_tx(&do_full[st], L::Q_BYTES);
            for (int j = 0; j < BOXES; ++j)
              tma_load_4d(
                  smem + L::do_off + st * L::Q_BYTES + j * QM * BOX_BYTES,
                  &tm_do, &do_full[st], 64 * j, hh, q0, it.bb);
            pos.advance();
          }
      }
    } else if (threadIdx.x / 32 == 1) {
      RingPos<STAGES> pos;
      for (int r = 0;; ++r) {
        const int index = item_index(work.total(), r);
        if (index < 0) break;
        const KvItem it = kv_item_of<QM>(work, index);
        for (int hh = it.kvh * group; hh < (it.kvh + 1) * group; ++hh) {
          const long long head = ((long long)it.bb * work.h + hh) * work.s_q;
          for (int q0 = it.qt0 * QM; q0 < work.s_q; q0 += QM) {
            const int st = pos.stage;
            float* lse_s = reinterpret_cast<float*>(smem + L::lse_off +
                                                    st * L::STAT_BYTES);
            float* delta_s = reinterpret_cast<float*>(smem + L::delta_off +
                                                      st * L::STAT_BYTES);
            mbar_wait(&q_empty[st], pos.phase ^ 1);
#pragma unroll
            for (int i = lane; i < QM; i += 32) {
              const bool ok = q0 + i < work.s_q;
              lse_s[i] = ok ? lse[head + q0 + i] : 0.0f;
              delta_s[i] = ok ? delta[head + q0 + i] : 0.0f;
            }
            __syncwarp();  // the warp's stores before lane 0's arrival
            if (lane == 0) mbar_arrive(&q_full[st]);
            pos.advance();
          }
        }
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  // Per q tile: S^T and dP^T issued in one turn; P^T while dP^T runs; dS^T;
  // then dV and dK in the next turn, waited for before the tile's Q and dO
  // are given back.
  regs_alloc<DKV_REGS.consumer>();
  const int cw = wg - 1;  // keys 64 cw .. 64 cw + 63 of the item
  const Turns turn{cw};  // both walk every step of every item
  turn.begin();
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32;
  const int key_in = cw * 64 + warp * 16 + lane / 4;  // and key_in + 8
  const int col_in = 2 * (lane % 4);  // columns col_in + 8 j + {0, 1}
  const int q_offset = work.s_kv - work.s_q;
  const float scale_log2 = sm_scale * LOG2E;

  float dk_acc[D / 2], dv_acc[D / 2];
  RingPos<STAGES> kvpos, pos;

  for (int r = 0;; ++r) {
    const int index = item_index(work.total(), r);
    if (index < 0) break;
    const KvItem it = kv_item_of<QM>(work, index);
    const int kc0 = it.k0 + cw * 64;  // this consumer's first key
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    const unsigned char* k_s =
        smem + L::k_off + kvpos.stage * L::KV_BYTES + cw * 64 * BOX_BYTES;
    const unsigned char* v_s =
        smem + L::v_off + kvpos.stage * L::KV_BYTES + cw * 64 * BOX_BYTES;
    mbar_wait(&kv_full[kvpos.stage], kvpos.phase);

    for (int step = 0; step < group * (work.n_qt - it.qt0); ++step) {
      const int q0 = (it.qt0 + step % (work.n_qt - it.qt0)) * QM;
      const int st = pos.stage;
      const unsigned char* q_s = smem + L::q_off + st * L::Q_BYTES;
      const unsigned char* do_s = smem + L::do_off + st * L::Q_BYTES;
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::lse_off + st * L::STAT_BYTES);
      const float* delta_s = reinterpret_cast<const float*>(
          smem + L::delta_off + st * L::STAT_BYTES);
      float s[QM / 2], dp[QM / 2];

      mbar_wait(&q_full[st], pos.phase);
      turn.wait();
      issue_nt<D, QM>(s, k_s, HN, q_s, QM);     // S^T = K Q^T
      mbar_wait(&do_full[st], pos.phase);
      issue_nt<D, QM>(dp, v_s, HN, do_s, QM);   // dP^T = V dO^T
      turn.pass();

      wgmma_wait<1>();  // S^T is done, dP^T may still run
      fence_regs(s);
      if (kc0 + 64 > work.s_kv || q0 + QM > work.s_q ||
          (work.causal && kc0 + 63 > q0 + q_offset))
        probs_t<true, QM>(s, lse_s, it.k0 + key_in, q0, col_in, work,
                          scale_log2);
      else
        probs_t<false, QM>(s, lse_s, it.k0 + key_in, q0, col_in, work,
                           scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - delta) sm_scale, in place
#pragma unroll
      for (int j = 0; j < QM / 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + col_in);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - (e % 2 ? d2.y : d2.x)) * sm_scale;
        }
      }
      uint32_t pa[QM / 16][4], dsa[QM / 16][4];
      pack_a<QM>(pa, s);
      pack_a<QM>(dsa, dp);

      turn.wait();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      issue_nn<D, QM>(dv_acc, pa, do_s, QM);    // dV += round(P^T) dO
      issue_nn<D, QM>(dk_acc, dsa, q_s, QM);    // dK += round(dS^T) Q
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      release(&q_empty[st], lane);
      release(&do_empty[st], lane);
      pos.advance();
    }
    release(&kv_empty[kvpos.stage], lane);
    kvpos.advance();

    const long long row_stride = (long long)work.h_kv * D;
    const long long head = (long long)it.bb * work.s_kv * row_stride +
                           (long long)it.kvh * D;
    store_rows<D>(dk + head, row_stride, dk_acc, it.k0 + key_in, work.s_kv,
                  lane);
    store_rows<D>(dv + head, row_stride, dv_acc, it.k0 + key_in, work.s_kv,
                  lane);
  }
}

// Shared memory of the dQ kernel: Q and dO of the resident items, then the
// K and V rings, every tile on a 1024-byte boundary; the mbarriers last.
// A K tile is read by its dQ product, issued in the next tile's turn, so
// its ring holds three.
template <int D>
struct DqSmem {
  static constexpr int Q_STAGES = D == 64 ? 2 : 1;  // items resident
  static constexpr int K_STAGES = 3;
  static constexpr uint32_t Q_BYTES = HM * D * 2;   // one Q or one dO tile
  static constexpr uint32_t KV_BYTES = HN * D * 2;  // one K or one V tile
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + Q_STAGES * Q_BYTES;
  static constexpr size_t k_off = do_off + Q_STAGES * Q_BYTES;
  static constexpr size_t v_off = k_off + K_STAGES * KV_BYTES;
  static constexpr size_t bar_off = v_off + STAGES * KV_BYTES;
  // full and empty
  static constexpr int N_BARS = 4 * Q_STAGES + 2 * K_STAGES + 2 * STAGES;
  static constexpr size_t bytes = bar_off + 8 * N_BARS + 1024;  // + align
};

// P of one k tile in place on the S accumulator: register i is row
// row0 + 8 ((i / 2) % 2) and key k0 + 8 (i / 4) + col_in + i % 2; nl holds
// -LSE log2 e of the two rows.  MASK (the diagonal and ragged tiles): keys
// >= s_kv and keys a row does not see get P = 0.  Rows >= s_q read Q, dO,
// LSE and delta as zeros, so their dS is 0, and they are not written.
template <bool MASK>
__device__ __forceinline__ void probs(float (&s)[HN / 2],
                                      const float (&nl)[2], int row0, int k0,
                                      int col_in, const Work& w,
                                      float scale_log2) {
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) {
    float p = ex2(fmaf(s[i], scale_log2, nl[(i / 2) % 2]));
    if (MASK) {
      const int key = k0 + 8 * (i / 4) + col_in + i % 2;
      const int row = row0 + 8 * ((i / 2) % 2);
      if (key >= w.s_kv || (w.causal && key > row + (w.s_kv - w.s_q)))
        p = 0.0f;
    }
    s[i] = p;
  }
}

// Warpgroup 0 is the producer, 1 and 2 the consumers of rows 0-63 and
// 64-127 of each item's q tile.  LSE and delta are [b, h, s_q]; dq is
// [b, s_q, h, D].
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, const Work work,
                           float sm_scale) {
  using L = DqSmem<D>;
  constexpr int QS = L::Q_STAGES;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_empty = q_full + QS;
  uint64_t* do_full = q_empty + QS;
  uint64_t* do_empty = do_full + QS;
  uint64_t* k_full = do_empty + QS;
  uint64_t* k_empty = k_full + L::K_STAGES;
  uint64_t* v_full = k_empty + L::K_STAGES;
  uint64_t* v_empty = v_full + STAGES;

  if (threadIdx.x == 0) {
    for (int st = 0; st < QS; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], CONSUMER_WARPS);
      mbar_init(&do_full[st], 1);
      mbar_init(&do_empty[st], CONSUMER_WARPS);
    }
    for (int st = 0; st < L::K_STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&k_empty[st], CONSUMER_WARPS);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // -- producer ------------------------------------------------------------
    regs_dealloc<DQ_REGS.producer>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      RingPos<L::K_STAGES> kpos;
      RingPos<STAGES> vpos;
      RingPos<QS> qpos;
      for (int r = 0;; ++r) {
        const int index = item_index(work.total(), r);
        if (index < 0) break;
        const Item it = item_of(work, index);
        const int st = qpos.stage;
        mbar_wait(&q_empty[st], qpos.phase ^ 1);
        mbar_arrive_expect_tx(&q_full[st], L::Q_BYTES);
        for (int j = 0; j < BOXES; ++j)
          tma_load_4d(smem + L::q_off + st * L::Q_BYTES + j * HM * BOX_BYTES,
                      &tm_q, &q_full[st], 64 * j, it.hh, it.q0, it.bb);
        mbar_wait(&do_empty[st], qpos.phase ^ 1);
        mbar_arrive_expect_tx(&do_full[st], L::Q_BYTES);
        for (int j = 0; j < BOXES; ++j)
          tma_load_4d(smem + L::do_off + st * L::Q_BYTES + j * HM * BOX_BYTES,
                      &tm_do, &do_full[st], 64 * j, it.hh, it.q0, it.bb);
        qpos.advance();
        for (int t = 0; t < it.n_tiles; ++t) {
          unsigned char* k_s = smem + L::k_off + kpos.stage * L::KV_BYTES;
          unsigned char* v_s = smem + L::v_off + vpos.stage * L::KV_BYTES;
          mbar_wait(&k_empty[kpos.stage], kpos.phase ^ 1);
          mbar_arrive_expect_tx(&k_full[kpos.stage], L::KV_BYTES);
          for (int j = 0; j < BOXES; ++j)
            tma_load_4d(k_s + j * HN * BOX_BYTES, &tm_k, &k_full[kpos.stage],
                        64 * j, it.kvh, t * HN, it.bb);
          mbar_wait(&v_empty[vpos.stage], vpos.phase ^ 1);
          mbar_arrive_expect_tx(&v_full[vpos.stage], L::KV_BYTES);
          for (int j = 0; j < BOXES; ++j)
            tma_load_4d(v_s + j * HN * BOX_BYTES, &tm_v, &v_full[vpos.stage],
                        64 * j, it.kvh, t * HN, it.bb);
          kpos.advance();
          vpos.advance();
        }
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  // Tile t's turn issues tile t-1's dQ += round(dS) K, then S_t, then dP_t
  // once dQ is done (its A fragment's registers are dP's), and gives
  // K_{t-1} back; P_t runs while dP_t does, then V_t goes back, then dS_t
  // and its A fragment.  So the tensor cores run one consumer's products
  // back to back while the other's elementwise work runs.
  regs_alloc<DQ_REGS.consumer>();
  const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the item
  const Turns turn{cw};  // both walk every step of every item
  turn.begin();
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32;
  const int row_in = cw * 64 + warp * 16 + lane / 4;  // and row_in + 8
  const int col_in = 2 * (lane % 4);
  const int q_offset = work.s_kv - work.s_q;
  const float scale_log2 = sm_scale * LOG2E;

  float acc[D / 2];
  uint32_t dsa[HN / 16][4];  // round(dS) of the last tile
  RingPos<L::K_STAGES> kpos, kprev;  // this tile's K stage, the last's
  RingPos<STAGES> vpos;
  RingPos<QS> qpos;

  auto issue_grad = [&]() {  // dQ += round(dS) K of the last tile
    fence_regs(acc);
    fence_regs(dsa);
    wgmma_fence();
    issue_nn<D, HN>(acc, dsa, smem + L::k_off + kprev.stage * L::KV_BYTES,
                    HN);
    wgmma_commit();
  };
  auto grad_done = [&]() {  // after the wait: its K goes back
    fence_regs(acc);
    fence_regs(dsa);
    release(&k_empty[kprev.stage], lane);
    kprev.advance();
  };

  for (int r = 0;; ++r) {
    const int index = item_index(work.total(), r);
    if (index < 0) break;
    const Item it = item_of(work, index);
    const int row0 = it.q0 + row_in;
    const int first_row_pos = it.q0 + cw * 64 + q_offset;
    float nl[2], dl[2];  // -LSE log2 e and delta of the thread's rows
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      const long long stat =
          ((long long)it.bb * work.h + it.hh) * work.s_q + row;
      nl[rr] = row < work.s_q ? -lse[stat] * LOG2E : 0.0f;
      dl[rr] = row < work.s_q ? delta[stat] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    const int qst = qpos.stage;
    const unsigned char* q_s =
        smem + L::q_off + qst * L::Q_BYTES + cw * 64 * BOX_BYTES;
    const unsigned char* do_s =
        smem + L::do_off + qst * L::Q_BYTES + cw * 64 * BOX_BYTES;
    mbar_wait(&q_full[qst], qpos.phase);
    mbar_wait(&do_full[qst], qpos.phase);

    // one k tile; the first of an item has no last tile's dQ to issue
    auto tile_of = [&](auto with_grad, int t) {
      constexpr bool GRAD = decltype(with_grad)::value;
      const int k0 = t * HN;
      const unsigned char* k_s = smem + L::k_off + kpos.stage * L::KV_BYTES;
      const unsigned char* v_s = smem + L::v_off + vpos.stage * L::KV_BYTES;
      float s[HN / 2], dp[HN / 2];

      mbar_wait(&k_full[kpos.stage], kpos.phase);
      turn.wait();
      if constexpr (GRAD) issue_grad();
      issue_nt<D, HN>(s, q_s, HM, k_s, HN);     // S = Q K^T
      if constexpr (GRAD) {
        wgmma_wait<1>();  // the last tile's dQ is done
        grad_done();
      }
      mbar_wait(&v_full[vpos.stage], vpos.phase);
      issue_nt<D, HN>(dp, do_s, HM, v_s, HN);   // dP = dO V^T
      turn.pass();

      wgmma_wait<1>();  // S is done, dP may still run
      fence_regs(s);
      if (k0 + HN > work.s_kv || (work.causal && k0 + HN - 1 > first_row_pos))
        probs<true>(s, nl, row0, k0, col_in, work, scale_log2);
      else
        probs<false>(s, nl, row0, k0, col_in, work, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
      release(&v_empty[vpos.stage], lane);
      vpos.advance();
      // dS = P (dP - delta) sm_scale, in place
#pragma unroll
      for (int i = 0; i < HN / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]) * sm_scale;
      pack_a<HN>(dsa, dp);
      kpos.advance();
    };
    if (it.n_tiles > 0) {
      tile_of(std::false_type{}, 0);
      for (int t = 1; t < it.n_tiles; ++t) tile_of(std::true_type{}, t);
      turn.wait();  // the item's last dQ product
      issue_grad();
      turn.pass();
      wgmma_wait<0>();
      grad_done();
    }
    release(&q_empty[qst], lane);
    release(&do_empty[qst], lane);
    qpos.advance();

    const long long row_stride = (long long)work.h * D;
    store_rows<D>(dq + (long long)it.bb * work.s_q * row_stride +
                      (long long)it.hh * D,
                  row_stride, acc, row0, work.s_q, lane);
  }
}

template <int D>
int launch_dkv_hopper(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int b, int h, int h_kv, int s_q,
                      int s_kv, int causal, float sm_scale, int device,
                      cudaStream_t stream) {
  constexpr int QM = D == 64 ? HM : 64;  // q rows a step: registers at d 128
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_head_map(&tm_q, q, b, s_q, h, D, QM);
  if (!err) err = encode_head_map(&tm_do, dout, b, s_q, h, D, QM);
  if (!err) err = encode_head_map(&tm_k, k, b, s_kv, h_kv, D, HN);
  if (!err) err = encode_head_map(&tm_v, v, b, s_kv, h_kv, D, HN);
  if (err) return err;
  const auto kernel = flash_bwd_dkv_hopper_kernel<D, QM>;
  constexpr size_t smem = DkvSmem<D, QM>::bytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const KvWork work{b * h_kv, (s_kv + HN - 1) / HN, (s_q + QM - 1) / QM,
                    h, h_kv, s_q, s_kv, causal};
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = work.total() < sms ? work.total() : sms;
  kernel<<<grid, HOPPER_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), work, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_hopper(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int b, int h, int h_kv, int s_q, int s_kv,
                     int causal, float sm_scale, int device,
                     cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = encode_head_map(&tm_q, q, b, s_q, h, D, HM);
  if (!err) err = encode_head_map(&tm_do, dout, b, s_q, h, D, HM);
  if (!err) err = encode_head_map(&tm_k, k, b, s_kv, h_kv, D, HN);
  if (!err) err = encode_head_map(&tm_v, v, b, s_kv, h_kv, D, HN);
  if (err) return err;
  const auto kernel = flash_bwd_dq_hopper_kernel<D>;
  constexpr size_t smem = DqSmem<D>::bytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const Work work{b * h, (s_q + HM - 1) / HM, h, h_kv, s_q, s_kv, causal};
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = work.total() < sms ? work.total() : sms;
  kernel<<<grid, HOPPER_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), work,
      sm_scale);
  return (int)cudaGetLastError();
}

// -- fp32: register-blocked scalar FMAs -------------------------------------

// dQ: a CTA owns BM q rows of one (batch, head) and walks the keys in
// tiles of DQ_BN; K and V tiles stream through two cp.async stages.  Each
// thread computes its elements of both S and dP, so P and dS form in
// registers and only dS goes to shared memory.  Shared memory: Q, dO (BM
// rows), 2 x (K, V) (DQ_BN rows), dS (BM x DQ_BN, rows padded by 8 floats).
constexpr int DQ_BN = 32;

template <int D, int BM>
struct DqFp32 {
  static constexpr int LDT = D + 4, LDS = DQ_BN + 8;
  using S = NtGrid<BM, DQ_BN>;  // S, dP: rows x keys
  using G = NnGrid<BM, D>;      // dQ: rows x D
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(float) * BM * LDT;
  static constexpr size_t k_off = do_off + sizeof(float) * BM * LDT;
  static constexpr size_t v_off = k_off + sizeof(float) * 2 * DQ_BN * LDT;
  static constexpr size_t ds_off = v_off + sizeof(float) * 2 * DQ_BN * LDT;
  static constexpr size_t bytes = ds_off + sizeof(float) * BM * LDS;
};

// dK/dV: a CTA owns BN keys of one (batch, KV head) and walks, for each
// query head of the group, the q tiles of QM rows from the first that sees
// its keys; Q, dO, LSE and delta stream through two cp.async stages.  One
// half of the CTA (HALF threads) computes S^T and P^T, the other dP^T, each
// over the whole tile, so that a thread holds twice the elements of one
// product rather than its share of both; P^T and dP^T meet in shared
// memory, where dS^T forms in an elementwise pass.  The gradient products
// split each q tile's rows between SPLIT groups of warps, so that a thread
// holds 32 floats of dK and of dV (4 keys x 8 columns or 8 x 4: 0.375
// operand floats an FMA), and the groups' sums are added once, in a fixed
// order, at the end.  Shared memory: K, V (BN rows), 2 x (Q, dO) (QM rows;
// the groups' sums at the end), P^T and dP^T / dS^T (BN x QM, rows padded
// by 8 floats), 2 x (LSE, delta).
constexpr int HALF = F32_THREADS / 2;

template <int D, int BN>
struct DkvFp32 {
  static constexpr int QM = D == 64 ? 64 : 32;
  static constexpr int LDT = D + 4, LDS = QM + 8;
  static constexpr int GROUP = BN * D / 32 < F32_THREADS ? BN * D / 32
                                                         : F32_THREADS;
  static constexpr int SPLIT = F32_THREADS / GROUP, ROWS = QM / SPLIT;
  using S = NtGrid<BN, QM, HALF>;   // S^T or dP^T: keys x rows
  using G = NnGrid<BN, D, GROUP>;   // dK, dV: keys x D, a group's share
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(float) * BN * LDT;
  static constexpr size_t q_off = v_off + sizeof(float) * BN * LDT;
  static constexpr size_t do_off = q_off + sizeof(float) * 2 * QM * LDT;
  static constexpr size_t pt_off = do_off + sizeof(float) * 2 * QM * LDT;
  static constexpr size_t ds_off = pt_off + sizeof(float) * BN * LDS;
  static constexpr size_t lse_off = ds_off + sizeof(float) * BN * LDS;
  static constexpr size_t dl_off = lse_off + sizeof(float) * 2 * QM;
  static constexpr size_t bytes = dl_off + sizeof(float) * 2 * QM;
  static_assert(GROUP % 32 == 0 && ROWS % 4 == 0 &&
                    sizeof(float) * SPLIT * 2 * BN * D <= pt_off - q_off,
                "the groups' sums must fit where Q and dO were");
};

// Two CTAs an SM (8 warps): every configuration's shared memory fits twice
// into the SM's 228 KB.
static_assert(2 * (DqFp32<64, 64>::bytes + 1024) <= 233472 &&
                  2 * (DqFp32<128, 32>::bytes + 1024) <= 233472 &&
                  2 * (DkvFp32<64, 32>::bytes + 1024) <= 233472 &&
                  2 * (DkvFp32<128, 32>::bytes + 1024) <= 233472,
              "an fp32 configuration no longer fits twice an SM");

// dS^T = P^T (dP^T - delta) sm_scale over a tile of R keys x C q rows in
// shared memory (rows LD floats apart), in place of dP^T; delta is per q
// row.
template <int R, int C, int LD>
__device__ __forceinline__ void scores_to_ds(const float* p, float* dp,
                                             const float* delta,
                                             float sm_scale) {
  for (int f = threadIdx.x; f < R * C / 4; f += F32_THREADS) {
    const int r = f / (C / 4), c = (f % (C / 4)) * 4;
    const float4 pv = *reinterpret_cast<const float4*>(p + r * LD + c);
    float4* out = reinterpret_cast<float4*>(dp + r * LD + c);
    const float4 dv = *out;
    const float4 dl = *reinterpret_cast<const float4*>(delta + c);
    *out = make_float4(pv.x * (dv.x - dl.x) * sm_scale,
                       pv.y * (dv.y - dl.y) * sm_scale,
                       pv.z * (dv.z - dl.z) * sm_scale,
                       pv.w * (dv.w - dl.w) * sm_scale);
  }
}

// Grid: one CTA per (batch, head, BM-row q tile), numbered with the heads
// and batches fastest and, under causality, the last q tiles (the longest
// walks) first, so that the walks left for the last CTAs are the shortest.
// Inputs are contiguous [b, s, heads, D] (q, dout, dq: h heads; k, v: h_kv
// heads); LSE and delta are [b, h, s_q].
template <int D, int BM>
__global__ void __launch_bounds__(F32_THREADS, 2)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int h, int h_kv, int s_q,
                         int s_kv, int causal, float sm_scale) {
  using L = DqFp32<D, BM>;
  using S = typename L::S;
  using G = typename L::G;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* do_s = reinterpret_cast<float*>(smem + L::do_off);
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds_off);

  const int n_qt = (s_q + BM - 1) / BM, bh_all = gridDim.x / n_qt;
  const int rank = blockIdx.x / bh_all, bh = blockIdx.x % bh_all;
  const int q0 = (causal ? n_qt - 1 - rank : rank) * BM;
  const int hh = bh % h, bb = bh / h;
  const int kvh = hh / (h / h_kv);
  const int q_offset = s_kv - s_q;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const float* q_b = q + (long long)bb * s_q * q_stride + (long long)hh * D;
  const float* do_b = dout + (long long)bb * s_q * q_stride + (long long)hh * D;
  const float* k_b = k + (long long)bb * s_kv * kv_stride + (long long)kvh * D;
  const float* v_b = v + (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  int n_tiles = (s_kv + DQ_BN - 1) / DQ_BN;
  if (causal) {  // skip key tiles wholly above the diagonal of these rows
    const int last_key = min(q0 + BM, s_q) - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / DQ_BN + 1);
  }
  load_tile_async<D, BM>(q_s, q_b, q_stride, q0, s_q);
  load_tile_async<D, BM>(do_s, do_b, q_stride, q0, s_q);
  if (n_tiles > 0) {
    load_tile_async<D, DQ_BN>(k_s, k_b, kv_stride, 0, s_kv);
    load_tile_async<D, DQ_BN>(v_s, v_b, kv_stride, 0, s_kv);
  }
  cp_async_commit();

  // -LSE log2 e and delta of this thread's rows of S
  const int2 sp = grid_pos<S::TX>(threadIdx.x);
  const float scale_log2 = sm_scale * LOG2E;
  const long long stat = ((long long)bb * h + hh) * s_q;
  float nl[S::TM], dl[S::TM];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = q0 + sp.y + i * S::TY;
    nl[i] = row < s_q ? -lse[stat + row] * LOG2E : 0.0f;
    dl[i] = row < s_q ? delta[stat + row] : 0.0f;
  }
  const int2 gp = grid_pos<G::TX>(threadIdx.x);
  float4 acc[G::TM][G::TV];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every thread is done with tile t - 1's stage
    // and with dS
    cp_async_wait<0>();
    __syncthreads();
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int nx = (st ^ 1) * DQ_BN * L::LDT;
      load_tile_async<D, DQ_BN>(k_s + nx, k_b, kv_stride, (t + 1) * DQ_BN,
                                s_kv);
      load_tile_async<D, DQ_BN>(v_s + nx, v_b, kv_stride, (t + 1) * DQ_BN,
                                s_kv);
    }
    cp_async_commit();
    const float* k_t = k_s + st * DQ_BN * L::LDT;
    const float* v_t = v_s + st * DQ_BN * L::LDT;

    float s[S::TM][S::TN], dp[S::TM][S::TN];
    nt_pair<D, S::TM, S::TN, S::TY, S::TX>(s, dp, q_s, k_t, do_s, v_t, sp.y,
                                           sp.x);
    const int k0 = t * DQ_BN;
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = sp.y + i * S::TY, row = q0 + r;
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        const int c = sp.x + j * S::TX, col = k0 + c;
        const bool visible = row < s_q && col < s_kv &&
                             (!causal || row + q_offset >= col);
        const float p = visible ? ex2(fmaf(s[i][j], scale_log2, nl[i])) : 0.f;
        ds_s[r * L::LDS + c] = p * (dp[i][j] - dl[i]) * sm_scale;
      }
    }
    __syncthreads();
    nn_acc<DQ_BN, L::LDS, D, G::TM, G::TV, G::TY, G::TX>(acc, ds_s, k_t,
                                                        gp.y, gp.x);
  }

#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int row = q0 + gp.y + i * G::TY;
    if (row >= s_q) continue;
    float* out = dq + (long long)bb * s_q * q_stride + (long long)hh * D +
                 (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < G::TV; ++j)
      *reinterpret_cast<float4*>(out + (gp.x + j * G::TX) * 4) = acc[i][j];
  }
}

// Grid: one CTA per (batch, KV head, BN-key slice), numbered with the KV
// heads and batches fastest and the first slices (the longest walks under
// causality) first.  dk and dv are [b, s_kv, h_kv, D].  In S^T and dP^T a
// thread's rows are keys and its columns the q tile's rows.
template <int D, int BN>
__global__ void __launch_bounds__(F32_THREADS, 2)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int h, int h_kv, int s_q, int s_kv, int causal,
                          float sm_scale) {
  using L = DkvFp32<D, BN>;
  using S = typename L::S;
  using G = typename L::G;
  constexpr int QM = L::QM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* do_s = reinterpret_cast<float*>(smem + L::do_off);
  float* pt_s = reinterpret_cast<float*>(smem + L::pt_off);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);

  const int bh_all = gridDim.x / ((s_kv + BN - 1) / BN);
  const int k0 = blockIdx.x / bh_all * BN, bh = blockIdx.x % bh_all;
  const int kvh = bh % h_kv, bb = bh / h_kv;
  const int group = h / h_kv;
  const int q_offset = s_kv - s_q;
  const long long q_stride = (long long)h * D, kv_stride = (long long)h_kv * D;
  const long long kv_base =
      (long long)bb * s_kv * kv_stride + (long long)kvh * D;

  // the first q tile with a row that sees key k0: row + q_offset >= k0
  const int n_q = (s_q + QM - 1) / QM;
  const int qt0 = causal && k0 - q_offset > 0 ? (k0 - q_offset) / QM : 0;
  const int per_head = n_q - qt0 > 0 ? n_q - qt0 : 0;
  const int steps = group * per_head;

  // step i: query head kvh * group + i / per_head, q tile qt0 + i % per_head
  auto issue = [&](int i, int stage) {
    const int hh = kvh * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * QM;
    const long long base = (long long)bb * s_q * q_stride + (long long)hh * D;
    load_tile_async<D, QM>(q_s + stage * QM * L::LDT, q + base, q_stride, q0,
                           s_q);
    load_tile_async<D, QM>(do_s + stage * QM * L::LDT, dout + base, q_stride,
                           q0, s_q);
    const long long stat = ((long long)bb * h + hh) * s_q;
    for (int r = threadIdx.x; r < QM; r += F32_THREADS) {
      const bool ok = q0 + r < s_q;
      cp_async4(lse_s + stage * QM + r, lse + stat + (ok ? q0 + r : 0), ok);
      cp_async4(dl_s + stage * QM + r, delta + stat + (ok ? q0 + r : 0), ok);
    }
  };
  load_tile_async<D, BN>(k_s, k + kv_base, kv_stride, k0, s_kv);
  load_tile_async<D, BN>(v_s, v + kv_base, kv_stride, k0, s_kv);
  if (steps > 0) issue(0, 0);
  cp_async_commit();

  // the first half computes S^T and P^T, the second dP^T
  const bool scores = threadIdx.x < HALF;
  const int2 sp = grid_pos<S::TX>(threadIdx.x % HALF);
  const int group_id = threadIdx.x / L::GROUP;  // its rows of each q tile
  const int2 gp = grid_pos<G::TX>(threadIdx.x % L::GROUP);
  const float scale_log2 = sm_scale * LOG2E;
  float4 acc_k[G::TM][G::TV], acc_v[G::TM][G::TV];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TV; ++j)
      acc_k[i][j] = acc_v[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < steps; ++i) {
    // step i has landed, and every thread is done with step i - 1's stage
    // and with P^T, dS^T
    cp_async_wait<0>();
    __syncthreads();
    const int st = i & 1;
    if (i + 1 < steps) issue(i + 1, st ^ 1);
    cp_async_commit();
    const float* q_t = q_s + st * QM * L::LDT;
    const float* do_t = do_s + st * QM * L::LDT;
    const float* lse_t = lse_s + st * QM;
    const float* dl_t = dl_s + st * QM;
    const int q0 = (qt0 + i % per_head) * QM;

    float s[S::TM][S::TN];
    nt_prod<D, S::TM, S::TN, S::TY, S::TX>(s, scores ? k_s : v_s,
                                           scores ? q_t : do_t, sp.y, sp.x);
    if (scores) {
      float nl[S::TN];
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
        nl[j] = -lse_t[sp.x + j * S::TX] * LOG2E;
#pragma unroll
      for (int a = 0; a < S::TM; ++a) {
        const int r = sp.y + a * S::TY, key = k0 + r;
#pragma unroll
        for (int j = 0; j < S::TN; ++j) {
          const int c = sp.x + j * S::TX, row = q0 + c;
          const bool visible = key < s_kv && row < s_q &&
                               (!causal || row + q_offset >= key);
          pt_s[r * L::LDS + c] =
              visible ? ex2(fmaf(s[a][j], scale_log2, nl[j])) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < S::TM; ++a)
#pragma unroll
        for (int j = 0; j < S::TN; ++j)
          ds_s[(sp.y + a * S::TY) * L::LDS + sp.x + j * S::TX] = s[a][j];
    }
    __syncthreads();
    scores_to_ds<BN, QM, L::LDS>(pt_s, ds_s, dl_t, sm_scale);
    __syncthreads();
    const int m0 = group_id * L::ROWS;
    nn_acc<L::ROWS, L::LDS, D, G::TM, G::TV, G::TY, G::TX>(
        acc_v, pt_s + m0, do_t + m0 * L::LDT, gp.y, gp.x);
    nn_acc<L::ROWS, L::LDS, D, G::TM, G::TV, G::TY, G::TX>(
        acc_k, ds_s + m0, q_t + m0 * L::LDT, gp.y, gp.x);
  }

  // every group's sums to shared memory (where Q and dO were), then each
  // output float4 as the sum over the groups in order
  cp_async_wait<0>();
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem + L::q_off);  // [SPLIT][2][BN][D]
#pragma unroll
  for (int a = 0; a < G::TM; ++a)
#pragma unroll
    for (int j = 0; j < G::TV; ++j) {
      const int at = (gp.y + a * G::TY) * D + (gp.x + j * G::TX) * 4;
      *reinterpret_cast<float4*>(sums + (group_id * 2) * BN * D + at) =
          acc_k[a][j];
      *reinterpret_cast<float4*>(sums + (group_id * 2 + 1) * BN * D + at) =
          acc_v[a][j];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * BN * D / 4; i += F32_THREADS) {
    const int which = i / (BN * D / 4), at = (i % (BN * D / 4)) * 4;
    const int key = k0 + at / D;
    float4 sum = *reinterpret_cast<const float4*>(sums + which * BN * D + at);
#pragma unroll
    for (int g = 1; g < L::SPLIT; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(
          sums + (g * 2 + which) * BN * D + at);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (key < s_kv)
      *reinterpret_cast<float4*>((which ? dv : dk) + kv_base +
                                 (long long)key * kv_stride + at % D) = sum;
  }
}

template <int D, int BM>
int launch_dq_fp32_rows(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int b, int h, int h_kv, int s_q, int s_kv,
                        int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = DqFp32<D, BM>::bytes;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_fp32_kernel<D, BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (s_q + BM - 1) / BM * b * h;
  flash_bwd_dq_fp32_kernel<D, BM><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, h_kv, s_q, s_kv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, int BN>
int launch_dkv_fp32_keys(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int b, int h,
                         int h_kv, int s_q, int s_kv, int causal,
                         float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = DkvFp32<D, BN>::bytes;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_fp32_kernel<D, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (s_kv + BN - 1) / BN * b * h_kv;
  flash_bwd_dkv_fp32_kernel<D, BN><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv, s_q, s_kv,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

// The largest slice (BM q rows: 64 at d 64, 32 at d 128; BN keys: 32) that
// still gives two CTAs for each SM, halved down to 16 while it does not.
template <int D>
int launch_dq_fp32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int h, int h_kv, int s_q, int s_kv,
                   int causal, float sm_scale, int device,
                   cudaStream_t stream) {
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const auto fills = [&](int rows) {
    return (long long)b * h * ((s_q + rows - 1) / rows) >= 2LL * sms;
  };
  if constexpr (D == 64)
    if (fills(64))
      return launch_dq_fp32_rows<D, 64>(q, k, v, dout, lse, delta, dq, b, h,
                                        h_kv, s_q, s_kv, causal, sm_scale,
                                        stream);
  if (fills(32))
    return launch_dq_fp32_rows<D, 32>(q, k, v, dout, lse, delta, dq, b, h,
                                      h_kv, s_q, s_kv, causal, sm_scale,
                                      stream);
  return launch_dq_fp32_rows<D, 16>(q, k, v, dout, lse, delta, dq, b, h, h_kv,
                                    s_q, s_kv, causal, sm_scale, stream);
}

template <int D>
int launch_dkv_fp32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int b, int h, int h_kv, int s_q,
                    int s_kv, int causal, float sm_scale, int device,
                    cudaStream_t stream) {
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  if ((long long)b * h_kv * ((s_kv + 31) / 32) >= 2LL * sms)
    return launch_dkv_fp32_keys<D, 32>(q, k, v, dout, lse, delta, dk, dv, b,
                                       h, h_kv, s_q, s_kv, causal, sm_scale,
                                       stream);
  return launch_dkv_fp32_keys<D, 16>(q, k, v, dout, lse, delta, dk, dv, b, h,
                                     h_kv, s_q, s_kv, causal, sm_scale,
                                     stream);
}

bool bad_shape(int b, int h, int h_kv, int s_q, int s_kv) {
  return b < 1 || h < 1 || h_kv < 1 || h % h_kv || s_q < 1 || s_kv < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32.  Each returns 0, the cudaError_t of its
// launch, or a tensor-map error (hopper::TMAP_ERROR + the CUresult of the
// refused encode).
int ray_tpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int dtype, int b, int h, int h_kv, int s_q,
                         int s_kv, int d, int causal, float sm_scale,
                         int device, void* stream) {
  if (bad_shape(b, h, h_kv, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_dq_hopper<64>(q, k, v, dout, lse, delta, dq, b, h, h_kv,
                                s_q, s_kv, causal, sm_scale, device, st);
  if (dtype == 0 && d == 128)
    return launch_dq_hopper<128>(q, k, v, dout, lse, delta, dq, b, h, h_kv,
                                 s_q, s_kv, causal, sm_scale, device, st);
  if (dtype == 1 && d == 64)
    return launch_dq_fp32<64>(q, k, v, dout, lse, delta, dq, b, h, h_kv, s_q,
                              s_kv, causal, sm_scale, device, st);
  if (dtype == 1 && d == 128)
    return launch_dq_fp32<128>(q, k, v, dout, lse, delta, dq, b, h, h_kv,
                               s_q, s_kv, causal, sm_scale, device, st);
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
  if (dtype == 0 && d == 64)
    return launch_dkv_hopper<64>(q, k, v, dout, lse, delta, dk, dv, b, h,
                                 h_kv, s_q, s_kv, causal, sm_scale, device,
                                 st);
  if (dtype == 0 && d == 128)
    return launch_dkv_hopper<128>(q, k, v, dout, lse, delta, dk, dv, b, h,
                                  h_kv, s_q, s_kv, causal, sm_scale, device,
                                  st);
  if (dtype == 1 && d == 64)
    return launch_dkv_fp32<64>(q, k, v, dout, lse, delta, dk, dv, b, h, h_kv,
                               s_q, s_kv, causal, sm_scale, device, st);
  if (dtype == 1 && d == 128)
    return launch_dkv_fp32<128>(q, k, v, dout, lse, delta, dk, dv, b, h,
                                h_kv, s_q, s_kv, causal, sm_scale, device,
                                st);
  return (int)cudaErrorInvalidValue;
}

const char* ray_tpu_cuda_error_string(int code) {
  return flash::error_string(code);
}

}  // extern "C"
