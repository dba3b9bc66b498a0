// The bf16 tensor-core plans of the rel full-H attention kernels: the
// forward #11 (attn_fwd_rel.cu), the saved-probs backward #13
// (attn_bwd_rel_saved.cu) and the recompute backward #12
// (attn_bwd_rel.cu). fp32 keeps their CUDA-core code (common.cuh's
// `fwd_rel_rows`, attn_bwd_rel_saved.cu's and attn_bwd_rel.cu's kernels)
// and its bits. #20 and #21 (attn_relik_full_tc.cuh) take the register
// plan's softmax and tail from here.
//
// What they compute is #11's, #13's and #12's function, per batch row b
// and head h, from q [B, Q, D], k, v [B, K, D] (head-major columns h·Dh +
// c) and the score bias ebias [B, H, Q, K] (#12: p and pd recomputed from
// them in fp32, the keep mask replayed; #13: read rounded from the saved
// probs):
//   s    = (q_h · k_hᵀ in fp32) · scale + ebias[b, h]; p = softmax_k(s)
//          (fp32, max-subtracted; a row masked whole comes out uniform)
//   save: p_out = bf16(p); rate > 0: p ← keep ? p · inv_keep : 0 (the
//          Philox stream at (k >> 2, q, h, b)); save: pd_out = bf16(p)
//   out  = bf16(p) · v_h summed in fp32, rounded once
//   dV = pdᵀ · g;  t = pd ⊙ (g · v_hᵀ);  ds = t − p · Σ_k t
//   debias = bf16(ds) (unscaled);  ds_c = bf16(ds · scale)
//   dQ = ds_c · k_h;  dK = ds_cᵀ · q_h      (every product summed in fp32)
//
// What bounds them on the card: at XLNet's training shape (B=256, Q=K=50,
// H=12, Dh=64) the forward is ~1 GFLOP over ~31 MB of q, k, v, out and
// the ebias plus the 31 MB of saved probs, the backward ~2 GFLOP over
// ~77 MB with the debias write: bytes-bound at 0.014-0.055 ms, where the
// CUDA-core kernels took 0.24-0.66 ms on dependent fp32 fmaf chains. The
// design is attn_full_tc.cuh's (#1, #3) in the rel layout: every product
// on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix from
// operands cp.async staged, the elementwise work on the accumulators in
// registers. q and k/v come from their own tensors (row stride D), Q ≠ K.
//
// Forward, register plan (K ≤ kRegMaxK = 64; `attn_fwd_rel_tc_reg_kernel`):
// one block per (64-row query tile, head, batch row) of rows16(min(Q, 64))
// / 16 warps (4 at Q = 50), each warp 16 query rows. q's tile and the
// head's k, v are staged as bf16 (rows of attn::tc_ld(Dh), rows past the
// edge zero-filled, the k-depth's pad columns zero). While the copies fly,
// each lane reads its ebias elements in the accumulator layout (rows
// q_lo = lane / 4 and q_lo + 8 of its slab, keys 8t + 2·(lane % 4) +
// {0, 1}): bf16x2 loads while K is even (a head's rows are K·2 bytes
// apart, 100 at K = 50), 2-byte loads otherwise. QKᵀ runs into registers;
// s = (dot · scale) + eb in fp32, keys past K at −inf, rows past Q on
// eb = 0 (finite, never stored). The row max and sum come from the lane's
// keys in order, then the quad's xor tree; p = e / sum. The keep bits come
// from lane pairs (attn_full_tc.cuh's `keep_words`: one Philox block each,
// two words traded by shuffles). p and pd are stored from the accumulator
// layout (bf16x2 while K is even), the dropped probs repacked into PV's A
// fragments, v read by ldmatrix.trans. Past Q = 64 the grid tiles q (the
// q rows are independent; each tile restages the ≤ 64 keys, a few KB, and
// keeps its scores in registers, where the score-tile plan would take them
// through shared memory). Shared memory (ops/fused_attention.py::
// rel_full_tc_fwd_smem_bytes): q [Q16][L], k, v [K16][L] bf16 (Q16: min(Q,
// 64) rounded up to 16, K16: K rounded up to 16, L: Dh rounded up to 16,
// + 8): 27.6 KB at Q = K = 50, Dh = 64.
//
// Forward, score-tile plan (kRegMaxK < K ≤ kMaxK = 512;
// `attn_fwd_rel_tc_smem_kernel`): #14's plan (attn_fwd_rel_hb.cu) with the
// save modes added, as attn_full_tc.cuh gave #1 #4's: a block of 8 warps
// per (32-row query tile, head, batch row), the tile's ebias rows first
// into the fp32 score tile [32][keys + 4], k then v streamed through a
// two-stage ring of 64-key blocks, s = (dot · scale) + eb over the bias in
// place, common.cuh's `tc_hb_softmax_rows` in its save mode, PV by
// ldmatrix. Shared memory as ops/fused_attention.py::rel_hb_fwd_smem_bytes
// (39.9 KB at K = 100, Dh = 64). #14 (attn_fwd_rel_hb.cu) launches the same
// kernel without the saves, up to K = 640 (`launch_fwd_smem`).
//
// Backward (`attn_bwd_rel_saved_tc_kernel`): attn_full_tc.cuh's
// `bwd_saved_rows` in the rel layout, one block per (head, batch row) of
// min(8, max(q chunk, K16) / 16) warps (4 at Q = K = 50, 7 at K = 100),
// over chunks of the query rows (one chunk, all of them, wherever that
// fits: every shape but Q > 944 at K ≤ 21). Two staging tiles are
// reused, as the fp32 kernel's: A [chunk][L] holds g, then q; B [K16][L]
// v, then k; beside them pd and ds_c [chunk][K16 + 8] bf16, pd loaded by
// 4-byte loads while K is even. Phase 1, warps on 16-row query slabs:
// d(pd) = g · vᵀ into registers 64 keys at a time (past K = 64 the product
// runs twice, once for Σ_k t and once for ds: holding 128 keys took 154
// registers at K = 100, one 7-warp block an SM, and ran 0.528 ms against
// 0.315 for two passes, bf16 B=256 Q=50 K=100 on an NVIDIA H100 80GB HBM3
// at 700 W, chip_ab.py); t = pd ⊙ d(pd); Σ_k t from the lane's keys in
// order, then the quad's xor tree; p read from device memory in the
// accumulator layout; debias = bf16(ds) stored from the accumulators,
// ds_c = bf16(ds · scale) into its tile. After a barrier k streams into B
// while phase 2a, warps on 16-key slices, runs dV = pdᵀ · g (pdᵀ by
// ldmatrix.trans); after the next, q streams into A while phase 1b runs
// dQ = ds_c · k; then phase 2b dK = ds_cᵀ · q. With more than one chunk
// the key slices' dV and dK add into fp32 sums [K16][Dh] in shared memory,
// each element owned by one lane in a fixed chunk order. Every reduction
// has one order: no atomics, the same bits twice. Shared memory
// (ops/fused_attention.py::rel_full_tc_bwd_smem_bytes): 36.9 KB at Q = K
// = 50, Dh = 64; 56.1 KB at Q = 50, K = 100. Built for Dh ≤ 64 and
// ≤ 128, it covers every (Q, K ≤ 512, Dh) that
// ops/fused_attention.py::rel_bwd_fits admits.
//
// Recompute backward (#12, `attn_bwd_rel_tc_kernel`): the same block code
// (`bwd_rows`) with a phase 0 in front of each chunk's phase 1 that
// rebuilds p with #11's bits (`rc_probs`): q's chunk rows stream into A and
// (once: B ends every chunk holding it) k into B; to K = 64 each warp runs
// #11's register plan on its 16-row slabs (the ebias read in the
// accumulator layout, `reg_softmax`, p = e / sum, the lane pairs' keep
// words), past it the chunk's ebias rows go into an fp32 tile and the
// scores over them in 16 × 16 units, then `softmax_rows_keep_sign` (the
// order of #14's `tc_hb_softmax_rows`). p lands in an fp32 tile P
// [chunk][K16 + 4], the keep bit in its sign, while g and v stream in.
// Phase 1 reads p and pd = p · inv_keep (0 where dropped) from P in fp32,
// as the CUDA-core kernel does, and writes pd_c = bf16(pd) over the slab's
// own P rows once the warp has read them; phase 2a reads pd_c from there.
// The keep mask is replayed at (k >> 2, q, h, b). Shared memory
// (ops/fused_attention.py::rel_full_tc_bwd_smem_bytes with `recompute`):
// A, B bf16, P fp32, ds_c bf16: 44.0 KB at Q = K = 50, Dh = 64 (45,056
// bytes), 68.75 KB at Q = 50, K = 100; all of Q in one chunk but for
// Q > 400 at K ≤ 67. At Dh ≤ 64 it is held to 128 registers: where the
// block has four warps or fewer (every shape with Q, K ≤ 64) for four
// blocks an SM (`kRcSmallBlocks`; it spills ~200 bytes, and still ran bf16
// B=256 Q=K=50 rate 0.1 at 0.198 ms against 0.248 unbounded, 216
// registers, two blocks), else for two where their shared memory allows
// (`kRcWideBlocks`: Q=50 K=100 0.564-0.568 against 0.940-0.946 unbounded,
// one block; NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py). Dh ≤ 128 runs
// unbounded. The chunk's probs rows (#13's pd, #12's ebias) come in by
// `load_pairs`, eight 4-byte loads in flight a thread.
//
// Against the fp32 kernels: a bf16 × bf16 product is exact in fp32, so a
// dot differs from the CUDA-core fmaf chain of the same values only in the
// order of its sum, and so do the row sums; the roundings sit where the
// fp32 kernels put them. bf16 #11 and #13 are held to their plain versions
// within the forward bound and `rel_grads_bf16_bound`, not bit for bit;
// so is #12 (to its plain version, to autograd and to #13).

#pragma once

#include "attn_full_tc.cuh"

// Internal linkage in each translation unit that includes this header.
namespace {

namespace rel_tc {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;
using full_tc::aligned;
using full_tc::dh_tiles;
using full_tc::rows16;

constexpr int kRegMaxK = 64;  // ops/fused_attention.py::REL_TC_REG_MAX_K
constexpr int kRegTiles = kRegMaxK / 8;   // the register plan's n8 key tiles
constexpr int kRegQTile = 64;             // its query rows a block
constexpr int kRegThreads = kRegQTile / 16 * 32;
constexpr int kSmemQTile = 32;            // the score-tile plan's q tile
constexpr int kKBlock = 64;               // its staged k/v blocks
constexpr int kMaxK = 512;                // ops/fused_attention.py::MAX_SEQ_LEN
constexpr int kBwdThreads = 256;          // the backward's most warps, 8
constexpr int kBwdTiles = 8;  // the backward's n8 key tiles in registers

// ---- forward, register plan (K ≤ kRegMaxK) --------------------------------

__host__ __device__ inline size_t fwd_reg_smem_bytes(int q_len, int k_len,
                                                     int dh) {
  const int tile = q_len < kRegQTile ? q_len : kRegQTile;
  return ((size_t)rows16(tile) + 2 * (size_t)rows16(k_len)) *
         attn::tc_ld(dh) * sizeof(bf16);
}

// The register plan's softmax on a warp's scores sc (its 16 rows × the
// n8 key tiles of `full_tc::warp_abt`'s layout; keys past K at −inf): each
// row's max and sum from the lane's keys in order, then the quad's xor
// tree; on return sc holds e (0 past K) and sum the lane's two rows' sums,
// p = e / sum (taken where the keep bits are drawn, so that the divisions
// overlap the Philox rounds). #20 and #21 run it too
// (attn_relik_full_tc.cuh), so their p take #11's order.
__device__ __forceinline__ void reg_softmax(float (&sc)[kRegTiles][4],
                                            float (&sum)[2], int K) {
  const int t4 = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      mx[hi] = fmaxf(mx[hi], fmaxf(sc[t][2 * hi], sc[t][2 * hi + 1]));
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
  sum[0] = sum[1] = 0.0f;
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * t + 2 * t4 + (e & 1);
      float x = 0.0f;
      if (j < K) {
        x = expf(sc[t][e] - mx[e >> 1]);
        sum[e >> 1] += x;
      }
      sc[t][e] = x;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
}

// The register plan's tail after `reg_softmax`, for the warp's rows q_lo
// and q_lo + 8 (global; slab m0 of a tile of q_rows rows): p = e / sum,
// the saved p, the keep mask (`full_tc::keep_words`), the saved pd (rows
// (row0 + q) · K of p_out / pd_out), then out = bf16(pd) · v with v staged
// at vs (row stride ld), rows m0 .. of out_tile (row stride D). #11 and
// #20 share it.
template <int kDT, bool kDropout, bool kSave>
__device__ __forceinline__ void reg_probs_pv(
    float (&sc)[kRegTiles][4], const float (&sum)[2], const bf16* vs, int ld,
    bf16* out_tile,
    int D, bf16* __restrict__ p_out, bf16* __restrict__ pd_out, size_t row0,
    int q_lo, int Q, int K, int nkt, int m0, int q_rows, int Dh, int b,
    int h, bool p_pairs, const DropoutArgs& drop) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
    if (t < nkt) {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if constexpr (kDropout) full_tc::keep_words(wd, q_lo, t, b, h, drop);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = sc[t][e] / sum[e >> 1];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int qr = q_lo + 8 * hi;
        const size_t prow = (row0 + qr) * K;
        if constexpr (kSave) {
          if (qr < Q)
            full_tc::store_pair(p_out + prow, 8 * t + 2 * t4, K, sc[t][2 * hi],
                                sc[t][2 * hi + 1], p_pairs);
        }
        if constexpr (kDropout) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * hi + u;
            sc[t][e] = wd[e] >= drop.threshold
                           ? __fmul_rn(sc[t][e], drop.inv_keep)
                           : 0.0f;
          }
          if constexpr (kSave) {
            if (qr < Q)
              full_tc::store_pair(pd_out + prow, 8 * t + 2 * t4, K,
                                  sc[t][2 * hi], sc[t][2 * hi + 1], p_pairs);
          }
        }
      }
    }
  }

  // out = bf16(p) · v: key tiles 2c and 2c + 1 are step c's A fragment.
  float acc[kDT][4] = {};
  const bf16* vb = attn::tc_lane_bt(vs, ld);
#pragma unroll
  for (int c = 0; c < kRegTiles / 2; ++c) {
    if (2 * c < nkt) {
      const uint32_t fa[4] = {attn::pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                              attn::pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                              attn::pack_bf16(sc[2 * c + 1][0],
                                              sc[2 * c + 1][1]),
                              attn::pack_bf16(sc[2 * c + 1][2],
                                              sc[2 * c + 1][3])};
      attn::tc_mma_bt(acc, fa, vb + 16 * c * ld, Dh / 8);
    }
  }
  full_tc::store_rows(acc, out_tile, D, m0, q_rows, Dh);
}

template <int kDT, bool kDropout, bool kSave>
__global__ void __launch_bounds__(kRegThreads)
    attn_fwd_rel_tc_reg_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ ebias,
                               bf16* __restrict__ out,
                               bf16* __restrict__ p_out,
                               bf16* __restrict__ pd_out, int Q, int K, int H,
                               int Dh, float scale, bool eb_pairs,
                               bool p_pairs, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kRegQTile, h = blockIdx.y, b = blockIdx.z;
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int qp = blockDim.x / 2;  // staged q rows: 16 a warp
  const int kp = rows16(K), nkt = kp / 8;
  const int q_rows = min(qp, Q - q0);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [qp][ld]
  bf16* ks = qs + qp * ld;                        // [kp][ld]
  bf16* vs = ks + kp * ld;                        // [kp][ld]

  // row q of ebias[b, h] and of the saved probs starts at (row0 + q) · K
  const size_t row0 = ((size_t)b * H + h) * Q;
  const size_t kv_off = (size_t)b * K * D + h * Dh;
  attn::tc_cp_rows(qs, ld, q + ((size_t)b * Q + q0) * D + h * Dh, D, 0, qp,
                   0, q_rows, Dh);
  attn::tc_cp_rows(ks, ld, k + kv_off, D, 0, kp, 0, K, Dh);
  attn::tc_cp_rows(vs, ld, v + kv_off, D, 0, kp, 0, K, Dh);
  attn::cp_async_commit();
  attn::tc_zero_cols(qs, ld, qp + 2 * kp, Dh, kd);  // q, k and v's pad columns

  // The lane's ebias pairs (bf16x2, as read), loaded while the copies fly:
  // keys past K at −inf, rows past Q at 0 (their scores stay finite and are
  // never stored).
  const int m0 = warp * 16;
  const int t4 = lane & 3;
  const int q_lo = q0 + m0 + (lane >> 2);  // global rows q_lo and q_lo + 8
  const bf16 zero = __float2bfloat16(0.0f), ninf = __float2bfloat16(-INFINITY);
  __nv_bfloat162 eb[kRegTiles][2];
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qr = q_lo + 8 * hi, j = 8 * t + 2 * t4;
      __nv_bfloat162 e;
      e.x = j < K ? zero : ninf;
      e.y = j + 1 < K ? zero : ninf;
      if (qr < Q && j < K) {
        const bf16* src = ebias + (row0 + qr) * K + j;
        if (eb_pairs) {
          e = *reinterpret_cast<const __nv_bfloat162*>(src);
        } else {
          e.x = src[0];
          if (j + 1 < K) e.y = src[1];
        }
      }
      eb[t][hi] = e;
    }
  }
  attn::cp_async_wait<0>();
  __syncthreads();

  // s = (q · k) · scale + eb for the warp's 16 rows and every key.
  float sc[kRegTiles][4] = {};
  full_tc::warp_abt<kRegTiles>(sc, qs + m0 * ld, ks, ld, kd, nkt);
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 e = __bfloat1622float2(eb[t][hi]);
      sc[t][2 * hi] = __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x);
      sc[t][2 * hi + 1] = __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), e.y);
    }
  }
  float sum[2];
  reg_softmax(sc, sum, K);
  reg_probs_pv<kDT, kDropout, kSave>(
      sc, sum, vs, ld, out + ((size_t)b * Q + q0) * D + h * Dh, D, p_out,
      pd_out,
      row0, q_lo, Q, K, nkt, m0, q_rows, Dh, b, h, p_pairs, drop);
}

// ---- forward, score-tile plan (kRegMaxK < K ≤ kMaxK) ----------------------

__host__ __device__ inline int smem_keys(int k_len) {
  return (k_len + kKBlock - 1) / kKBlock * kKBlock;
}
__host__ __device__ inline int smem_ss_ld(int k_len) {
  return smem_keys(k_len) + 4;
}

__host__ __device__ inline size_t fwd_smem_bytes(int k_len, int dh) {
  return (size_t)kSmemQTile * smem_ss_ld(k_len) * sizeof(float) +
         (size_t)(kSmemQTile + 2 * kKBlock) * attn::tc_ld(dh) * sizeof(bf16);
}

template <bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_rel_tc_smem_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ ebias,
                                bf16* __restrict__ out,
                                bf16* __restrict__ p_out,
                                bf16* __restrict__ pd_out, int Q, int K,
                                int H, int Dh, float scale, bool vec_eb,
                                DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kSmemQTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int ssld = smem_ss_ld(K), keys = smem_keys(K);
  const int n_blocks = keys / kKBlock;
  const int stage = kKBlock * ld;

  float* ss = reinterpret_cast<float*>(smem_raw);  // [32][ssld]: eb, s, P
  bf16* qs = reinterpret_cast<bf16*>(ss + kSmemQTile * ssld);  // [32][ld]
  bf16* ring = qs + kSmemQTile * ld;      // 2 × [64][ld]: k blocks, then v

  const size_t kv_off = (size_t)b * K * D + h * Dh;
  const bf16* k_base = k + kv_off;
  const bf16* v_base = v + kv_off;
  const size_t prow0 = ((size_t)b * H + h) * Q + q0;  // the tile's first row
  const bf16* eb = ebias + prow0 * K;
  const int q_rows = min(kSmemQTile, Q - q0);

  // Block i of the stream, into stage i & 1: k block i for i < n_blocks,
  // then v block i − n_blocks. Each its own cp.async group.
  auto load = [&](int i) {
    const bool is_k = i < n_blocks;
    const int k0 = (is_k ? i : i - n_blocks) * kKBlock;
    attn::tc_cp_rows(ring + (i & 1) * stage, ld, is_k ? k_base : v_base,
                     (size_t)D, k0, kKBlock, 0, min(kKBlock, K - k0), Dh);
  };
  attn::tc_cp_rows(qs, ld, q + (size_t)b * Q * D + h * Dh, (size_t)D, q0,
                   kSmemQTile, 0, q_rows, Dh);
  load(0);
  attn::cp_async_commit();  // q and k block 0
  // The tile's ebias rows, as fp32, where their scores will be.
  if (vec_eb) {
    const int chunks = K / 8;
#pragma unroll 4
    for (int x = tid; x < q_rows * chunks; x += attn::kTcThreads) {
      const int r = x / chunks, c = (x - r * chunks) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(eb + (size_t)r * K + c);
      const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(e2[0]);
      const float2 f1 = __bfloat1622float2(e2[1]);
      const float2 f2 = __bfloat1622float2(e2[2]);
      const float2 f3 = __bfloat1622float2(e2[3]);
      float4* dst = reinterpret_cast<float4*>(ss + r * ssld + c);
      dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  } else {
    for (int x = tid; x < q_rows * K; x += attn::kTcThreads) {
      const int r = x / K, c = x - r * K;
      ss[r * ssld + c] = __bfloat162float(eb[(size_t)r * K + c]);
    }
  }
  // The k-depth's pad columns of q and of both ring stages stay zero.
  attn::tc_zero_cols(qs, ld, kSmemQTile + 2 * kKBlock, Dh, kd);

  // Scores: warp w takes rows m0 .. m0 + 15 and keys kq .. kq + 15 of each
  // block. PV: rows m0 .. m0 + 15 and n8 tiles c0 / 8 .. c0 / 8 + n − 1.
  const int m0 = (warp & 1) * 16;
  const int kq = (warp >> 1) * 16;
  const int tiles = Dh / 8, per = (tiles + 3) / 4;
  const int c0 = (warp >> 1) * per * 8;
  const int n = max(0, min(per, tiles - (warp >> 1) * per));
  constexpr int kPvTiles = attn::kTcMaxDh / 32;
  float acc[kPvTiles][4] = {};
  const bf16* ps = reinterpret_cast<const bf16*>(ss);  // P, rows of 2·ssld

  for (int i = 0; i < 2 * n_blocks; ++i) {
    attn::cp_async_wait<0>();  // block i
    __syncthreads();  // ... for every thread (and eb); block i − 1 is done
    if (i + 1 < 2 * n_blocks) load(i + 1);
    attn::cp_async_commit();
    const bf16* blk = ring + (i & 1) * stage;
    if (i < n_blocks) {
      // s = (q · k) · scale + eb, over eb in the fp32 score tile.
      const int k0 = i * kKBlock;
      float sc[2][4] = {};
      attn::tc_warp_abt<2>(sc, qs + m0 * ld, ld, blk + kq * ld, ld, kd);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + kq + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = m0 + (lane >> 2) + 8 * hi;
          float2* dst = reinterpret_cast<float2*>(ss + r * ssld + j);
          const float2 e = *dst;
          *dst = make_float2(__fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x),
                             __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale),
                                       e.y));
        }
      }
      if (i == n_blocks - 1) {
        __syncthreads();  // every score is in
        attn::tc_hb_softmax_rows<kDropout, kSave>(ss, ssld, q_rows, K, q0, b,
                                                  h, drop, prow0, p_out,
                                                  pd_out);
      }
    } else {
      // acc += P[:, k0 .. k0 + kmax) · v block
      const int k0 = (i - n_blocks) * kKBlock;
      const int kmax = min(kKBlock, (K - k0 + 15) / 16 * 16);
      const bf16* pa = attn::tc_lane_a(ps + m0 * 2 * ssld + k0, 2 * ssld);
      const bf16* vb = attn::tc_lane_bt(blk + c0, ld);
      for (int kk = 0; kk < kmax; kk += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + kk);
        attn::tc_mma_bt(acc, fa, vb + kk * ld, n);
      }
    }
  }
  bf16* out_tile = out + ((size_t)b * Q + q0) * D + h * Dh + c0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = m0 + (lane >> 2) + 8 * hi;
    if (r >= q_rows) continue;
#pragma unroll
    for (int t = 0; t < kPvTiles; ++t) {
      if (t < n)
        *reinterpret_cast<__nv_bfloat162*>(
            out_tile + (size_t)r * D + t * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[t][2 * hi], acc[t][2 * hi + 1]);
    }
  }
}

// ---- the forward's launch --------------------------------------------------

// Where the bf16 forward's tensors live and how it reads them.
struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* ebias;
  bf16* out;
  bf16* p;   // null: no save
  bf16* pd;
  int B, Q, K, H, Dh;
  float scale;
};

__host__ __device__ inline size_t fwd_plan_bytes(int q_len, int k_len,
                                                 int dh) {
  return k_len <= kRegMaxK ? fwd_reg_smem_bytes(q_len, k_len, dh)
                           : fwd_smem_bytes(k_len, dh);
}

template <int kDT, bool kDropout, bool kSave, typename Args>
int launch_fwd_reg(const Args& a, const DropoutArgs& drop, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_tc_reg_kernel<kDT, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const bool eb_pairs = a.K % 2 == 0 && aligned(a.ebias, 4);
  const bool p_pairs = a.K % 2 == 0 && aligned(a.p, 4) && aligned(a.pd, 4);
  const int threads = rows16(a.Q < kRegQTile ? a.Q : kRegQTile) / 16 * 32;
  attn_fwd_rel_tc_reg_kernel<kDT, kDropout, kSave>
      <<<dim3((a.Q + kRegQTile - 1) / kRegQTile, a.H, a.B), threads,
         fwd_reg_smem_bytes(a.Q, a.K, a.Dh), st>>>(
          a.q, a.k, a.v, a.ebias, a.out, a.p, a.pd, a.Q, a.K, a.H, a.Dh,
          a.scale, eb_pairs, p_pairs, drop);
  return (int)cudaGetLastError();
}

// The score-tile plan at any K ≤ attn::kTcHbMaxLen (#11 past kRegMaxK,
// and #14).
template <bool kDropout, bool kSave, typename Args>
int launch_fwd_smem(const Args& a, const DropoutArgs& drop, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_tc_smem_kernel<kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const bool vec_eb = a.K % 8 == 0 && aligned(a.ebias, 16);
  attn_fwd_rel_tc_smem_kernel<kDropout, kSave>
      <<<dim3((a.Q + kSmemQTile - 1) / kSmemQTile, a.H, a.B),
         attn::kTcThreads, fwd_smem_bytes(a.K, a.Dh), st>>>(
          a.q, a.k, a.v, a.ebias, a.out, a.p, a.pd, a.Q, a.K, a.H, a.Dh,
          a.scale, vec_eb, drop);
  return (int)cudaGetLastError();
}

template <bool kDropout, bool kSave, typename Args>
int launch_fwd_mode(const Args& a, const DropoutArgs& drop, cudaStream_t st) {
  if (a.K > kRegMaxK) return launch_fwd_smem<kDropout, kSave>(a, drop, st);
  return dh_tiles(a.Dh) == 8 ? launch_fwd_reg<8, kDropout, kSave>(a, drop, st)
                             : launch_fwd_reg<16, kDropout, kSave>(a, drop,
                                                                   st);
}

// The bf16 forward of #11. q, k and v must start on the 16 bytes cp.async
// copies (a head's rows, D·2 bytes apart, and its first column, h·Dh·2
// bytes in, then are too). Returns the cudaError_t of the launch; a shape
// past the plan returns cudaErrorInvalidValue. (A template on the
// arguments, here always FwdArgs, so that only the sources that launch the
// forward compile its kernels; launch_bwd likewise.)
template <typename Args>
int launch_fwd(const Args& a, bool dropout, const DropoutArgs& drop,
               cudaStream_t st) {
  if (a.K > kMaxK || fwd_plan_bytes(a.Q, a.K, a.Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool save = a.p != nullptr;
  if (dropout && save) return launch_fwd_mode<true, true>(a, drop, st);
  if (dropout) return launch_fwd_mode<true, false>(a, drop, st);
  if (save) return launch_fwd_mode<false, true>(a, drop, st);
  return launch_fwd_mode<false, false>(a, drop, st);
}

// ---- the backward: #13 from saved probs, #12 recomputing them ---------------

__host__ __device__ inline int bwd_pld(int k_len) { return rows16(k_len) + 8; }
// #12's fp32 probs tile row stride (pd_c over it as bf16 rows of twice it)
__host__ __device__ inline int bwd_rc_p_ld(int k_len) {
  return rows16(k_len) + 4;
}

// Shared memory of a backward block whose query chunk holds qc rows (a
// multiple of 16): A [qc][L] and B [K16][L], bf16; #13 (`rc` false) pd and
// ds_c [qc][K16 + 8] bf16; #12 (`rc`) the fp32 probs P [qc][K16 + 4] (pd_c
// over them) and ds_c [qc][K16 + 8] bf16; with more than one chunk
// (`multi`) the fp32 dK and dV sums [K16][Dh].
__host__ __device__ inline size_t bwd_smem_bytes(int qc, int k_len, int dh,
                                                 bool multi, bool rc = false) {
  const int kp = rows16(k_len);
  const size_t probs =
      rc ? (size_t)qc * bwd_rc_p_ld(k_len) * sizeof(float) +
               (size_t)qc * bwd_pld(k_len) * sizeof(bf16)
         : 2 * (size_t)qc * bwd_pld(k_len) * sizeof(bf16);
  return (size_t)(qc + kp) * attn::tc_ld(dh) * sizeof(bf16) + probs +
         (multi ? 2 * (size_t)kp * dh * sizeof(float) : 0);
}

// The query chunk: all of Q's rows (rounded up to 16) where they fit, else
// the most 16-row slabs that fit beside the dK/dV sums; 0 where not even 16
// do (ops/fused_attention.py::rel_full_tc_bwd_q_chunk).
inline int bwd_q_chunk(int q_len, int k_len, int dh, bool rc = false) {
  const int qp = rows16(q_len);
  if (bwd_smem_bytes(qp, k_len, dh, false, rc) <= attn::kMaxSmemBytes)
    return qp;
  int qc = 0;
  while (qc + 16 < qp &&
         bwd_smem_bytes(qc + 16, k_len, dh, true, rc) <= attn::kMaxSmemBytes)
    qc += 16;
  return qc;
}

// A key slice's [16][Dh] fp32 product over one query chunk, rows k0 +
// lane / 4 (+ 8): stored as bf16 (rows < K of dst, row stride D) when the
// block has one chunk; else added into the fp32 sums [kp][Dh] (set at the
// first chunk) and stored from them at the last. Each element's sum is one
// lane's, in chunk order.
template <int kDT>
__device__ __forceinline__ void emit_keys(float (&acc)[kDT][4], bf16* dst,
                                          int D, float* sums, int k0, int K,
                                          int Dh, bool multi, bool first,
                                          bool last) {
  const int lane = threadIdx.x & 31;
  if (multi) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = k0 + (lane >> 2) + 8 * hi;
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        if (t < Dh / 8) {
          float2* s =
              reinterpret_cast<float2*>(sums + r * Dh + t * 8 + 2 * (lane & 3));
          float2 x = make_float2(acc[t][2 * hi], acc[t][2 * hi + 1]);
          if (!first) x = make_float2(s->x + x.x, s->y + x.y);
          *s = x;
          acc[t][2 * hi] = x.x;
          acc[t][2 * hi + 1] = x.y;
        }
      }
    }
    if (!last) return;
  }
  full_tc::store_rows(acc, dst, D, k0, K, Dh);
}

// Where the bf16 backward's tensors live. #13 reads p, pd (ebias null);
// #12 reads ebias (p, pd null).
struct BwdArgs {
  const bf16* p;
  const bf16* pd;
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  bf16* debias;
  int B, Q, K, H, Dh;
  float scale;
  const bf16* ebias = nullptr;
};

// Rows r < rp, keys c < kp of a chunk of a [.][K] bf16 tensor (row r at
// src + r·K; zeros past `rows` and K) handed to store(r, c, keys c and c +
// 1) two keys at a time, eight pair loads in flight a thread before their
// stores so that their latencies overlap. `pairs`: one 4-byte load a pair
// (K even and src 4-byte aligned), else 2-byte loads.
template <typename Store>
__device__ __forceinline__ void load_pairs(const bf16* __restrict__ src,
                                           int K, int rows, int rp, int kp,
                                           bool pairs, Store store) {
  constexpr int kInFlight = 8;
  const int half = kp / 2, n = rp * half;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInFlight * blockDim.x) {
    __nv_bfloat162 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / half, c = 2 * (i - r * half);
      v[u] = __floats2bfloat162_rn(0.0f, 0.0f);
      if (i < n && r < rows && c < K) {
        const bf16* at = src + (size_t)r * K + c;
        if (pairs) {
          v[u] = *reinterpret_cast<const __nv_bfloat162*>(at);
        } else {
          v[u].x = at[0];
          if (c + 1 < K) v[u].y = at[1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int r = i / half;
        store(r, 2 * (i - r * half), v[u]);
      }
    }
  }
}

// #12's phase 0 on one query chunk (rows c0 .. c0 + rows − 1, rp = rows
// rounded up to 16) whose q rows are staged in A and k in B: p again with
// #11's bits into the fp32 tile P [rp][pl4], the keep bit in its sign. To
// K = 64 #11's register plan: the warp's slabs against every key in
// registers, the ebias read in the accumulator layout (`eb_pairs`: bf16x2
// while K is even), `reg_softmax`, p = e / sum, the lane pairs' keep words.
// Past it #14's score tile: the chunk's ebias rows into P as fp32
// (`load_pairs`), s = (dot · scale) + eb over them in 16 × 16 units, then the whole-row order of `tc_hb_softmax_rows`
// (`softmax_rows_keep_sign`). Returns after a barrier that every warp has
// passed once it is done reading A and B, with g and v in flight into them
// (one cp.async group).
template <bool kDropout>
__device__ __forceinline__ void rc_probs(
    float* ps, int pl4, bf16* as, bf16* bs, const bf16* __restrict__ ebias,
    const bf16* __restrict__ g, const bf16* __restrict__ v, int Q, int K,
    int H, int Dh, float scale, int c0, int rows, int ld, int kd,
    bool eb_pairs, const DropoutArgs& drop) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * Dh;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int kp = rows16(K), nkt = kp / 8, nk16 = kp / 16, rp = rows16(rows);
  const size_t row0 = ((size_t)b * H + h) * Q;  // ebias row q at + q · K
  const bf16* eb_rows = ebias + (row0 + c0) * K;
  auto stage_g_v = [&]() {
    attn::tc_cp_rows(as, ld, g + (size_t)b * Q * D + Dh * h, D, c0, rp, 0,
                     rows, Dh);
    attn::tc_cp_rows(bs, ld, v + (size_t)b * K * D + Dh * h, D, 0, kp, 0, K,
                     Dh);
    attn::cp_async_commit();
  };
  if (K <= kRegMaxK) {
    attn::cp_async_wait<0>();
    __syncthreads();  // q and k are in
    const bf16 zero = __float2bfloat16(0.0f);
    const bf16 ninf = __float2bfloat16(-INFINITY);
    for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
      // The lane's ebias pairs: keys past K at −inf, rows past the chunk at
      // 0 (their scores stay finite and are never read).
      __nv_bfloat162 eb[kRegTiles][2];
#pragma unroll
      for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = r0 + g4 + 8 * hi, j = 8 * t + 2 * t4;
          __nv_bfloat162 e;
          e.x = j < K ? zero : ninf;
          e.y = j + 1 < K ? zero : ninf;
          if (r < rows && j < K) {
            const bf16* src = eb_rows + (size_t)r * K + j;
            if (eb_pairs) {
              e = *reinterpret_cast<const __nv_bfloat162*>(src);
            } else {
              e.x = src[0];
              if (j + 1 < K) e.y = src[1];
            }
          }
          eb[t][hi] = e;
        }
      }
      float sc[kRegTiles][4] = {};
      full_tc::warp_abt<kRegTiles>(sc, as + r0 * ld, bs, ld, kd, nkt);
#pragma unroll
      for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float2 e = __bfloat1622float2(eb[t][hi]);
          sc[t][2 * hi] = __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x);
          sc[t][2 * hi + 1] =
              __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), e.y);
        }
      }
      float sum[2];
      reg_softmax(sc, sum, K);
#pragma unroll
      for (int t = 0; t < kRegTiles; ++t) {
        if (t < nkt) {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
          if constexpr (kDropout)
            full_tc::keep_words(wd, c0 + r0 + g4, t, b, h, drop);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float x[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              x[u] = sc[t][2 * hi + u] / sum[hi];
              if (kDropout && wd[2 * hi + u] < drop.threshold)
                x[u] = copysignf(x[u], -1.0f);
            }
            *reinterpret_cast<float2*>(ps + (r0 + g4 + 8 * hi) * pl4 + 8 * t +
                                       2 * t4) = make_float2(x[0], x[1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with q and k
    stage_g_v();
    return;
  }
  // The chunk's ebias rows, as fp32, where their scores will be.
  load_pairs(eb_rows, K, rows, rp, kp, eb_pairs,
             [&](int r, int c, __nv_bfloat162 x) {
               *reinterpret_cast<float2*>(ps + r * pl4 + c) =
                   __bfloat1622float2(x);
             });
  attn::cp_async_wait<0>();
  __syncthreads();  // q, k and the ebias rows are in
  for (int u = warp; u < (rp / 16) * nk16; u += nw) {
    const int r0 = 16 * (u / nk16), k0 = 16 * (u - (u / nk16) * nk16);
    float sc[2][4] = {};
    full_tc::warp_abt<2>(sc, as + r0 * ld, bs + k0 * ld, ld, kd, 2);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float2* dst = reinterpret_cast<float2*>(ps + (r0 + g4 + 8 * hi) * pl4 +
                                                k0 + 8 * t + 2 * t4);
        const float2 e = *dst;
        *dst = make_float2(__fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x),
                           __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale),
                                     e.y));
      }
    }
  }
  __syncthreads();  // every score is in; q and k are done with
  stage_g_v();
  attn::softmax_rows_keep_sign<kDropout>(ps, rows, K, c0, b, h, drop, pl4);
}

// One (head, batch row)'s block, over chunks of qc query rows. kRc: #12, p
// and pd recomputed (`rc_probs`) into the fp32 tile P, pd_c written over
// it; else #13, pd read from device memory into its bf16 tile and p read in
// phase 1. `pairs`: p, pd and debias read and written as bf16x2.
template <int kDT, bool kRc, bool kDropout>
__device__ __forceinline__ void bwd_rows(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const bf16* __restrict__ p,
    const bf16* __restrict__ pd, const bf16* __restrict__ ebias,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    bf16* __restrict__ debias, int Q, int K, int H, int Dh, float scale,
    int qc, bool pairs, bool eb_pairs, const DropoutArgs& drop) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * Dh;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int kp = rows16(K), nkt = kp / 8, pld = bwd_pld(K);
  const int pl4 = bwd_rc_p_ld(K);
  const bool multi = qc < Q;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [qc][ld]: (q,) g, then q
  bf16* bs = as + qc * ld;                        // [kp][ld]: (k,) v, then k
  // #13: pd [qc][pld] bf16; #12: P [qc][pl4] fp32, pd_c over it as bf16
  // rows of 2·pl4.
  float* ps = reinterpret_cast<float*>(bs + kp * ld);
  bf16* pds = reinterpret_cast<bf16*>(ps);
  const int pds_ld = kRc ? 2 * pl4 : pld;
  bf16* dss = kRc ? reinterpret_cast<bf16*>(ps + qc * pl4)
                  : pds + qc * pld;               // [qc][pld]: ds_c
  float* dk_sum = reinterpret_cast<float*>(dss + qc * pld);  // [kp][Dh]
  float* dv_sum = dk_sum + kp * Dh;
  const float inv_keep = drop.inv_keep;

  const size_t q_off = (size_t)b * Q * D + h * Dh;  // row r at + r · D
  const size_t k_off = (size_t)b * K * D + h * Dh;
  // row q of p, pd, ebias and debias starts at (row0 + q) · K
  const size_t row0 = ((size_t)b * H + h) * Q;

  attn::tc_zero_cols(as, ld, qc + kp, Dh, kd);  // A's and B's pad columns

  for (int c0 = 0; c0 < Q; c0 += qc) {
    const int rows = min(qc, Q - c0), rp = rows16(rows);
    const bool first = c0 == 0, last = c0 + qc >= Q;
    if constexpr (kRc) {
      // Phase 0: q and (at the first chunk; B ends each chunk holding it)
      // k, then p again.
      attn::tc_cp_rows(as, ld, q + q_off, D, c0, rp, 0, rows, Dh);
      if (first) attn::tc_cp_rows(bs, ld, k + k_off, D, 0, kp, 0, K, Dh);
      attn::cp_async_commit();
      rc_probs<kDropout>(ps, pl4, as, bs, ebias, g, v, Q, K, H, Dh, scale,
                         c0, rows, ld, kd, eb_pairs, drop);
    } else {
      attn::tc_cp_rows(as, ld, g + q_off, D, c0, rp, 0, rows, Dh);
      attn::tc_cp_rows(bs, ld, v + k_off, D, 0, kp, 0, K, Dh);
      attn::cp_async_commit();
      // pd's rows c0 .. c0 + rows − 1 → pds, zeros to [rp][kp].
      load_pairs(pd + (row0 + c0) * K, K, rows, rp, kp, pairs,
                 [&](int r, int c, __nv_bfloat162 x) {
                   *reinterpret_cast<__nv_bfloat162*>(pds + r * pld + c) = x;
                 });
    }
    attn::cp_async_wait<0>();
    __syncthreads();  // g and v are in (#13: and pd; #12: and p whole)

    // Phase 1: the warp's 16-row query slabs.
    for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
      const int q_lo = r0 + (lane >> 2);  // chunk rows q_lo and q_lo + 8
      float tt[kBwdTiles][4];
      // #12's signed p of chunk row r, keys j, j + 1 (0 past the chunk and
      // K)
      auto p_signed = [&](int r, int j, float (&x)[2]) {
        x[0] = x[1] = 0.0f;
        if (r < rows && j < K) {
          const float2 f = *reinterpret_cast<const float2*>(ps + r * pl4 + j);
          x[0] = f.x;
          if (j + 1 < K) x[1] = f.y;
        }
      };
      // tt = pd ⊙ (g · vᵀ) over the n8 key tiles t0 .. t0 + n − 1 (n even)
      auto dpd = [&](int t0, int n) {
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t)
          tt[t][0] = tt[t][1] = tt[t][2] = tt[t][3] = 0.0f;
        full_tc::warp_abt<kBwdTiles>(tt, as + r0 * ld, bs + t0 * 8 * ld, ld,
                                     kd, n);
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t) {
          if (t < n) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int r = q_lo + 8 * hi, j = 8 * (t0 + t) + 2 * t4;
              float pdv[2];
              if constexpr (kRc) {
                float x[2];
                p_signed(r, j, x);
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  pdv[u] = attn::pd_of_signed<kDropout>(x[u], inv_keep);
              } else {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(pds + r * pld +
                                                             j));
                pdv[0] = f.x;
                pdv[1] = f.y;
              }
              tt[t][2 * hi] = __fmul_rn(pdv[0], tt[t][2 * hi]);
              tt[t][2 * hi + 1] = __fmul_rn(pdv[1], tt[t][2 * hi + 1]);
            }
          }
        }
      };
      const int n_kc = (nkt + kBwdTiles - 1) / kBwdTiles;
      float sum[2] = {0.0f, 0.0f};
      for (int kc = 0; kc < n_kc; ++kc) {
        const int n = min(kBwdTiles, nkt - kc * kBwdTiles);
        dpd(kc * kBwdTiles, n);
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t) {
          if (t < n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[e >> 1] += tt[t][e];
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
      // ds = t − p · Σt: debias = T(ds) to device memory, ds_c = T(ds ·
      // scale) into its tile (zeros past Q and K); #12 also pd_c = T(pd)
      // over the slab's own P rows.
      for (int kc = 0; kc < n_kc; ++kc) {
        const int t0 = kc * kBwdTiles, n = min(kBwdTiles, nkt - t0);
        if (n_kc > 1) dpd(t0, n);
        uint32_t pdw[kBwdTiles][2];
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t) {
          if (t < n) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int r = q_lo + 8 * hi, qr = c0 + r;
              const int j = 8 * (t0 + t) + 2 * t4;
              float pv[2] = {0.0f, 0.0f};
              if constexpr (kRc) {
                float x[2];
                p_signed(r, j, x);
#pragma unroll
                for (int u = 0; u < 2; ++u)
                  pv[u] = attn::p_of_signed<kDropout>(x[u]);
                pdw[t][hi] =
                    attn::pack_bf16(attn::pd_of_signed<kDropout>(x[0], inv_keep),
                                    attn::pd_of_signed<kDropout>(x[1], inv_keep));
              } else if (qr < Q && j < K) {
                const bf16* src = p + (row0 + qr) * K + j;
                if (pairs) {
                  const float2 f = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(src));
                  pv[0] = f.x;
                  pv[1] = f.y;
                } else {
                  pv[0] = __bfloat162float(src[0]);
                  if (j + 1 < K) pv[1] = __bfloat162float(src[1]);
                }
              }
              float ds[2];
#pragma unroll
              for (int u = 0; u < 2; ++u)
                ds[u] = __fsub_rn(tt[t][2 * hi + u], __fmul_rn(pv[u], sum[hi]));
              if (qr < Q)
                full_tc::store_pair(debias + (row0 + qr) * K, j, K, ds[0],
                                    ds[1], pairs);
              *reinterpret_cast<uint32_t*>(dss + r * pld + j) =
                  attn::pack_bf16(__fmul_rn(ds[0], scale),
                                  __fmul_rn(ds[1], scale));
            }
          }
        }
        if constexpr (kRc) {
          // pd_c of key j lies on p's element j / 2: each written once the
          // warp has read this chunk's keys (and, past the first, the
          // earlier chunks' that it lies on).
          __syncwarp();
#pragma unroll
          for (int t = 0; t < kBwdTiles; ++t) {
            if (t < n) {
#pragma unroll
              for (int hi = 0; hi < 2; ++hi)
                *reinterpret_cast<uint32_t*>(pds + (q_lo + 8 * hi) * pds_ld +
                                             8 * (t0 + t) + 2 * t4) =
                    pdw[t][hi];
            }
          }
        }
      }
    }
    __syncthreads();  // every ds_c (and #12's pd_c) is in; v is done with

    attn::tc_cp_rows(bs, ld, k + k_off, D, 0, kp, 0, K, Dh);
    attn::cp_async_commit();
    // Phase 2a: dV (+)= pdᵀ · g, the warp's 16-key slices.
    for (int k0 = 16 * warp; k0 < kp; k0 += 16 * nw) {
      float acc[kDT][4] = {};
      for (int c = 0; c < rp; c += 16) {
        uint32_t fa[4];
        attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * pds_ld + k0,
                                                 pds_ld));
        attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
      }
      emit_keys(acc, dv + k_off, D, dv_sum, k0, K, Dh, multi, first, last);
    }
    attn::cp_async_wait<0>();
    __syncthreads();  // k is in; g is done with

    attn::tc_cp_rows(as, ld, q + q_off, D, c0, rp, 0, rows, Dh);
    attn::cp_async_commit();
    // Phase 1b: dQ = ds_c · k, the warp's slabs.
    for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
      float acc[kDT][4] = {};
      const bf16* pa = attn::tc_lane_a(dss + r0 * pld, pld);
      const bf16* kb = attn::tc_lane_bt(bs, ld);
      for (int c = 0; c < kp; c += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + c);
        attn::tc_mma_bt(acc, fa, kb + c * ld, Dh / 8);
      }
      full_tc::store_rows(acc, dq + q_off + (size_t)c0 * D, D, r0, rows, Dh);
    }
    attn::cp_async_wait<0>();
    __syncthreads();  // q is in

    // Phase 2b: dK (+)= ds_cᵀ · q.
    for (int k0 = 16 * warp; k0 < kp; k0 += 16 * nw) {
      float acc[kDT][4] = {};
      for (int c = 0; c < rp; c += 16) {
        uint32_t fa[4];
        attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * pld + k0, pld));
        attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
      }
      emit_keys(acc, dk + k_off, D, dk_sum, k0, K, Dh, multi, first, last);
    }
    if (!last) __syncthreads();  // the next chunk restages A (and pd or P)
  }
}

template <int kDT>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_rel_saved_tc_kernel(BwdArgs a, int qc, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_rows<kDT, false, false>(smem_raw, a.q, a.k, a.v, a.g, a.p, a.pd,
                              nullptr, a.dq, a.dk, a.dv, a.debias, a.Q, a.K,
                              a.H, a.Dh, a.scale, qc, pairs, false,
                              DropoutArgs{0ull, 0u, 1.0f});
}

template <int kDT, bool kDropout, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_bwd_rel_tc_kernel(BwdArgs a, int qc, bool pairs, bool eb_pairs,
                           DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_rows<kDT, true, kDropout>(smem_raw, a.q, a.k, a.v, a.g, nullptr,
                                nullptr, a.ebias, a.dq, a.dk, a.dv, a.debias,
                                a.Q, a.K, a.H, a.Dh, a.scale, qc, pairs,
                                eb_pairs, drop);
}

// The backward's warps: one per 16-row slab or 16-key slice of the larger
// of the chunk and K16, at most 8.
inline int bwd_warps(int qc, int k_len) {
  const int rows = qc > rows16(k_len) ? qc : rows16(k_len);
  return rows / 16 < kBwdThreads / 32 ? rows / 16 : kBwdThreads / 32;
}

template <int kDT, typename Args>
int launch_bwd_dt(const Args& a, int qc, bool pairs, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_bwd_rel_saved_tc_kernel<kDT>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_rel_saved_tc_kernel<kDT>
      <<<dim3(a.H, a.B), bwd_warps(qc, a.K) * 32,
         bwd_smem_bytes(qc, a.K, a.Dh, qc < a.Q), st>>>(a, qc, pairs);
  return (int)cudaGetLastError();
}

// The bf16 saved-probs backward of #13. q, k, v and g must start on the 16
// bytes cp.async copies. Returns the cudaError_t of the launch; a shape
// past the plan returns cudaErrorInvalidValue. (A template on the
// arguments, here always BwdArgs: see launch_fwd.)
template <typename Args>
int launch_bwd(const Args& a, cudaStream_t st) {
  const int qc = a.K <= kMaxK ? bwd_q_chunk(a.Q, a.K, a.Dh) : 0;
  if (qc == 0) return (int)cudaErrorInvalidValue;
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) ||
      !aligned(a.g, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs = a.K % 2 == 0 && aligned(a.p, 4) && aligned(a.pd, 4) &&
                     aligned(a.debias, 4);
  return dh_tiles(a.Dh) == 8 ? launch_bwd_dt<8>(a, qc, pairs, st)
                             : launch_bwd_dt<16>(a, qc, pairs, st);
}

// #12's blocks an SM where its block has at most four warps at Dh ≤ 64
// (every shape with Q, K ≤ 64): its build held to 128 registers. Its
// wider blocks at Dh ≤ 64 are built for kRcWideBlocks an SM where their
// shared memory allows as many (228 KB an SM, 1 KB reserved a block).
constexpr int kRcSmallBlocks = 4;
constexpr int kRcSmallThreads = 128;
constexpr int kRcWideBlocks = 2;

template <int kDT, bool kDropout, int kThreads, int kMinBlocks, typename Args>
int launch_bwd_rc_build(const Args& a, int qc, bool pairs, bool eb_pairs,
                        const DropoutArgs& drop, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_rel_tc_kernel<kDT, kDropout, kThreads, kMinBlocks>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_rel_tc_kernel<kDT, kDropout, kThreads, kMinBlocks>
      <<<dim3(a.H, a.B), bwd_warps(qc, a.K) * 32,
         bwd_smem_bytes(qc, a.K, a.Dh, qc < a.Q, true), st>>>(
          a, qc, pairs, eb_pairs, drop);
  return (int)cudaGetLastError();
}

template <int kDT, bool kDropout, typename Args>
int launch_bwd_rc_dt(const Args& a, int qc, bool pairs, bool eb_pairs,
                     const DropoutArgs& drop, cudaStream_t st) {
  if constexpr (kDT == 8) {
    if (bwd_warps(qc, a.K) * 32 <= kRcSmallThreads)
      return launch_bwd_rc_build<kDT, kDropout, kRcSmallThreads,
                                 kRcSmallBlocks>(a, qc, pairs, eb_pairs, drop,
                                                 st);
    if (kRcWideBlocks *
            (bwd_smem_bytes(qc, a.K, a.Dh, qc < a.Q, true) + 1024) <=
        228 * 1024)
      return launch_bwd_rc_build<kDT, kDropout, kBwdThreads, kRcWideBlocks>(
          a, qc, pairs, eb_pairs, drop, st);
  }
  return launch_bwd_rc_build<kDT, kDropout, kBwdThreads, 1>(
      a, qc, pairs, eb_pairs, drop, st);
}

// The bf16 recompute backward of #12: p again with #11's bits and the keep
// mask replayed at (k >> 2, q, h, b), then #13's phases. q, k, v and g must
// start on the 16 bytes cp.async copies. Returns the cudaError_t of the
// launch; a shape past the plan returns cudaErrorInvalidValue.
template <typename Args>
int launch_bwd_rc(const Args& a, bool dropout, const DropoutArgs& drop,
                  cudaStream_t st) {
  const int qc = a.K <= kMaxK ? bwd_q_chunk(a.Q, a.K, a.Dh, true) : 0;
  if (qc == 0) return (int)cudaErrorInvalidValue;
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) ||
      !aligned(a.g, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs = a.K % 2 == 0 && aligned(a.debias, 4);
  const bool eb_pairs = a.K % 2 == 0 && aligned(a.ebias, 4);
  if (dh_tiles(a.Dh) == 8)
    return dropout
               ? launch_bwd_rc_dt<8, true>(a, qc, pairs, eb_pairs, drop, st)
               : launch_bwd_rc_dt<8, false>(a, qc, pairs, eb_pairs, drop, st);
  return dropout
             ? launch_bwd_rc_dt<16, true>(a, qc, pairs, eb_pairs, drop, st)
             : launch_bwd_rc_dt<16, false>(a, qc, pairs, eb_pairs, drop, st);
}

}  // namespace rel_tc

}  // namespace
