// The bf16 tensor-core plans of the full-H ingredients rel kernels: the
// forward #20 (attn_fwd_relik.cu), the recompute backward #21
// (attn_bwd_relik.cu) and the saved-probs backward #22
// (attn_bwd_relik_saved.cu), which runs #21's block code without its
// recompute.
// fp32 keeps their CUDA-core kernels and their bits.
//
// What they compute is #20's and #21's function, per batch row b and head
// h, from rw, rr [B, Q, D], r [P, D] (P ≥ Q + K), k, v [B, K, D], ed
// [B, H, Q], segd, maskb [B, Q, K] (head-major columns h·Dh + c):
//   s    = ((rw · k) · scale + rr · r[Q − q + k]) + ed · segd + maskb
//          (common.cuh's `relik_combine` order; every dot summed in fp32)
//   p    = softmax_k(s) (fp32, max-subtracted); save: p_out = bf16(p);
//          rate > 0: pd = keep ? p · inv_keep : 0 (the Philox stream at
//          (k >> 2, q, h, b)); save: pd_out = bf16(pd); out = bf16(pd) · v
//   #21: p and pd recomputed (#22: read from the saved bf16 probs);
//        t = pd ⊙ (g · vᵀ); ds = t − p · Σ_k t;
//        ded = Σ_k ds · segd; ds_c = bf16(ds · scale), ds_u = bf16(ds);
//        dv = bf16(pd)ᵀ · g, drw = ds_c · k, dk = ds_cᵀ · rw,
//        drr[q] = Σ_k ds_u[q][k] · r[Q − q + k], and this (b, h)'s fp32
//        rows ws[b][p] = Σ_q ds_u[q][p − Q + q] · rr[q] of the [B, P, D]
//        workspace that #24's third launch sums over B into dr.
//
// What bounds them on the card: at XLNet's serving shape (B=128, Q=K=50,
// H=12, Dh=64) #20 moves ~51 MB (0.015 ms) and does ~1.5 GFLOP; #21 at
// B=256 reads and writes ~181 MB plus the 79 MB workspace (0.054 ms) and
// does ~8 GFLOP. Both were latency-bound on the CUDA cores (fp32 fmaf
// chains from shared memory; 0.41 and 1.94 ms on an NVIDIA H100 80GB HBM3
// at 700 W). The design is attn_rel_full_tc.cuh's (#11, #13): every
// product on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix
// from operands cp.async staged, the elementwise work on the accumulators.
//
// The scores (`relik_scores`, one function for both kernels, so that #21's
// p has #20's bits): a warp takes 16 query rows against 8·NK keys. ac =
// rw · kᵀ into registers. bd is the relative shift on the tensor cores, as
// #23 does it: the wide product BDʷ = rr · windowᵀ over the window rows the
// slab reads (row i of the slab reads window row (15 − i) + j for key j:
// 15 + 8·NK rows, NK + 2 n8 tiles), read on its diagonal. A lane holds the
// other lanes' diagonal, so the diagonal goes through a small fp32 strip in
// shared memory (dynamic register indexing would spill). Window rows
// outside [0, P) are zero (`cp_window`). s is assembled in the
// accumulators, segd and maskb read in their layout (bf16x2 while K is
// even, 2-byte loads otherwise), −inf past K; rows past Q come out finite
// (their staged rows are zero) and are never stored.
//
// #20, register plan (K ≤ kRegMaxK = 64; `attn_fwd_relik_tc_reg_kernel`):
// #11's plan, one block per (64-row query tile, head, batch row) of
// rows16(min(Q, 64)) / 16 warps, each warp one NK = 8 score slab (its
// strip [16][72] fp32 over the window, once every warp has read that),
// then #11's register softmax, keep bits
// from lane pairs, p/pd stores and PV (attn_rel_full_tc.cuh's
// `reg_softmax`, `reg_probs_pv`). Shared memory (ops/fused_attention.py::
// relik_full_tc_fwd_smem_bytes): rw, rr [Q16][L], k, v [K16][L] and the
// window [Q16 + 64][L] bf16 (Q16: min(Q, 64) rounded up to 16, K16: K
// rounded up to 16, L: Dh rounded up to 16, + 8), the strips [Q16][72]
// fp32 over the window: 55.3 KB at Q = K = 50, Dh = 64 (four blocks an SM).
//
// #20, score-tile plan (64 < K ≤ 512; `attn_fwd_relik_tc_smem_kernel`):
// #11's score-tile plan with the fp32 score tile [32][keys + 4] seeded by
// the scores of the ingredients in place of the ebias rows: 8 warps per
// (32-row query tile, head, batch row), each key block of 64 cut into
// 16 × 16 units (NK = 2, the unit's strip its own place in the score
// tile). A two-stage ring holds the key block with the 96 window rows its
// units read ([64 + 96][L]), then the v blocks; `tc_hb_softmax_rows` in its
// save mode, PV by ldmatrix. Shared memory (`fwd_smem_bytes`): 72.2 KB at
// K = 100, Dh = 64; 170.5 KB at K = 512, Dh = 128.
//
// #21 (`attn_bwd_relik_tc_kernel`): #13's plan with a recompute phase in
// front and #24's unshift behind, one block of 8 warps per (head, batch
// row) over chunks of the query rows (one chunk, all of them, wherever
// that fits), two blocks an SM where their shared memory allows at Dh ≤ 64
// (`launch_bwd_dt`). Per chunk:
//   0. rw, rr, k and the chunk's window (rows16(rows) + K16 rows of r)
//      staged; the scores by `relik_scores` in 16 × 16 units into an fp32
//      tile P [chunk][K16 + 4]; the softmax with the keep bit in p's sign:
//      K ≤ 64 #20's register softmax and lane-pair bits, past it
//      common.cuh's `softmax_rows_keep_sign` (the order of
//      `tc_hb_softmax_rows`), so p has #20's bits either way.
//   1. g, v staged; warps on 16-row slabs: d(pd) = g · vᵀ 64 keys at a
//      time, t = pd ⊙ d(pd), Σ_k t from the lane's keys in order then the
//      quad (a second pass past K = 64, as #13); ds = t − p · Σt in fp32,
//      ded = Σ_k ds · segd in the same lane order; pd_c = bf16(pd) over
//      the slab's own P rows (each written after the warp has read them),
//      ds_c = bf16(ds · scale) to its tile, ds_u skewed into S′[r][(15 −
//      r mod 16) + k], a [16][K16 + 16] band per slab, zeros round it.
//   2. k streams into B while the warps run dV (+)= pd_cᵀ · g (key
//      slices), drr = S′ · window (slabs) and dr = S′ᵀ · rr (16-row window
//      tiles, S′ᵀ by ldmatrix.trans, the slabs whose band reaches the tile
//      in order), the dr rows stored into the workspace slice (added from
//      the second chunk on; the rows no chunk's window reaches are zeroed
//      at the first, so the slice is written whole); then rw streams into
//      A while drw = ds_c · k runs, then dK (+)= ds_cᵀ · rw. With more than
//      one chunk dK and dV add into fp32 sums [K16][Dh] (#13's
//      `emit_keys`).
// #22 (`attn_bwd_relik_saved_tc_kernel`) runs the same block code
// (`bwd_block`) with phase 0 replaced: g, v, rr and the window are staged
// at once, the chunk's saved pd rows go straight into the pd_c tile over P
// (bf16, K·2 bytes apart: 4-byte pair loads while K is even, 2-byte loads
// otherwise) and phase 1 reads p from device memory in the accumulator
// layout, as #13 does; it writes no pd_c. Phases 1-2 are #21's code (#21
// reads p and pd in fp32 where #22 reads them rounded, so the two agree
// within `relik_full_grads_bf16_bound`, not bit for bit).
// Every reduction has one order: no atomics, the same bits twice. Shared
// memory (`bwd_smem_bytes`, ops/fused_attention.py::
// relik_full_tc_bwd_smem_bytes): 84.0 KB at Q = K = 50, Dh = 64; it covers
// every (Q, K, Dh) that ops/fused_attention.py::relik_bwd_fits admits
// (query chunks of 16 rows or more).
//
// Against the fp32 kernels: a bf16 × bf16 product is exact in fp32, so a
// dot differs from the CUDA-core fmaf chain of the same values only in the
// order of its sum, and so do the row sums; the roundings sit where the
// fp32 kernels put them. bf16 #20 and #21 are held to their plain versions
// within the forward bound and `relik_full_grads_bf16_bound`, not bit for
// bit.

#pragma once

#include "attn_rel_full_tc.cuh"

// Internal linkage in each translation unit that includes this header.
namespace {

namespace relik_tc {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;
using full_tc::aligned;
using full_tc::dh_tiles;
using full_tc::rows16;

constexpr int kRegMaxK = rel_tc::kRegMaxK;  // REL_TC_REG_MAX_K
constexpr int kRegTiles = rel_tc::kRegTiles;
constexpr int kRegQTile = rel_tc::kRegQTile;
constexpr int kBandTiles = kRegTiles + 2;  // window n8 tiles a slab reads
constexpr int kStripLd = kRegMaxK + 8;     // the register plan's strip row
constexpr int kSmemQTile = 32;             // the score-tile plan's q tile
constexpr int kKBlock = 64;
constexpr int kSmemWin = kSmemQTile + kKBlock;  // its window rows a block
constexpr int kStage = kKBlock + kSmemWin;      // its ring stage's rows
constexpr int kMaxK = 512;                      // MAX_SEQ_LEN
constexpr int kBwdThreads = 256;
constexpr int kBwdTiles = 8;  // the backward's n8 key tiles in registers

// Where one (batch row, head)'s bias ingredients live: ed[b, h] [Q],
// segd[b] and maskb[b] [Q][K]; `pairs`: segd and maskb read as bf16x2 (K
// even, both 4-byte aligned).
struct Bias {
  const bf16* ed;
  const bf16* segd;
  const bf16* maskb;
  int Q, K;
  bool pairs;
};

__device__ __forceinline__ Bias bias_of(const bf16* ed, const bf16* segd,
                                        const bf16* maskb, int b, int h,
                                        int H, int Q, int K, bool pairs) {
  const size_t qk = (size_t)b * Q * K;
  return {ed + ((size_t)b * H + h) * Q, segd + qk, maskb + qk, Q, K, pairs};
}

// Elements j, j + 1 (j even) of row q of a [Q][K] bf16 tensor, as fp32; 0
// where q ≥ Q or past K.
__device__ __forceinline__ float2 qk_pair(const bf16* t, int q, int j,
                                          const Bias& bs) {
  float2 f = make_float2(0.0f, 0.0f);
  if (q < bs.Q && j < bs.K) {
    const bf16* src = t + (size_t)q * bs.K + j;
    if (bs.pairs) {
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    } else {
      f.x = __bfloat162float(src[0]);
      if (j + 1 < bs.K) f.y = __bfloat162float(src[1]);
    }
  }
  return f;
}

// ed of the lane's rows q_lo and q_lo + 8 (0 past Q).
__device__ __forceinline__ void lane_ed(float (&ed2)[2], const Bias& bs,
                                        int q_lo) {
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int q = q_lo + 8 * hi;
    ed2[hi] = q < bs.Q ? __bfloat162float(bs.ed[q]) : 0.0f;
  }
}

// dst rows w < rows (row stride ld) = r_head rows p0 + w (row stride D, Dh
// columns) where 0 ≤ p0 + w < P, zeros elsewhere, by cp.async (the caller
// commits).
__device__ __forceinline__ void cp_window(bf16* dst, int ld,
                                          const bf16* r_head, int D, int P,
                                          long long p0, int rows, int Dh) {
  const long long lo = p0 < 0 ? -p0 : 0;
  const long long hi = P - p0;
  attn::tc_cp_rows(dst, ld, r_head, (size_t)D, p0, rows,
                   (int)min(lo, (long long)rows),
                   (int)max(0ll, min(hi, (long long)rows)), Dh);
}

// One warp's scores for its 16 query rows (global q_lo = lane / 4 + the
// slab's first row, and q_lo + 8) against keys k0 + 8t + 2·(lane % 4) +
// {0, 1}, t < nk (nk ≤ NK, even), in the accumulators of
// `full_tc::warp_abt<NK>` (−inf past K): rw_s, rr_s the slab's staged rows,
// k_s the staged key rows from k0, win_s the staged r rows from r[Q −
// q_lo(lane 0) − 15 + k0], all bf16 with row stride ld and depth kd; the
// diagonal of BDʷ through strip [16][8·nk] (fp32, row stride sld). With
// kBlockSync every warp of the block calls it once and the strips may lie
// over the window: a barrier parts the BDʷ products from the strips.
template <int NK, bool kBlockSync = false>
__device__ __forceinline__ void relik_scores(
    float (&sc)[NK][4], const bf16* rw_s, const bf16* rr_s, const bf16* k_s,
    const bf16* win_s, int ld, int kd, int nk, float* strip, int sld,
    const Bias& bs, const float (&ed2)[2], int q_lo, int k0, float scale) {
  constexpr int NB = NK + 2;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  {
    // BDʷ[i][c] = rr_i · window_c; bd[i][j] = BDʷ[i][(15 − i) + j]
    float bw[NB][4] = {};
    full_tc::warp_abt<NB>(bw, rr_s, win_s, ld, kd, nk + 2);
    if constexpr (kBlockSync) __syncthreads();  // every warp's window read
#pragma unroll
    for (int t = 0; t < NB; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g4 + 8 * (e >> 1);
        const int j = 8 * t + 2 * t4 + (e & 1) - (15 - i);
        if (t < nk + 2 && j >= 0 && j < 8 * nk) strip[i * sld + j] = bw[t][e];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NK; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.0f;
  full_tc::warp_abt<NK>(sc, rw_s, k_s, ld, kd, nk);
#pragma unroll
  for (int t = 0; t < NK; ++t) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = g4 + 8 * hi, q = q_lo + 8 * hi;
      const int j = 8 * t + 2 * t4, k = k0 + j;
      float2 s = make_float2(-INFINITY, -INFINITY);
      if (t < nk && k < bs.K) {
        const float2 bd = *reinterpret_cast<const float2*>(strip + i * sld + j);
        const float2 sg = qk_pair(bs.segd, q, k, bs);
        const float2 mk = qk_pair(bs.maskb, q, k, bs);
        s.x = attn::relik_combine(sc[t][2 * hi], bd.x, scale, ed2[hi], sg.x,
                                  mk.x);
        if (k + 1 < bs.K)
          s.y = attn::relik_combine(sc[t][2 * hi + 1], bd.y, scale, ed2[hi],
                                    sg.y, mk.y);
      }
      sc[t][2 * hi] = s.x;
      sc[t][2 * hi + 1] = s.y;
    }
  }
}

// Where the bf16 forward's tensors live.
struct FwdArgs {
  const bf16* rw;
  const bf16* rr;
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const bf16* ed;
  const bf16* segd;
  const bf16* maskb;
  bf16* out;
  bf16* p;   // null: no save
  bf16* pd;
  int B, Q, K, P, H, Dh;
  float scale;
};

// ---- #20, register plan (K ≤ kRegMaxK) -------------------------------------

// rw, rr [qp][L], k, v [K16][L], then the window [qp + 64][L] bf16 and,
// over it once read, the warps' strips [qp][kStripLd] fp32.
__host__ __device__ inline size_t fwd_reg_smem_bytes(int q_len, int k_len,
                                                     int dh) {
  const int qp = rows16(q_len < kRegQTile ? q_len : kRegQTile);
  const size_t win = (size_t)(qp + 8 * kBandTiles - 16) * attn::tc_ld(dh) *
                     sizeof(bf16);
  const size_t strips = (size_t)qp * kStripLd * sizeof(float);
  return (size_t)(2 * qp + 2 * rows16(k_len)) * attn::tc_ld(dh) *
             sizeof(bf16) +
         (win > strips ? win : strips);
}

template <int kDT, bool kDropout, bool kSave>
__global__ void __launch_bounds__(rel_tc::kRegThreads)
    attn_fwd_relik_tc_reg_kernel(FwdArgs a, bool pairs, bool p_pairs,
                                 DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kRegQTile, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, K = a.K, Dh = a.Dh, D = a.H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int qp = blockDim.x / 2;  // staged q rows: 16 a warp
  const int kp = rows16(K), nkt = kp / 8;
  const int wrows = qp + 8 * kBandTiles - 16;
  const int q_rows = min(qp, Q - q0);
  bf16* rws = reinterpret_cast<bf16*>(smem_raw);  // [qp][ld]
  bf16* rrs = rws + qp * ld;                       // [qp][ld]
  bf16* ks = rrs + qp * ld;                        // [kp][ld]
  bf16* vs = ks + kp * ld;                         // [kp][ld]
  bf16* win = vs + kp * ld;  // [wrows][ld]: r rows Q − q0 − qp + 1 + w
  float* strip = reinterpret_cast<float*>(win);  // [qp][72], over win

  const size_t q_off = ((size_t)b * Q + q0) * D + h * Dh;
  const size_t kv_off = (size_t)b * K * D + h * Dh;
  attn::tc_cp_rows(rws, ld, a.rw + q_off, D, 0, qp, 0, q_rows, Dh);
  attn::tc_cp_rows(rrs, ld, a.rr + q_off, D, 0, qp, 0, q_rows, Dh);
  attn::tc_cp_rows(ks, ld, a.k + kv_off, D, 0, kp, 0, K, Dh);
  attn::tc_cp_rows(vs, ld, a.v + kv_off, D, 0, kp, 0, K, Dh);
  cp_window(win, ld, a.r + h * Dh, D, a.P, (long long)Q - q0 - qp + 1, wrows,
            Dh);
  attn::cp_async_commit();
  // the pad columns of rw, rr, k, v and the window
  attn::tc_zero_cols(rws, ld, 2 * qp + 2 * kp + wrows, Dh, kd);
  const Bias bs = bias_of(a.ed, a.segd, a.maskb, b, h, a.H, Q, K, pairs);
  const int m0 = warp * 16;
  const int q_lo = q0 + m0 + (lane >> 2);  // global rows q_lo and q_lo + 8
  float ed2[2];
  lane_ed(ed2, bs, q_lo);
  attn::cp_async_wait<0>();
  __syncthreads();

  // The warp's slab reads window rows from qp − 16 − m0 on.
  float sc[kRegTiles][4];
  relik_scores<kRegTiles, true>(sc, rws + m0 * ld, rrs + m0 * ld, ks,
                          win + (qp - 16 - m0) * ld, ld, kd, nkt,
                          strip + m0 * kStripLd, kStripLd, bs, ed2, q_lo, 0,
                          a.scale);
  float sum[2];
  rel_tc::reg_softmax(sc, sum, K);
  rel_tc::reg_probs_pv<kDT, kDropout, kSave>(
      sc, sum, vs, ld, a.out + q_off, D, a.p, a.pd,
      ((size_t)b * a.H + h) * Q, q_lo, Q, K, nkt, m0, q_rows, Dh, b, h,
      p_pairs, drop);
}

// ---- #20, score-tile plan (kRegMaxK < K ≤ kMaxK) ---------------------------

__host__ __device__ inline size_t fwd_smem_bytes(int k_len, int dh) {
  return (size_t)kSmemQTile * rel_tc::smem_ss_ld(k_len) * sizeof(float) +
         (size_t)(2 * kSmemQTile + 2 * kStage) * attn::tc_ld(dh) *
             sizeof(bf16);
}

template <bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_relik_tc_smem_kernel(FwdArgs a, bool pairs, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = a.Q, K = a.K, Dh = a.Dh, D = a.H * Dh;
  const int q0 = blockIdx.x * kSmemQTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int ssld = rel_tc::smem_ss_ld(K), keys = rel_tc::smem_keys(K);
  const int n_blocks = keys / kKBlock;
  const int stage = kStage * ld;

  float* ss = reinterpret_cast<float*>(smem_raw);  // [32][ssld]: s, then P
  bf16* rws = reinterpret_cast<bf16*>(ss + kSmemQTile * ssld);  // [32][ld]
  bf16* rrs = rws + kSmemQTile * ld;                            // [32][ld]
  // 2 × [kStage][ld]: k block i and its window (r rows Q − q0 − 31 + 64i
  // + w, w < 96), then the v blocks
  bf16* ring = rrs + kSmemQTile * ld;

  const size_t q_off = ((size_t)b * Q + q0) * D + h * Dh;
  const size_t kv_off = (size_t)b * K * D + h * Dh;
  const size_t prow0 = ((size_t)b * a.H + h) * Q + q0;  // the tile's row
  const int q_rows = min(kSmemQTile, Q - q0);
  const long long p0 = (long long)Q - q0 - (kSmemQTile - 1);

  // Block i of the stream, into stage i & 1: k block i with its window for
  // i < n_blocks, then v block i − n_blocks. Each its own cp.async group.
  auto load = [&](int i) {
    bf16* dst = ring + (i & 1) * stage;
    const bool is_k = i < n_blocks;
    const int k0 = (is_k ? i : i - n_blocks) * kKBlock;
    attn::tc_cp_rows(dst, ld, (is_k ? a.k : a.v) + kv_off, (size_t)D, k0,
                     kKBlock, 0, min(kKBlock, K - k0), Dh);
    if (is_k)
      cp_window(dst + kKBlock * ld, ld, a.r + h * Dh, D, a.P, p0 + k0,
                kSmemWin, Dh);
  };
  attn::tc_cp_rows(rws, ld, a.rw + q_off, (size_t)D, 0, kSmemQTile, 0,
                   q_rows, Dh);
  attn::tc_cp_rows(rrs, ld, a.rr + q_off, (size_t)D, 0, kSmemQTile, 0,
                   q_rows, Dh);
  load(0);
  attn::cp_async_commit();  // rw, rr and k block 0
  // The k-depth's pad columns of rw, rr and both ring stages stay zero.
  attn::tc_zero_cols(rws, ld, 2 * kSmemQTile + 2 * kStage, Dh, kd);
  const Bias bs = bias_of(a.ed, a.segd, a.maskb, b, h, a.H, Q, K, pairs);

  // Scores: warp w takes rows m0 .. m0 + 15 and keys kq .. kq + 15 of each
  // block. PV: rows m0 .. m0 + 15 and n8 tiles c0 / 8 .. c0 / 8 + n − 1.
  const int m0 = (warp & 1) * 16;
  const int kq = (warp >> 1) * 16;
  const int q_lo = q0 + m0 + (lane >> 2);
  float ed2[2];
  lane_ed(ed2, bs, q_lo);
  const int tiles = Dh / 8, per = (tiles + 3) / 4;
  const int c0 = (warp >> 1) * per * 8;
  const int n = max(0, min(per, tiles - (warp >> 1) * per));
  constexpr int kPvTiles = attn::kTcMaxDh / 32;
  float acc[kPvTiles][4] = {};
  const bf16* ps = reinterpret_cast<const bf16*>(ss);  // P, rows of 2·ssld

  for (int i = 0; i < 2 * n_blocks; ++i) {
    attn::cp_async_wait<0>();  // block i
    __syncthreads();  // ... for every thread; block i − 1 is done
    if (i + 1 < 2 * n_blocks) load(i + 1);
    attn::cp_async_commit();
    const bf16* blk = ring + (i & 1) * stage;
    if (i < n_blocks) {
      // The unit's scores, its strip its own place in the score tile; its
      // slab reads window rows from 16 − m0 + kq on.
      const int k0 = i * kKBlock;
      if (k0 + kq < K) {
        float* unit = ss + m0 * ssld + k0 + kq;
        float sc[2][4];
        relik_scores<2>(sc, rws + m0 * ld, rrs + m0 * ld, blk + kq * ld,
                        blk + (kKBlock + 16 - m0 + kq) * ld, ld, kd, 2, unit,
                        ssld, bs, ed2, q_lo, k0 + kq, a.scale);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            *reinterpret_cast<float2*>(
                unit + ((lane >> 2) + 8 * hi) * ssld + 8 * t +
                2 * (lane & 3)) = make_float2(sc[t][2 * hi], sc[t][2 * hi + 1]);
      }
      if (i == n_blocks - 1) {
        __syncthreads();  // every score is in
        attn::tc_hb_softmax_rows<kDropout, kSave>(ss, ssld, q_rows, K, q0, b,
                                                  h, drop, prow0, a.p, a.pd);
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
  bf16* out_tile = a.out + q_off + c0;
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

// ---- #20's launch -----------------------------------------------------------

__host__ __device__ inline size_t fwd_plan_bytes(int q_len, int k_len,
                                                 int dh) {
  return k_len <= kRegMaxK ? fwd_reg_smem_bytes(q_len, k_len, dh)
                           : fwd_smem_bytes(k_len, dh);
}

template <int kDT, bool kDropout, bool kSave, typename Args>
int launch_fwd_reg(const Args& a, bool pairs, const DropoutArgs& drop,
                   cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_relik_tc_reg_kernel<kDT, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const bool p_pairs = a.K % 2 == 0 && aligned(a.p, 4) && aligned(a.pd, 4);
  const int threads = rows16(a.Q < kRegQTile ? a.Q : kRegQTile) / 16 * 32;
  attn_fwd_relik_tc_reg_kernel<kDT, kDropout, kSave>
      <<<dim3((a.Q + kRegQTile - 1) / kRegQTile, a.H, a.B), threads,
         fwd_reg_smem_bytes(a.Q, a.K, a.Dh), st>>>(a, pairs, p_pairs, drop);
  return (int)cudaGetLastError();
}

template <bool kDropout, bool kSave, typename Args>
int launch_fwd_mode(const Args& a, const DropoutArgs& drop, cudaStream_t st) {
  const bool pairs =
      a.K % 2 == 0 && aligned(a.segd, 4) && aligned(a.maskb, 4);
  if (a.K > kRegMaxK) {
    static unsigned long long attr_set = 0;
    const cudaError_t err = attn::allow_max_smem(
        attn_fwd_relik_tc_smem_kernel<kDropout, kSave>, &attr_set);
    if (err != cudaSuccess) return (int)err;
    attn_fwd_relik_tc_smem_kernel<kDropout, kSave>
        <<<dim3((a.Q + kSmemQTile - 1) / kSmemQTile, a.H, a.B),
           attn::kTcThreads, fwd_smem_bytes(a.K, a.Dh), st>>>(a, pairs, drop);
    return (int)cudaGetLastError();
  }
  return dh_tiles(a.Dh) == 8
             ? launch_fwd_reg<8, kDropout, kSave>(a, pairs, drop, st)
             : launch_fwd_reg<16, kDropout, kSave>(a, pairs, drop, st);
}

// The bf16 forward of #20. rw, rr, r, k and v must start on the 16 bytes
// cp.async copies (their rows, D·2 bytes apart, and a head's first column,
// h·Dh·2 bytes in, then are too). Returns the cudaError_t of the launch; a
// shape past the plan returns cudaErrorInvalidValue. (A template on the
// arguments, here always FwdArgs, so that only the sources that launch the
// forward compile its kernels; launch_bwd likewise.)
template <typename Args>
int launch_fwd(const Args& a, bool dropout, const DropoutArgs& drop,
               cudaStream_t st) {
  if (a.K > kMaxK || fwd_plan_bytes(a.Q, a.K, a.Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!aligned(a.rw, 16) || !aligned(a.rr, 16) || !aligned(a.r, 16) ||
      !aligned(a.k, 16) || !aligned(a.v, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool save = a.p != nullptr;
  if (dropout && save) return launch_fwd_mode<true, true>(a, drop, st);
  if (dropout) return launch_fwd_mode<true, false>(a, drop, st);
  if (save) return launch_fwd_mode<false, true>(a, drop, st);
  return launch_fwd_mode<false, false>(a, drop, st);
}

// ---- #21, the recompute backward -------------------------------------------

__host__ __device__ inline int bwd_p_ld(int k_len) {  // P, fp32
  return rows16(k_len) + 4;
}
__host__ __device__ inline int bwd_sp_ld(int k_len) {  // S′, bf16
  return rows16(k_len) + 24;
}

// Shared memory of a #21 block whose query chunk holds qc rows (a multiple
// of 16): A, R [qc][L], B [K16][L] and the window [qc + K16][L], bf16; P
// [qc][K16 + 4] fp32 (pd_c over it); ds_c [qc][K16 + 8] and S′
// [qc][K16 + 24], bf16; with more than one chunk (`multi`) the fp32 dK and
// dV sums [K16][Dh].
__host__ __device__ inline size_t bwd_smem_bytes(int qc, int k_len, int dh,
                                                 bool multi) {
  const int kp = rows16(k_len);
  return (size_t)(3 * qc + 2 * kp) * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)qc * bwd_p_ld(k_len) * sizeof(float) +
         (size_t)qc * (rel_tc::bwd_pld(k_len) + bwd_sp_ld(k_len)) *
             sizeof(bf16) +
         (multi ? 2 * (size_t)kp * dh * sizeof(float) : 0);
}

// The query chunk: all of Q's rows (rounded up to 16) where they fit, else
// the most 16-row slabs that fit beside the dK/dV sums; 0 where not even 16
// do (ops/fused_attention.py::relik_full_tc_bwd_q_chunk).
inline int bwd_q_chunk(int q_len, int k_len, int dh) {
  const int qp = rows16(q_len);
  if (bwd_smem_bytes(qp, k_len, dh, false) <= attn::kMaxSmemBytes) return qp;
  int qc = 0;
  while (qc + 16 < qp &&
         bwd_smem_bytes(qc + 16, k_len, dh, true) <= attn::kMaxSmemBytes)
    qc += 16;
  return qc;
}

// Where the bf16 backward's tensors live.
struct BwdArgs {
  const bf16* rw;
  const bf16* rr;
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const bf16* ed;
  const bf16* segd;
  const bf16* maskb;
  const bf16* g;
  bf16* drw;
  bf16* drr;
  bf16* dk;
  bf16* dv;
  bf16* ded;
  float* ws;  // [B, P, D]
  int B, Q, K, P, H, Dh;
  float scale;
  const bf16* p;  // #22: the saved probs [B, H, Q, K] (null for #21)
  const bf16* pd;
};

// One (head, batch row)'s block. kSaved: #22, p and pd read from the saved
// probs (ed and maskb unused, `p_pairs`: them read as bf16x2); else #21,
// both recomputed.
template <int kDT, bool kDropout, bool kSaved>
__device__ __forceinline__ void bwd_block(unsigned char* smem_raw,
                                          const BwdArgs& a, int qc,
                                          bool pairs, bool p_pairs,
                                          const DropoutArgs& drop) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, K = a.K, P = a.P, Dh = a.Dh, D = a.H * Dh;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int kp = rows16(K), nkt = kp / 8, nk16 = kp / 16;
  const int pl4 = bwd_p_ld(K), pld = rel_tc::bwd_pld(K), spl = bwd_sp_ld(K);
  const bool multi = qc < Q;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [qc][ld]: rw, g, rw
  bf16* rs = as + qc * ld;                        // [qc][ld]: rr
  bf16* bs = rs + qc * ld;                        // [kp][ld]: k, v, k
  bf16* win = bs + kp * ld;                       // [qc + kp][ld]
  float* ps = reinterpret_cast<float*>(win + (qc + kp) * ld);  // [qc][pl4]
  bf16* pds = reinterpret_cast<bf16*>(ps);       // [qc][2·pl4]: pd_c over P
  bf16* dss = reinterpret_cast<bf16*>(ps + qc * pl4);  // [qc][pld]: ds_c
  bf16* sps = dss + qc * pld;                          // [qc][spl]: S′
  float* dk_sum = reinterpret_cast<float*>(sps + qc * spl);  // [kp][Dh]
  float* dv_sum = dk_sum + kp * Dh;

  const size_t q_base = (size_t)b * Q * D + h * Dh;  // row q at + q · D
  const size_t k_base = (size_t)b * K * D + h * Dh;
  const Bias bsx = bias_of(a.ed, a.segd, a.maskb, b, h, a.H, Q, K, pairs);
  bf16* ded_bh = a.ded + ((size_t)b * a.H + h) * Q;
  float* ws_bh = a.ws + (size_t)b * P * D + h * Dh;
  const float inv_keep = drop.inv_keep;
  const size_t prow0 = ((size_t)b * a.H + h) * Q;  // saved row q at + q · K

  attn::tc_zero_cols(as, ld, 3 * qc + 2 * kp, Dh, kd);  // the pad columns

  for (int c0 = 0; c0 < Q; c0 += qc) {
    const int rows = min(qc, Q - c0), rp = rows16(rows), nsl = rp / 16;
    const bool first = c0 == 0, last = c0 + qc >= Q;
    // window row w holds r[pw + w]; slab m0 reads from rp − 16 − m0 on
    const long long pw = (long long)Q - c0 - rp + 1;
    const int wrows = rp + kp;
    // #21 stages rw and k for the scores; #22 g and v for phase 1.
    attn::tc_cp_rows(as, ld, (kSaved ? a.g : a.rw) + q_base, D, c0, rp, 0,
                     rows, Dh);
    attn::tc_cp_rows(rs, ld, a.rr + q_base, D, c0, rp, 0, rows, Dh);
    attn::tc_cp_rows(bs, ld, (kSaved ? a.v : a.k) + k_base, D, 0, kp, 0, K,
                     Dh);
    cp_window(win, ld, a.r + h * Dh, D, P, pw, wrows, Dh);
    attn::cp_async_commit();
    if (first) {
      // The workspace rows no window of this chunk reaches: zero, so that
      // the slice is written whole (later chunks add into their rows).
      const int half = Dh / 2;
      for (int i = threadIdx.x; i < P * half; i += blockDim.x) {
        const int p = i / half, c = 2 * (i - p * half);
        if (p < pw || p >= pw + wrows)
          *reinterpret_cast<float2*>(ws_bh + (size_t)p * D + c) =
              make_float2(0.0f, 0.0f);
      }
    }
    if constexpr (kSaved) {
      // Phase 0 of #22: the chunk's saved pd rows → pd_c over P (zeros to
      // [rp][kp]), two keys a thread; p is read in phase 1.
      const bf16* pd_rows = a.pd + (prow0 + c0) * K;
      const int half = kp / 2;
      for (int i = threadIdx.x; i < rp * half; i += blockDim.x) {
        const int r = i / half, c = 2 * (i - r * half);
        uint32_t w = 0u;
        if (r < rows && c < K) {
          const bf16* src = pd_rows + (size_t)r * K + c;
          if (p_pairs) {
            w = *reinterpret_cast<const uint32_t*>(src);
          } else {
            __nv_bfloat162 x;
            x.x = src[0];
            x.y = c + 1 < K ? src[1] : __float2bfloat16(0.0f);
            w = *reinterpret_cast<const uint32_t*>(&x);
          }
        }
        *reinterpret_cast<uint32_t*>(pds + r * 2 * pl4 + c) = w;
      }
    }
    attn::cp_async_wait<0>();
    __syncthreads();

    if constexpr (!kSaved) {
      // Phase 0: #20's scores into P, 16 rows × 16 keys a unit.
      for (int u = warp; u < nsl * nk16; u += nw) {
        const int m0 = 16 * (u / nk16), kq = 16 * (u - (u / nk16) * nk16);
        const int q_lo = c0 + m0 + g4;
        float ed2[2];
        lane_ed(ed2, bsx, q_lo);
        float* unit = ps + m0 * pl4 + kq;
        float sc[2][4];
        relik_scores<2>(sc, as + m0 * ld, rs + m0 * ld, bs + kq * ld,
                        win + (rp - 16 - m0 + kq) * ld, ld, kd, 2, unit, pl4,
                        bsx, ed2, q_lo, kq, a.scale);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            *reinterpret_cast<float2*>(unit + (g4 + 8 * hi) * pl4 + 8 * t +
                                       2 * t4) =
                make_float2(sc[t][2 * hi], sc[t][2 * hi + 1]);
      }
      __syncthreads();  // every score is in; rw and k are done with

      attn::tc_cp_rows(as, ld, a.g + q_base, D, c0, rp, 0, rows, Dh);
      attn::tc_cp_rows(bs, ld, a.v + k_base, D, 0, kp, 0, K, Dh);
      attn::cp_async_commit();
      // The softmax, the keep bit in p's sign: #20's order either way.
      if (K <= kRegMaxK) {
        for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
          float sc[kRegTiles][4];
#pragma unroll
          for (int t = 0; t < kRegTiles; ++t)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              float2 x = make_float2(-INFINITY, -INFINITY);
              if (t < nkt)
                x = *reinterpret_cast<const float2*>(
                    ps + (r0 + g4 + 8 * hi) * pl4 + 8 * t + 2 * t4);
              sc[t][2 * hi] = x.x;
              sc[t][2 * hi + 1] = x.y;
            }
          float sum[2];
          rel_tc::reg_softmax(sc, sum, K);
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
                *reinterpret_cast<float2*>(ps + (r0 + g4 + 8 * hi) * pl4 +
                                           8 * t + 2 * t4) =
                    make_float2(x[0], x[1]);
              }
            }
          }
        }
      } else {
        attn::softmax_rows_keep_sign<kDropout>(ps, rows, K, c0, b, h, drop,
                                               pl4);
      }
      attn::cp_async_wait<0>();
      __syncthreads();  // p whole; g and v are in
    }

    // Phase 1: the warp's 16-row slabs.
    for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
      const int q_lo = r0 + g4;  // chunk rows q_lo and q_lo + 8
      float tt[kBwdTiles][4];
      // p (#21: signed) of the lane's keys j, j + 1 of row q_lo + 8·hi; 0
      // past Q and K. #22 reads the saved p in the accumulator layout.
      auto p_pair = [&](int hi, int j, float (&x)[2]) {
        x[0] = x[1] = 0.0f;
        const int q = c0 + q_lo + 8 * hi;
        if (q < Q && j < K) {
          if constexpr (kSaved) {
            const bf16* src = a.p + (prow0 + q) * K + j;
            if (p_pairs) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(src));
              x[0] = f.x;
              x[1] = f.y;
            } else {
              x[0] = __bfloat162float(src[0]);
              if (j + 1 < K) x[1] = __bfloat162float(src[1]);
            }
          } else {
            const float2 f = *reinterpret_cast<const float2*>(
                ps + (q_lo + 8 * hi) * pl4 + j);
            x[0] = f.x;
            if (j + 1 < K) x[1] = f.y;
          }
        }
      };
      // pd of the same keys: #21 from the signed p, #22 its saved pd_c
      auto pd_pair = [&](int hi, int j, const float (&x)[2],
                         float (&pd)[2]) {
        if constexpr (kSaved) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  pds + (q_lo + 8 * hi) * 2 * pl4 + j));
          pd[0] = f.x;
          pd[1] = f.y;
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            pd[u] = attn::pd_of_signed<kDropout>(x[u], inv_keep);
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
              const int j = 8 * (t0 + t) + 2 * t4;
              float x[2] = {0.0f, 0.0f}, pd[2];
              if constexpr (!kSaved) p_pair(hi, j, x);
              pd_pair(hi, j, x, pd);
#pragma unroll
              for (int u = 0; u < 2; ++u)
                tt[t][2 * hi + u] = __fmul_rn(pd[u], tt[t][2 * hi + u]);
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
      // ds = t − p · Σt; pd_c over the slab's P rows (once the warp has
      // read this chunk of keys: pd_c of key k lies on p's element k / 2),
      // ds_c to its tile, ds_u into S′, ded += ds · segd.
      float dsd[2] = {0.0f, 0.0f};
      for (int kc = 0; kc < n_kc; ++kc) {
        const int t0 = kc * kBwdTiles, n = min(kBwdTiles, nkt - t0);
        if (n_kc > 1) dpd(t0, n);
        uint32_t pdw[kBwdTiles][2];
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t) {
          if (t < n) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int j = 8 * (t0 + t) + 2 * t4;
              float x[2], pd[2] = {0.0f, 0.0f};
              p_pair(hi, j, x);
              if constexpr (!kSaved) pd_pair(hi, j, x, pd);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                tt[t][2 * hi + u] =
                    __fsub_rn(tt[t][2 * hi + u],
                              __fmul_rn(attn::p_of_signed<kDropout>(x[u]),
                                        sum[hi]));
              }
              pdw[t][hi] = attn::pack_bf16(pd[0], pd[1]);
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < kBwdTiles; ++t) {
          if (t < n) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int i = g4 + 8 * hi, row = r0 + i;
              const int j = 8 * (t0 + t) + 2 * t4;
              const float ds0 = tt[t][2 * hi], ds1 = tt[t][2 * hi + 1];
              if constexpr (!kSaved)
                *reinterpret_cast<uint32_t*>(pds + row * 2 * pl4 + j) =
                    pdw[t][hi];
              *reinterpret_cast<uint32_t*>(dss + row * pld + j) =
                  attn::pack_bf16(__fmul_rn(ds0, a.scale),
                                  __fmul_rn(ds1, a.scale));
              bf16* sp = sps + row * spl + (15 - i) + j;
              sp[0] = __float2bfloat16(ds0);
              sp[1] = __float2bfloat16(ds1);
              const float2 sg = qk_pair(bsx.segd, c0 + row, j, bsx);
              dsd[hi] = __fadd_rn(dsd[hi], __fmul_rn(ds0, sg.x));
              dsd[hi] = __fadd_rn(dsd[hi], __fmul_rn(ds1, sg.y));
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dsd[r] += __shfl_xor_sync(0xffffffffu, dsd[r], o);
      if (t4 == 0) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int q = c0 + q_lo + 8 * hi;
          if (q < Q) ded_bh[q] = __float2bfloat16(dsd[hi]);
        }
      }
      // S′'s zeros round the band: row i's columns [0, 15 − i) and
      // [15 − i + K16, K16 + 16).
      for (int z = lane; z < 256; z += 32) {
        const int i = z >> 4, x = z & 15;
        sps[(r0 + i) * spl + (x < 15 - i ? x : kp + x)] =
            __float2bfloat16(0.0f);
      }
    }
    __syncthreads();  // pd_c, ds_c and S′ whole; v is done with

    attn::tc_cp_rows(bs, ld, a.k + k_base, D, 0, kp, 0, K, Dh);
    attn::cp_async_commit();
    // Phase 2a: dV (+)= pd_cᵀ · g over 16-key slices; drr = S′ · window
    // over the slabs; the dr rows S′ᵀ · rr over 16-row window tiles.
    const int n_dv = nk16, n_drr = nsl, n_dr = wrows / 16;
    for (int u = warp; u < n_dv + n_drr + n_dr; u += nw) {
      float acc[kDT][4] = {};
      if (u < n_dv) {
        const int k0 = 16 * u;
        for (int c = 0; c < rp; c += 16) {
          uint32_t fa[4];
          attn::ldsm_x4_trans(
              fa, attn::tc_lane_at(pds + c * 2 * pl4 + k0, 2 * pl4));
          attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
        }
        rel_tc::emit_keys(acc, a.dv + k_base, D, dv_sum, k0, K, Dh, multi,
                          first, last);
      } else if (u < n_dv + n_drr) {
        const int m0 = 16 * (u - n_dv), off = rp - 16 - m0;
        for (int kk = 0; kk <= nk16; ++kk) {
          uint32_t fa[4];
          attn::ldsm_x4(fa, attn::tc_lane_a(sps + m0 * spl + 16 * kk, spl));
          attn::tc_mma_bt(acc, fa,
                          attn::tc_lane_bt(win + (off + 16 * kk) * ld, ld),
                          Dh / 8);
        }
        full_tc::store_rows(acc, a.drr + q_base + (size_t)c0 * D, D, m0, rows,
                            Dh);
      } else {
        const int w0 = 16 * (u - n_dv - n_drr);
        for (int s = 0; s < nsl; ++s) {
          const int lc = w0 - (rp - 16 - 16 * s);
          if (lc < 0 || lc > kp) continue;
          uint32_t fa[4];
          attn::ldsm_x4_trans(
              fa, attn::tc_lane_at(sps + 16 * s * spl + lc, spl));
          attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(rs + 16 * s * ld, ld),
                          Dh / 8);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const long long p = pw + w0 + g4 + 8 * hi;
          if (p < 0 || p >= P) continue;
#pragma unroll
          for (int t = 0; t < kDT; ++t) {
            if (t < Dh / 8) {
              float2* dst = reinterpret_cast<float2*>(ws_bh + p * D + 8 * t +
                                                      2 * t4);
              float2 x = make_float2(acc[t][2 * hi], acc[t][2 * hi + 1]);
              if (!first) {
                const float2 old = *dst;
                x = make_float2(__fadd_rn(old.x, x.x), __fadd_rn(old.y, x.y));
              }
              *dst = x;
            }
          }
        }
      }
    }
    attn::cp_async_wait<0>();
    __syncthreads();  // k is in; g is done with

    attn::tc_cp_rows(as, ld, a.rw + q_base, D, c0, rp, 0, rows, Dh);
    attn::cp_async_commit();
    // Phase 1b: drw = ds_c · k, the warp's slabs.
    for (int r0 = 16 * warp; r0 < rp; r0 += 16 * nw) {
      float acc[kDT][4] = {};
      const bf16* pa = attn::tc_lane_a(dss + r0 * pld, pld);
      const bf16* kb = attn::tc_lane_bt(bs, ld);
      for (int c = 0; c < kp; c += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + c);
        attn::tc_mma_bt(acc, fa, kb + c * ld, Dh / 8);
      }
      full_tc::store_rows(acc, a.drw + q_base + (size_t)c0 * D, D, r0, rows,
                          Dh);
    }
    attn::cp_async_wait<0>();
    __syncthreads();  // rw is in

    // Phase 2b: dK (+)= ds_cᵀ · rw.
    for (int k0 = 16 * warp; k0 < kp; k0 += 16 * nw) {
      float acc[kDT][4] = {};
      for (int c = 0; c < rp; c += 16) {
        uint32_t fa[4];
        attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * pld + k0, pld));
        attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
      }
      rel_tc::emit_keys(acc, a.dk + k_base, D, dk_sum, k0, K, Dh, multi,
                        first, last);
    }
    if (!last) __syncthreads();  // the next chunk restages every tile
  }
}

template <int kDT, bool kDropout, int kMinBlocks>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
    attn_bwd_relik_tc_kernel(BwdArgs a, int qc, bool pairs,
                             DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_block<kDT, kDropout, false>(smem_raw, a, qc, pairs, false, drop);
}

template <int kDT, int kMinBlocks>
__global__ void __launch_bounds__(kBwdThreads, kMinBlocks)
    attn_bwd_relik_saved_tc_kernel(BwdArgs a, int qc, bool pairs,
                                   bool p_pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_block<kDT, false, true>(smem_raw, a, qc, pairs, p_pairs,
                              DropoutArgs{0ull, 0u, 1.0f});
}

template <int kDT, bool kDropout, int kMinBlocks, bool kSaved, typename Args>
int launch_bwd_blocks(const Args& a, int qc, bool pairs, bool p_pairs,
                      const DropoutArgs& drop, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  const size_t bytes = bwd_smem_bytes(qc, a.K, a.Dh, qc < a.Q);
  if constexpr (kSaved) {
    const cudaError_t err = attn::allow_max_smem(
        attn_bwd_relik_saved_tc_kernel<kDT, kMinBlocks>, &attr_set);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_relik_saved_tc_kernel<kDT, kMinBlocks>
        <<<dim3(a.H, a.B), kBwdThreads, bytes, st>>>(a, qc, pairs, p_pairs);
  } else {
    const cudaError_t err = attn::allow_max_smem(
        attn_bwd_relik_tc_kernel<kDT, kDropout, kMinBlocks>, &attr_set);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_relik_tc_kernel<kDT, kDropout, kMinBlocks>
        <<<dim3(a.H, a.B), kBwdThreads, bytes, st>>>(a, qc, pairs, drop);
  }
  return (int)cudaGetLastError();
}

// Two blocks an SM where their shared memory allows (228 KB an SM, 1 KB of
// it reserved a block) at Dh ≤ 64: the build held to 128 registers (it
// spills 28-40 bytes) ran 1.5× faster at Q = K = 50 than the one at 196-198
// registers, one block an SM; where one block fills the SM the unbounded
// build runs (at Q = 50, K = 100 the bounded one lost 8%; bf16 B=256 on an
// NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py). Dh ≤ 128 takes one block.
template <int kDT, bool kDropout, bool kSaved, typename Args>
int launch_bwd_dt(const Args& a, int qc, bool pairs, bool p_pairs,
                  const DropoutArgs& drop, cudaStream_t st) {
  if constexpr (kDT == 8) {
    const size_t bytes = bwd_smem_bytes(qc, a.K, a.Dh, qc < a.Q);
    if (2 * (bytes + 1024) <= 228 * 1024)
      return launch_bwd_blocks<kDT, kDropout, 2, kSaved>(a, qc, pairs,
                                                         p_pairs, drop, st);
  }
  return launch_bwd_blocks<kDT, kDropout, 1, kSaved>(a, qc, pairs, p_pairs,
                                                     drop, st);
}

// The bf16 recompute backward of #21 (its first launch; the caller sums the
// workspace over B). rw, rr, r, k, v and g must start on the 16 bytes
// cp.async copies. Returns the cudaError_t of the launch; a shape past the
// plan returns cudaErrorInvalidValue. (A template on the arguments, here
// always BwdArgs: see launch_fwd.)
template <typename Args>
int launch_bwd(const Args& a, bool dropout, const DropoutArgs& drop,
               cudaStream_t st) {
  const int qc = bwd_q_chunk(a.Q, a.K, a.Dh);
  if (qc == 0) return (int)cudaErrorInvalidValue;
  if (!aligned(a.rw, 16) || !aligned(a.rr, 16) || !aligned(a.r, 16) ||
      !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.g, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs =
      a.K % 2 == 0 && aligned(a.segd, 4) && aligned(a.maskb, 4);
  if (dh_tiles(a.Dh) == 8)
    return dropout ? launch_bwd_dt<8, true, false>(a, qc, pairs, false, drop,
                                                   st)
                   : launch_bwd_dt<8, false, false>(a, qc, pairs, false,
                                                    drop, st);
  return dropout ? launch_bwd_dt<16, true, false>(a, qc, pairs, false, drop,
                                                  st)
                 : launch_bwd_dt<16, false, false>(a, qc, pairs, false, drop,
                                                   st);
}

// The bf16 saved-probs backward of #22 (its first launch, as launch_bwd):
// a.p and a.pd the saved probs (one pointer twice at rate 0), a.ed and
// a.maskb unused. rr, r, v, g, rw and k must start on the 16 bytes cp.async
// copies.
template <typename Args>
int launch_bwd_saved(const Args& a, cudaStream_t st) {
  const int qc = bwd_q_chunk(a.Q, a.K, a.Dh);
  if (qc == 0) return (int)cudaErrorInvalidValue;
  if (!aligned(a.rw, 16) || !aligned(a.rr, 16) || !aligned(a.r, 16) ||
      !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.g, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs = a.K % 2 == 0 && aligned(a.segd, 4);
  const bool p_pairs = a.K % 2 == 0 && aligned(a.p, 4) && aligned(a.pd, 4);
  const DropoutArgs none{0ull, 0u, 1.0f};
  return dh_tiles(a.Dh) == 8
             ? launch_bwd_dt<8, false, true>(a, qc, pairs, p_pairs, none, st)
             : launch_bwd_dt<16, false, true>(a, qc, pairs, p_pairs, none,
                                              st);
}

}  // namespace relik_tc

}  // namespace
