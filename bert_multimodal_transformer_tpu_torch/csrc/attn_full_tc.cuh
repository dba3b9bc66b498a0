// The bf16 tensor-core plans of the full-H attention kernels: the forward
// #1 (attn_fwd_packed.cu) and its split-layout twin #8 (attn_fwd_split.cu),
// the saved-probs backward #3 (attn_bwd_packed_saved.cu) and its twin #10
// (attn_bwd_split_saved.cu), the recompute backward #9 (attn_bwd_split.cu)
// and its packed twin #2 (attn_bwd_packed.cu); and the QKV projection of
// #18 (attn_fwd_qkvproj.cu) and #19 (attn_bwd_qkvproj.cu), with #1's
// register plan and #3's backward each split into their staging and compute
// halves so that #18 and #19 run the compute half on the head they project
// into shared memory. fp32 keeps the CUDA-core row code of common.cuh
// (`fwd_rows`, `bwd_saved_head`, `bwd_recompute_head`, `project_head`);
// #18's attention past S = 64 runs that row code in bf16 too.
//
// What they compute is #1's and #3's function (common.cuh's notes), per
// batch row b and head h:
//   s    = (Q · Kᵀ in fp32) · scale + (1 − m) · −10000; p = softmax_k(s)
//   save: p_out = bf16(p); rate > 0: p ← keep ? p · inv_keep : 0 (the
//          Philox stream at (k >> 2, q, h, b)); save: pd_out = bf16(p)
//   out  = bf16(p) · V summed in fp32, rounded once
//   dV = pdᵀ · g;  t = pd ⊙ (g · Vᵀ);  ds_c = bf16((t − p · Σ_k t) · scale)
//   dQ = ds_c · K;  dK = ds_cᵀ · Q      (every product summed in fp32)
//
// What bounds them on the card: at the bench's shape (B=256, S=50, H=12,
// Dh=64) the forward is ~1 GFLOP over ~39 MB with the saved probs, the
// backward ~2 GFLOP over ~71 MB: both bytes-bound at 0.012-0.05 ms, where
// the CUDA-core kernels took 0.24-0.66 ms on dependent fp32 fmaf chains.
// The design runs every product on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from operands cp.async staged once, with
// common.cuh's tensor-core pieces, and keeps the elementwise work on the
// accumulators in registers.
//
// Forward, register plan (S ≤ kRegMaxS = 64; `fwd_reg_rows`). One block of
// S/16 warps (rounded up; 4 at S = 50) per (head, batch row), each warp 16
// query rows. Q, K, V of the head are staged once as bf16 (rows of
// attn::tc_ld(Dh), rows past S zero-filled, the k-depth's pad columns
// zero). QKᵀ runs into registers: a lane holds rows g = lane / 4 and g + 8
// of its slab at keys 8t + 2·(lane % 4) + {0, 1} of the n8 tiles t < S/8,
// ≤ 32 fp32. The row max and sum come from the lane's values in key order,
// then the quad's xor tree (1, 2); p = e / sum, the fp32 kernel's
// operations. The keep bits take the existing counter: lanes 2m and 2m + 1
// share the key group k >> 2, so each draws one Philox block (rows g and
// g + 8) and they trade the words the other needs by two shuffles. p and
// pd are stored from the accumulator layout, bf16x2 while S is even (a
// head's [S][S] block is then 4-byte aligned), 2-byte stores otherwise. The
// dropped probs are repacked from the C fragments into PV's A fragments
// (two neighbouring n8 tiles are one 16-key step), as FlashAttention-2
// does, with no shared-memory round trip; V is read by ldmatrix.trans.
// Shared memory: Q, K, V [S16][L] bf16 and the [S16] bias, 27.3 KB at
// S = 50, Dh = 64 (S16: S rounded up to 16; L: Dh rounded up to 16, + 8).
//
// Forward, shared-memory plan (64 < S ≤ 512;
// `attn_full_tc_fwd_smem_kernel`): #4's plan
// (attn_fwd_packed_hb.cu), with the save modes added: a block of 8 warps
// per (32-row query tile, head, batch row), K then V streamed through a
// two-stage ring of 64-key blocks, the fp32 score tile [32][keys + 4] in
// shared memory, the whole-row softmax one warp per row (common.cuh's
// `tc_hb_softmax_rows`, which #4 and #14 run, in its save mode), the probs
// in bf16 over their own score row, PV by ldmatrix. Shared memory as
// ops/fused_attention.py::hb_fwd_smem_bytes. #4 keeps its own copy of the
// kernel: launched as #4 from attn_fwd_packed_hb.cu, this one ran 2.5%
// slower than #4's (1.192-1.201 against 1.162-1.175 ms at bf16 B=48
// S=512 on an NVIDIA H100 80GB HBM3 at 700 W, one call of chip_ab.py)
// with the same registers, while launched as #1 it runs at #4's pace.
//
// Backward (`bwd_saved_rows`, S ≤ max_bwd_seq_len(Dh)): one block of S/16
// warps (rounded up) per (head, batch row); the staging half
// (`bwd_saved_stage`), then the compute half's two phases
// (`bwd_saved_phase1`, a barrier, `bwd_saved_phase2`), which #19 also runs
// on the tiles its projection fills. Q, K, V and g are staged as
// bf16 by cp.async; pd into a bf16 [S16][S16 + 8] tile by 4-byte loads
// while S is even (its rows are S·2 bytes apart: 100 at S = 50, only
// 4-byte aligned), 2-byte loads otherwise. Phase 1, warp w on query rows
// 16w .. 16w + 15: d(pd) = g · Vᵀ into registers; t = pd ⊙ d(pd); Σ_k t
// from the lane's values in key order, then the quad's xor tree; p read
// straight from device memory in the accumulator layout; ds_c packed to
// bf16 pairs in place. Those pairs are dQ = ds_c · K's A fragments (K by
// ldmatrix.trans), and are written to a bf16 [S16][S16 + 8] ds_c tile.
// Phase 2, after one barrier, warp w on keys 16w .. 16w + 15: dV = pdᵀ · g
// and dK = ds_cᵀ · Q, pdᵀ and ds_cᵀ by ldmatrix.trans from their tiles, g
// and Q by ldmatrix.trans, summed over all query rows. Every reduction
// lies inside one warp's registers in a fixed order: no atomics, the same
// bits twice. Built for S ≤ 64 (kNT = 8 key tiles) and for the whole reach
// (22 key tiles at Dh ≤ 64, 18 at Dh ≤ 128), each for Dh ≤ 64 and ≤ 128.
// Shared memory (ops/fused_attention.py::full_tc_bwd_smem_bytes): Q, K, V
// and g [S16][L] bf16, pd and ds_c [S16][S16 + 8] bf16: 54 KB at S = 50,
// Dh = 64; 166.5 KB at S = 140; 204 KB at S = 117, Dh = 128.
//
// Recompute backward (`bwd_recompute_rows`, #2 and #9, S ≤
// max_bwd_seq_len(Dh)): #1's scores and softmax in front of #3's phases,
// one block of S/16 warps (rounded up) per (head, batch row), #13's
// staging. Q, K staged by cp.async into A, B; phase 0 rebuilds p with the
// forward's bits: to S = 64 each warp runs #1's register plan on its slab
// (`reg_scores_softmax`, the keep words from the lane pairs of
// `keep_words`), past it the scores go to an fp32 tile in #4's 16 × 16
// units and common.cuh's `softmax_rows_keep_sign` (the order of
// `tc_hb_softmax_rows`). p lands in an fp32 tile P [S16][S16 + 4], the
// keep bit in its sign, while g and V stream into A and B. Phase 1, warp w
// on its slab, 64 keys at a time: d(pd) = g · Vᵀ, t = pd ⊙ d(pd), Σ_k t in
// the lane order of #3, ds_c = bf16((t − p · Σt) · scale) to a bf16 tile,
// pd_c = bf16(pd) over the slab's own P rows. Then K streams into B while
// dV = pd_cᵀ · g runs (key slices), Q into A while dQ = ds_c · K runs
// (slabs), and dK = ds_cᵀ · Q (key slices), each by ldmatrix(.trans). The
// keep mask is replayed at (k >> 2, q, h + h_off, b + b_off), so a TP
// shard draws the one-card mask. The layouts reach it through BwdGeom, so
// #2 and #9 give the same bits. Shared memory (ops/fused_attention.py::
// full_tc_bwd_recompute_smem_bytes): 44.3 KB at S = 50, Dh = 64; 167.1 KB
// at S = 140; 168.5 KB at S = 117, Dh = 128.
//
// The QKV projection (`project_head_tc`, #18 and #19): a block of 8 warps
// a batch row computes head = bf16(x_b · w_hᵀ in fp32 + b3_h) for one head
// of one or two batch rows, in passes of 64 rows × up to 192 columns (the
// head's 3·Dh: one pass at Dh = 64, S ≤ 64), the batch rows' x and the
// head's weight rows streamed in 32- or 64-deep slices through a two-stage
// cp.async ring, each warp a 16-row slab × half the pass's n8 tiles in
// registers; the bias is added in fp32 before the one rounding, and the
// bf16 pairs go straight into the layout the caller names (#1's tiles up
// to S = 64, [S][3·Dh] past it; #3's tiles in #19) and, with `emit`, to
// the packed qkv. #18 and #19 to S = 64 take two batch rows a block with
// 64-deep slices, past it one with 32-deep slices (kProjRegRows,
// kBwdProjRows, kProjRegDepth, kProjRowsDepth); a weight slice serves
// every batch row of its block. The register plan's compute half
// (`fwd_reg_compute`) then runs on #18's tiles as on the ones #1 stages
// (`fwd_reg_stage`), so #18 gives #1's bits on its emitted projection; #3's
// phases run on #19's tiles as on the ones #3 stages, so #19 gives #3's
// bits.
//
// Against the fp32 kernels: a bf16 × bf16 product is exact in fp32, so a
// dot differs from the CUDA-core fmaf chain of the same values only in the
// order of its sum, and so do the row sums of the quad plan; the roundings
// sit where the fp32 kernels put them. bf16 #1, #3 and #2/#9 are held to
// their plain versions within the forward bound and `dqkv_bf16_bound`, not
// bit for bit. The layouts reach these functions through plain strides
// (`FwdGeom`, `BwdGeom`), so the packed and split kernels run one code and
// #8 gives #1's bits, #10 #3's.

#pragma once

#include "common.cuh"

// Internal linkage in each translation unit that includes this header.
namespace {

namespace full_tc {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;

constexpr int kRegMaxS = 64;  // ops/fused_attention.py::FULL_TC_REG_MAX_SEQ_LEN
constexpr int kRegTiles = kRegMaxS / 8;     // the register plan's n8 key tiles
constexpr int kRegThreads = kRegMaxS / 16 * 32;
constexpr int kSmemQTile = 32;              // the shared-memory plan's q tile
constexpr int kKBlock = 64;                 // its staged K/V blocks
constexpr int kMaxS = 512;                  // ops/fused_attention.py::MAX_SEQ_LEN
// The backward's n8 key tiles: its build for S ≤ 64, and its builds for
// the whole reach of each Dh class (the class's longest max_bwd_seq_len,
// rounded up to 16: 165 at Dh = 8, 138 at Dh = 72).
constexpr int kBwdSmallTiles = 8;
constexpr int kBwdTiles64 = 22;
constexpr int kBwdTiles128 = 18;

__host__ __device__ inline int rows16(int s) { return (s + 15) / 16 * 16; }
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
__host__ __device__ inline int dh_tiles(int dh) { return dh <= 64 ? 8 : 16; }

// Where one (head, batch row) lives: row r of its q, k, v at
// q/k/v + b·sb + h·sh + r·ld, row r of its output at out + b·osb + h·osh +
// r·out_ld; its fp32 [S] mask at mask + b·S (null: no padding); its saved
// probs at ((b·H + h)·S + r)·S.
struct FwdGeom {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long sb, sh;
  int ld;
  const float* mask;
  bf16* out;
  long long osb, osh;
  int out_ld;
  int b_off, h_off;  // the Philox counter's batch row and head offsets
};

// The packed projection qkv [B, S, 3D] (column packing i·D + h·Dh + c),
// its fp32 [B, S] mask (null: no padding) and out [B, S, D] (#1).
inline FwdGeom packed_fwd_geom(const void* qkv, const void* mask, void* out,
                               int S, int H, int Dh) {
  const int D = H * Dh;
  const bf16* q = static_cast<const bf16*>(qkv);
  return {q,
          q + D,
          q + 2 * D,
          (long long)S * 3 * D,
          Dh,
          3 * D,
          static_cast<const float*>(mask),
          static_cast<bf16*>(out),
          (long long)S * D,
          Dh,
          D,
          0,
          0};
}

__device__ __forceinline__ attn::RowsHead<bf16> fwd_head(const FwdGeom& g,
                                                         int b, int h, int S,
                                                         int H) {
  const long long o = b * g.sb + h * g.sh;
  return {g.q + o,
          g.k + o,
          g.v + o,
          (size_t)g.ld,
          g.mask ? g.mask + (size_t)b * S : nullptr,
          g.out + b * g.osb + h * g.osh,
          (size_t)g.out_ld,
          ((size_t)b * H + h) * S,
          b + g.b_off,
          h + g.h_off};
}

// The keep-test draws of a lane's four accumulators of n8 key tile t (rows
// q_lo and q_lo + 8; keys 8t + 2·(lane % 4) + {0, 1}): lanes 2m and
// 2m + 1 hold the same key group, draw one Philox block each (for q_lo and
// q_lo + 8) and trade the two words the other needs. Every lane of the
// warp must call it.
__device__ __forceinline__ void keep_words(uint32_t (&wd)[4], int q_lo,
                                           int t, int b, int h,
                                           const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int k4 = (8 * t + 4 * ((lane & 3) >> 1)) >> 2;
  const uint4 own =
      attn::dropout_bits4(drop, b, h, odd ? q_lo + 8 : q_lo, k4);
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? own.x : own.z, 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? own.y : own.w, 1);
  wd[0] = odd ? x0 : own.x;
  wd[1] = odd ? x1 : own.y;
  wd[2] = odd ? own.z : x0;
  wd[3] = odd ? own.w : x1;
}

// dst[j], dst[j + 1] = lo, hi for the keys j, j + 1 < S of a [.][S] prob
// row (j even): one bf16x2 store when `pairs` (S even and the tensor 4-byte
// aligned), else one store per key.
__device__ __forceinline__ void store_pair(bf16* dst, int j, int S, float lo,
                                           float hi, bool pairs) {
  if (j >= S) return;
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(dst + j) =
        __floats2bfloat162_rn(lo, hi);
  } else {
    dst[j] = __float2bfloat16(lo);
    if (j + 1 < S) dst[j + 1] = __float2bfloat16(hi);
  }
}

// One warp: acc[t] += A[16 rows] · B[8t .. 8t + 8)ᵀ over depth kd for the
// n8 tiles t < n (n even, ≤ nt), A and B row-major bf16 in shared memory
// (`attn::tc_warp_abt` with the tiles past n skipped).
template <int nt>
__device__ __forceinline__ void warp_abt(float (&acc)[nt][4],
                                         const bf16* a, const bf16* b,
                                         int ld, int kd, int n) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = attn::tc_lane_a(a, ld);
  const bf16* pb =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < kd; k += 16) {
    uint32_t fa[4];
    attn::ldsm_x4(fa, pa + k);
#pragma unroll
    for (int t = 0; t < nt; t += 2) {
      if (t < n) {
        uint32_t fb[4];
        attn::ldsm_x4(fb, pb + t * 8 * ld + k);
        attn::mma_bf16(acc[t], fa, fb[0], fb[1]);
        attn::mma_bf16(acc[t + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// Rows r0 + lane / 4 (+ 8) < rows of a warp's [16][Dh] fp32 accumulators,
// rounded to bf16, at dst + r · dst_ld (bf16x2: Dh and dst_ld are even).
template <int nt>
__device__ __forceinline__ void store_rows(const float (&acc)[nt][4],
                                           bf16* dst, size_t dst_ld, int r0,
                                           int rows, int Dh) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = r0 + (lane >> 2) + 8 * hi;
    if (r >= rows) continue;
#pragma unroll
    for (int t = 0; t < nt; ++t) {
      if (t < Dh / 8)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * dst_ld + t * 8 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[t][2 * hi], acc[t][2 * hi + 1]);
    }
  }
}

// ---- forward, register plan (S ≤ kRegMaxS) --------------------------------

// One warp's 16 query rows (qs, staged from row m0) against every key (ks,
// nkt ≤ kRegTiles n8 tiles): s = (q · k) · scale + bias into registers, the
// row's max and sum from the lane's keys in order, then the quad's xor
// tree; returns e = exp(s − max) in sc (0 past S) and the sums. #1/#8's
// register plan and #2/#9's recompute share it, so both have the same p.
__device__ __forceinline__ void reg_scores_softmax(
    float (&sc)[kRegTiles][4], float (&sum)[2], const bf16* qs,
    const bf16* ks, int ld, int kd, int nkt, int S, float scale,
    const float* bias) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t)
    sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.0f;
  warp_abt<kRegTiles>(sc, qs, ks, ld, kd, nkt);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * t + 2 * t4 + (e & 1);
      const float x = t < nkt && j < S
                          ? __fadd_rn(__fmul_rn(sc[t][e], scale), bias[j])
                          : -INFINITY;
      sc[t][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
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
      if (t < nkt && j < S) {
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

__host__ __device__ inline size_t fwd_reg_smem_bytes(int s, int dh) {
  return 3 * (size_t)rows16(s) * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)rows16(s) * sizeof(float);
}

// The register plan's tiles in shared memory (`fwd_reg_smem_bytes`): Q, K,
// V [S16][L] bf16 one after the other (rows past S and the k-depth's pad
// columns zero), then the [S16] fp32 mask bias.
__device__ __forceinline__ void fill_bias(float* bias, const float* mask,
                                          int S) {
  for (int j = threadIdx.x; j < rows16(S); j += blockDim.x)
    bias[j] = mask && j < S ? (1.0f - mask[j]) * -10000.0f : 0.0f;
}

// The register plan's staging half: the head's Q, K, V and its mask bias
// into the tiles, visible to every thread on return.
__device__ __forceinline__ void fwd_reg_stage(unsigned char* smem_raw,
                                              const attn::RowsHead<bf16>& hd,
                                              int S, int Dh) {
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = rows16(S);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  attn::tc_cp_rows(qs, ld, hd.q, hd.ld, 0, sp, 0, S, Dh);
  attn::tc_cp_rows(qs + sp * ld, ld, hd.k, hd.ld, 0, sp, 0, S, Dh);
  attn::tc_cp_rows(qs + 2 * sp * ld, ld, hd.v, hd.ld, 0, sp, 0, S, Dh);
  attn::cp_async_commit();
  fill_bias(reinterpret_cast<float*>(qs + 3 * sp * ld), hd.mask, S);
  attn::tc_zero_cols(qs, ld, 3 * sp, Dh, kd);  // Q, K and V's pad columns
  attn::cp_async_wait<0>();
  __syncthreads();
}

// The register plan's compute half on the staged tiles: the calling warp
// takes query rows m0 .. m0 + 15 (m0 < S16; no block barrier, so a block
// with more warps than slabs leaves the rest idle). hd's q, k, v and mask
// are not read.
template <int kDT, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_reg_compute(
    const unsigned char* smem_raw, const attn::RowsHead<bf16>& hd,
    bf16* __restrict__ p_out, bf16* __restrict__ pd_out, int m0, int S,
    int Dh, float scale, bool pairs, const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = rows16(S), nkt = sp / 8;
  const bf16* qs = reinterpret_cast<const bf16*>(smem_raw);  // [sp][ld]
  const bf16* ks = qs + sp * ld;                              // [sp][ld]
  const bf16* vs = ks + sp * ld;                              // [sp][ld]
  const float* bias = reinterpret_cast<const float*>(vs + sp * ld);  // [sp]

  const int t4 = lane & 3;
  float sc[kRegTiles][4], sum[2];
  reg_scores_softmax(sc, sum, qs + m0 * ld, ks, ld, kd, nkt, S, scale, bias);

  // p = e / sum; the saved p, the keep mask, the saved pd.
  const int q_lo = m0 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
    if (t < nkt) {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if constexpr (kDropout)
        keep_words(wd, q_lo, t, hd.drop_b, hd.drop_h, drop);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[t][e] = sc[t][e] / sum[e >> 1];
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int q = q_lo + 8 * hi;
        const size_t prow = (hd.prob_row + q) * S;
        if constexpr (kSave) {
          if (q < S)
            store_pair(p_out + prow, 8 * t + 2 * t4, S, sc[t][2 * hi],
                       sc[t][2 * hi + 1], pairs);
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
            if (q < S)
              store_pair(pd_out + prow, 8 * t + 2 * t4, S, sc[t][2 * hi],
                         sc[t][2 * hi + 1], pairs);
          }
        }
      }
    }
  }

  // out = bf16(p) · V: key tiles 2c and 2c + 1 are step c's A fragment.
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
  store_rows(acc, hd.out, hd.out_ld, m0, S, Dh);
}

template <int kDT, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_reg_rows(unsigned char* smem_raw,
                                             const attn::RowsHead<bf16>& hd,
                                             bf16* __restrict__ p_out,
                                             bf16* __restrict__ pd_out,
                                             int S, int Dh, float scale,
                                             bool pairs,
                                             const DropoutArgs& drop) {
  fwd_reg_stage(smem_raw, hd, S, Dh);
  fwd_reg_compute<kDT, kDropout, kSave>(smem_raw, hd, p_out, pd_out,
                                        16 * (threadIdx.x >> 5), S, Dh, scale,
                                        pairs, drop);
}

template <int kDT, bool kDropout, bool kSave>
__global__ void __launch_bounds__(kRegThreads)
    attn_full_tc_fwd_reg_kernel(FwdGeom g, bf16* __restrict__ p_out,
                                bf16* __restrict__ pd_out, int S, int H,
                                int Dh, float scale, bool pairs,
                                DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_reg_rows<kDT, kDropout, kSave>(
      smem_raw, fwd_head(g, blockIdx.y, blockIdx.x, S, H), p_out, pd_out, S,
      Dh, scale, pairs, drop);
}

// ---- forward, shared-memory plan (kRegMaxS < S ≤ kMaxS) -------------------

__host__ __device__ inline int smem_keys(int s) {
  return (s + kKBlock - 1) / kKBlock * kKBlock;
}
__host__ __device__ inline int smem_ss_ld(int s) { return smem_keys(s) + 4; }

__host__ __device__ inline size_t fwd_smem_bytes(int s, int dh) {
  return (size_t)kSmemQTile * smem_ss_ld(s) * sizeof(float) +
         (size_t)(kSmemQTile + 2 * kKBlock) * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)smem_keys(s) * sizeof(float);
}

template <bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_full_tc_fwd_smem_kernel(FwdGeom g, bf16* __restrict__ p_out,
                                 bf16* __restrict__ pd_out, int S, int H,
                                 int Dh, float scale, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const attn::RowsHead<bf16> hd =
      fwd_head(g, blockIdx.z, blockIdx.y, S, H);
  const int q0 = blockIdx.x * kSmemQTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int ssld = smem_ss_ld(S), keys = smem_keys(S);
  const int n_blocks = keys / kKBlock;
  const int stage = kKBlock * ld;

  float* ss = reinterpret_cast<float*>(smem_raw);  // [32][ssld]: s, then P
  bf16* qs = reinterpret_cast<bf16*>(ss + kSmemQTile * ssld);  // [32][ld]
  bf16* ring = qs + kSmemQTile * ld;      // 2 × [64][ld]: K blocks, then V
  float* bias = reinterpret_cast<float*>(ring + 2 * stage);  // [keys]
  const int q_rows = min(kSmemQTile, S - q0);

  // Block i of the stream, into stage i & 1: K block i for i < n_blocks,
  // then V block i − n_blocks. Each its own cp.async group.
  auto load = [&](int i) {
    const bool is_k = i < n_blocks;
    const int k0 = (is_k ? i : i - n_blocks) * kKBlock;
    attn::tc_cp_rows(ring + (i & 1) * stage, ld, is_k ? hd.k : hd.v, hd.ld,
                     k0, kKBlock, 0, min(kKBlock, S - k0), Dh);
  };
  attn::tc_cp_rows(qs, ld, hd.q, hd.ld, q0, kSmemQTile, 0, q_rows, Dh);
  load(0);
  attn::cp_async_commit();  // Q and K block 0
  for (int j = tid; j < keys; j += attn::kTcThreads)
    bias[j] = hd.mask && j < S ? (1.0f - hd.mask[j]) * -10000.0f : 0.0f;
  // The k-depth's pad columns of Q and of both ring stages stay zero.
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
    __syncthreads();  // ... for every thread; block i − 1 is done with
    if (i + 1 < 2 * n_blocks) load(i + 1);
    attn::cp_async_commit();
    const bf16* blk = ring + (i & 1) * stage;
    if (i < n_blocks) {
      const int k0 = i * kKBlock;
      float sc[2][4] = {};
      attn::tc_warp_abt<2>(sc, qs + m0 * ld, ld, blk + kq * ld, ld, kd);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + kq + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = m0 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<float2*>(ss + r * ssld + j) = make_float2(
              __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), bias[j]),
              __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), bias[j + 1]));
        }
      }
      if (i == n_blocks - 1) {
        __syncthreads();  // every score is in
        attn::tc_hb_softmax_rows<kDropout, kSave>(
            ss, ssld, q_rows, S, q0, hd.drop_b, hd.drop_h, drop,
            hd.prob_row + q0, p_out, pd_out);
      }
    } else {
      // acc += P[:, k0 .. k0 + kmax) · V block
      const int k0 = (i - n_blocks) * kKBlock;
      const int kmax = min(kKBlock, (S - k0 + 15) / 16 * 16);
      const bf16* pa = attn::tc_lane_a(ps + m0 * 2 * ssld + k0, 2 * ssld);
      const bf16* vb = attn::tc_lane_bt(blk + c0, ld);
      for (int k = 0; k < kmax; k += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + k);
        attn::tc_mma_bt(acc, fa, vb + k * ld, n);
      }
    }
  }
  bf16* out_tile = hd.out + (size_t)q0 * hd.out_ld + c0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = m0 + (lane >> 2) + 8 * hi;
    if (r >= q_rows) continue;
#pragma unroll
    for (int t = 0; t < kPvTiles; ++t) {
      if (t < n)
        *reinterpret_cast<__nv_bfloat162*>(
            out_tile + (size_t)r * hd.out_ld + t * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[t][2 * hi], acc[t][2 * hi + 1]);
    }
  }
}

// The score-tile forward: #1's and #8's plan past kRegMaxS.
template <bool kDropout, bool kSave>
int launch_fwd_smem(const FwdGeom& g, bf16* p, bf16* pd, int B, int S,
                    int H, int Dh, float scale, const DropoutArgs& drop,
                    cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_full_tc_fwd_smem_kernel<kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_full_tc_fwd_smem_kernel<kDropout, kSave>
      <<<dim3((S + kSmemQTile - 1) / kSmemQTile, H, B), attn::kTcThreads,
         fwd_smem_bytes(S, Dh), stream>>>(g, p, pd, S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <int kDT, bool kDropout, bool kSave>
int launch_fwd_mode(const FwdGeom& g, bf16* p, bf16* pd, int B, int S,
                    int H, int Dh, float scale, bool pairs,
                    const DropoutArgs& drop, cudaStream_t stream) {
  if (S > kRegMaxS)
    return launch_fwd_smem<kDropout, kSave>(g, p, pd, B, S, H, Dh, scale,
                                            drop, stream);
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_full_tc_fwd_reg_kernel<kDT, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_full_tc_fwd_reg_kernel<kDT, kDropout, kSave>
      <<<dim3(H, B), rows16(S) / 16 * 32, fwd_reg_smem_bytes(S, Dh),
         stream>>>(g, p, pd, S, H, Dh, scale, pairs, drop);
  return (int)cudaGetLastError();
}

template <int kDT>
int launch_fwd_dt(const FwdGeom& g, bf16* p, bf16* pd, int B, int S, int H,
                  int Dh, float scale, bool dropout, bool pairs,
                  const DropoutArgs& drop, cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch_fwd_mode<kDT, true, true>(g, p, pd, B, S, H, Dh, scale,
                                            pairs, drop, st);
  if (dropout)
    return launch_fwd_mode<kDT, true, false>(g, p, pd, B, S, H, Dh, scale,
                                             pairs, drop, st);
  if (save)
    return launch_fwd_mode<kDT, false, true>(g, p, pd, B, S, H, Dh, scale,
                                             pairs, drop, st);
  return launch_fwd_mode<kDT, false, false>(g, p, pd, B, S, H, Dh, scale,
                                            pairs, drop, st);
}

// The bf16 forward of #1 / #8 on one layout. p/pd: null for no save. q, k
// and v must start on the 16 bytes cp.async copies (rows of ld and heads
// of sh elements are then 16-byte aligned too: both multiples of 8).
// Returns the cudaError_t of the launch. (A template on the geometry, here
// always FwdGeom, so that only the sources that launch the forward compile
// its kernels; launch_bwd likewise.)
template <typename Geom>
int launch_fwd(const Geom& g, bf16* p, bf16* pd, int B, int S, int H,
               int Dh, float scale, bool dropout, const DropoutArgs& drop,
               cudaStream_t st) {
  if (S > kMaxS || (S <= kRegMaxS ? fwd_reg_smem_bytes(S, Dh)
                                  : fwd_smem_bytes(S, Dh)) >
                       attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!aligned(g.q, 16) || !aligned(g.k, 16) || !aligned(g.v, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs = S % 2 == 0 && aligned(p, 4) && aligned(pd, 4);
  return dh_tiles(Dh) == 8
             ? launch_fwd_dt<8>(g, p, pd, B, S, H, Dh, scale, dropout, pairs,
                                drop, st)
             : launch_fwd_dt<16>(g, p, pd, B, S, H, Dh, scale, dropout,
                                 pairs, drop, st);
}

// ---- the saved-probs backward ----------------------------------------------

// Where one (head, batch row) lives: as FwdGeom, for q, k, v; the context
// gradient g and the gradients dq, dk, dv with their own strides; the
// saved probs p, pd [B, H, S, S].
struct BwdGeom {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long sb, sh;
  int ld;
  const bf16* g;
  long long gsb, gsh;
  int g_ld;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long dsb, dsh;
  int d_ld;
  const bf16* p;
  const bf16* pd;
};

__host__ __device__ inline int bwd_pld(int s) { return rows16(s) + 8; }

__host__ __device__ inline size_t bwd_smem_bytes(int s, int dh) {
  return (4 * (size_t)rows16(s) * attn::tc_ld(dh) +
          2 * (size_t)rows16(s) * bwd_pld(s)) *
         sizeof(bf16);
}

// The saved-probs backward's tiles of one (head, batch row) in shared
// memory: Q, K, V and g [sp][ld] bf16 one after the other from `qkvg`,
// and the pd and ds_c tiles [sp][pld] one after the other from `pd_ds`;
// each function below derives its tiles from these two pointers. #3/#10
// lay them out as `bwd_smem_bytes` says; #19 puts each batch row's Q, K,
// V, g first and the pd and ds_c tiles after all of them.

// The staging half: Q, K, V and g by cp.async, committed as one group (Q,
// K, V skipped when q is null, g when g is: the caller has written or
// copied them, rows past S zero); the pad columns of all four zeroed; pd
// [S][S] into its tile, zeros to sp, two keys a thread (4-byte loads when
// `pairs`). Every thread of the block takes part; the caller waits and
// synchronises.
__device__ __forceinline__ void bwd_saved_stage(
    bf16* qkvg, bf16* pd_ds, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ld_in,
    const bf16* __restrict__ g, int g_ld, const bf16* __restrict__ pd_head,
    int S, int Dh, bool pairs) {
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = rows16(S), pld = bwd_pld(S);
  if (q) {
    attn::tc_cp_rows(qkvg, ld, q, ld_in, 0, sp, 0, S, Dh);
    attn::tc_cp_rows(qkvg + sp * ld, ld, k, ld_in, 0, sp, 0, S, Dh);
    attn::tc_cp_rows(qkvg + 2 * sp * ld, ld, v, ld_in, 0, sp, 0, S, Dh);
  }
  if (g) attn::tc_cp_rows(qkvg + 3 * sp * ld, ld, g, g_ld, 0, sp, 0, S, Dh);
  attn::cp_async_commit();
  attn::tc_zero_cols(qkvg, ld, 4 * sp, Dh, kd);  // the pad columns
  const int half = sp / 2;
  for (int i = threadIdx.x; i < sp * half; i += blockDim.x) {
    const int r = i / half, c = 2 * (i - r * half);
    uint32_t w = 0u;
    if (r < S && c < S) {
      const bf16* src = pd_head + (size_t)r * S + c;
      if (pairs) {
        w = *reinterpret_cast<const uint32_t*>(src);
      } else {
        __nv_bfloat162 x;
        x.x = src[0];
        x.y = c + 1 < S ? src[1] : __float2bfloat16(0.0f);
        w = *reinterpret_cast<const uint32_t*>(&x);
      }
    }
    *reinterpret_cast<uint32_t*>(pd_ds + r * pld + c) = w;
  }
}

// The compute half's phase 1 on staged tiles, for the calling warp's 16
// query rows m0 .. m0 + 15: d(pd) = g · Vᵀ into registers; t = pd ⊙ d(pd);
// Σ_k t from the lane's values in key order, then the quad's xor tree; p
// read from device memory in the accumulator layout; ds_c packed to bf16
// pairs, written to the ds_c tile and used as dQ = ds_c · K's A fragments.
template <int kNT, int kDT>
__device__ __forceinline__ void bwd_saved_phase1(
    bf16* qkvg, bf16* pd_ds, bf16* __restrict__ dq, int d_ld,
    const bf16* __restrict__ p_head, int m0, int S, int Dh, float scale,
    bool pairs) {
  const int lane = threadIdx.x & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = rows16(S), nkt = sp / 8, pld = bwd_pld(S);
  const bf16* ks = qkvg + sp * ld;
  const bf16* vs = ks + sp * ld;
  const bf16* gs = vs + sp * ld;
  const bf16* pds = pd_ds;
  bf16* dss = pd_ds + sp * pld;
  const int t4 = lane & 3;
  const int q_lo = m0 + (lane >> 2);
  float tt[kNT][4] = {};
  warp_abt<kNT>(tt, gs + m0 * ld, vs, ld, kd, nkt);  // d(pd) = g · Vᵀ
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    if (t < nkt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const __nv_bfloat162 pd2 = *reinterpret_cast<const __nv_bfloat162*>(
            pds + (q_lo + 8 * hi) * pld + 8 * t + 2 * t4);
        const float pd[2] = {__low2float(pd2), __high2float(pd2)};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float x = __fmul_rn(pd[u], tt[t][2 * hi + u]);
          tt[t][2 * hi + u] = x;
          sum[hi] += x;
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
  // ds_c = T((t − p · Σt) · scale), packed: [t][0] rows q_lo, [t][1]
  // rows q_lo + 8, each the lane's two keys.
  uint32_t dsp[kNT][2];
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    if (t < nkt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int qr = q_lo + 8 * hi, j = 8 * t + 2 * t4;
        float p[2] = {0.0f, 0.0f};
        if (qr < S && j < S) {
          const bf16* src = p_head + (size_t)qr * S + j;
          if (pairs) {
            const __nv_bfloat162 p2 =
                *reinterpret_cast<const __nv_bfloat162*>(src);
            p[0] = __low2float(p2);
            p[1] = __high2float(p2);
          } else {
            p[0] = __bfloat162float(src[0]);
            if (j + 1 < S) p[1] = __bfloat162float(src[1]);
          }
        }
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ds[u] = __fmul_rn(
              __fsub_rn(tt[t][2 * hi + u], __fmul_rn(p[u], sum[hi])), scale);
        dsp[t][hi] = attn::pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dss + qr * pld + j) = dsp[t][hi];
      }
    }
  }
  // dQ = ds_c · K: key tiles 2c and 2c + 1 are step c's A fragment.
  float acc[kDT][4] = {};
  const bf16* kb = attn::tc_lane_bt(ks, ld);
#pragma unroll
  for (int c = 0; c < kNT / 2; ++c) {
    if (2 * c < nkt) {
      const uint32_t fa[4] = {dsp[2 * c][0], dsp[2 * c][1],
                              dsp[2 * c + 1][0], dsp[2 * c + 1][1]};
      attn::tc_mma_bt(acc, fa, kb + 16 * c * ld, Dh / 8);
    }
  }
  store_rows(acc, dq, d_ld, m0, S, Dh);
}

// Phase 2, after a barrier that follows every row's phase 1 (the whole
// ds_c tile is in): the calling warp's 16 keys k0 .. k0 + 15, summed over
// every query row: dV = pdᵀ · g and dK = ds_cᵀ · Q, pdᵀ and ds_cᵀ by
// ldmatrix.trans from their tiles, g and Q by ldmatrix.trans.
template <int kDT>
__device__ __forceinline__ void bwd_saved_phase2(bf16* qkvg, bf16* pd_ds,
                                                 bf16* __restrict__ dk,
                                                 bf16* __restrict__ dv,
                                                 int d_ld, int k0, int S,
                                                 int Dh) {
  const int ld = attn::tc_ld(Dh);
  const int sp = rows16(S), pld = bwd_pld(S);
  const bf16* qs = qkvg;
  const bf16* gs = qkvg + 3 * sp * ld;
  const bf16* pds = pd_ds;
  const bf16* dss = pd_ds + sp * pld;
  {
    float acc[kDT][4] = {};  // dV = pdᵀ · g
    for (int c = 0; c < sp; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * pld + k0, pld));
      attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(gs + c * ld, ld), Dh / 8);
    }
    store_rows(acc, dv, d_ld, k0, S, Dh);
  }
  {
    float acc[kDT][4] = {};  // dK = ds_cᵀ · Q
    for (int c = 0; c < sp; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * pld + k0, pld));
      attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(qs + c * ld, ld), Dh / 8);
    }
    store_rows(acc, dk, d_ld, k0, S, Dh);
  }
}

// The saved-probs backward of one (head, batch row) (#3, #10): rows16(S) /
// 16 warps, the staging half, then the compute half's two phases, warp w
// on query rows and keys 16w .. 16w + 15.
template <int kNT, int kDT>
__device__ __forceinline__ void bwd_saved_rows(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ld_in,
    const bf16* __restrict__ g, int g_ld, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int d_ld,
    const bf16* __restrict__ p_head, const bf16* __restrict__ pd_head,
    int S, int Dh, float scale, bool pairs) {
  bf16* qkvg = reinterpret_cast<bf16*>(smem_raw);
  bf16* pd_ds = qkvg + 4 * rows16(S) * attn::tc_ld(Dh);
  bwd_saved_stage(qkvg, pd_ds, q, k, v, ld_in, g, g_ld, pd_head, S, Dh,
                  pairs);
  attn::cp_async_wait<0>();
  __syncthreads();
  const int m0 = 16 * (threadIdx.x >> 5);
  bwd_saved_phase1<kNT, kDT>(qkvg, pd_ds, dq, d_ld, p_head, m0, S, Dh, scale,
                             pairs);
  __syncthreads();  // every row's ds_c is in
  bwd_saved_phase2<kDT>(qkvg, pd_ds, dk, dv, d_ld, m0, S, Dh);
}

template <int kNT, int kDT>
__global__ void __launch_bounds__(kNT / 2 * 32)
    attn_full_tc_bwd_saved_kernel(BwdGeom g, int S, int H, int Dh,
                                  float scale, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const long long o = b * g.sb + h * g.sh;
  const long long og = b * g.gsb + h * g.gsh;
  const long long od = b * g.dsb + h * g.dsh;
  const size_t head = ((size_t)b * H + h) * S * S;
  bwd_saved_rows<kNT, kDT>(smem_raw, g.q + o, g.k + o, g.v + o, g.ld,
                           g.g + og, g.g_ld, g.dq + od, g.dk + od, g.dv + od,
                           g.d_ld, g.p + head, g.pd + head, S, Dh, scale,
                           pairs);
}

template <int kNT, int kDT>
int launch_bwd_tiles(const BwdGeom& g, int B, int S, int H, int Dh,
                     float scale, bool pairs, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_full_tc_bwd_saved_kernel<kNT, kDT>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_full_tc_bwd_saved_kernel<kNT, kDT>
      <<<dim3(H, B), rows16(S) / 16 * 32, bwd_smem_bytes(S, Dh), stream>>>(
          g, S, H, Dh, scale, pairs);
  return (int)cudaGetLastError();
}

// The bf16 saved-probs backward of #3 / #10 on one layout. q, k, v and g
// must start on the 16 bytes cp.async copies. Returns the cudaError_t of
// the launch; a shape past the plan returns cudaErrorInvalidValue.
template <typename Geom>
int launch_bwd(const Geom& g, int B, int S, int H, int Dh, float scale,
               cudaStream_t st) {
  const int wide = dh_tiles(Dh) == 8 ? kBwdTiles64 : kBwdTiles128;
  if (rows16(S) / 8 > wide || bwd_smem_bytes(S, Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!aligned(g.q, 16) || !aligned(g.k, 16) || !aligned(g.v, 16) ||
      !aligned(g.g, 16))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs = S % 2 == 0 && aligned(g.p, 4) && aligned(g.pd, 4);
  const bool small = rows16(S) / 8 <= kBwdSmallTiles;
  if (dh_tiles(Dh) == 8)
    return small ? launch_bwd_tiles<kBwdSmallTiles, 8>(g, B, S, H, Dh, scale,
                                                       pairs, st)
                 : launch_bwd_tiles<kBwdTiles64, 8>(g, B, S, H, Dh, scale,
                                                    pairs, st);
  return small ? launch_bwd_tiles<kBwdSmallTiles, 16>(g, B, S, H, Dh, scale,
                                                      pairs, st)
               : launch_bwd_tiles<kBwdTiles128, 16>(g, B, S, H, Dh, scale,
                                                    pairs, st);
}

// ---- the recompute backward ------------------------------------------------

constexpr int kRcTiles = 8;  // the recompute's n8 key tiles in registers
// Its most warps: one a 16-row slab of the reach's longest S (165 at Dh = 8
// rounded up to 176).
constexpr int kMaxBwdRcWarps = 11;
constexpr int kMaxBwdRcThreads = kMaxBwdRcWarps * 32;
// Blocks an SM the S ≤ 64 build at Dh ≤ 64 is held to: four blocks of
// four warps (128 registers) ran #9 14% faster at bf16 B=256 S=50 H=12
// than three (132 registers, no bound) on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_ab.py).
constexpr int kRcSmallBlocks = 4;

__host__ __device__ inline int bwd_rc_p_ld(int s) { return rows16(s) + 4; }

// Shared memory of a #2/#9 block: A and B [S16][L] bf16 (Q and K, then g
// and V, then K and Q again), the probs P [S16][S16 + 4] fp32 (pd_c over
// them), ds_c [S16][S16 + 8] bf16 and the [S16] fp32 bias.
__host__ __device__ inline size_t bwd_rc_smem_bytes(int s, int dh) {
  const size_t sp = rows16(s);
  return 2 * sp * attn::tc_ld(dh) * sizeof(bf16) +
         sp * bwd_rc_p_ld(s) * sizeof(float) +
         sp * bwd_pld(s) * sizeof(bf16) + sp * sizeof(float);
}

// The recompute backward of one (head, batch row): rows16(S) / 16 warps,
// warp w on query rows 16w .. 16w + 15 and keys 16w .. 16w + 15. mask: the
// batch row's fp32 [S] mask (null: no padding); (drop_b, drop_h): the
// Philox counter's batch row and head.
template <int kDT, bool kDropout>
__device__ __forceinline__ void bwd_recompute_rows(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int ld_in,
    const bf16* __restrict__ g, int g_ld, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int d_ld,
    const float* __restrict__ mask, int drop_b, int drop_h, int S, int Dh,
    float scale, const DropoutArgs& drop) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t4 = lane & 3;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = rows16(S), nkt = sp / 8, nk16 = sp / 16;
  const int pl4 = bwd_rc_p_ld(S), pld = bwd_pld(S);
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [sp][ld]: Q, g, Q
  bf16* bs = as + sp * ld;                        // [sp][ld]: K, V, K
  float* ps = reinterpret_cast<float*>(bs + sp * ld);  // [sp][pl4]
  bf16* pds = reinterpret_cast<bf16*>(ps);   // [sp][2·pl4]: pd_c over P
  bf16* dss = reinterpret_cast<bf16*>(ps + sp * pl4);    // [sp][pld]: ds_c
  float* bias = reinterpret_cast<float*>(dss + sp * pld);  // [sp]
  const float inv_keep = drop.inv_keep;

  attn::tc_cp_rows(as, ld, q, ld_in, 0, sp, 0, S, Dh);
  attn::tc_cp_rows(bs, ld, k, ld_in, 0, sp, 0, S, Dh);
  attn::cp_async_commit();
  for (int j = threadIdx.x; j < sp; j += blockDim.x)
    bias[j] = mask && j < S ? (1.0f - mask[j]) * -10000.0f : 0.0f;
  attn::tc_zero_cols(as, ld, 2 * sp, Dh, kd);  // A's and B's pad columns
  attn::cp_async_wait<0>();
  __syncthreads();

  // Phase 0: p again, with the forward's bits; the keep bit in its sign.
  const int m0 = 16 * warp;
  if (S <= kRegMaxS) {
    // #1's register plan: the warp's slab in registers, its lane pairs'
    // keep words.
    float sc[kRegTiles][4], sum[2];
    reg_scores_softmax(sc, sum, as + m0 * ld, bs, ld, kd, nkt, S, scale,
                       bias);
    __syncthreads();  // every warp has read Q and K: stage g and V
    attn::tc_cp_rows(as, ld, g, g_ld, 0, sp, 0, S, Dh);
    attn::tc_cp_rows(bs, ld, v, ld_in, 0, sp, 0, S, Dh);
    attn::cp_async_commit();
#pragma unroll
    for (int t = 0; t < kRegTiles; ++t) {
      if (t < nkt) {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
        if constexpr (kDropout)
          keep_words(wd, m0 + g4, t, drop_b, drop_h, drop);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float x[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            x[u] = sc[t][2 * hi + u] / sum[hi];
            if (kDropout && wd[2 * hi + u] < drop.threshold)
              x[u] = copysignf(x[u], -1.0f);
          }
          *reinterpret_cast<float2*>(ps + (m0 + g4 + 8 * hi) * pl4 + 8 * t +
                                     2 * t4) = make_float2(x[0], x[1]);
        }
      }
    }
  } else {
    // #4's score tile: 16 × 16 units, then its whole-row softmax order.
    for (int u = warp; u < nk16 * nk16; u += nw) {
      const int r0 = 16 * (u / nk16), k0 = 16 * (u - (u / nk16) * nk16);
      float sc[2][4] = {};
      warp_abt<2>(sc, as + r0 * ld, bs + k0 * ld, ld, kd, 2);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + 8 * t + 2 * t4;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<float2*>(ps + (r0 + g4 + 8 * hi) * pl4 + j) =
              make_float2(
                  __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), bias[j]),
                  __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale),
                            bias[j + 1]));
      }
    }
    __syncthreads();  // every score is in; Q and K are done with
    attn::tc_cp_rows(as, ld, g, g_ld, 0, sp, 0, S, Dh);
    attn::tc_cp_rows(bs, ld, v, ld_in, 0, sp, 0, S, Dh);
    attn::cp_async_commit();
    attn::softmax_rows_keep_sign<kDropout>(ps, S, S, 0, drop_b, drop_h, drop,
                                           pl4);
  }
  attn::cp_async_wait<0>();
  __syncthreads();  // p whole; g and V are in

  // Phase 1: the warp's slab. d(pd) = g · Vᵀ a 64-key chunk at a time, t =
  // pd ⊙ d(pd), Σ_k t from the lane's keys in order then the quad (a second
  // pass past 64 keys), ds_c = T((t − p · Σt) · scale) to its tile, pd_c
  // over the slab's own P rows.
  {
    const int q_lo = m0 + g4;
    float tt[kRcTiles][4];
    auto p_pair = [&](int hi, int j, float (&x)[2]) {  // signed; 0 past S
      x[0] = x[1] = 0.0f;
      if (q_lo + 8 * hi < S && j < S) {
        const float2 f =
            *reinterpret_cast<const float2*>(ps + (q_lo + 8 * hi) * pl4 + j);
        x[0] = f.x;
        if (j + 1 < S) x[1] = f.y;
      }
    };
    auto dpd = [&](int t0, int n) {
#pragma unroll
      for (int t = 0; t < kRcTiles; ++t)
        tt[t][0] = tt[t][1] = tt[t][2] = tt[t][3] = 0.0f;
      warp_abt<kRcTiles>(tt, as + m0 * ld, bs + t0 * 8 * ld, ld, kd, n);
#pragma unroll
      for (int t = 0; t < kRcTiles; ++t) {
        if (t < n) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float x[2];
            p_pair(hi, 8 * (t0 + t) + 2 * t4, x);
#pragma unroll
            for (int u = 0; u < 2; ++u)
              tt[t][2 * hi + u] =
                  __fmul_rn(attn::pd_of_signed<kDropout>(x[u], inv_keep),
                            tt[t][2 * hi + u]);
          }
        }
      }
    };
    const int n_kc = (nkt + kRcTiles - 1) / kRcTiles;
    float sum[2] = {0.0f, 0.0f};
    for (int kc = 0; kc < n_kc; ++kc) {
      const int n = min(kRcTiles, nkt - kc * kRcTiles);
      dpd(kc * kRcTiles, n);
#pragma unroll
      for (int t = 0; t < kRcTiles; ++t) {
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
    for (int kc = 0; kc < n_kc; ++kc) {
      const int t0 = kc * kRcTiles, n = min(kRcTiles, nkt - t0);
      if (n_kc > 1) dpd(t0, n);
      uint32_t pdw[kRcTiles][2];
#pragma unroll
      for (int t = 0; t < kRcTiles; ++t) {
        if (t < n) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int j = 8 * (t0 + t) + 2 * t4;
            float x[2], pd[2], ds[2];
            p_pair(hi, j, x);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              pd[u] = attn::pd_of_signed<kDropout>(x[u], inv_keep);
              ds[u] = __fmul_rn(
                  __fsub_rn(tt[t][2 * hi + u],
                            __fmul_rn(attn::p_of_signed<kDropout>(x[u]),
                                      sum[hi])),
                  scale);
            }
            pdw[t][hi] = attn::pack_bf16(pd[0], pd[1]);
            *reinterpret_cast<uint32_t*>(dss + (q_lo + 8 * hi) * pld + j) =
                attn::pack_bf16(ds[0], ds[1]);
          }
        }
      }
      // pd_c of key j lies on p's element j / 2: each written once the
      // warp has read this chunk's keys (and, past the first, the earlier
      // chunks' that it lies on).
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kRcTiles; ++t) {
        if (t < n) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            *reinterpret_cast<uint32_t*>(pds + (q_lo + 8 * hi) * 2 * pl4 +
                                         8 * (t0 + t) + 2 * t4) = pdw[t][hi];
        }
      }
    }
  }
  __syncthreads();  // pd_c and ds_c whole; V is done with

  attn::tc_cp_rows(bs, ld, k, ld_in, 0, sp, 0, S, Dh);
  attn::cp_async_commit();
  {  // Phase 2a: dV = pd_cᵀ · g, the warp's 16 keys over every query row.
    float acc[kDT][4] = {};
    for (int c = 0; c < sp; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * 2 * pl4 + m0,
                                               2 * pl4));
      attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
    }
    store_rows(acc, dv, d_ld, m0, S, Dh);
  }
  attn::cp_async_wait<0>();
  __syncthreads();  // K is in; g is done with

  attn::tc_cp_rows(as, ld, q, ld_in, 0, sp, 0, S, Dh);
  attn::cp_async_commit();
  {  // Phase 1b: dQ = ds_c · K, the warp's slab.
    float acc[kDT][4] = {};
    const bf16* pa = attn::tc_lane_a(dss + m0 * pld, pld);
    const bf16* kb = attn::tc_lane_bt(bs, ld);
    for (int c = 0; c < sp; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4(fa, pa + c);
      attn::tc_mma_bt(acc, fa, kb + c * ld, Dh / 8);
    }
    store_rows(acc, dq, d_ld, m0, S, Dh);
  }
  attn::cp_async_wait<0>();
  __syncthreads();  // Q is in

  {  // Phase 2b: dK = ds_cᵀ · Q, the warp's 16 keys.
    float acc[kDT][4] = {};
    for (int c = 0; c < sp; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * pld + m0, pld));
      attn::tc_mma_bt(acc, fa, attn::tc_lane_bt(as + c * ld, ld), Dh / 8);
    }
    store_rows(acc, dk, d_ld, m0, S, Dh);
  }
}

// #2/#9's geometry: BwdGeom's q, k, v, g and the gradients (p and pd
// unused), the fp32 [B, S] mask (null: no padding) and the Philox
// counter's offsets.
template <int kDT, bool kDropout, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_full_tc_bwd_recompute_kernel(BwdGeom g, const float* mask, int S,
                                      int H, int Dh, float scale, int b_off,
                                      int h_off, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const long long o = b * g.sb + h * g.sh;
  const long long og = b * g.gsb + h * g.gsh;
  const long long od = b * g.dsb + h * g.dsh;
  bwd_recompute_rows<kDT, kDropout>(
      smem_raw, g.q + o, g.k + o, g.v + o, g.ld, g.g + og, g.g_ld, g.dq + od,
      g.dk + od, g.dv + od, g.d_ld, mask ? mask + (size_t)b * S : nullptr,
      b + b_off, h + h_off, S, Dh, scale, drop);
}

template <int kDT, bool kDropout, int kThreads, int kMinBlocks>
int launch_bwd_rc_build(const BwdGeom& g, const float* mask, int B, int S,
                        int H, int Dh, float scale, int b_off, int h_off,
                        const DropoutArgs& drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_full_tc_bwd_recompute_kernel<kDT, kDropout, kThreads, kMinBlocks>,
      &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_full_tc_bwd_recompute_kernel<kDT, kDropout, kThreads, kMinBlocks>
      <<<dim3(H, B), rows16(S) / 16 * 32, bwd_rc_smem_bytes(S, Dh),
         stream>>>(g, mask, S, H, Dh, scale, b_off, h_off, drop);
  return (int)cudaGetLastError();
}

template <int kDT, bool kDropout>
int launch_bwd_rc(const BwdGeom& g, const float* mask, int B, int S, int H,
                  int Dh, float scale, int b_off, int h_off,
                  const DropoutArgs& drop, cudaStream_t stream) {
  if constexpr (kDT == 8) {
    if (S <= kRegMaxS)
      return launch_bwd_rc_build<kDT, kDropout, kRegThreads, kRcSmallBlocks>(
          g, mask, B, S, H, Dh, scale, b_off, h_off, drop, stream);
  }
  return launch_bwd_rc_build<kDT, kDropout, kMaxBwdRcThreads, 1>(
      g, mask, B, S, H, Dh, scale, b_off, h_off, drop, stream);
}

// The bf16 recompute backward of #2 / #9 on one layout (the probs again
// with the forward's bits, the keep mask replayed at (k >> 2, q, h + h_off,
// b + b_off)). q, k, v and g must start on the 16 bytes cp.async copies.
// Returns the cudaError_t of the launch; a shape past the plan returns
// cudaErrorInvalidValue.
template <typename Geom>
int launch_bwd_recompute(const Geom& g, const float* mask, int B, int S,
                         int H, int Dh, float scale, bool dropout, int b_off,
                         int h_off, const DropoutArgs& drop,
                         cudaStream_t st) {
  if (rows16(S) / 16 * 32 > kMaxBwdRcThreads ||
      bwd_rc_smem_bytes(S, Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!aligned(g.q, 16) || !aligned(g.k, 16) || !aligned(g.v, 16) ||
      !aligned(g.g, 16))
    return (int)cudaErrorMisalignedAddress;
  if (dh_tiles(Dh) == 8)
    return dropout ? launch_bwd_rc<8, true>(g, mask, B, S, H, Dh, scale,
                                            b_off, h_off, drop, st)
                   : launch_bwd_rc<8, false>(g, mask, B, S, H, Dh, scale,
                                             b_off, h_off, drop, st);
  return dropout ? launch_bwd_rc<16, true>(g, mask, B, S, H, Dh, scale,
                                           b_off, h_off, drop, st)
                 : launch_bwd_rc<16, false>(g, mask, B, S, H, Dh, scale,
                                            b_off, h_off, drop, st);
}

// ---- #18's and #19's QKV projection ----------------------------------------

// One block of kRows · kProjThreads projects head h of kRows batch rows
// (n_rows < kRows of them real at the batch's end):
//   head[r][j] = bf16(Σ_c x_b[r][c] · w[row(j)][c] in fp32 + b3[row(j)])
// for r < S and the head's 3·Dh columns j, row(j) = (j / Dh)·D + h·Dh +
// j % Dh its row of w (nn.Linear's [3D, D]) and column of the packed
// projection: the TPU kernel's `(x·W in fp32 + b).astype(dtype)`, the bias
// added to the fp32 sum before the one rounding. The product runs on
// mma.sync.m16n8k16 in passes of kProjRows rows of each batch row × at
// most kProjCols columns: the batch rows' x and the head's weight rows
// stream through a ring of kProjStages cp.async stages of kDepth-deep
// slices (rows of kDepth + 8 bf16, conflict-free for ldmatrix; depth past
// D zero-filled), so each weight slice serves every batch row of the
// block. Warp w takes batch row w / 8, the 16-row slab w % 4 and half
// (w / 4) % 2 of the pass's n8 tiles, its fp32 sums in registers over the
// whole depth, in 16-deep steps (the order, and so the bits, depend on
// neither kRows nor kDepth). Column j of row r of batch row i lands at
// head + i·head_step + (j / Dh)·seg + r·ld + j % Dh (q, k and v as three
// tiles of row stride ld, seg apart); rows S .. zero_rows − 1 are written
// as zeros. With kEmit the same bf16 pairs go to qkv_b + i·S·3D, row r,
// column row(j) ([S, 3D] a batch row). #18 and #19 call it alike, so
// #19's re-projection has #18's bits. x_b, w and their rows (D·2 bytes
// apart) must be 16-byte aligned; `stage` holds `proj_smem_bytes(Dh,
// kRows, kDepth)`. The caller synchronises before reading head.
constexpr int kProjThreads = 256;
constexpr int kProjRows = 64;
constexpr int kProjCols = 192;
constexpr int kProjStages = 2;
constexpr int kProjTiles = kProjCols / 16;  // a warp's n8 tiles, at most
// The plans' batch rows a block and slice depths (ops/fused_attention.py::
// QKVPROJ_TC_*): #18 to S = 64 (its register plan); #18 past S = 64, which
// keeps the head as [S][3·Dh] beside its row code and whose staging must
// fit beside the head at the reach, S = 468, one batch row a block with
// 32-deep slices, as #19 past S = 64 (one batch row of #19's CUDA-core
// chain ran 1.22 ms with 32-deep slices against 1.32 with 64-deep at bf16
// B=256 S=50 on an NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py). #19 to
// S = 64 takes kBwdProjRows batch rows with 64-deep slices: its (head,
// batch row) pass ran 0.644 ms against 0.795 with one batch row a block
// (the same card, chip_ab.py).
constexpr int kProjRegRows = 2;
constexpr int kProjRegDepth = 64;
constexpr int kProjRowsDepth = 32;
constexpr int kBwdProjRows = 2;

__host__ __device__ inline int proj_w_rows(int dh) {
  return rows16(3 * dh < kProjCols ? 3 * dh : kProjCols);
}

__host__ __device__ inline size_t proj_smem_bytes(int dh, int rows,
                                                  int depth) {
  return (size_t)kProjStages * (rows * kProjRows + proj_w_rows(dh)) *
         (depth + 8) * sizeof(bf16);
}

template <int kRows, int kDepth, bool kEmit>
__device__ __forceinline__ void project_head_tc(
    unsigned char* stage, bf16* head, size_t head_step, int ld, int seg,
    int zero_rows, const bf16* __restrict__ x_b, const bf16* __restrict__ w,
    const bf16* __restrict__ b3, bf16* __restrict__ qkv_b, int n_rows, int S,
    int D, int Dh, int h) {
  constexpr int kLd = kDepth + 8;
  constexpr int kXRows = kRows * kProjRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3, row_sel = warp >> 3, slab = warp & 3;
  const int half = (warp >> 2) & 1;
  const int N = 3 * Dh, wrows = proj_w_rows(Dh);
  const int n_slices = (D + kDepth - 1) / kDepth;
  const int n_cb = (N + kProjCols - 1) / kProjCols;
  const int n_pass = (zero_rows + kProjRows - 1) / kProjRows * n_cb;
  const int total = n_pass * n_slices;
  const int stage_elems = (kXRows + wrows) * kLd;
  bf16* ring = reinterpret_cast<bf16*>(stage);
  auto w_row = [=](int j) {
    return (size_t)(j / Dh) * D + h * Dh + j % Dh;
  };
  // Slice i of the stream into stage i % kProjStages: each batch row's x
  // rows m0 .. m0 + kProjRows − 1 (zeros past S and past the batch) and w's
  // rows of the pass's columns, at depth k0 .. k0 + kDepth − 1 (zeros past
  // D); one cp.async group.
  auto load = [&](int i) {
    const int pass = i / n_slices, k0 = (i - pass * n_slices) * kDepth;
    const int m0 = pass / n_cb * kProjRows;
    const int n0 = (pass - pass / n_cb * n_cb) * kProjCols;
    const int ncols = min(kProjCols, N - n0);
    bf16* xs = ring + (i % kProjStages) * stage_elems;
    bf16* ws = xs + kXRows * kLd;
    constexpr int kChunks = kDepth / 8;
    for (int e = threadIdx.x; e < (kXRows + ncols) * kChunks;
         e += blockDim.x) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      const bool in_depth = k0 + c < D;
      if (r < kXRows) {
        const int bi = r / kProjRows, m = m0 + r - bi * kProjRows;
        const bool ok = in_depth && bi < n_rows && m < S;
        attn::cp_async16(
            xs + r * kLd + c,
            ok ? x_b + ((size_t)bi * S + m) * D + k0 + c : x_b, ok);
      } else {
        const int j = r - kXRows;
        attn::cp_async16(ws + j * kLd + c,
                         in_depth ? w + w_row(n0 + j) * D + k0 + c : w,
                         in_depth);
      }
    }
  };
  float acc[kProjTiles][4];
#pragma unroll
  for (int t = 0; t < kProjTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < kProjStages - 1; ++i) {
    if (i < total) load(i);
    attn::cp_async_commit();
  }
  bf16* head_i = head + row_sel * head_step;
  bf16* qkv_i = kEmit ? qkv_b + (size_t)row_sel * S * 3 * D : nullptr;
  const bool real = row_sel < n_rows;
  for (int i = 0; i < total; ++i) {
    attn::cp_async_wait<kProjStages - 2>();  // slice i
    __syncthreads();  // ... for every thread; slice i − 1's readers are done
    if (i + kProjStages - 1 < total) load(i + kProjStages - 1);
    attn::cp_async_commit();
    const int pass = i / n_slices, sl = i - pass * n_slices;
    const int m0 = pass / n_cb * kProjRows;
    const int n0 = (pass - pass / n_cb * n_cb) * kProjCols;
    const int nt = (min(kProjCols, N - n0) + 7) / 8;
    const int per = (nt + 1) / 2, tb = half * per;
    const int n = max(0, min(per, nt - tb));
    const bf16* xs = ring + (i % kProjStages) * stage_elems;
    const bf16* ws = xs + kXRows * kLd;
    if (real && m0 + 16 * slab < zero_rows)
      warp_abt<kProjTiles>(acc,
                           xs + (row_sel * kProjRows + 16 * slab) * kLd,
                           ws + tb * 8 * kLd, kLd, kDepth, n);
    if (sl == n_slices - 1) {
      // The pass's epilogue: + b3 in fp32, one rounding, into the head.
#pragma unroll
      for (int t = 0; t < kProjTiles; ++t) {
        if (real && t < n) {
          const int j = n0 + 8 * (tb + t) + 2 * t4;
          const int part = j / Dh, c = j - part * Dh;
          const size_t col = (size_t)part * D + h * Dh + c;
          const float2 bias = make_float2(__bfloat162float(b3[col]),
                                          __bfloat162float(b3[col + 1]));
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = m0 + 16 * slab + (lane >> 2) + 8 * hi;
            __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, 0.0f);
            if (r < S) {
              v = __floats2bfloat162_rn(__fadd_rn(acc[t][2 * hi], bias.x),
                                        __fadd_rn(acc[t][2 * hi + 1],
                                                  bias.y));
              if constexpr (kEmit)
                *reinterpret_cast<__nv_bfloat162*>(
                    qkv_i + (size_t)r * 3 * D + col) = v;
            }
            if (r < zero_rows)
              *reinterpret_cast<__nv_bfloat162*>(
                  head_i + (size_t)part * seg + (size_t)r * ld + c) = v;
          }
        }
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      }
    }
  }
  attn::cp_async_wait<0>();
}

}  // namespace full_tc

}  // namespace
