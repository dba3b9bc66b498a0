// The two bf16 tensor-core passes of the rel-attention backwards, shared by
// #17 (attn_bwd_rel_fs.cu, the flash backward from #16's o and lse) and #15
// (attn_bwd_rel_hb.cu, #12's recompute backward, which has no forward
// residual and computes its row statistics itself): the packed backwards'
// passes (attn_bwd_packed_tc.cuh, whose Philox trade, statistics merge and
// tiling this header uses) in the rel layout.
//
// Per batch row b and head h, from q [B, Q, D], k and v [B, K, D] (separate
// tensors, head-major columns h·Dh + c, K ≠ Q under the memory), the score
// bias ebias [B, H, Q, K], the context gradient g [B, Q, D], the seed and
// each query row's softmax statistics (lse, or m and 1/l) and δ:
//   s    = (q · k) · scale + ebias   (the bias added in fp32)
//   p    = exp(s − lse_q), rebuilt per element (#15: exp(s − m_q) · (1/l)_q)
//   d(pd) = g · vᵀ;  with the replayed keep mask (common.cuh):
//   pd   = keep ? p · inv_keep : 0,  dp = keep ? d(pd) · inv_keep : 0
//   ds   = p · (dp − δ), the unscaled score gradient;  debias = T(ds)
//   ds_c = T(ds · scale);  pd_c = T(pd)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q,  dV = pd_cᵀ · g
// with dq [B, Q, D], dk, dv [B, K, D] and debias [B, H, Q, K] in bf16. The
// packed passes form T((p · (dp − δ)) · scale) with the same operations, so
// the two share the arithmetic and differ in the bias (one per key there,
// one per element here) and in the debias output. Where the row statistics
// come from is the template flag kOwnStats:
//   - #17 (false): lse is #16's, δ = Σ_c g ⊙ o from #16's rounded output;
//   - #15 (true): the dQ pass first walks the keys once for them, writes m,
//     1/l and δ ([3][B, H, Q] fp32), and the dK/dV pass, launched second,
//     reads them (#5's plan). m and 1/l stay apart: in a row masked whole
//     every score is −1e30 in fp32, where s − m is exact and an lse would
//     keep nothing of p.
//
// Two launches, each a deterministic reduction inside its blocks, with no
// atomics and no Q·K-sized memory beyond ebias and debias themselves. All
// products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by
// ldmatrix, with common.cuh's tensor-core pieces; every operand is staged
// as bf16 by cp.async, Dh padded to a k-depth of 16 with zero columns, rows
// past Q and K zero-filled. 8 warps a block; each pass is built for Dh ≤ 64
// and for Dh ≤ 128 (`tc_tiles`). In both passes a [64 q][64 k] tile of S =
// Q·Kᵀ and d(pd) = g·Vᵀ is split the same way, warp w taking queries
// 16·(w & 3) .. + 15 and keys 32·(w >> 2) .. + 31 (`attn::tc_warp`), both
// products by `tc_warp_abt<4>` over the same k16 steps, the score assembled
// from the same staged ebias bits (`tc_scores`), so every [q, k] element is
// fed the same fragments in the same order in both passes; the elementwise
// step (`tc_grads`) then runs on the accumulators in registers, each lane
// drawing one Philox block for its 2 rows × 4 keys with its neighbour
// (`tc_keep_words`). Both passes read the same statistics' bits (#17: δ from
// `tc_slab_delta` in `row_delta`'s order), hence the same ds bits, and
// debias is the ds the dK/dV pass used. Each [64 q][64 k] ebias slice comes
// by cp.async in a two-stage ring beside its block, as #16 stages it:
// 16-byte copies where K % 8 == 0 and ebias (and debias) start on 16 bytes,
// plain loads otherwise (K = 562 under a 50-row memory).
//   - dK/dV pass: one block per (64-key tile, head, batch row). K and V
//     staged once; q, g (#17: and o) and the query block's ebias slice in
//     two-stage rings, query block i + 1 in flight while block i is
//     computed. pd_c and ds_c go to bf16 [q][k] tiles; then each warp
//     accumulates its 16 keys × half of Dh of dV += pd_cᵀ·g and dK +=
//     ds_cᵀ·q, pd_cᵀ and ds_cᵀ by ldmatrix.trans from those tiles.
//   - dQ pass: one block per (64-query tile, head, batch row). q and g
//     staged once, K, V and the key block's ebias slice in two-stage rings.
//     ds_c never leaves the registers: a warp's accumulators of two
//     neighbouring n8 key tiles, packed to bf16 pairs, are the A fragment of
//     a 16-key step of dQ += ds_c·K. Each warp writes T(ds) of its elements
//     over the ebias it read in the slice's ring stage; after a barrier the
//     block stores the [64][64] debias tile in 16-byte row chunks (plain
//     stores where the ebias slices take plain loads). The two key halves'
//     partial dQ meet in shared memory once, at the end.
//   - #15's statistics walk, at the head of its dQ pass: the same ring
//     walks the keys twice, steps 0 .. n − 1 for the online max m,
//     denominator l and δ·l = Σ_k e · (keep ? d(pd) · inv_keep : 0) under
//     one rescale α = exp(m − m') (`tc_stats_step`), merged over a lane
//     quad and the two key halves once (`tc_stats_merge`), and steps n ..
//     2n − 1 for dQ and debias. δ = Σ_k pd ⊙ d(pd), #12's Σ_k t; #12 takes
//     it from the whole-row p = e / l, so the two differ at the fp32 level.
// Shared plans (`dkdv_smem_bytes`, `dq_smem_bytes`; ops/fused_attention.py::
// rel_fs_bwd_smem_bytes, rel_hb_bwd_smem_bytes), at Dh = 64 and 128: #17's
// dK/dV 108 and 172 KB, its dQ 72 and 120 KB; #15's dK/dV (no o ring) 90
// and 138 KB, its dQ (with the statistics' exchange) 72.8 and 120.8 KB.
// Every plan at Dh = 64 leaves two blocks an SM.

#pragma once

#include "attn_bwd_packed_tc.cuh"
#include "common.cuh"

// Internal linkage in each translation unit that includes this header.
namespace {

namespace rel_tc {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;
using packed_tc::kPLd;   // the bf16 [64][64] tiles' row stride
using packed_tc::kTile;  // keys a dK/dV block owns, queries a dQ block
using packed_tc::tc_keep_words;
using packed_tc::tc_row_pair;
using packed_tc::tc_stats_merge;
using packed_tc::tc_tiles;

// The operands of one call (rows of D = H·Dh elements; see the note).
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const bf16* o;       // #16's output (#17), else null
  const bf16* ebias;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  bf16* debias;        // written by the dQ pass
  float* stats;        // #16's lse [B, H, Q] (read), or m, 1/l, δ [3][B, H, Q]
  int Q, K, H, Dh;
  float scale;
  int vec_eb;          // every ebias and debias row on 16 bytes
  DropoutArgs drop;
};

// Bytes of shared memory of one block (see the note). dK/dV: K, V and the
// q and g rings (and #17's o ring), bf16 [64][L] each, the bf16 pd_c and
// ds_c tiles [64][72] and the ebias ring 2 × bf16 [64][72]. dQ: q, g and
// the K and V rings (six), the ebias ring and, with its own statistics,
// their exchange [3][64] fp32; at the end the key halves' partial dQ, fp32
// [64][Dh + 8], over the K and V rings.
__host__ __device__ inline size_t dkdv_smem_bytes(int dh, bool own_stats) {
  return ((own_stats ? 6 : 8) * (size_t)kTile) * attn::tc_ld(dh) *
             sizeof(bf16) +
         4 * (size_t)kTile * kPLd * sizeof(bf16);
}
__host__ __device__ inline size_t dq_smem_bytes(int dh, bool own_stats) {
  return 6 * (size_t)kTile * attn::tc_ld(dh) * sizeof(bf16) +
         2 * (size_t)kTile * kPLd * sizeof(bf16) +
         (own_stats ? 3 : 0) * (size_t)kTile * sizeof(float);
}

// The [64 q][64 k] ebias slice of one head (eb_bh: its [Q][K] block) at
// query q0 and key k0 into dst (rows of kPLd), zeros past Q and K: 16-byte
// cp.async copies where vec, plain loads otherwise (the caller commits).
__device__ __forceinline__ void tc_load_eb(bf16* dst, const bf16* eb_bh,
                                           int Q, int K, int q0, int k0,
                                           int vec) {
  const int rows = min(kTile, Q - q0), cols = min(kTile, K - k0);
  const bf16* src = eb_bh + (size_t)q0 * K + k0;
  if (vec) {
    for (int x = threadIdx.x; x < kTile * (kTile / 8); x += blockDim.x) {
      const int r = x / (kTile / 8), c = (x % (kTile / 8)) * 8;
      const bool ok = r < rows && c < cols;
      attn::cp_async16(dst + r * kPLd + c, ok ? src + (size_t)r * K + c : src,
                       ok);
    }
  } else {
    for (int x = threadIdx.x; x < kTile * kTile; x += blockDim.x) {
      const int r = x / kTile, c = x % kTile;
      dst[r * kPLd + c] = r < rows && c < cols ? src[(size_t)r * K + c]
                                               : __float2bfloat16(0.0f);
    }
  }
}

// The staged [64 q][64 k] debias tile src (rows of kPLd) to one head's
// [Q][K] block db_bh at query q0 and key k0, nothing past Q and K: 16-byte
// row chunks where vec, plain stores otherwise.
__device__ __forceinline__ void tc_store_db(bf16* db_bh, const bf16* src,
                                            int Q, int K, int q0, int k0,
                                            int vec) {
  const int rows = min(kTile, Q - q0), cols = min(kTile, K - k0);
  bf16* dst = db_bh + (size_t)q0 * K + k0;
  if (vec) {
    for (int x = threadIdx.x; x < kTile * (kTile / 8); x += blockDim.x) {
      const int r = x / (kTile / 8), c = (x % (kTile / 8)) * 8;
      if (r < rows && c < cols)
        *reinterpret_cast<uint4*>(dst + (size_t)r * K + c) =
            *reinterpret_cast<const uint4*>(src + r * kPLd + c);
    }
  } else {
    for (int x = threadIdx.x; x < kTile * kTile; x += blockDim.x) {
      const int r = x / kTile, c = x % kTile;
      if (r < rows && c < cols) dst[(size_t)r * K + c] = src[r * kPLd + c];
    }
  }
}

// The scores of a warp's [16 q][32 k] tile of accumulators (the layout of
// `tc_warp_abt<4>`: element (q_lo + 8·(e ≥ 2), k_first + 8t + 2·(lane % 4)
// + (e & 1)) in [t][e]), in place: s = (dot · scale) + ebias at the
// element's own (q, k), eb the warp's [16][32] slice of the staged tile
// (rows of kPLd).
__device__ __forceinline__ void tc_scores(float (&sc)[4][4], const bf16* eb,
                                          float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 e =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              eb + ((lane >> 2) + 8 * hi) * kPLd + 8 * t + 2 * (lane & 3)));
      sc[t][2 * hi] = __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x);
      sc[t][2 * hi + 1] = __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), e.y);
    }
}

// The elementwise step on a warp's [16 q][32 k] tile (as `tc_scores`): sc
// holds the scores s, tt the g·v dots. Per element, the CUDA-core kernels'
// arithmetic: p = exp(s − lse) (#15: exp(s − m) · (1/l)), the keep mask, pd,
// dp, ds = p · (dp − δ). Leaves pd_c = T(pd) in sc and ds_c = T(ds · scale)
// in tt, zeros where q ≥ Q or k ≥ K; with db (the dQ pass) also T(ds) of
// each element at its place in db, the warp's [16][32] slice of a bf16
// tile (rows of kPLd). r_*, il_* and d_* hold the lane's rows' lse (#15:
// m), 1/l (#15 only) and δ.
template <bool kOwnStats, bool kDropout>
__device__ __forceinline__ void tc_grads(float (&sc)[4][4], float (&tt)[4][4],
                                         bf16* db, float r_lo, float r_hi,
                                         float il_lo, float il_hi, float d_lo,
                                         float d_hi, int q_lo, int k_first,
                                         int Q, int K, int b, int h,
                                         float scale,
                                         const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};  // the draws of [t][0 .. 3]
    if constexpr (kDropout) tc_keep_words(wd, q_lo, k_first, t, b, h, drop);
    float ds_u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q_lo + 8 * (e >> 1);
      const int jj = 8 * t + 2 * (lane & 3) + (e & 1);
      float pd_c = 0.0f, ds_c = 0.0f, ds = 0.0f;
      if (q < Q && k_first + jj < K) {
        const float x = __fsub_rn(sc[t][e], e < 2 ? r_lo : r_hi);
        const float p =
            kOwnStats ? __fmul_rn(expf(x), e < 2 ? il_lo : il_hi) : expf(x);
        float pd = p, dp = tt[t][e];
        if constexpr (kDropout) {
          const bool keep = wd[e] >= drop.threshold;
          pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
          dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
        }
        ds = __fmul_rn(p, __fsub_rn(dp, e < 2 ? d_lo : d_hi));
        pd_c = attn::round_to<bf16>(pd);
        ds_c = attn::round_to<bf16>(__fmul_rn(ds, scale));
      }
      ds_u[e] = ds;
      sc[t][e] = pd_c;
      tt[t][e] = ds_c;
    }
    if (db != nullptr) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<__nv_bfloat162*>(
            db + ((lane >> 2) + 8 * hi) * kPLd + 8 * t + 2 * (lane & 3)) =
            __floats2bfloat162_rn(ds_u[2 * hi], ds_u[2 * hi + 1]);
    }
  }
}

// #15's statistics step on a warp's [16 q][32 k] tile (as `tc_grads`' sc
// and tt): for the lane's rows q_lo (r = 0) and q_lo + 8 (r = 1), over its
// 8 keys < K of the tile, m' = max(m, max s), α = exp(m − m'), l ← l·α + Σ
// e and dn ← dn·α + Σ e · (keep ? d(pd) · inv_keep : 0), e = exp(s − m').
// m starts at −∞ (l = dn = 0): a lane with no key yet keeps it there.
template <bool kDropout>
__device__ __forceinline__ void tc_stats_step(
    float (&m)[2], float (&l)[2], float (&dn)[2], const float (&sc)[4][4],
    const float (&tt)[4][4], int q_lo, int k_first, int K, int b, int h,
    const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  float s[4][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = 8 * t + 2 * (lane & 3) + (e & 1);
      s[t][e] = k_first + jj < K ? sc[t][e] : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    if (m_new != -INFINITY) {
      const float alpha = expf(m[r] - m_new);  // 0 while m = −∞
      l[r] = __fmul_rn(l[r], alpha);
      dn[r] = __fmul_rn(dn[r], alpha);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    if constexpr (kDropout) tc_keep_words(wd, q_lo, k_first, t, b, h, drop);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (s[t][e] == -INFINITY) continue;  // a key past K
      const int r = e >> 1;
      const float x = expf(s[t][e] - m[r]);
      float dp = tt[t][e];
      if constexpr (kDropout)
        dp = wd[e] >= drop.threshold ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
      l[r] = __fadd_rn(l[r], x);
      dn[r] = fmaf(x, dp, dn[r]);
    }
  }
}

template <int kTiles, bool kOwnStats, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_rel_dkdv_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dh = a.Dh, D = a.H * Dh, Q = a.Q, K = a.K;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kTile * ld;

  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* vs = ks + tile;                          // [64][ld]
  bf16* qs = vs + tile;                          // 2 × [64][ld]
  bf16* gs = qs + 2 * tile;                      // 2 × [64][ld]
  bf16* os = gs + 2 * tile;                      // 2 × [64][ld] (#17)
  bf16* pds = os + (kOwnStats ? 0 : 2 * tile);   // [64 q][kPLd] pd_c
  bf16* dss = pds + kTile * kPLd;                // [64 q][kPLd] ds_c
  bf16* ebs = dss + kTile * kPLd;                // 2 × [64 q][kPLd] ebias

  const bf16* q_base = a.q + (size_t)b * Q * D + h * Dh;  // q, g, o rows
  const bf16* g_base = a.g + (size_t)b * Q * D + h * Dh;
  const bf16* o_base = kOwnStats ? a.o : a.o + (size_t)b * Q * D + h * Dh;
  const size_t kv_off = (size_t)b * K * D + h * Dh;
  const bf16* eb_bh = a.ebias + ((size_t)b * a.H + h) * Q * K;
  // The rows' lse (#17), or m, 1/l and δ (#15), [B, H, Q] each.
  const float* r_bh = a.stats + ((size_t)b * a.H + h) * Q;
  const int cols = min(kTile, K - k0);
  const int n_blocks = (Q + kTile - 1) / kTile;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // Query block i (q, g, #17's o and the ebias slice) into ring stage i & 1.
  auto load_q = [&](int i) {
    const int q0 = i * kTile;
    const int rows = min(kTile, Q - q0);
    const int s = (i & 1) * tile;
    attn::tc_cp_rows(qs + s, ld, q_base, (size_t)D, q0, kTile, 0, rows, Dh);
    attn::tc_cp_rows(gs + s, ld, g_base, (size_t)D, q0, kTile, 0, rows, Dh);
    if constexpr (!kOwnStats)
      attn::tc_cp_rows(os + s, ld, o_base, (size_t)D, q0, kTile, 0, rows,
                       Dh);
    tc_load_eb(ebs + (i & 1) * kTile * kPLd, eb_bh, Q, K, q0, k0, a.vec_eb);
  };
  attn::tc_cp_rows(ks, ld, a.k + kv_off, (size_t)D, k0, kTile, 0, cols, Dh);
  attn::tc_cp_rows(vs, ld, a.v + kv_off, (size_t)D, k0, kTile, 0, cols, Dh);
  load_q(0);
  attn::cp_async_commit();
  // The k-depth's pad columns of K, V and the q and g rings stay zero.
  attn::tc_zero_cols(ks, ld, 6 * kTile, Dh, kd);

  float dk[kTiles / 2][4], dv[kTiles / 2][4];
#pragma unroll
  for (int t = 0; t < kTiles / 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.0f;

  for (int i = 0; i < n_blocks; ++i) {
    const int q0 = i * kTile;
    attn::cp_async_wait<0>();  // query block i
    __syncthreads();  // ... for every thread; block i − 1's products done
    if (i + 1 < n_blocks) load_q(i + 1);
    attn::cp_async_commit();
    const int s = (i & 1) * tile;
    const int q_lo = q0 + w.m0 + (lane >> 2);
    float r_lo, r_hi, il_lo = 0.0f, il_hi = 0.0f, d_lo, d_hi;
    tc_row_pair(r_lo, r_hi, r_bh, q_lo, Q);
    if constexpr (kOwnStats) {
      const size_t plane = (size_t)gridDim.z * a.H * Q;
      tc_row_pair(il_lo, il_hi, r_bh + plane, q_lo, Q);
      tc_row_pair(d_lo, d_hi, r_bh + 2 * plane, q_lo, Q);
    } else {
      attn::tc_slab_delta(d_lo, d_hi, gs + s + w.m0 * ld, ld,
                          os + s + w.m0 * ld, (size_t)ld, Q - q0 - w.m0, Dh);
    }
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + s + w.m0 * ld, ld, ks + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + s + w.m0 * ld, ld, vs + w.k0 * ld, ld, kd);
    tc_scores(sc, ebs + (i & 1) * kTile * kPLd + w.m0 * kPLd + w.k0,
              a.scale);
    tc_grads<kOwnStats, kDropout>(sc, tt, nullptr, r_lo, r_hi, il_lo, il_hi,
                                  d_lo, d_hi, q_lo, k0 + w.k0, Q, K, b, h,
                                  a.scale, a.drop);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = w.m0 + (lane >> 2) + 8 * hi;
        *reinterpret_cast<__nv_bfloat162*>(pds + r * kPLd + j) =
            __floats2bfloat162_rn(sc[t][2 * hi], sc[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dss + r * kPLd + j) =
            __floats2bfloat162_rn(tt[t][2 * hi], tt[t][2 * hi + 1]);
      }
    }
    __syncthreads();
    // dV[k] += Σ_q pd_c[q][k] · g[q],  dK[k] += Σ_q ds_c[q][k] · q[q] for
    // the warp's keys w.m0 .. + 15 and columns w.c0 .., 16 queries a step.
    const int q_end = min(kTile, (Q - q0 + 15) / 16 * 16);
    for (int c = 0; c < q_end; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * kPLd + w.m0, kPLd));
      attn::tc_mma_bt(dv, fa, attn::tc_lane_bt(gs + s + c * ld + w.c0, ld),
                      w.n);
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * kPLd + w.m0, kPLd));
      attn::tc_mma_bt(dk, fa, attn::tc_lane_bt(qs + s + c * ld + w.c0, ld),
                      w.n);
    }
  }
  bf16* dk_dst = a.dk + kv_off + (size_t)k0 * D + w.c0;
  bf16* dv_dst = a.dv + kv_off + (size_t)k0 * D + w.c0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = w.m0 + (lane >> 2) + 8 * hi;
    if (r >= cols) continue;
#pragma unroll
    for (int t = 0; t < kTiles / 2; ++t) {
      if (t < w.n) {
        const size_t at = (size_t)r * D + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dk_dst + at) =
            __floats2bfloat162_rn(dk[t][2 * hi], dk[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_dst + at) =
            __floats2bfloat162_rn(dv[t][2 * hi], dv[t][2 * hi + 1]);
      }
    }
  }
}

// #17 reads #16's lse (stats) and o; #15 (kOwnStats) writes m, 1/l and δ
// (stats, [3][B, H, Q]) from its statistics walk and reads nothing of the
// forward. Both write dq and debias.
template <int kTiles, bool kOwnStats, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_rel_dq_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dh = a.Dh, D = a.H * Dh, Q = a.Q, K = a.K;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kTile * ld;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* gs = qs + tile;                          // [64][ld]
  bf16* ks = gs + tile;                          // 2 × [64][ld]
  bf16* vs = ks + 2 * tile;                      // 2 × [64][ld]
  bf16* ebs = vs + 2 * tile;  // 2 × [64 q][kPLd] ebias, then debias
  float* st = reinterpret_cast<float*>(ebs + 2 * kTile * kPLd);  // [3][64]

  const size_t q_off = ((size_t)b * Q + q0) * D + h * Dh;  // q, g, o, dq
  const size_t kv_off = (size_t)b * K * D + h * Dh;
  const size_t eb_off = ((size_t)b * a.H + h) * Q * K;
  const int rows = min(kTile, Q - q0);
  const int n_blocks = (K + kTile - 1) / kTile;
  const int tiles = Dh / 8;
  const attn::TcWarp w = attn::tc_warp(Dh);
  float* r_bh = a.stats + ((size_t)b * a.H + h) * Q;  // lse, or m

  // Step t's K block, V block and ebias slice into ring stage t & 1: key
  // block t for #15's statistics walk (t < n_blocks), then key block
  // t − n_blocks for the dQ walk. #17 walks only the latter.
  auto load_kv = [&](int t) {
    const int k0 = (t < n_blocks ? t : t - n_blocks) * kTile;
    const int k_rows = min(kTile, K - k0);
    attn::tc_cp_rows(ks + (t & 1) * tile, ld, a.k + kv_off, (size_t)D, k0,
                     kTile, 0, k_rows, Dh);
    attn::tc_cp_rows(vs + (t & 1) * tile, ld, a.v + kv_off, (size_t)D, k0,
                     kTile, 0, k_rows, Dh);
    tc_load_eb(ebs + (t & 1) * kTile * kPLd, a.ebias + eb_off, Q, K, q0, k0,
               a.vec_eb);
  };
  const int t0 = kOwnStats ? 0 : n_blocks;
  attn::tc_cp_rows(qs, ld, a.q + q_off, (size_t)D, 0, kTile, 0, rows, Dh);
  attn::tc_cp_rows(gs, ld, a.g + q_off, (size_t)D, 0, kTile, 0, rows, Dh);
  load_kv(t0);
  attn::cp_async_commit();
  // The k-depth's pad columns of q, g and both ring stages stay zero.
  attn::tc_zero_cols(qs, ld, 6 * kTile, Dh, kd);
  const int q_lo = q0 + w.m0 + (lane >> 2);
  float r_lo = 0.0f, r_hi = 0.0f, il_lo = 0.0f, il_hi = 0.0f, d_lo = 0.0f,
        d_hi = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        dn[2] = {0.0f, 0.0f};  // #15's statistics of the lane's rows
  if constexpr (!kOwnStats) {
    tc_row_pair(r_lo, r_hi, r_bh, q_lo, Q);
    attn::cp_async_wait<0>();
    __syncthreads();  // g is staged
    attn::tc_slab_delta(d_lo, d_hi, gs + w.m0 * ld, ld,
                        a.o + q_off + (size_t)w.m0 * D, (size_t)D,
                        rows - w.m0, Dh);
  }
  float acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int t = t0; t < 2 * n_blocks; ++t) {
    attn::cp_async_wait<0>();  // step t's K/V block and ebias slice
    __syncthreads();  // ... for every thread; step t − 1 is done with
    if (t + 1 < 2 * n_blocks) load_kv(t + 1);
    attn::cp_async_commit();
    const int k0 = (t < n_blocks ? t : t - n_blocks) * kTile;
    const bf16* kb = ks + (t & 1) * tile;
    const bf16* vb = vs + (t & 1) * tile;
    bf16* eb = ebs + (t & 1) * kTile * kPLd;
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + w.m0 * ld, ld, kb + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + w.m0 * ld, ld, vb + w.k0 * ld, ld, kd);
    tc_scores(sc, eb + w.m0 * kPLd + w.k0, a.scale);
    if constexpr (kOwnStats) {
      if (t < n_blocks) {
        tc_stats_step<kDropout>(m, l, dn, sc, tt, q_lo, k0 + w.k0, K, b, h,
                                a.drop);
        continue;
      }
      if (t == n_blocks) {
        // The statistics walk is done: merge the lanes of each row (the
        // lane's quad), then the two key halves (warps w and w + 4) in
        // shared memory; m, 1/l and δ = dn / l (0 past Q).
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1)
            tc_stats_merge(m[r], l[r], dn[r],
                           __shfl_xor_sync(0xffffffffu, m[r], x),
                           __shfl_xor_sync(0xffffffffu, l[r], x),
                           __shfl_xor_sync(0xffffffffu, dn[r], x));
        const int row = w.m0 + (lane >> 2);
        if (w.k0 != 0 && (lane & 3) == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            st[row + 8 * r] = m[r];
            st[kTile + row + 8 * r] = l[r];
            st[2 * kTile + row + 8 * r] = dn[r];
          }
        }
        __syncthreads();
        if (w.k0 == 0) {
          float out[3][2];  // m, 1/l, δ
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rr = row + 8 * r;
            tc_stats_merge(m[r], l[r], dn[r], st[rr], st[kTile + rr],
                           st[2 * kTile + rr]);
            const bool live = q0 + rr < Q;
            out[0][r] = live ? m[r] : 0.0f;
            out[1][r] = live ? 1.0f / l[r] : 0.0f;
            out[2][r] = live ? dn[r] / l[r] : 0.0f;
          }
          __syncwarp();  // the quad has read the other half's partials
          const size_t plane = (size_t)gridDim.z * a.H * Q;
          if ((lane & 3) == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int rr = row + 8 * r;
#pragma unroll
              for (int x = 0; x < 3; ++x) {
                st[x * kTile + rr] = out[x][r];
                if (q0 + rr < Q) r_bh[x * plane + q0 + rr] = out[x][r];
              }
            }
          }
        }
        __syncthreads();
        r_lo = st[row];
        r_hi = st[row + 8];
        il_lo = st[kTile + row];
        il_hi = st[kTile + row + 8];
        d_lo = st[2 * kTile + row];
        d_hi = st[2 * kTile + row + 8];
      }
    }
    // T(ds) over the ebias the warp has just read, at the same places.
    tc_grads<kOwnStats, kDropout>(sc, tt, eb + w.m0 * kPLd + w.k0, r_lo,
                                  r_hi, il_lo, il_hi, d_lo, d_hi, q_lo,
                                  k0 + w.k0, Q, K, b, h, a.scale, a.drop);
    // dQ[q] += Σ_k ds_c[q][k] · k_k over the warp's 32 keys: the
    // accumulators of key tiles 2c and 2c + 1 are step c's A fragment.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t fa[4] = {
          attn::pack_bf16(tt[2 * c][0], tt[2 * c][1]),
          attn::pack_bf16(tt[2 * c][2], tt[2 * c][3]),
          attn::pack_bf16(tt[2 * c + 1][0], tt[2 * c + 1][1]),
          attn::pack_bf16(tt[2 * c + 1][2], tt[2 * c + 1][3])};
      attn::tc_mma_bt(acc, fa,
                      attn::tc_lane_bt(kb + (w.k0 + 16 * c) * ld, ld), tiles);
    }
    __syncthreads();  // every warp's debias is in the tile
    tc_store_db(a.debias + eb_off, eb, Q, K, q0, k0, a.vec_eb);
  }
  // The second key half's partial dQ to the first, over the rings.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ks);  // [64][Dh + 8]
  const int rld = Dh + 8;
  if (w.k0 != 0) {
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t < tiles) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = w.m0 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<float2*>(red + r * rld + t * 8 +
                                     2 * (lane & 3)) =
              make_float2(acc[t][2 * hi], acc[t][2 * hi + 1]);
        }
      }
    }
  }
  __syncthreads();
  if (w.k0 != 0) return;
  bf16* dq_dst = a.dq + q_off;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = w.m0 + (lane >> 2) + 8 * hi;
    if (r >= rows) continue;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t < tiles) {
        const int c = t * 8 + 2 * (lane & 3);
        const float2 other =
            *reinterpret_cast<const float2*>(red + r * rld + c);
        *reinterpret_cast<__nv_bfloat162*>(dq_dst + (size_t)r * D + c) =
            __floats2bfloat162_rn(__fadd_rn(acc[t][2 * hi], other.x),
                                  __fadd_rn(acc[t][2 * hi + 1], other.y));
      }
    }
  }
}

template <bool kDkdv, bool kOwnStats, int kTiles, bool kDropout>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = kDkdv ? attn_bwd_rel_dkdv_tc_kernel<kTiles, kOwnStats, kDropout>
                      : attn_bwd_rel_dq_tc_kernel<kTiles, kOwnStats, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kDkdv ? dkdv_smem_bytes(a.Dh, kOwnStats)
                            : dq_smem_bytes(a.Dh, kOwnStats);
  dim3 grid(((kDkdv ? a.K : a.Q) + kTile - 1) / kTile, a.H, B);
  kernel<<<grid, attn::kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One pass (kDkdv: the dK/dV pass, else the dQ and debias pass) for any Dh
// ≤ 128 and rate. q, o and g are [B, Q, D], k and v [B, K, D], ebias and
// debias [B, H, Q, K]; stats is #16's lse [B, H, Q] (#17) or m, 1/l and δ
// [3][B, H, Q] (#15, kOwnStats). cudaErrorMisalignedAddress where q, k, v,
// g (or o) does not start on the 16 bytes cp.async copies.
template <bool kDkdv, bool kOwnStats>
int launch_pass(const void* q, const void* k, const void* v,
                const void* ebias, const void* o, float* stats, const void* g,
                void* dq, void* dk, void* dv, void* debias, int B, int Q,
                int K, int H, int Dh, float scale, bool dropout,
                DropoutArgs drop, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int vec_eb = K % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(ebias) |
                      reinterpret_cast<uintptr_t>(debias)) % 16 == 0;
  const Args a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),     static_cast<const bf16*>(g),
               static_cast<const bf16*>(o),     static_cast<const bf16*>(ebias),
               static_cast<bf16*>(dq),          static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),          static_cast<bf16*>(debias),
               stats, Q, K, H, Dh, scale, vec_eb, drop};
  const bool wide = tc_tiles(Dh) == 16;
  if (dropout)
    return wide ? launch<kDkdv, kOwnStats, 16, true>(a, B, stream)
                : launch<kDkdv, kOwnStats, 8, true>(a, B, stream);
  return wide ? launch<kDkdv, kOwnStats, 16, false>(a, B, stream)
              : launch<kDkdv, kOwnStats, 8, false>(a, B, stream);
}

}  // namespace rel_tc

}  // namespace
