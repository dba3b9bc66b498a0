// The two bf16 tensor-core passes of the packed attention backward, shared
// by #7 (attn_bwd_packed_fs.cu, the flash backward from #6's o and lse) and
// #5 (attn_bwd_packed_hb.cu, #2's recompute backward, which has no forward
// residual and computes its row statistics itself).
//
// Per batch row b and head h, from qkv [B, S, 3D], the fp32 mask, the
// context gradient g [B, S, D], the seed and each query row's softmax
// statistics (lse, or m and 1/l) and δ:
//   p    = exp((q · k) · scale + bias − lse_q), rebuilt per element (#5:
//          exp(s − m_q) · (1/l)_q)
//   d(pd) = g · vᵀ;  with the replayed keep mask (common.cuh):
//   pd   = keep ? p · inv_keep : 0,  dp = keep ? d(pd) · inv_keep : 0
//   ds   = (p · (dp − δ)) · scale;  ds_c = T(ds);  pd_c = T(pd)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q,  dV = pd_cᵀ · g
// written into dqkv [B, S, 3D] at the columns q, k, v came from. Where the
// row statistics come from is the template flag kOwnStats:
//   - #7 (false): lse is #6's, δ = Σ_c g ⊙ o from #6's rounded output o;
//   - #5 (true): the dQ pass first walks the keys once for them (below),
//     writes m, 1/l and δ ([3][B, H, S] fp32), and the dK/dV pass,
//     launched second, reads them. #5 keeps m and 1/l apart where #7 has
//     lse = m + log l: in a batch row masked whole every score sits near
//     −10^4, where an fp32 lse holds only ~5e-4 of p's relative precision,
//     while s − m is exact there, so p = exp(s − m) · (1/l) stays within a
//     few ulp of #2's whole-row exp(s − m) / l.
//
// Two launches, each a deterministic reduction inside its blocks, with no
// atomics and no S²-sized memory. All products run on mma.sync.m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix, with common.cuh's tensor-core
// pieces; every operand is staged as bf16 by cp.async, Dh padded to a
// k-depth of 16 with zero columns, rows past S zero-filled. 8 warps a
// block; each pass is built for Dh ≤ 64 and for Dh ≤ 128 (`tc_tiles`), so
// that Dh = 64 holds no accumulators for the wider head. In both passes a
// [64 q][64 k] tile of S = Q·Kᵀ and d(pd) = g·Vᵀ is split the same way,
// warp w taking queries 16·(w & 3) .. + 15 and keys 32·(w >> 2) .. + 31
// (`attn::tc_warp`), both products by `tc_warp_abt<4>` over the same k16
// steps, so every [q, k] element is fed the same fragments in the same
// order in both passes; the elementwise step (`tc_grads`, the CUDA-core
// kernels' `scores` + `grads_of_scores` arithmetic) then runs on the
// accumulators in registers, each lane drawing one Philox block for its
// 2 rows × 4 keys with its neighbour and trading the other's words by two
// shuffles (`tc_keep_words`). Both passes read the same statistics' bits
// (#7: δ from `tc_slab_delta` in `row_delta`'s order), hence the same ds
// bits.
//   - dK/dV pass: one block per (64-key tile, head, batch row). K and V
//     staged once; Q and g (and #7's o) in two-stage rings, query block
//     i + 1 in flight while block i is computed. pd_c and ds_c go to bf16
//     [q][k] tiles; then each warp accumulates its 16 keys × half of Dh of
//     dV += pd_cᵀ·g and dK += ds_cᵀ·Q, pd_cᵀ and ds_cᵀ by ldmatrix.trans
//     from those tiles, g and Q by ldmatrix.trans.
//   - dQ pass: one block per (64-query tile, head, batch row). Q and g
//     staged once, K and V (and the bias) in two-stage rings. ds_c never
//     leaves the registers: a warp's accumulators of two neighbouring n8
//     key tiles, packed to bf16 pairs, are the A fragment of a 16-key step
//     of dQ += ds_c·K (K by ldmatrix.trans). The two key halves' partial
//     dQ meet in shared memory once, at the end.
//   - #5's statistics walk, at the head of its dQ pass: the same ring walks
//     the keys twice, steps 0 .. n − 1 for the statistics and n .. 2n − 1
//     for dQ (step n's blocks in flight during step n − 1). On each key
//     block's S and d(pd) accumulators a lane keeps, for its two rows, the
//     online max m and denominator l of the undropped e = exp(s − m) and
//     δ·l = Σ_k e · (keep ? d(pd) · inv_keep : 0) under the same rescale
//     α = exp(m − m') (`tc_stats_step`); the lanes of a row, then its two
//     key halves, merge their partials once (`tc_stats_merge`), and δ =
//     (δ·l) / l. δ = Σ_k pd ⊙ d(pd), #2's Σ_k t; #2 takes it from the
//     whole-row p = e / l, so the two differ at the fp32 level.
// Shared plans (`dkdv_smem_bytes`, `dq_smem_bytes`;
// ops/fused_attention.py::fs_bwd_smem_bytes, hb_bwd_smem_bytes): #7's
// dK/dV 90.3 KB at Dh = 64 (two blocks an SM), 154.3 KB at Dh = 128, its dQ
// 54.5 KB and 102.5 KB; #5's dK/dV (no o ring) 72.3 KB and 120.3 KB, its dQ
// (with the statistics' exchange) 55.3 KB and 103.3 KB.

#pragma once

#include "common.cuh"

// Internal linkage in each translation unit that includes this header.
namespace {

namespace packed_tc {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // keys a dK/dV block owns; queries a dQ
                                   // block; the rows of every staged block
constexpr int kPLd = kTile + 8;    // the bf16 pd_c / ds_c tiles' row stride
constexpr int kMaxDh = 128;
static_assert(kTile == attn::kTcQTile && kTile == attn::kTcKBlock,
              "the tensor-core tiles are 64 × 64 (attn::tc_warp)");

// The kernels are instantiated for kTiles = 8 (Dh ≤ 64) and 16 (Dh ≤ 128)
// n8 tiles of Dh, so that Dh = 64 holds no registers for Dh = 128: a dK/dV
// warp holds kTiles / 2 tiles each of dK and dV (16 keys × half of Dh), a
// dQ warp kTiles (16 queries × Dh).
__host__ __device__ inline int tc_tiles(int dh) { return dh <= 64 ? 8 : 16; }

// Bytes of shared memory of one block (see the note). dK/dV: K, V and the
// Q and g rings (and #7's o ring), bf16 [64][L] each, the bf16 pd_c and
// ds_c tiles [64][72], the tile's bias. dQ: Q, g and the K and V rings
// (six), the two bias blocks (and #5's statistics exchange, [3][64] fp32);
// at the end the key halves' partial dQ, fp32 [64][Dh + 8], over the rings.
__host__ __device__ inline size_t dkdv_smem_bytes(int dh, bool own_stats) {
  return ((own_stats ? 6 : 8) * (size_t)kTile) * attn::tc_ld(dh) *
             sizeof(bf16) +
         2 * (size_t)kTile * kPLd * sizeof(bf16) + kTile * sizeof(float);
}
__host__ __device__ inline size_t dq_smem_bytes(int dh, bool own_stats) {
  return 6 * (size_t)kTile * attn::tc_ld(dh) * sizeof(bf16) +
         (2 + (own_stats ? 3 : 0)) * (size_t)kTile * sizeof(float);
}

// The keep-test draws of a lane's elements [t][0 .. 3] of a warp's [16 q]
// [32 k] tile (the layout of `tc_warp_abt<4>`): lanes 2m and 2m + 1 (the
// same 4 keys, rows q_lo and q_lo + 8) draw one Philox block each, for
// q_lo and q_lo + 8, and trade the two words the other needs. Every lane
// of the warp must call it.
__device__ __forceinline__ void tc_keep_words(uint32_t (&wd)[4], int q_lo,
                                              int k_first, int t, int b,
                                              int h, const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int k4 = (k_first + 8 * t + 4 * ((lane & 3) >> 1)) >> 2;
  const uint4 own =
      attn::dropout_bits4(drop, b, h, odd ? q_lo + 8 : q_lo, k4);
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? own.x : own.z, 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? own.y : own.w, 1);
  wd[0] = odd ? x0 : own.x;
  wd[1] = odd ? x1 : own.y;
  wd[2] = odd ? own.z : x0;
  wd[3] = odd ? own.w : x1;
}

// The elementwise step on a warp's [16 q][32 k] tile of accumulators (the
// layout of `tc_warp_abt<4>`: element (q_lo + 8·(e ≥ 2), k_first + 8t +
// 2·(lane % 4) + (e & 1)) in [t][e]): sc holds the q·k dots, tt the g·v
// dots. Per element, `scores` + `grads_of_scores`' arithmetic: p =
// exp((dot · scale + bias) − lse) (#5: exp((dot · scale + bias) − m) ·
// (1/l)), the keep mask, pd, dp, ds = (p · (dp − δ)) · scale. Leaves pd_c
// = T(pd) in sc and ds_c = T(ds) in tt, zeros where q or k ≥ S. bias holds
// the 32 keys' bias; r_*, il_* and d_* the lane's rows' lse (#5: m), 1/l
// (#5 only) and δ.
template <bool kOwnStats, bool kDropout>
__device__ __forceinline__ void tc_grads(float (&sc)[4][4], float (&tt)[4][4],
                                         const float* bias, float r_lo,
                                         float r_hi, float il_lo, float il_hi,
                                         float d_lo, float d_hi, int q_lo,
                                         int k_first, int S, int b, int h,
                                         float scale,
                                         const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};  // the draws of [t][0 .. 3]
    if constexpr (kDropout) tc_keep_words(wd, q_lo, k_first, t, b, h, drop);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q_lo + 8 * (e >> 1);
      const int jj = 8 * t + 2 * (lane & 3) + (e & 1);
      float pd_c = 0.0f, ds_c = 0.0f;
      if (q < S && k_first + jj < S) {
        const float x = __fsub_rn(
            __fadd_rn(__fmul_rn(sc[t][e], scale), bias[jj]),
            e < 2 ? r_lo : r_hi);
        const float p =
            kOwnStats ? __fmul_rn(expf(x), e < 2 ? il_lo : il_hi) : expf(x);
        float pd = p, dp = tt[t][e];
        if constexpr (kDropout) {
          const bool keep = wd[e] >= drop.threshold;
          pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
          dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
        }
        const float ds = __fmul_rn(
            __fmul_rn(p, __fsub_rn(dp, e < 2 ? d_lo : d_hi)), scale);
        pd_c = attn::round_to<bf16>(pd);
        ds_c = attn::round_to<bf16>(ds);
      }
      sc[t][e] = pd_c;
      tt[t][e] = ds_c;
    }
  }
}

// #5's statistics step on a warp's [16 q][32 k] tile of accumulators (as
// `tc_grads`' sc and tt): for the lane's rows q_lo (r = 0) and q_lo + 8
// (r = 1), over its 8 keys < S of the tile, s = (dot · scale) + bias as in
// `tc_grads`; m' = max(m, max s), α = exp(m − m'), l ← l·α + Σ e and dn ←
// dn·α + Σ e · (keep ? d(pd) · inv_keep : 0), e = exp(s − m'). m starts at
// −∞ (l = dn = 0): a lane with no key yet keeps it there.
template <bool kDropout>
__device__ __forceinline__ void tc_stats_step(
    float (&m)[2], float (&l)[2], float (&dn)[2], const float (&sc)[4][4],
    const float (&tt)[4][4], const float* bias, int q_lo, int k_first, int S,
    int b, int h, float scale, const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  float s[4][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = 8 * t + 2 * (lane & 3) + (e & 1);
      s[t][e] = k_first + jj < S
                    ? __fadd_rn(__fmul_rn(sc[t][e], scale), bias[jj])
                    : -INFINITY;
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
      if (s[t][e] == -INFINITY) continue;  // a key past S
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

// (m, l, dn) ← the merge of two partial statistics of one row.
__device__ __forceinline__ void tc_stats_merge(float& m, float& l, float& dn,
                                               float m_o, float l_o,
                                               float dn_o) {
  const float mm = fmaxf(m, m_o);
  if (mm == -INFINITY) return;  // neither has a key
  const float a = expf(m - mm), c = expf(m_o - mm);
  l = __fadd_rn(__fmul_rn(l, a), __fmul_rn(l_o, c));
  dn = __fadd_rn(__fmul_rn(dn, a), __fmul_rn(dn_o, c));
  m = mm;
}

// The lane's rows' values of a per-row statistic (0 past S).
__device__ __forceinline__ void tc_row_pair(float& lo, float& hi,
                                            const float* row_bh, int q_lo,
                                            int S) {
  lo = q_lo < S ? row_bh[q_lo] : 0.0f;
  hi = q_lo + 8 < S ? row_bh[q_lo + 8] : 0.0f;
}

template <int kTiles, bool kOwnStats, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_packed_dkdv_tc_kernel(const bf16* __restrict__ qkv,
                                   const float* __restrict__ mask,
                                   const bf16* __restrict__ o,
                                   float* __restrict__ stats,  // read only
                                   const bf16* __restrict__ g,
                                   bf16* __restrict__ dqkv, int S, int H,
                                   int Dh, float scale, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
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
  bf16* os = gs + 2 * tile;                      // 2 × [64][ld] (#7)
  bf16* pds = os + (kOwnStats ? 0 : 2 * tile);   // [64 q][kPLd] pd_c
  bf16* dss = pds + kTile * kPLd;                // [64 q][kPLd] ds_c
  float* bias = reinterpret_cast<float*>(dss + kTile * kPLd);  // [64]

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const bf16* g_base = g + (size_t)b * S * D + h * Dh;
  const bf16* o_base = kOwnStats ? o : o + (size_t)b * S * D + h * Dh;
  // The rows' lse (#7), or m, 1/l and δ (#5), [B, H, S] each.
  const float* r_bh = stats + ((size_t)b * H + h) * S;
  const int cols = min(kTile, S - k0);
  const int n_blocks = (S + kTile - 1) / kTile;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // Query block i (Q, g and #7's o) into ring stage i & 1.
  auto load_q = [&](int i) {
    const int q0 = i * kTile;
    const int rows = min(kTile, S - q0);
    const int s = (i & 1) * tile;
    attn::tc_cp_rows(qs + s, ld, q_base, row_stride, q0, kTile, 0, rows, Dh);
    attn::tc_cp_rows(gs + s, ld, g_base, (size_t)D, q0, kTile, 0, rows, Dh);
    if constexpr (!kOwnStats)
      attn::tc_cp_rows(os + s, ld, o_base, (size_t)D, q0, kTile, 0, rows,
                       Dh);
  };
  attn::tc_cp_rows(ks, ld, q_base + D, row_stride, k0, kTile, 0, cols, Dh);
  attn::tc_cp_rows(vs, ld, q_base + 2 * D, row_stride, k0, kTile, 0, cols,
                   Dh);
  load_q(0);
  attn::cp_async_commit();
  if (tid < kTile)
    bias[tid] = mask && tid < cols
                    ? (1.0f - mask[(size_t)b * S + k0 + tid]) * -10000.0f
                    : 0.0f;
  // The k-depth's pad columns of K, V and the Q and g rings stay zero.
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
    tc_row_pair(r_lo, r_hi, r_bh, q_lo, S);
    if constexpr (kOwnStats) {
      const size_t plane = (size_t)gridDim.z * H * S;
      tc_row_pair(il_lo, il_hi, r_bh + plane, q_lo, S);
      tc_row_pair(d_lo, d_hi, r_bh + 2 * plane, q_lo, S);
    } else {
      attn::tc_slab_delta(d_lo, d_hi, gs + s + w.m0 * ld, ld,
                          os + s + w.m0 * ld, (size_t)ld, S - q0 - w.m0, Dh);
    }
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + s + w.m0 * ld, ld, ks + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + s + w.m0 * ld, ld, vs + w.k0 * ld, ld, kd);
    tc_grads<kOwnStats, kDropout>(sc, tt, bias + w.k0, r_lo, r_hi, il_lo,
                                  il_hi, d_lo, d_hi, q_lo, k0 + w.k0, S, b,
                                  h, scale, drop);
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
    const int q_end = min(kTile, (S - q0 + 15) / 16 * 16);
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
  bf16* dk_dst = dqkv + ((size_t)b * S + k0) * row_stride + D + h * Dh + w.c0;
  bf16* dv_dst = dk_dst + D;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = w.m0 + (lane >> 2) + 8 * hi;
    if (r >= cols) continue;
#pragma unroll
    for (int t = 0; t < kTiles / 2; ++t) {
      if (t < w.n) {
        const size_t at = (size_t)r * row_stride + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dk_dst + at) =
            __floats2bfloat162_rn(dk[t][2 * hi], dk[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_dst + at) =
            __floats2bfloat162_rn(dv[t][2 * hi], dv[t][2 * hi + 1]);
      }
    }
  }
}

// #7 reads #6's lse (stats) and o; #5 (kOwnStats) writes m, 1/l and δ
// (stats, [3][B, H, S]) from its statistics walk and reads nothing of the
// forward.
template <int kTiles, bool kOwnStats, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_packed_dq_tc_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ mask,
                                 const bf16* __restrict__ o,
                                 float* __restrict__ stats,
                                 const bf16* __restrict__ g,
                                 bf16* __restrict__ dqkv, int S, int H,
                                 int Dh, float scale, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
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
  float* bias = reinterpret_cast<float*>(vs + 2 * tile);  // 2 × [64]
  float* st = bias + 2 * kTile;  // #5: [3][64] the statistics' exchange

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const int rows = min(kTile, S - q0);
  const int n_blocks = (S + kTile - 1) / kTile;
  const int tiles = Dh / 8;
  const attn::TcWarp w = attn::tc_warp(Dh);
  float* r_bh = stats + ((size_t)b * H + h) * S;  // lse (#7) or m (#5)

  // Step t's K block, V block and their bias into ring stage t & 1: key
  // block t for #5's statistics walk (t < n_blocks), then key block
  // t − n_blocks for the dQ walk. #7 walks only the latter.
  auto load_kv = [&](int t) {
    const int k0 = (t < n_blocks ? t : t - n_blocks) * kTile;
    const int k_rows = min(kTile, S - k0);
    attn::tc_cp_rows(ks + (t & 1) * tile, ld, q_base + D, row_stride, k0,
                     kTile, 0, k_rows, Dh);
    attn::tc_cp_rows(vs + (t & 1) * tile, ld, q_base + 2 * D, row_stride, k0,
                     kTile, 0, k_rows, Dh);
    if (tid < kTile)
      bias[(t & 1) * kTile + tid] =
          mask && tid < k_rows
              ? (1.0f - mask[(size_t)b * S + k0 + tid]) * -10000.0f
              : 0.0f;
  };
  const int t0 = kOwnStats ? 0 : n_blocks;
  attn::tc_cp_rows(qs, ld, q_base, row_stride, q0, kTile, 0, rows, Dh);
  attn::tc_cp_rows(gs, ld, g + (size_t)b * S * D + h * Dh, (size_t)D, q0,
                   kTile, 0, rows, Dh);
  load_kv(t0);
  attn::cp_async_commit();
  // The k-depth's pad columns of Q, g and both ring stages stay zero.
  attn::tc_zero_cols(qs, ld, 6 * kTile, Dh, kd);
  const int q_lo = q0 + w.m0 + (lane >> 2);
  float r_lo = 0.0f, r_hi = 0.0f, il_lo = 0.0f, il_hi = 0.0f, d_lo = 0.0f,
        d_hi = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        dn[2] = {0.0f, 0.0f};  // #5's statistics of the lane's rows
  if constexpr (!kOwnStats) {
    tc_row_pair(r_lo, r_hi, r_bh, q_lo, S);
    attn::cp_async_wait<0>();
    __syncthreads();  // g is staged
    attn::tc_slab_delta(d_lo, d_hi, gs + w.m0 * ld, ld,
                        o + ((size_t)b * S + q0 + w.m0) * D + h * Dh,
                        (size_t)D, rows - w.m0, Dh);
  }
  float acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int t = t0; t < 2 * n_blocks; ++t) {
    attn::cp_async_wait<0>();  // step t's K/V block
    __syncthreads();  // ... for every thread; step t − 1 is done with
    if (t + 1 < 2 * n_blocks) load_kv(t + 1);
    attn::cp_async_commit();
    const int k0 = (t < n_blocks ? t : t - n_blocks) * kTile;
    const bf16* kb = ks + (t & 1) * tile;
    const bf16* vb = vs + (t & 1) * tile;
    const float* bi = bias + (t & 1) * kTile + w.k0;
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + w.m0 * ld, ld, kb + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + w.m0 * ld, ld, vb + w.k0 * ld, ld, kd);
    if constexpr (kOwnStats) {
      if (t < n_blocks) {
        tc_stats_step<kDropout>(m, l, dn, sc, tt, bi, q_lo, k0 + w.k0, S, b,
                                h, scale, drop);
        continue;
      }
      if (t == n_blocks) {
        // The statistics walk is done: merge the lanes of each row (the
        // lane's quad), then the two key halves (warps w and w + 4) in
        // shared memory; m, 1/l and δ = dn / l (0 past S).
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
            const bool live = q0 + rr < S;
            out[0][r] = live ? m[r] : 0.0f;
            out[1][r] = live ? 1.0f / l[r] : 0.0f;
            out[2][r] = live ? dn[r] / l[r] : 0.0f;
          }
          __syncwarp();  // the quad has read the other half's partials
          const size_t plane = (size_t)gridDim.z * H * S;
          if ((lane & 3) == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int rr = row + 8 * r;
#pragma unroll
              for (int x = 0; x < 3; ++x) {
                st[x * kTile + rr] = out[x][r];
                if (q0 + rr < S) r_bh[x * plane + q0 + rr] = out[x][r];
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
    tc_grads<kOwnStats, kDropout>(sc, tt, bi, r_lo, r_hi, il_lo, il_hi, d_lo,
                                  d_hi, q_lo, k0 + w.k0, S, b, h, scale,
                                  drop);
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
  bf16* dq_dst = dqkv + ((size_t)b * S + q0) * row_stride + h * Dh;
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
        *reinterpret_cast<__nv_bfloat162*>(dq_dst + (size_t)r * row_stride +
                                           c) =
            __floats2bfloat162_rn(__fadd_rn(acc[t][2 * hi], other.x),
                                  __fadd_rn(acc[t][2 * hi + 1], other.y));
      }
    }
  }
}

template <bool kDkdv, bool kOwnStats, int kTiles, bool kDropout>
int launch(const void* qkv, const void* mask, const void* o, float* stats,
           const void* g, void* dqkv, int B, int S, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  auto kernel =
      kDkdv ? attn_bwd_packed_dkdv_tc_kernel<kTiles, kOwnStats, kDropout>
            : attn_bwd_packed_dq_tc_kernel<kTiles, kOwnStats, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      kDkdv ? dkdv_smem_bytes(Dh, kOwnStats) : dq_smem_bytes(Dh, kOwnStats);
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, attn::kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<const bf16*>(o), stats, static_cast<const bf16*>(g),
      static_cast<bf16*>(dqkv), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

// One pass (kDkdv: the dK/dV pass, else the dQ pass) for any Dh ≤ 128 and
// rate; stats is #6's lse [B, H, S] (#7) or m, 1/l and δ [3][B, H, S] (#5);
// cudaErrorMisalignedAddress where qkv, g (or #7's o) does not start on
// the 16 bytes cp.async copies.
template <bool kDkdv, bool kOwnStats>
int launch_pass(const void* qkv, const void* mask, const void* o,
                float* stats, const void* g, void* dqkv, int B, int S, int H,
                int Dh, float scale, bool dropout, DropoutArgs drop,
                cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(g)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const bool wide = tc_tiles(Dh) == 16;
  if (dropout)
    return wide ? launch<kDkdv, kOwnStats, 16, true>(
                      qkv, mask, o, stats, g, dqkv, B, S, H, Dh, scale,
                      drop, stream)
                : launch<kDkdv, kOwnStats, 8, true>(
                      qkv, mask, o, stats, g, dqkv, B, S, H, Dh, scale,
                      drop, stream);
  return wide ? launch<kDkdv, kOwnStats, 16, false>(
                    qkv, mask, o, stats, g, dqkv, B, S, H, Dh, scale,
                    drop, stream)
              : launch<kDkdv, kOwnStats, 8, false>(
                    qkv, mask, o, stats, g, dqkv, B, S, H, Dh, scale,
                    drop, stream);
}

}  // namespace packed_tc

}  // namespace
