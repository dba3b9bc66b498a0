// Flash-streamed ingredients rel-attention backward for Hopper (sm_90a):
// the long-sequence MAG-XLNet training backward.
//
// Replaces the TPU kernel `_attn_bwd_relik_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:4345).
//
// What it computes, per batch row b and head h, from #23's inputs, its
// output o [B, Q, D] and lse [B, H, Q], the context gradient g [B, Q, D]
// and the forward's seed, every product accumulated in fp32:
//   s     = #23's score (common.cuh's `relik_score`);  p = exp(s − lse)
//   δ_q   = Σ_c g[q][c] · o[q][c]   (from the rounded o, as #7)
//   d(pd) = g · vᵀ;  with the replayed keep mask pd = keep ? p · inv_keep
//           : 0 and dp = keep ? d(pd) · inv_keep : 0
//   ds    = p · (dp − δ)   (the score gradient);  ds_c = T(ds · scale),
//           ds_u = T(ds), pd_c = T(pd)
//   drw   = ds_c · k,  dk = ds_cᵀ · rw,  dv = pd_cᵀ · g
//   drr[q] = Σ_k ds_u[q][k] · r[Q − q + k]
//   ded[b, h, q] = Σ_k ds[q][k] · segd[q][k]
//   dr[p] = Σ_b Σ_q ds_u[b, h, q, p − Q + q] · rr[b, q]  (the k in range)
// drw, drr [B, Q, D], dk, dv [B, K, D], ded [B, H, Q] and dr [P, D] in the
// input dtype, each rounded once from its fp32 sum.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12, Dh=64)
// eight products of 2·B·H·Q·K·Dh (77 GFLOP each: ac, bd and d(pd) again,
// dV, dK, drw, drr, dr) plus ~1 GB of inputs and outputs: operations bound
// at the bf16 tensor-core peak (0.63 ms). dQ-like sums (drw, drr, ded)
// reduce over keys, dK and dV over queries, and dr over every (b, q) along
// a diagonal k − q = p − Q. On the TPU the backward grid runs in order with
// the head block outermost, so every revisit of the [P, hb·Dh] dr block is
// consecutive (:4353-4360); Hopper's blocks run in no order.
//
// What the design does about that: three launches, each a deterministic
// reduction with no float atomics and nothing S²-sized in memory.
//   1. The dK/dV pass: one block per (64-key tile, head, batch row) holds
//      its k and v rows and walks the query rows in order, accumulating dK
//      and dV in fp32 registers.
//   2. The drw/drr/ded/dr pass: one block per (head, batch row) walks the
//      query steps in order, and within each the key blocks of 64 in
//      order. It accumulates drw and drr in registers and ded in fixed
//      order, and adds the step's dr rows into its own fp32 slice ws[b, :,
//      h·Dh:(h+1)·Dh] of a [B, P, D] workspace: one block owns each (b, h)
//      slice, so its read-modify-writes need no atomics and run in a fixed
//      order. Owning the whole (b, h) keeps the window in one block (the
//      alternative, a dr pass over position tiles, recomputes ac, bd and
//      d(pd) a third time); the price is B·H blocks (576 at the driver's
//      shape: a few waves over the 132 SMs).
//   3. `attn_bwd_relik_fs_dr_kernel`: dr[p][c] = T(Σ_b ws[b][p][c]), b in
//      order (#22 launches it too).
// Passes 1 and 2 rebuild p and d(pd) with the same code on the same tiles,
// so both see the same ds bits. The relative shift is the window's index
// arithmetic, as in #23.
//
// bf16 (`attn_bwd_relik_fs_dkdv_tc_kernel`, `attn_bwd_relik_fs_dq_tc_
// kernel`): every product on mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
// fed by ldmatrix, with common.cuh's tensor-core pieces; operands staged as
// bf16 by cp.async (Dh padded to a k-depth of 16 with zero columns, rows
// past Q, K and [0, P) zero-filled; segd and maskb by plain loads where K %
// 8 ≠ 0 leaves their rows off 16 bytes). 8 warps a block; each pass built
// for Dh ≤ 64 and Dh ≤ 128 (`tc_tiles`). Both passes cut the work into #23's
// [64 q][64 k] tiles: ac = rw·kᵀ and d(pd) = g·vᵀ by `tc_warp_abt<4>` (warp
// w: queries 16·(w & 3) .., keys 32·(w >> 2) ..), and bd from #23's wide
// product BDʷ = rr · r-windowᵀ [64 × 128] over the window rows Q − q0 − 63
// + k0 + w (w < 128), two 64-row r chunks; BDʷ is read on its diagonal,
// BDʷ[qi][63 − qi + j], as it leaves the accumulators (`tc_bd`) into an
// fp32 [64][64] tile. The score is assembled in `relik_score`'s order in
// the accumulators and the elementwise step runs there (`tc_relik_grads`,
// the CUDA-core `grads` arithmetic; #7's Philox trade between neighbouring
// lanes), so p = exp(s − lse) comes from the kind of score that produced
// #23's lse.
//   - Pass 1 (`_dkdv_tc_`): k and v staged once; rw, rr, g, segd and maskb
//     a step and the r chunks in a two-slot ring (adjacent steps share a
//     chunk), each reloaded as soon as the step has read it. pd_c and ds_c
//     go to bf16 [q][k] tiles over the bd tile; dv += pd_cᵀ·g and dk +=
//     ds_cᵀ·rw read them by ldmatrix.trans (#7's dK/dV step).
//   - Pass 2 (`_dq_tc_`): rw, rr and g a step; k in a two-stage ring, v,
//     segd and maskb a block; r chunks in a three-slot ring (adjacent key
//     blocks share a chunk). drw += ds_c·k takes ds_c straight from the
//     accumulators as A fragments (#7's dQ step; the key halves meet at the
//     step's end). ds_u goes skewed into a bf16 [64][128] tile over the bd
//     tile, S′[r][63 − r + j] = ds_u[r][j] (zeros round the band), so that
//     drr and the dr window are two products against it: drr += S′ ·
//     r-window and dr-window = S′ᵀ · rr (S′ᵀ by ldmatrix.trans), each over
//     the 80 of S′'s 128 columns (rows) that a 16-row slab's band touches.
//     The dr window rolls: key block k0 + 64 never touches a window row
//     below w0 + 64, so the lower chunk is complete after its block and
//     goes to ws (its rows read once at the block's start, so the read
//     overlaps the block's work); the upper chunk's sums wait in an fp32
//     [64][Dh + 8] carry for the next block's lower half. ws is read and
//     written once per q step. ded: each warp's 32 keys of a row by a quad
//     shuffle, then the two key halves, in order.
//   Shared plans (`tc_dkdv_smem_bytes`, `tc_dq_smem_bytes`; ops/
//   fused_attention.py::relik_fs_bwd_smem_bytes): pass 1 99.0 KB at Dh = 64
//   (two blocks an SM), 155.0 KB at Dh = 128; pass 2 135.5 KB and 223.5 KB
//   (one block an SM).
//
// fp32 input keeps the CUDA-core kernels (`attn_bwd_relik_fs_dkdv_kernel`,
// `attn_bwd_relik_fs_dq_kernel`: fp32 dots from fp32 shared memory, query
// steps of 32, the [95][Dh] r window of a (step, block) added into ws every
// block; shared plans 97 KB and 105 KB at Dh = 64, 177 KB and 185 KB at Dh
// = 128): a TF32 product would not hold the fp32 checks. The entries
// dispatch on the dtype; a bf16 call always launches the tensor-core kernel
// or returns the launch's error (cudaErrorMisalignedAddress where rw, rr,
// r, k, v or g does not start on the 16 bytes cp.async copies).

#include "common.cuh"

#include <algorithm>

namespace {

using attn::DropoutArgs;

constexpr int kThreadsKV = 256;  // pass 1: 8 warps
constexpr int kThreadsQ = 512;   // pass 2: 16 warps
constexpr int kKTile = 64;       // keys a pass-1 block owns; keys a step
constexpr int kStep = 32;        // query rows per step of either walk
constexpr int kWin = kStep + kKTile - 1;  // r rows a (step, key tile) reads
constexpr int kMaxDh = 128;
constexpr int kAccKV = kKTile * kMaxDh / kThreadsKV;
constexpr int kAccQ = kStep * kMaxDh / kThreadsQ;

// The inputs and geometry every pass reads.
template <typename T>
struct Args {
  const T* rw;
  const T* rr;
  const T* r;
  const T* k;
  const T* v;
  const T* ed;
  const T* segd;
  const T* maskb;
  const T* o;
  const float* lse;
  const T* g;
  int Q, K, P, H, Dh;
  float scale;
  DropoutArgs drop;
};

// The query-side rows of the step q0 .. q0 + rows − 1 of (b, h): rw, rr and
// g [kStep][Dh + 1], lse and ed [kStep]; then (after a barrier) δ.
template <typename T>
__device__ __forceinline__ void load_step(const Args<T>& a, int b, int h,
                                          int q0, int rows, float* rws,
                                          float* rrs, float* gs,
                                          float* lse_s, float* ed_s) {
  const int D = a.H * a.Dh;
  const size_t off = ((size_t)b * a.Q + q0) * D + h * a.Dh;
  attn::load_tile(rws, a.rw + off, (size_t)D, rows, a.Dh);
  attn::load_tile(rrs, a.rr + off, (size_t)D, rows, a.Dh);
  attn::load_tile(gs, a.g + off, (size_t)D, rows, a.Dh);
  const size_t row = ((size_t)b * a.H + h) * a.Q + q0;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    lse_s[i] = a.lse[row + i];
    ed_s[i] = attn::to_float(a.ed[row + i]);
  }
}

// δ[r] = Σ_c g[r][c] · o[q0 + r][c], one warp per row, the same order in
// both passes (#7's `row_delta`).
template <typename T>
__device__ __forceinline__ void row_delta(const Args<T>& a, int b, int h,
                                          int q0, int rows, const float* gs,
                                          float* delta) {
  const int D = a.H * a.Dh;
  const T* o_rows = a.o + ((size_t)b * a.Q + q0) * D + h * a.Dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float sum = 0.0f;
    for (int c = lane; c < a.Dh; c += 32)
      sum = fmaf(gs[r * (a.Dh + 1) + c],
                 attn::to_float(o_rows[(size_t)r * D + c]), sum);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) delta[r] = sum;
  }
}

// On the [rows][cols] tile of queries q0 + r against keys k0 + j (tile rows
// of kKTile floats): ps[r][j] = s − lse[r], tt[r][j] = g_r · v_j and, when
// sg is given, sg[r][j] = segd. rwin holds the step's r window.
template <typename T>
__device__ __forceinline__ void scores(const Args<T>& a, int b, int q0,
                                       int k0, int rows, int cols,
                                       const float* rws, const float* rrs,
                                       const float* gs, const float* ks,
                                       const float* vs, const float* rwin,
                                       const float* lse_s,
                                       const float* ed_s, float* ps,
                                       float* tt, float* sg) {
  const int ld = a.Dh + 1;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, j = i - r * cols;
    const size_t qk = ((size_t)b * a.Q + q0 + r) * a.K + k0 + j;
    const float sd = attn::to_float(a.segd[qk]);
    const float s = attn::relik_score(
        rws + r * ld, rrs + r * ld, ks + j * ld,
        rwin + (kStep - 1 - r + j) * ld, a.Dh, a.scale, ed_s[r], sd,
        attn::to_float(a.maskb[qk]));
    const float* gr = gs + r * ld;
    const float* vj = vs + j * ld;
    float t = 0.0f;
    for (int c = 0; c < a.Dh; ++c) t = fmaf(gr[c], vj[c], t);
    ps[r * kKTile + j] = __fsub_rn(s, lse_s[r]);
    tt[r * kKTile + j] = t;
    if (sg != nullptr) sg[r * kKTile + j] = sd;
  }
}

// From ps = s − lse and tt = d(pd): p, the replayed mask, ds. Pass 1
// (kKV) leaves pd_c in ps and ds_c in tt; pass 2 leaves ds_c in ps, ds_u
// in tt and ds · segd in sg. k0 is a multiple of 4.
template <typename T, bool kDropout, bool kKV>
__device__ __forceinline__ void grads(int rows, int cols, int q0, int k0,
                                      int b, int h, const float* delta,
                                      float scale, DropoutArgs drop,
                                      float* ps, float* tt, float* sg) {
  const int quads = (cols + 3) / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i / quads, j0 = 4 * (i - r * quads);
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kDropout)
      bits = attn::dropout_bits4(drop, b, h, q0 + r, (k0 + j0) >> 2);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j < cols) {
        const int at = r * kKTile + j;
        const float p = expf(ps[at]);
        float pd = p, dp = tt[at];
        if constexpr (kDropout) {
          const bool keep = attn::word(bits, u) >= drop.threshold;
          pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
          dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
        }
        const float ds = __fmul_rn(p, __fsub_rn(dp, delta[r]));
        const float ds_c = attn::round_to<T>(__fmul_rn(ds, scale));
        if constexpr (kKV) {
          ps[at] = attn::round_to<T>(pd);
          tt[at] = ds_c;
        } else {
          ps[at] = ds_c;
          tt[at] = attn::round_to<T>(ds);
          sg[at] = __fmul_rn(ds, sg[at]);
        }
      }
    }
  }
}

// k, v [kKTile][Dh+1]; rw, rr, g [kStep][Dh+1]; r window [kWin][Dh+1];
// P, Tt [kStep][kKTile]; lse, ed, δ [kStep].
__host__ __device__ inline size_t dkdv_smem_floats(int dh) {
  return (size_t)(2 * kKTile + 3 * kStep + kWin) * (dh + 1) +
         2 * (size_t)kStep * kKTile + 3 * (size_t)kStep;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreadsKV)
    attn_bwd_relik_fs_dkdv_kernel(Args<T> a, T* __restrict__ dk,
                                  T* __restrict__ dv) {
  extern __shared__ float smem[];
  const int Dh = a.Dh, ld = Dh + 1, D = a.H * Dh;
  const int k0 = blockIdx.x * kKTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  float* ks = smem;                    // [kKTile][Dh + 1]
  float* vs = ks + kKTile * ld;        // [kKTile][Dh + 1]
  float* rws = vs + kKTile * ld;       // [kStep][Dh + 1]
  float* rrs = rws + kStep * ld;       // [kStep][Dh + 1]
  float* gs = rrs + kStep * ld;        // [kStep][Dh + 1]
  float* rwin = gs + kStep * ld;       // [kWin][Dh + 1]
  float* ps = rwin + kWin * ld;        // [kStep][kKTile]
  float* tt = ps + kStep * kKTile;     // [kStep][kKTile]
  float* lse_s = tt + kStep * kKTile;  // [kStep]
  float* ed_s = lse_s + kStep;         // [kStep]
  float* delta = ed_s + kStep;         // [kStep]

  const size_t kv_off = (size_t)b * a.K * D + h * Dh;
  const int cols = min(kKTile, a.K - k0);
  attn::load_tile(ks, a.k + kv_off + (size_t)k0 * D, (size_t)D, cols, Dh);
  attn::load_tile(vs, a.v + kv_off + (size_t)k0 * D, (size_t)D, cols, Dh);
  float dk_acc[kAccKV], dv_acc[kAccKV];
#pragma unroll
  for (int i = 0; i < kAccKV; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int q0 = 0; q0 < a.Q; q0 += kStep) {
    const int rows = min(kStep, a.Q - q0);
    __syncthreads();  // the previous step's readers are done
    load_step(a, b, h, q0, rows, rws, rrs, gs, lse_s, ed_s);
    attn::load_r_window(rwin, a.r + h * Dh, D, a.P,
                        a.Q - q0 - (kStep - 1) + k0, kWin, Dh);
    __syncthreads();
    row_delta(a, b, h, q0, rows, gs, delta);
    scores(a, b, q0, k0, rows, cols, rws, rrs, gs, ks, vs, rwin, lse_s, ed_s,
           ps, tt, nullptr);
    __syncthreads();
    grads<T, kDropout, true>(rows, cols, q0, k0, b, h, delta, a.scale,
                             a.drop, ps, tt, nullptr);
    __syncthreads();
    // dV[j] += Σ_r pd_c[r][j] · g[r],  dK[j] += Σ_r ds_c[r][j] · rw[r]
#pragma unroll
    for (int x = 0; x < kAccKV; ++x) {
      const int i = tid + x * kThreadsKV;
      const int j = i / Dh, c = i - j * Dh;
      if (i < kKTile * Dh && j < cols) {
        float v_acc = dv_acc[x], k_acc = dk_acc[x];
        for (int r = 0; r < rows; ++r) {
          v_acc = fmaf(ps[r * kKTile + j], gs[r * ld + c], v_acc);
          k_acc = fmaf(tt[r * kKTile + j], rws[r * ld + c], k_acc);
        }
        dv_acc[x] = v_acc;
        dk_acc[x] = k_acc;
      }
    }
  }
#pragma unroll
  for (int x = 0; x < kAccKV; ++x) {
    const int i = tid + x * kThreadsKV;
    const int j = i / Dh, c = i - j * Dh;
    if (i < kKTile * Dh && j < cols) {
      const size_t at = kv_off + (size_t)(k0 + j) * D + c;
      dk[at] = attn::from_float<T>(dk_acc[x]);
      dv[at] = attn::from_float<T>(dv_acc[x]);
    }
  }
}

// rw, rr, g [kStep][Dh+1]; k, v [kKTile][Dh+1]; r window [kWin][Dh+1];
// ds_c, ds_u, ds·segd [kStep][kKTile]; lse, ed, δ, ded [kStep].
__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return (size_t)(3 * kStep + 2 * kKTile + kWin) * (dh + 1) +
         3 * (size_t)kStep * kKTile + 4 * (size_t)kStep;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreadsQ)
    attn_bwd_relik_fs_dq_kernel(Args<T> a, T* __restrict__ drw,
                                T* __restrict__ drr, T* __restrict__ ded,
                                float* __restrict__ ws) {
  extern __shared__ float smem[];
  const int Dh = a.Dh, ld = Dh + 1, D = a.H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* rws = smem;                   // [kStep][Dh + 1]
  float* rrs = rws + kStep * ld;       // [kStep][Dh + 1]
  float* gs = rrs + kStep * ld;        // [kStep][Dh + 1]
  float* ks = gs + kStep * ld;         // [kKTile][Dh + 1]
  float* vs = ks + kKTile * ld;        // [kKTile][Dh + 1]
  float* rwin = vs + kKTile * ld;      // [kWin][Dh + 1]
  float* ps = rwin + kWin * ld;        // [kStep][kKTile]: s − lse, ds_c
  float* tt = ps + kStep * kKTile;     // [kStep][kKTile]: d(pd), ds_u
  float* sg = tt + kStep * kKTile;     // [kStep][kKTile]: segd, ds·segd
  float* lse_s = sg + kStep * kKTile;  // [kStep]
  float* ed_s = lse_s + kStep;         // [kStep]
  float* delta = ed_s + kStep;         // [kStep]
  float* ded_s = delta + kStep;        // [kStep]

  const size_t kv_off = (size_t)b * a.K * D + h * Dh;
  // This block's slice of the workspace: rows p of ws[b], columns h·Dh + c.
  float* ws_bh = ws + (size_t)b * a.P * D + h * Dh;

  for (int q0 = 0; q0 < a.Q; q0 += kStep) {
    const int rows = min(kStep, a.Q - q0);
    __syncthreads();  // the previous tile's readers are done
    load_step(a, b, h, q0, rows, rws, rrs, gs, lse_s, ed_s);
    for (int i = tid; i < kStep; i += kThreadsQ) ded_s[i] = 0.0f;
    __syncthreads();
    row_delta(a, b, h, q0, rows, gs, delta);
    float drw_acc[kAccQ], drr_acc[kAccQ];
#pragma unroll
    for (int x = 0; x < kAccQ; ++x) drw_acc[x] = drr_acc[x] = 0.0f;

    for (int k0 = 0; k0 < a.K; k0 += kKTile) {
      const int cols = min(kKTile, a.K - k0);
      const int w0 = a.Q - q0 - (kStep - 1) + k0;
      __syncthreads();  // the previous block's readers are done (and δ set)
      attn::load_tile(ks, a.k + kv_off + (size_t)k0 * D, (size_t)D, cols,
                      Dh);
      attn::load_tile(vs, a.v + kv_off + (size_t)k0 * D, (size_t)D, cols,
                      Dh);
      attn::load_r_window(rwin, a.r + h * Dh, D, a.P, w0, kWin, Dh);
      __syncthreads();
      scores(a, b, q0, k0, rows, cols, rws, rrs, gs, ks, vs, rwin, lse_s,
             ed_s, ps, tt, sg);
      __syncthreads();
      grads<T, kDropout, false>(rows, cols, q0, k0, b, h, delta, a.scale,
                                a.drop, ps, tt, sg);
      __syncthreads();
      // ded[r] += Σ_j ds·segd, one warp per row in a fixed order.
      for (int r = warp; r < rows; r += kThreadsQ / 32) {
        float sum = 0.0f;
        for (int j = lane; j < cols; j += 32) sum += sg[r * kKTile + j];
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) ded_s[r] += sum;
      }
      // drw[r] += Σ_j ds_c[r][j] · k_j,  drr[r] += Σ_j ds_u[r][j] ·
      // r_window[(31 − r) + j]
#pragma unroll
      for (int x = 0; x < kAccQ; ++x) {
        const int i = tid + x * kThreadsQ;
        const int r = i / Dh, c = i - r * Dh;
        if (i < kStep * Dh && r < rows) {
          const float* dc = ps + r * kKTile;
          const float* du = tt + r * kKTile;
          const float* win = rwin + (kStep - 1 - r) * ld + c;
          float w_acc = drw_acc[x], r_acc = drr_acc[x];
          for (int j = 0; j < cols; ++j) {
            w_acc = fmaf(dc[j], ks[j * ld + c], w_acc);
            r_acc = fmaf(du[j], win[j * ld], r_acc);
          }
          drw_acc[x] = w_acc;
          drr_acc[x] = r_acc;
        }
      }
      // The dr window: row w of it (position w0 + w) gathers ds_u[r][j] ·
      // rr[r] over the (r, j) with (31 − r) + j = w, r ascending; added to
      // this block's workspace rows in a fixed order.
      for (int i = tid; i < kWin * Dh; i += kThreadsQ) {
        const int w = i / Dh, c = i - w * Dh;
        const int p = w0 + w;
        const int r_lo = max(0, kStep - 1 - w);
        const int r_hi = min(rows, kStep - 1 - w + cols);
        if (p < 0 || p >= a.P || r_lo >= r_hi) continue;
        float z = 0.0f;
        for (int r = r_lo; r < r_hi; ++r)
          z = fmaf(tt[r * kKTile + w - (kStep - 1 - r)], rrs[r * ld + c], z);
        float* dst = ws_bh + (size_t)p * D + c;
        *dst = __fadd_rn(*dst, z);
      }
    }
    __syncthreads();  // ded_s complete
    const size_t q_off = ((size_t)b * a.Q + q0) * D + h * Dh;
#pragma unroll
    for (int x = 0; x < kAccQ; ++x) {
      const int i = tid + x * kThreadsQ;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kStep * Dh && r < rows) {
        drw[q_off + (size_t)r * D + c] = attn::from_float<T>(drw_acc[x]);
        drr[q_off + (size_t)r * D + c] = attn::from_float<T>(drr_acc[x]);
      }
    }
    for (int r = tid; r < rows; r += kThreadsQ)
      ded[((size_t)b * a.H + h) * a.Q + q0 + r] =
          attn::from_float<T>(ded_s[r]);
  }
}

// dr[i] = T(Σ_b ws[b][i]) over the P·D elements, b ascending.
template <typename T>
__global__ void __launch_bounds__(256)
    attn_bwd_relik_fs_dr_kernel(const float* __restrict__ ws,
                                T* __restrict__ dr, int B, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc = __fadd_rn(acc, ws[(size_t)b * n + i]);
    dr[i] = attn::from_float<T>(acc);
  }
}

template <typename T, bool kDropout>
int launch_dkdv(const Args<T>& a, int B, void* dk, void* dv,
                cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_relik_fs_dkdv_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.K + kKTile - 1) / kKTile, a.H, B);
  attn_bwd_relik_fs_dkdv_kernel<T, kDropout>
      <<<grid, kThreadsKV, dkdv_smem_floats(a.Dh) * sizeof(float), stream>>>(
          a, static_cast<T*>(dk), static_cast<T*>(dv));
  return (int)cudaGetLastError();
}

template <typename T, bool kDropout>
int launch_dq(const Args<T>& a, int B, void* drw, void* drr, void* ded,
              void* ws, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_relik_fs_dq_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_relik_fs_dq_kernel<T, kDropout>
      <<<dim3(a.H, B), kThreadsQ, dq_smem_floats(a.Dh) * sizeof(float),
         stream>>>(a, static_cast<T*>(drw), static_cast<T*>(drr),
                   static_cast<T*>(ded), static_cast<float*>(ws));
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernels ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // query rows a step, keys a block
constexpr int kBdLd = kTile + 8;       // the read-off bd tile (fp32)
constexpr int kQkLd = kTile + 8;       // segd, maskb, pd_c, ds_c (bf16)
constexpr int kSpLd = 2 * kTile + 8;   // S′, [64][128] (bf16)
static_assert(kTile == attn::kTcQTile && kTile == attn::kTcKBlock,
              "the tensor-core tiles are 64 × 64 (attn::tc_warp)");
static_assert(kSpLd * sizeof(bf16) <= kBdLd * sizeof(float) &&
                  2 * kQkLd * sizeof(bf16) <= kBdLd * sizeof(float),
              "S′, and pd_c with ds_c, fit over the bd tile");

// Each pass is built for kTiles = 8 (Dh ≤ 64) and 16 (Dh ≤ 128) n8 tiles
// of Dh, so that Dh = 64 holds no registers for Dh = 128.
__host__ __device__ inline int tc_tiles(int dh) { return dh <= 64 ? 8 : 16; }

// Bytes of shared memory of one block of each pass (see the note).
__host__ __device__ inline size_t tc_dkdv_smem_bytes(int dh) {
  return 7 * (size_t)kTile * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)kTile * kBdLd * sizeof(float) +
         2 * (size_t)kTile * kQkLd * sizeof(bf16);
}
__host__ __device__ inline size_t tc_dq_smem_bytes(int dh) {
  return 9 * (size_t)kTile * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)kTile * kBdLd * sizeof(float) +
         2 * (size_t)kTile * kQkLd * sizeof(bf16) +
         (size_t)kTile * (dh + 8) * sizeof(float) +
         2 * (size_t)kTile * sizeof(float);
}

// The segd and maskb tiles of query rows q0 .. and keys k0 .. of batch row
// b: cp.async where their rows lie on 16 bytes (vec), plain loads where
// they do not; zeros past Q and K.
__device__ __forceinline__ void tc_load_qk(bf16* sgs, bf16* mks,
                                           const Args<bf16>& a, int b,
                                           int q0, int k0, int vec) {
  const int q_rows = min(kTile, a.Q - q0), k_rows = min(kTile, a.K - k0);
  const size_t at0 = ((size_t)b * a.Q + q0) * a.K + k0;
  if (vec) {
    for (int x = threadIdx.x; x < kTile * kTile / 8; x += blockDim.x) {
      const int r = x / (kTile / 8), c = (x % (kTile / 8)) * 8;
      const bool ok = r < q_rows && c < k_rows;
      const size_t at = at0 + (size_t)r * a.K + c;
      attn::cp_async16(sgs + r * kQkLd + c, ok ? a.segd + at : a.segd, ok);
      attn::cp_async16(mks + r * kQkLd + c, ok ? a.maskb + at : a.maskb, ok);
    }
  } else {
    for (int x = threadIdx.x; x < kTile * kTile; x += blockDim.x) {
      const int r = x / kTile, c = x % kTile;
      const bool ok = r < q_rows && c < k_rows;
      const size_t at = at0 + (size_t)r * a.K + c;
      sgs[r * kQkLd + c] = ok ? a.segd[at] : __float2bfloat16(0.0f);
      mks[r * kQkLd + c] = ok ? a.maskb[at] : __float2bfloat16(0.0f);
    }
  }
}

// The lane's two rows of a step, q0 + m0 + lane / 4 and + 8: lse, ed and δ
// (common.cuh's `tc_slab_delta` from the staged g and o), 0 past Q.
struct TcRows {
  float lse[2], ed[2], delta[2];
};

__device__ __forceinline__ TcRows tc_rows(const Args<bf16>& a, int b, int h,
                                          int q0, int m0, const bf16* gs,
                                          int ld) {
  const int lane = threadIdx.x & 31;
  const int D = a.H * a.Dh;
  const size_t row = ((size_t)b * a.H + h) * a.Q;
  TcRows x;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int q = q0 + m0 + (lane >> 2) + 8 * hi;
    x.lse[hi] = q < a.Q ? a.lse[row + q] : 0.0f;
    x.ed[hi] = q < a.Q ? __bfloat162float(a.ed[row + q]) : 0.0f;
  }
  attn::tc_slab_delta(x.delta[0], x.delta[1], gs + m0 * ld, ld,
                      a.o + ((size_t)b * a.Q + q0 + m0) * D + h * a.Dh,
                      (size_t)D, a.Q - q0 - m0, a.Dh);
  return x;
}

// #23's wide product BDʷ = rr_tile · windowᵀ [64 × 128] (window rows 0 ..
// 63 from the r chunk `lower`, 64 .. 127 from `upper`), warp (m0, half =
// warp / 4) taking rows m0 .. m0 + 15 × window rows 64·half .. + 63, read
// off its diagonal as it leaves the accumulators: bd[qi][j] =
// BDʷ[qi][63 − qi + j] for j < 64, the bd term of score (qi, j).
__device__ __forceinline__ void tc_bd(float* bd, const bf16* rrs,
                                      const bf16* lower, const bf16* upper,
                                      int ld, int kd, int m0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;
  float acc[8][4] = {};
  attn::tc_warp_abt<8>(acc, rrs + m0 * ld, ld, half ? upper : lower, ld, kd);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = m0 + (lane >> 2) + 8 * (e >> 1);
      const int j = kTile * half + 8 * t + 2 * (lane & 3) + (e & 1) -
                    (kTile - 1) + qi;
      if (j >= 0 && j < kTile) bd[qi * kBdLd + j] = acc[t][e];
    }
  }
}

// The elementwise step on a warp's [16 q][32 k] accumulators (the layout
// of `tc_warp_abt<4>`; #7's `tc_grads` for the ingredients score): sc holds
// the rw·k dots, tt the g·v dots. Per element (query q0 + r, key k0 + j; r
// from m0, j from kw), the CUDA-core kernels' `grads` arithmetic: s =
// relik_combine(ac, bd[r][j], scale, ed, segd, maskb), p = exp(s − lse),
// the keep mask, pd, dp, ds = p · (dp − δ), ds_c = T(ds · scale). kKV
// (pass 1) leaves pd_c = T(pd) in sc and ds_c in tt; else (pass 2) ds_u =
// T(ds) in sc, ds_c in tt, and adds ds · segd to ded[hi] (the lane's two
// rows, keys in order). Zeros where q ≥ Q or k ≥ K. Lanes 2m and 2m + 1
// (the same 4 keys, rows q_lo and q_lo + 8) draw one Philox block each and
// trade the two words the other needs.
template <bool kDropout, bool kKV>
__device__ __forceinline__ void tc_relik_grads(
    float (&sc)[4][4], float (&tt)[4][4], float (&ded)[2], const float* bd,
    const bf16* sgs, const bf16* mks, const TcRows& x, int m0, int kw,
    int q0, int k0, const Args<bf16>& a, int b, int h) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int r_lo = m0 + (lane >> 2);
  const int q_lo = q0 + r_lo;
  const DropoutArgs& drop = a.drop;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = kw + 8 * t + 2 * (lane & 3);
    uint32_t wd[4] = {0u, 0u, 0u, 0u};  // the draws of [t][0 .. 3]
    if constexpr (kDropout) {
      const int k4 = (k0 + kw + 8 * t + 4 * ((lane & 3) >> 1)) >> 2;
      const uint4 own =
          attn::dropout_bits4(drop, b, h, odd ? q_lo + 8 : q_lo, k4);
      const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? own.x : own.z, 1);
      const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? own.y : own.w, 1);
      wd[0] = odd ? x0 : own.x;
      wd[1] = odd ? x1 : own.y;
      wd[2] = odd ? own.z : x0;
      wd[3] = odd ? own.w : x1;
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r_lo + 8 * hi;
      const float2 bd2 = *reinterpret_cast<const float2*>(bd + r * kBdLd + j);
      const float2 sg2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sgs + r * kQkLd + j));
      const float2 mk2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(mks + r * kQkLd + j));
      const float bdv[2] = {bd2.x, bd2.y}, sgv[2] = {sg2.x, sg2.y};
      const float mkv[2] = {mk2.x, mk2.y};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * hi + u;
        float first = 0.0f, ds_c = 0.0f;
        if (q_lo + 8 * hi < a.Q && k0 + j + u < a.K) {
          const float s = attn::relik_combine(sc[t][e], bdv[u], a.scale,
                                              x.ed[hi], sgv[u], mkv[u]);
          const float p = expf(__fsub_rn(s, x.lse[hi]));
          float pd = p, dp = tt[t][e];
          if constexpr (kDropout) {
            const bool keep = wd[e] >= drop.threshold;
            pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
            dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
          }
          const float ds = __fmul_rn(p, __fsub_rn(dp, x.delta[hi]));
          ds_c = attn::round_to<bf16>(__fmul_rn(ds, a.scale));
          if constexpr (kKV) {
            first = attn::round_to<bf16>(pd);
          } else {
            first = attn::round_to<bf16>(ds);
            ded[hi] = __fadd_rn(ded[hi], __fmul_rn(ds, sgv[u]));
          }
        }
        sc[t][e] = first;
        tt[t][e] = ds_c;
      }
    }
  }
}

// Pass 1: dk and dv of one 64-key tile (see the note).
template <int kTiles, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, kTiles == 8 ? 2 : 1)
    attn_bwd_relik_fs_dkdv_tc_kernel(Args<bf16> a, int vec_qk,
                                     bf16* __restrict__ drw,
                                     bf16* __restrict__ drr,
                                     bf16* __restrict__ dk,
                                     bf16* __restrict__ dv,
                                     bf16* __restrict__ ded,
                                     float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dh = a.Dh, D = a.H * Dh;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kTile * ld;

  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* vs = ks + tile;                          // [64][ld]
  bf16* rws = vs + tile;                         // [64][ld]
  bf16* rrs = rws + tile;                        // [64][ld]
  bf16* gs = rrs + tile;                         // [64][ld]
  bf16* rwin = gs + tile;                        // 2 × [64][ld] r chunks
  float* bd = reinterpret_cast<float*>(rwin + 2 * tile);  // [64][kBdLd]
  bf16* pds = reinterpret_cast<bf16*>(bd);       // [64 q][kQkLd], over bd
  bf16* dss = pds + kTile * kQkLd;               // [64 q][kQkLd], over bd
  bf16* sgs = reinterpret_cast<bf16*>(bd + kTile * kBdLd);  // [64][kQkLd]
  bf16* mks = sgs + kTile * kQkLd;                           // [64][kQkLd]

  const size_t q_base = (size_t)b * a.Q * D + h * Dh;
  const size_t kv_base = (size_t)b * a.K * D + h * Dh;
  const int cols = min(kTile, a.K - k0);
  const int n_steps = (a.Q + kTile - 1) / kTile;
  // Step i's window, r rows Q − 64i − 63 + k0 .. + 127, is chunk i + 1
  // (rows 0 .. 63) and chunk i (64 .. 127); chunk c starts at p_top − 64c.
  const long long p_top = (long long)a.Q + 1 + k0;
  const attn::TcWarp w = attn::tc_warp(Dh);

  auto load_rows = [&](bf16* dst, const bf16* src, int q0) {
    attn::tc_cp_rows(dst, ld, src + q_base, (size_t)D, q0, kTile, 0,
                     min(kTile, a.Q - q0), Dh);
  };
  auto load_chunk = [&](int c) {
    attn::relik_tc_r_chunk(rwin + (c & 1) * tile, ld, a.r + h * Dh, D, a.P,
                           p_top - (long long)kTile * c, Dh);
  };
  attn::tc_cp_rows(ks, ld, a.k + kv_base, (size_t)D, k0, kTile, 0, cols, Dh);
  attn::tc_cp_rows(vs, ld, a.v + kv_base, (size_t)D, k0, kTile, 0, cols, Dh);
  load_rows(rws, a.rw, 0);
  load_rows(rrs, a.rr, 0);
  load_rows(gs, a.g, 0);
  load_chunk(0);
  load_chunk(1);
  tc_load_qk(sgs, mks, a, b, 0, k0, vec_qk);
  attn::cp_async_commit();
  // The k-depth's pad columns of k, v, rw, rr, g and the chunks stay zero.
  attn::tc_zero_cols(ks, ld, 7 * kTile, Dh, kd);

  float dk_acc[kTiles / 2][4], dv_acc[kTiles / 2][4];
#pragma unroll
  for (int t = 0; t < kTiles / 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    const int q0 = i * kTile;
    attn::cp_async_wait<0>();  // step i's rows and chunks, segd, maskb
    __syncthreads();           // ... for every thread; step i − 1 is done
    tc_bd(bd, rrs, rwin + ((i + 1) & 1) * tile, rwin + (i & 1) * tile, ld,
          kd, w.m0);
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, rws + w.m0 * ld, ld, ks + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + w.m0 * ld, ld, vs + w.k0 * ld, ld, kd);
    const TcRows x = tc_rows(a, b, h, q0, w.m0, gs, ld);
    __syncthreads();  // bd whole; rr and chunk i read for the last time
    if (i + 1 < n_steps) load_rows(rrs, a.rr, q0 + kTile);
    if (i + 2 <= n_steps) load_chunk(i + 2);
    attn::cp_async_commit();
    float unused[2] = {0.0f, 0.0f};
    tc_relik_grads<kDropout, true>(sc, tt, unused, bd, sgs, mks, x, w.m0,
                                   w.k0, q0, k0, a, b, h);
    __syncthreads();  // bd, segd and maskb read
    if (i + 1 < n_steps) tc_load_qk(sgs, mks, a, b, q0 + kTile, k0, vec_qk);
    attn::cp_async_commit();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = w.m0 + (lane >> 2) + 8 * hi;
        *reinterpret_cast<__nv_bfloat162*>(pds + r * kQkLd + j) =
            __floats2bfloat162_rn(sc[t][2 * hi], sc[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dss + r * kQkLd + j) =
            __floats2bfloat162_rn(tt[t][2 * hi], tt[t][2 * hi + 1]);
      }
    }
    __syncthreads();
    // dv[k] += Σ_q pd_c[q][k] · g[q],  dk[k] += Σ_q ds_c[q][k] · rw[q] for
    // the warp's keys w.m0 .. + 15 and columns w.c0 .., 16 queries a step.
    const int q_end = min(kTile, (a.Q - q0 + 15) / 16 * 16);
    for (int c = 0; c < q_end; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * kQkLd + w.m0,
                                               kQkLd));
      attn::tc_mma_bt(dv_acc, fa, attn::tc_lane_bt(gs + c * ld + w.c0, ld),
                      w.n);
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * kQkLd + w.m0,
                                               kQkLd));
      attn::tc_mma_bt(dk_acc, fa, attn::tc_lane_bt(rws + c * ld + w.c0, ld),
                      w.n);
    }
    __syncthreads();  // rw and g read
    if (i + 1 < n_steps) {
      load_rows(rws, a.rw, q0 + kTile);
      load_rows(gs, a.g, q0 + kTile);
    }
    attn::cp_async_commit();
  }
  bf16* dk_dst = dk + kv_base + (size_t)k0 * D + w.c0;
  bf16* dv_dst = dv + kv_base + (size_t)k0 * D + w.c0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = w.m0 + (lane >> 2) + 8 * hi;
    if (r >= cols) continue;
#pragma unroll
    for (int t = 0; t < kTiles / 2; ++t) {
      if (t < w.n) {
        const size_t at = (size_t)r * D + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(dk_dst + at) =
            __floats2bfloat162_rn(dk_acc[t][2 * hi], dk_acc[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_dst + at) =
            __floats2bfloat162_rn(dv_acc[t][2 * hi], dv_acc[t][2 * hi + 1]);
      }
    }
  }
}

// Pass 2: drw, drr, ded and the dr rows of one (head, batch row) (see the
// note).
template <int kTiles, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 1)
    attn_bwd_relik_fs_dq_tc_kernel(Args<bf16> a, int vec_qk,
                                   bf16* __restrict__ drw,
                                   bf16* __restrict__ drr,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv,
                                   bf16* __restrict__ ded,
                                   float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dh = a.Dh, D = a.H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kTile * ld;
  const int tiles = Dh / 8;
  const int cld = Dh + 8;  // the carry's row stride (fp32)

  bf16* rws = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* rrs = rws + tile;                         // [64][ld]
  bf16* gs = rrs + tile;                          // [64][ld]
  bf16* ks = gs + tile;                           // 2 × [64][ld] ring
  bf16* vs = ks + 2 * tile;                       // [64][ld]
  bf16* rwin = vs + tile;                         // 3 × [64][ld] r chunks
  float* bd = reinterpret_cast<float*>(rwin + 3 * tile);  // [64][kBdLd]
  bf16* sp = reinterpret_cast<bf16*>(bd);         // S′ [64][kSpLd], over bd
  bf16* sgs = reinterpret_cast<bf16*>(bd + kTile * kBdLd);  // [64][kQkLd]
  bf16* mks = sgs + kTile * kQkLd;                           // [64][kQkLd]
  float* carry = reinterpret_cast<float*>(mks + kTile * kQkLd);  // [64][cld]
  float* dedp = carry + kTile * cld;                             // [2][64]

  const size_t q_base = (size_t)b * a.Q * D + h * Dh;
  const size_t kv_base = (size_t)b * a.K * D + h * Dh;
  float* ws_bh = ws + (size_t)b * a.P * D + h * Dh;
  const int n_steps = (a.Q + kTile - 1) / kTile;
  const int n_kb = (a.K + kTile - 1) / kTile;
  const int n_it = n_steps * n_kb;
  const int n_chunks = n_steps * (n_kb + 1);
  const attn::TcWarp w = attn::tc_warp(Dh);
  // dr: warp s takes window rows 16s .. 16s + 15, in the lower chunk (s < 4)
  // or the upper one; crow is the lane's first row within its chunk.
  const bool lower = warp < 4;
  const int crow = 16 * (warp & 3) + (lane >> 2);

  auto load_rows = [&](bf16* dst, const bf16* src, int q0) {
    attn::tc_cp_rows(dst, ld, src + q_base, (size_t)D, q0, kTile, 0,
                     min(kTile, a.Q - q0), Dh);
  };
  auto load_keys = [&](bf16* dst, const bf16* src, int k0) {
    attn::tc_cp_rows(dst, ld, src + kv_base, (size_t)D, k0, kTile, 0,
                     min(kTile, a.K - k0), Dh);
  };
  // Chunk g of the walk: step g / (n_kb + 1)'s chunk m = g % (n_kb + 1),
  // r rows Q − q0 − 63 + 64m .. + 63, into slot g % 3.
  auto chunk_p0 = [&](int g) {
    const int i = g / (n_kb + 1), m = g - i * (n_kb + 1);
    return (long long)a.Q - (long long)kTile * i - (kTile - 1) +
           (long long)kTile * m;
  };
  auto load_chunk = [&](int g) {
    attn::relik_tc_r_chunk(rwin + (g % 3) * tile, ld, a.r + h * Dh, D, a.P,
                           chunk_p0(g), Dh);
  };
  // ws[b, p, h·Dh + 8t + 2·(lane % 4) ..] ← + v for the lane's row p.
  auto flush = [&](long long p, const float (&v)[kTiles][4], int hi) {
    if (p < 0 || p >= a.P) return;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t < tiles) {
        float2* dst = reinterpret_cast<float2*>(ws_bh + p * D + t * 8 +
                                                2 * (lane & 3));
        const float2 old = *dst;
        *dst = make_float2(__fadd_rn(old.x, v[t][2 * hi]),
                           __fadd_rn(old.y, v[t][2 * hi + 1]));
      }
    }
  };

  load_rows(rws, a.rw, 0);
  load_rows(rrs, a.rr, 0);
  load_rows(gs, a.g, 0);
  load_keys(ks, a.k, 0);
  load_keys(vs, a.v, 0);
  load_chunk(0);
  load_chunk(1);
  tc_load_qk(sgs, mks, a, b, 0, 0, vec_qk);
  attn::cp_async_commit();
  // The k-depth's pad columns of every staged bf16 tile stay zero.
  attn::tc_zero_cols(rws, ld, 9 * kTile, Dh, kd);

  float drw_acc[kTiles][4], drr_acc[kTiles / 2][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      drw_acc[t][e] = 0.0f;
      if (t < kTiles / 2) drr_acc[t][e] = 0.0f;
    }
  float ded_acc = 0.0f;  // thread tid < 64: row tid of the step
  TcRows x;

  for (int it = 0; it < n_it; ++it) {
    const int i = it / n_kb, kb = it - i * n_kb;
    const int q0 = i * kTile, k0 = kb * kTile;
    const int g_lo = i * (n_kb + 1) + kb;  // the window: chunks g_lo, + 1
    const bool last_kb = kb == n_kb - 1, more = it + 1 < n_it;
    const int i1 = (it + 1) / n_kb, k1 = ((it + 1) - i1 * n_kb) * kTile;
    attn::cp_async_wait<0>();  // this block's k, v, segd, maskb, chunks
    __syncthreads();           // ... for every thread; the last one done
    if (more) load_keys(ks + ((it + 1) & 1) * tile, a.k, k1);
    if (g_lo + 2 < n_chunks) load_chunk(g_lo + 2);
    attn::cp_async_commit();
    const bf16* kbs = ks + (it & 1) * tile;
    const bf16* lo_c = rwin + (g_lo % 3) * tile;
    const bf16* up_c = rwin + ((g_lo + 1) % 3) * tile;
    if (kb == 0) x = tc_rows(a, b, h, q0, w.m0, gs, ld);
    tc_bd(bd, rrs, lo_c, up_c, ld, kd, w.m0);
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, rws + w.m0 * ld, ld, kbs + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + w.m0 * ld, ld, vs + w.k0 * ld, ld, kd);
    __syncthreads();  // bd whole; v (and at a step's end rw, g) read
    if (more) {
      load_keys(vs, a.v, k1);
      if (last_kb) {
        load_rows(rws, a.rw, q0 + kTile);
        load_rows(gs, a.g, q0 + kTile);
      }
    }
    attn::cp_async_commit();
    // The lower warps' dr sums start from the ws rows they will update,
    // read now so the loads overlap the work up to the flush.
    const long long p_lo = chunk_p0(g_lo) + crow;
    float dr_acc[kTiles][4];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const long long p = p_lo + 8 * hi;
        float2 v = make_float2(0.0f, 0.0f);
        if (lower && t < tiles && p >= 0 && p < a.P)
          v = *reinterpret_cast<const float2*>(ws_bh + p * D + t * 8 +
                                               2 * (lane & 3));
        dr_acc[t][2 * hi] = v.x;
        dr_acc[t][2 * hi + 1] = v.y;
      }
    }
    float dsd[2] = {0.0f, 0.0f};
    tc_relik_grads<kDropout, false>(sc, tt, dsd, bd, sgs, mks, x, w.m0,
                                    w.k0, q0, k0, a, b, h);
    // ded: the warp's 32 keys of its two rows, then the key halves in order.
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      dsd[hi] += __shfl_xor_sync(0xffffffffu, dsd[hi], 1);
      dsd[hi] += __shfl_xor_sync(0xffffffffu, dsd[hi], 2);
    }
    if ((lane & 3) == 0) {
      dedp[(warp >> 2) * kTile + w.m0 + (lane >> 2)] = dsd[0];
      dedp[(warp >> 2) * kTile + w.m0 + (lane >> 2) + 8] = dsd[1];
    }
    __syncthreads();  // bd, segd and maskb read
    if (more) tc_load_qk(sgs, mks, a, b, i1 * kTile, k1, vec_qk);
    attn::cp_async_commit();
    // S′ over bd: S′[r][63 − r + j] = ds_u[r][j]; zeros in row r's columns
    // [48 − 16u, 63 − r) and [127 − r, 128 − 16u) (u = r / 16), the rest of
    // the 80 columns that drr and dr read of it.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w.m0 + (lane >> 2) + 8 * (e >> 1);
        const int j = w.k0 + 8 * t + 2 * (lane & 3) + (e & 1);
        sp[r * kSpLd + (kTile - 1) - r + j] = __float2bfloat16(sc[t][e]);
      }
    }
    {
      const int r = tid >> 2, ri = r & 15, u = r >> 4;
#pragma unroll
      for (int z = 4 * (tid & 3); z < 4 * (tid & 3) + 4; ++z)
        sp[r * kSpLd + (z < 15 - ri ? 48 - 16 * u + z
                                    : 127 - r + z - (15 - ri))] =
            __float2bfloat16(0.0f);
    }
    // drw += ds_c · k over the warp's 32 keys: the accumulators of key
    // tiles 2c and 2c + 1 are step c's A fragment (#7's dQ step).
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t fa[4] = {
          attn::pack_bf16(tt[2 * c][0], tt[2 * c][1]),
          attn::pack_bf16(tt[2 * c][2], tt[2 * c][3]),
          attn::pack_bf16(tt[2 * c + 1][0], tt[2 * c + 1][1]),
          attn::pack_bf16(tt[2 * c + 1][2], tt[2 * c + 1][3])};
      attn::tc_mma_bt(drw_acc, fa,
                      attn::tc_lane_bt(kbs + (w.k0 + 16 * c) * ld, ld),
                      tiles);
    }
    __syncthreads();  // S′ and ded's halves whole
    if (tid < kTile)
      ded_acc = __fadd_rn(ded_acc, __fadd_rn(dedp[tid], dedp[kTile + tid]));
    // drr += S′ · window for the warp's rows w.m0 .. and columns w.c0 ..,
    // over the window rows [48 − m0, 128 − m0) its rows' band lies in.
    for (int kk = 3 - w.m0 / 16; kk <= 7 - w.m0 / 16; ++kk) {
      uint32_t fa[4];
      attn::ldsm_x4(fa, attn::tc_lane_a(sp + w.m0 * kSpLd + 16 * kk, kSpLd));
      attn::tc_mma_bt(drr_acc, fa,
                      attn::tc_lane_bt((kk < 4 ? lo_c : up_c) +
                                           16 * (kk & 3) * ld + w.c0,
                                       ld),
                      w.n);
    }
    // dr for window rows 16·warp .. + 15 += S′ᵀ · rr, S′ᵀ by
    // ldmatrix.trans, over the query rows whose band reaches them.
    for (int u = max(0, 3 - warp); u <= min(3, 7 - warp); ++u) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(sp + 16 * u * kSpLd +
                                                   16 * warp,
                                               kSpLd));
      attn::tc_mma_bt(dr_acc, fa, attn::tc_lane_bt(rrs + 16 * u * ld, ld),
                      tiles);
    }
    // The window rolls: the lower chunk (g_lo) is complete, its rows now
    // (ws + this block's sums) + the upper half's from the key block before;
    // the upper chunk waits in the carry for the next key block, but for
    // the step's last one, which completes it too.
    if (lower) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const long long p = p_lo + 8 * hi;
        if (p < 0 || p >= a.P) continue;
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          if (t < tiles) {
            const int c = t * 8 + 2 * (lane & 3);
            float2 cv = make_float2(0.0f, 0.0f);
            if (kb > 0)
              cv = *reinterpret_cast<const float2*>(
                  carry + (crow + 8 * hi) * cld + c);
            *reinterpret_cast<float2*>(ws_bh + p * D + c) =
                make_float2(__fadd_rn(dr_acc[t][2 * hi], cv.x),
                            __fadd_rn(dr_acc[t][2 * hi + 1], cv.y));
          }
        }
      }
    } else if (last_kb) {
      const long long p_up = chunk_p0(g_lo + 1) + crow;
      flush(p_up, dr_acc, 0);
      flush(p_up + 8, dr_acc, 1);
    }
    __syncthreads();  // the carry, k, S′, rr and chunk g_lo read
    if (!lower && !last_kb) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
          if (t < tiles)
            *reinterpret_cast<float2*>(carry + (crow + 8 * hi) * cld + t * 8 +
                                       2 * (lane & 3)) =
                make_float2(dr_acc[t][2 * hi], dr_acc[t][2 * hi + 1]);
    }
    if (!last_kb) continue;
    // The step's end: the next step's rr and second chunk; drw (the second
    // key half's partial to the first through the carry), drr and ded.
    if (more) load_rows(rrs, a.rr, q0 + kTile);
    if (g_lo + 3 < n_chunks) load_chunk(g_lo + 3);
    attn::cp_async_commit();
    if (w.k0 != 0) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
          if (t < tiles)
            *reinterpret_cast<float2*>(
                carry + (w.m0 + (lane >> 2) + 8 * hi) * cld + t * 8 +
                2 * (lane & 3)) =
                make_float2(drw_acc[t][2 * hi], drw_acc[t][2 * hi + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = w.m0 + (lane >> 2) + 8 * hi;
      if (q0 + r >= a.Q) continue;
      bf16* drw_row = drw + q_base + (size_t)(q0 + r) * D;
      bf16* drr_row = drr + q_base + (size_t)(q0 + r) * D + w.c0;
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        const int c = t * 8 + 2 * (lane & 3);
        if (w.k0 == 0 && t < tiles) {
          const float2 o =
              *reinterpret_cast<const float2*>(carry + r * cld + c);
          *reinterpret_cast<__nv_bfloat162*>(drw_row + c) =
              __floats2bfloat162_rn(__fadd_rn(drw_acc[t][2 * hi], o.x),
                                    __fadd_rn(drw_acc[t][2 * hi + 1], o.y));
        }
        if (t < kTiles / 2 && t < w.n)
          *reinterpret_cast<__nv_bfloat162*>(drr_row + c) =
              __floats2bfloat162_rn(drr_acc[t][2 * hi],
                                    drr_acc[t][2 * hi + 1]);
      }
    }
    if (tid < kTile && q0 + tid < a.Q)
      ded[((size_t)b * a.H + h) * a.Q + q0 + tid] = __float2bfloat16(ded_acc);
    ded_acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        drw_acc[t][e] = 0.0f;
        if (t < kTiles / 2) drr_acc[t][e] = 0.0f;
      }
  }
}

template <bool kKV, int kTiles, bool kDropout>
int launch_tc(const Args<bf16>& a, int B, int vec_qk, void* drw, void* drr,
              void* dk, void* dv, void* ded, void* ws, cudaStream_t stream) {
  auto kernel = kKV ? attn_bwd_relik_fs_dkdv_tc_kernel<kTiles, kDropout>
                    : attn_bwd_relik_fs_dq_tc_kernel<kTiles, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      kKV ? tc_dkdv_smem_bytes(a.Dh) : tc_dq_smem_bytes(a.Dh);
  const dim3 grid = kKV ? dim3((a.K + kTile - 1) / kTile, a.H, B)
                        : dim3(a.H, B);
  kernel<<<grid, attn::kTcThreads, smem, stream>>>(
      a, vec_qk, static_cast<bf16*>(drw), static_cast<bf16*>(drr),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(ded), static_cast<float*>(ws));
  return (int)cudaGetLastError();
}

template <bool kKV>
int run_tc(const Args<bf16>& a, int B, bool dropout, void* drw, void* drr,
           void* dk, void* dv, void* ded, void* ws, cudaStream_t stream) {
  const uintptr_t rows = reinterpret_cast<uintptr_t>(a.rw) |
                         reinterpret_cast<uintptr_t>(a.rr) |
                         reinterpret_cast<uintptr_t>(a.r) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.g);
  if (rows % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int vec_qk = a.K % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(a.segd) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.maskb) % 16 == 0;
  if (tc_tiles(a.Dh) == 8)
    return dropout ? launch_tc<kKV, 8, true>(a, B, vec_qk, drw, drr, dk, dv,
                                             ded, ws, stream)
                   : launch_tc<kKV, 8, false>(a, B, vec_qk, drw, drr, dk,
                                              dv, ded, ws, stream);
  return dropout ? launch_tc<kKV, 16, true>(a, B, vec_qk, drw, drr, dk, dv,
                                            ded, ws, stream)
                 : launch_tc<kKV, 16, false>(a, B, vec_qk, drw, drr, dk, dv,
                                             ded, ws, stream);
}

template <typename T>
Args<T> make_args(const void* rw, const void* rr, const void* r,
                  const void* k, const void* v, const void* ed,
                  const void* segd, const void* maskb, const void* o,
                  const void* lse, const void* g, int Q, int K, int P, int H,
                  int Dh, float scale, DropoutArgs drop) {
  return Args<T>{static_cast<const T*>(rw),    static_cast<const T*>(rr),
                 static_cast<const T*>(r),     static_cast<const T*>(k),
                 static_cast<const T*>(v),     static_cast<const T*>(ed),
                 static_cast<const T*>(segd),  static_cast<const T*>(maskb),
                 static_cast<const T*>(o),     static_cast<const float*>(lse),
                 static_cast<const T*>(g),     Q, K, P, H, Dh, scale, drop};
}

// Pass 1 (kPass 0) or 2 (kPass 1): fp32 on the CUDA cores, bf16 on the
// tensor cores (see the note).
template <int kPass>
int entry(const void* rw, const void* rr, const void* r, const void* k,
          const void* v, const void* ed, const void* segd, const void* maskb,
          const void* o, const void* lse, const void* g, void* drw,
          void* drr, void* dk, void* dv, void* ded, void* ws, int B, int Q,
          int K, int P, int H, int Dh, float scale, int dropout,
          unsigned long long seed, unsigned int threshold, float inv_keep,
          int b_off, int h_off, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_off < 0 || h_off < 0) return (int)cudaErrorInvalidValue;
  const DropoutArgs drop{seed, threshold, inv_keep, b_off, h_off};
  if (dtype == 0) {
    const Args<float> a = make_args<float>(rw, rr, r, k, v, ed, segd, maskb,
                                           o, lse, g, Q, K, P, H, Dh, scale,
                                           drop);
    if constexpr (kPass == 0)
      return dropout ? launch_dkdv<float, true>(a, B, dk, dv, st)
                     : launch_dkdv<float, false>(a, B, dk, dv, st);
    return dropout ? launch_dq<float, true>(a, B, drw, drr, ded, ws, st)
                   : launch_dq<float, false>(a, B, drw, drr, ded, ws, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Args<bf16> a = make_args<bf16>(rw, rr, r, k, v, ed, segd, maskb, o,
                                       lse, g, Q, K, P, H, Dh, scale, drop);
  return run_tc<kPass == 0>(a, B, dropout != 0, drw, drr, dk, dv, ded, ws,
                            st);
}

}  // namespace

extern "C" {

// The three launches of #24, in this order on one stream (the wrapper's).
// dtype: 0 = float32, 1 = bfloat16, for every tensor but lse and ws. The
// inputs are #23's (rw, rr, r, k, v, ed, segd, maskb), its output o and lse
// [B, H, Q] fp32, and g [B, Q, D]. Pass 1 writes dk and dv [B, K, D];
// pass 2 writes drw and drr [B, Q, D] and ded [B, H, Q], and adds into ws,
// an fp32 [B, P, D] workspace that must hold zeros; pass 3 writes dr
// [P, D] from ws. dropout = 0 ignores seed/threshold/inv_keep;
// b_off/h_off (≥ 0) are the global batch row and head of the tensors'
// first (b, h) in the Philox counter (a tensor-parallel rank's shard). Each
// returns the cudaError_t of its launch (0 on success).
int attn_bwd_relik_fs_dkdv(const void* rw, const void* rr, const void* r,
                           const void* k, const void* v, const void* ed,
                           const void* segd, const void* maskb,
                           const void* o, const void* lse, const void* g,
                           void* drw, void* drr, void* dk, void* dv,
                           void* ded, void* ws, int B, int Q, int K, int P,
                           int H, int Dh, float scale, int dropout,
                           unsigned long long seed, unsigned int threshold,
                           float inv_keep, int b_off, int h_off, int dtype,
                           void* stream) {
  return entry<0>(rw, rr, r, k, v, ed, segd, maskb, o, lse, g, drw, drr, dk,
                  dv, ded, ws, B, Q, K, P, H, Dh, scale, dropout, seed,
                  threshold, inv_keep, b_off, h_off, dtype, stream);
}

int attn_bwd_relik_fs_dq(const void* rw, const void* rr, const void* r,
                         const void* k, const void* v, const void* ed,
                         const void* segd, const void* maskb, const void* o,
                         const void* lse, const void* g, void* drw,
                         void* drr, void* dk, void* dv, void* ded, void* ws,
                         int B, int Q, int K, int P, int H, int Dh,
                         float scale, int dropout, unsigned long long seed,
                         unsigned int threshold, float inv_keep, int b_off,
                         int h_off, int dtype, void* stream) {
  return entry<1>(rw, rr, r, k, v, ed, segd, maskb, o, lse, g, drw, drr, dk,
                  dv, ded, ws, B, Q, K, P, H, Dh, scale, dropout, seed,
                  threshold, inv_keep, b_off, h_off, dtype, stream);
}

int attn_bwd_relik_fs_dr(const void* ws, void* dr, int B, int P, int D,
                         int dtype, void* stream) {
  if (B < 1 || P < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)P * D;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 65535);
  switch (dtype) {
    case 0:
      attn_bwd_relik_fs_dr_kernel<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(ws), static_cast<float*>(dr), B, n);
      break;
    case 1:
      attn_bwd_relik_fs_dr_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dr), B,
          n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
