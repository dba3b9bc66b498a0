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
//   1. `attn_bwd_relik_fs_dkdv_kernel`, #7's dK/dV pass: one block per
//      (64-key tile, head, batch row) holds its k and v rows and walks the
//      query rows in steps of 32, in order, accumulating dK and dV in fp32
//      registers.
//   2. `attn_bwd_relik_fs_dq_kernel`: one block per (head, batch row) walks
//      the query tiles of 32, in order, and within each the key blocks of
//      64, in order. It accumulates drw and drr in registers and ded in
//      shared memory, and adds the tile's dr window, the [95][Dh] rows
//      Q − q0 − 31 + k0 .. of r that the (tile, block) touches, into its own
//      fp32 slice ws[b, :, h·Dh:(h+1)·Dh] of a [B, P, D] workspace: one
//      block owns each (b, h) slice, so its read-modify-writes need no
//      atomics and run in a fixed order. Owning the whole (b, h) keeps the
//      window in one block (the alternative, a dr pass over position tiles,
//      recomputes ac, bd and d(pd) a third time); the price is B·H blocks
//      (576 at the driver's shape: a few waves over the 132 SMs).
//   3. `attn_bwd_relik_fs_dr_kernel`: dr[p][c] = T(Σ_b ws[b][p][c]), b in
//      order.
// Passes 1 and 2 rebuild p and d(pd) with the same code, so both see the
// same ds bits. The relative shift is the window's index arithmetic, as in
// #23 (row qi of a step reads window row (31 − qi) + j for key j). Shared
// plans at Dh = 64: 97 KB and 105 KB (177 KB and 185 KB at Dh = 128). The
// dots run on the CUDA cores in fp32, as #7's.

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
      bits = attn::dropout_bits4(drop.seed, b, h, q0 + r, (k0 + j0) >> 2);
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

// Pass 1 (kPass 0) or 2 (kPass 1) at dtype T.
template <int kPass, typename T>
int run(const void* rw, const void* rr, const void* r, const void* k,
        const void* v, const void* ed, const void* segd, const void* maskb,
        const void* o, const void* lse, const void* g, void* drw, void* drr,
        void* dk, void* dv, void* ded, void* ws, int B, int Q, int K, int P,
        int H, int Dh, float scale, bool dropout, DropoutArgs drop,
        cudaStream_t st) {
  const Args<T> a{static_cast<const T*>(rw),    static_cast<const T*>(rr),
                  static_cast<const T*>(r),     static_cast<const T*>(k),
                  static_cast<const T*>(v),     static_cast<const T*>(ed),
                  static_cast<const T*>(segd),  static_cast<const T*>(maskb),
                  static_cast<const T*>(o),     static_cast<const float*>(lse),
                  static_cast<const T*>(g),     Q, K, P, H, Dh, scale, drop};
  if constexpr (kPass == 0) {
    return dropout ? launch_dkdv<T, true>(a, B, dk, dv, st)
                   : launch_dkdv<T, false>(a, B, dk, dv, st);
  } else {
    return dropout ? launch_dq<T, true>(a, B, drw, drr, ded, ws, st)
                   : launch_dq<T, false>(a, B, drw, drr, ded, ws, st);
  }
}

template <int kPass>
int entry(const void* rw, const void* rr, const void* r, const void* k,
          const void* v, const void* ed, const void* segd, const void* maskb,
          const void* o, const void* lse, const void* g, void* drw,
          void* drr, void* dk, void* dv, void* ded, void* ws, int B, int Q,
          int K, int P, int H, int Dh, float scale, int dropout,
          unsigned long long seed, unsigned int threshold, float inv_keep,
          int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return run<kPass, float>(rw, rr, r, k, v, ed, segd, maskb, o, lse, g,
                               drw, drr, dk, dv, ded, ws, B, Q, K, P, H, Dh,
                               scale, dropout != 0, drop, st);
    case 1:
      return run<kPass, __nv_bfloat16>(rw, rr, r, k, v, ed, segd, maskb, o,
                                       lse, g, drw, drr, dk, dv, ded, ws, B,
                                       Q, K, P, H, Dh, scale, dropout != 0,
                                       drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The three launches of #24, in this order on one stream (the wrapper's).
// dtype: 0 = float32, 1 = bfloat16, for every tensor but lse and ws. The
// inputs are #23's (rw, rr, r, k, v, ed, segd, maskb), its output o and lse
// [B, H, Q] fp32, and g [B, Q, D]. Pass 1 writes dk and dv [B, K, D];
// pass 2 writes drw and drr [B, Q, D] and ded [B, H, Q], and adds into ws,
// an fp32 [B, P, D] workspace that must hold zeros; pass 3 writes dr
// [P, D] from ws. dropout = 0 ignores seed/threshold/inv_keep. Each
// returns the cudaError_t of its launch (0 on success).
int attn_bwd_relik_fs_dkdv(const void* rw, const void* rr, const void* r,
                           const void* k, const void* v, const void* ed,
                           const void* segd, const void* maskb,
                           const void* o, const void* lse, const void* g,
                           void* drw, void* drr, void* dk, void* dv,
                           void* ded, void* ws, int B, int Q, int K, int P,
                           int H, int Dh, float scale, int dropout,
                           unsigned long long seed, unsigned int threshold,
                           float inv_keep, int dtype, void* stream) {
  return entry<0>(rw, rr, r, k, v, ed, segd, maskb, o, lse, g, drw, drr, dk,
                  dv, ded, ws, B, Q, K, P, H, Dh, scale, dropout, seed,
                  threshold, inv_keep, dtype, stream);
}

int attn_bwd_relik_fs_dq(const void* rw, const void* rr, const void* r,
                         const void* k, const void* v, const void* ed,
                         const void* segd, const void* maskb, const void* o,
                         const void* lse, const void* g, void* drw,
                         void* drr, void* dk, void* dv, void* ded, void* ws,
                         int B, int Q, int K, int P, int H, int Dh,
                         float scale, int dropout, unsigned long long seed,
                         unsigned int threshold, float inv_keep, int dtype,
                         void* stream) {
  return entry<1>(rw, rr, r, k, v, ed, segd, maskb, o, lse, g, drw, drr, dk,
                  dv, ded, ws, B, Q, K, P, H, Dh, scale, dropout, seed,
                  threshold, inv_keep, dtype, stream);
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
