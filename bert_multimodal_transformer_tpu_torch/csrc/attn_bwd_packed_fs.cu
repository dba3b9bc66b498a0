// Flash-streamed packed attention backward for Hopper (sm_90a): the
// training backward past the head-blocked reach (S > 640).
//
// Replaces the TPU kernel `_attn_bwd_packed_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1328).
//
// What it computes, per batch row b and head h, from qkv [B, S, 3D], the
// fp32 mask, the forward's output o [B, S, D] and lse [B, H, S] (#6), the
// context gradient g [B, S, D] and the forward's seed, with every product
// accumulated in fp32:
//   δ_q  = Σ_c g[q][c] · o[q][c]        (from the rounded o, as the TPU
//          kernel; it stands for Σ_k pd ⊙ d(pd), which differs from it by
//          o's rounding, so the two are not interchangeable)
//   p    = exp((q · k) · scale + bias − lse_q), rebuilt per element
//   d(pd) = g · vᵀ;  with the replayed keep mask (common.cuh):
//   pd   = keep ? p · inv_keep : 0,  dp = keep ? d(pd) · inv_keep : 0
//   ds   = (p · (dp − δ)) · scale;  ds_c = T(ds);  pd_c = T(pd)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q,  dV = pd_cᵀ · g
// written into dqkv [B, S, 3D] at the columns q, k, v came from.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12,
// Dh=64) the five products are ~387 GFLOP: operations bound, 0.39 ms at
// the bf16 tensor-core peak. dQ reduces over keys while dK and dV reduce
// over queries; on the TPU the q-block grid axis runs in order and
// revisits the dK/dV output blocks, which Hopper's unordered blocks cannot
// do without atomics.
//
// What the design does about that: two launches, each a deterministic
// reduction inside its blocks, with no atomics and no S²-sized memory.
//   1. The dK/dV pass: one block per (64-key tile, head, batch row) holds
//      its K and V rows and walks the query rows in order, accumulating dK
//      and dV in fp32 registers; it rounds them once at the end.
//   2. The dQ pass: one block per (64-query tile, head, batch row) walks
//      the keys in blocks of 64 and accumulates dQ.
// Both rebuild p and d(pd) and form ds with the same code, so the two
// passes see the same ds bits; the price is the QKᵀ and g·Vᵀ products
// computed twice (seven products in place of five).
//
// bf16 (`attn_bwd_packed_fs_dkdv_tc_kernel`, `attn_bwd_packed_fs_dq_tc_
// kernel`): all seven products run on the tensor cores, mma.sync.m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix, with common.cuh's tensor-core
// pieces; every operand is staged as bf16 by cp.async, Dh padded to a
// k-depth of 16 with zero columns, rows past S zero-filled. 8 warps a block;
// each pass is built for Dh ≤ 64 and for Dh ≤ 128 (`tc_tiles`), so that Dh =
// 64 holds no accumulators for the wider head. In both passes a [64 q][64 k]
// tile of S = Q·Kᵀ and d(pd) = g·Vᵀ is split the same way, warp w taking
// queries 16·(w & 3) .. + 15 and keys 32·(w >> 2) .. + 31 (`attn::tc_warp`),
// both products by `tc_warp_abt<4>` over the same k16 steps, so every [q, k]
// element is fed the same fragments in the same order in both passes; the
// elementwise step (`tc_grads`, the CUDA-core kernels' `scores` +
// `grads_of_scores` arithmetic) then runs on the accumulators in registers,
// each lane drawing one Philox block for its 2 rows × 4 keys with its
// neighbour and trading the other's words by two shuffles; δ comes from
// common.cuh's `tc_slab_delta` in `row_delta`'s order. Hence the same ds
// bits in both passes.
//   - dK/dV pass: K and V staged once; Q, g and o in two-stage rings,
//     query block i + 1 in flight while block i is computed. pd_c and ds_c
//     go to bf16 [q][k] tiles; then each warp accumulates its 16 keys × half
//     of Dh of dV += pd_cᵀ·g and dK += ds_cᵀ·Q, pd_cᵀ and ds_cᵀ by
//     ldmatrix.trans from those tiles, g and Q by ldmatrix.trans.
//   - dQ pass: Q and g staged once, K and V (and the bias) in two-stage
//     rings. ds_c never leaves the registers: a warp's accumulators of two
//     neighbouring n8 key tiles, packed to bf16 pairs, are the A fragment
//     of a 16-key step of dQ += ds_c·K (K by ldmatrix.trans). The two key
//     halves' partial dQ meet in shared memory once, at the end.
//   Shared plans (`tc_dkdv_smem_bytes`, `tc_dq_smem_bytes`;
//   ops/fused_attention.py::fs_bwd_smem_bytes): dK/dV 90.3 KB at Dh = 64
//   (two blocks an SM), 154.3 KB at Dh = 128; dQ 54.5 KB and 102.5 KB.
//
// fp32 input keeps the CUDA-core kernels (`attn_bwd_packed_fs_dkdv_kernel`,
// `attn_bwd_packed_fs_dq_kernel`): the dots in fp32 from fp32 shared
// memory, the dK/dV walk in query blocks of 32; shared plans at Dh = 128
// 113 KB and 162 KB (65 KB and 98 KB at Dh = 64). The entries dispatch on
// the dtype; a bf16 call always launches the tensor-core kernel or returns
// the launch's error (cudaErrorMisalignedAddress where qkv, o or g does not
// start on the 16 bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // keys a dK/dV block owns; queries a dQ block
constexpr int kStep = 32;      // query rows per step of the dK/dV walk
constexpr int kKBlock = 64;    // key rows per step of the dQ walk
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kTile * kMaxDh / kThreads;

// δ[r] = Σ_c g[r][c] · o[q0 + r][c] for the staged g rows (rows of Dh + 1),
// one warp per row, the same order in both passes.
template <typename T>
__device__ __forceinline__ void row_delta(float* delta, const float* gs,
                                          const T* o_rows, size_t o_stride,
                                          int rows, int Dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float sum = 0.0f;
    for (int c = lane; c < Dh; c += 32)
      sum = fmaf(gs[r * (Dh + 1) + c],
                 attn::to_float(o_rows[(size_t)r * o_stride + c]), sum);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) delta[r] = sum;
  }
}

// On a [rows][cols] tile of queries q0 + r against keys k0 + j: ps holds
// s · scale + bias − lse (as computed by `scores`), tt holds d(pd). Leaves
// pd_c in ps and ds_c in tt. cols is a multiple of 4 but for the last
// block of keys; k0 is a multiple of 4.
template <typename T, bool kDropout>
__device__ __forceinline__ void grads_of_scores(float* ps, float* tt,
                                                int ld, int rows, int cols,
                                                int q0, int k0, int b, int h,
                                                const float* delta,
                                                float scale,
                                                DropoutArgs drop) {
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
        const float p = expf(ps[r * ld + j]);
        float pd = p, dp = tt[r * ld + j];
        if constexpr (kDropout) {
          const bool keep = attn::word(bits, u) >= drop.threshold;
          pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
          dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
        }
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta[r])),
                                   scale);
        ps[r * ld + j] = attn::round_to<T>(pd);
        tt[r * ld + j] = attn::round_to<T>(ds);
      }
    }
  }
}

// ps[r][j] = (q_r · k_j) · scale + bias[j] − lse[r] and tt[r][j] = g_r · v_j
// for r < rows, j < cols (staged rows of Dh + 1; ps/tt rows of ld).
__device__ __forceinline__ void scores(float* ps, float* tt, int ld,
                                       const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       const float* bias, const float* lse,
                                       int rows, int cols, int Dh,
                                       float scale) {
  const int ldr = Dh + 1;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, j = i - r * cols;
    const float* qr = qs + r * ldr;
    const float* gr = gs + r * ldr;
    const float* kj = ks + j * ldr;
    const float* vj = vs + j * ldr;
    float s = 0.0f, t = 0.0f;
    for (int c = 0; c < Dh; ++c) {
      s = fmaf(qr[c], kj[c], s);
      t = fmaf(gr[c], vj[c], t);
    }
    ps[r * ld + j] =
        __fsub_rn(__fadd_rn(__fmul_rn(s, scale), bias[j]), lse[r]);
    tt[r * ld + j] = t;
  }
}

__device__ __forceinline__ void load_bias(float* bias, const float* mask,
                                          int b, int S, int k0, int cols) {
  for (int j = threadIdx.x; j < cols; j += blockDim.x)
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + k0 + j]) * -10000.0f
                   : 0.0f;
}

// K, V [kTile][Dh+1]; Q, g [kStep][Dh+1]; P, Tt [kStep][kTile]; lse, δ
// [kStep]; bias [kTile].
__host__ __device__ inline size_t dkdv_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kStep * (dh + 1) +
         2 * (size_t)kStep * kTile + 2 * (size_t)kStep + kTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_fs_dkdv_kernel(const T* __restrict__ qkv,
                                   const float* __restrict__ mask,
                                   const T* __restrict__ o,
                                   const float* __restrict__ lse,
                                   const T* __restrict__ g,
                                   T* __restrict__ dqkv, int S, int H,
                                   int Dh, float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;
  float* ks = smem;                     // [kTile][Dh + 1]
  float* vs = ks + kTile * ld;          // [kTile][Dh + 1]
  float* qs = vs + kTile * ld;          // [kStep][Dh + 1]
  float* gs = qs + kStep * ld;          // [kStep][Dh + 1]
  float* ps = gs + kStep * ld;          // [kStep][kTile]
  float* tt = ps + kStep * kTile;       // [kStep][kTile]
  float* lse_s = tt + kStep * kTile;    // [kStep]
  float* delta = lse_s + kStep;         // [kStep]
  float* bias = delta + kStep;          // [kTile]

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const T* g_src = g + (size_t)b * S * D + h * Dh;
  const T* o_src = o + (size_t)b * S * D + h * Dh;
  const float* lse_src = lse + ((size_t)b * H + h) * S;
  const int cols = min(kTile, S - k0);

  attn::load_tile(ks, q_src + D + (size_t)k0 * row_stride, row_stride, cols,
                  Dh);
  attn::load_tile(vs, q_src + 2 * D + (size_t)k0 * row_stride, row_stride,
                  cols, Dh);
  load_bias(bias, mask, b, S, k0, cols);
  float dk[kAccPerThread], dv[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dk[a] = dv[a] = 0.0f;

  for (int q0 = 0; q0 < S; q0 += kStep) {
    const int rows = min(kStep, S - q0);
    __syncthreads();  // the previous step's readers are done
    attn::load_tile(qs, q_src + (size_t)q0 * row_stride, row_stride, rows,
                    Dh);
    attn::load_tile(gs, g_src + (size_t)q0 * D, (size_t)D, rows, Dh);
    for (int r = tid; r < rows; r += kThreads) lse_s[r] = lse_src[q0 + r];
    __syncthreads();
    row_delta(delta, gs, o_src + (size_t)q0 * D, (size_t)D, rows, Dh);
    scores(ps, tt, kTile, qs, gs, ks, vs, bias, lse_s, rows, cols, Dh,
           scale);
    __syncthreads();
    grads_of_scores<T, kDropout>(ps, tt, kTile, rows, cols, q0, k0, b, h,
                                 delta, scale, drop);
    __syncthreads();
    // dV[j] += Σ_r pd_c[r][j] · g[r],  dK[j] += Σ_r ds_c[r][j] · q[r]
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int j = i / Dh, c = i - j * Dh;
      if (i < kTile * Dh && j < cols) {
        float v_acc = dv[a], k_acc = dk[a];
        for (int r = 0; r < rows; ++r) {
          v_acc = fmaf(ps[r * kTile + j], gs[r * ld + c], v_acc);
          k_acc = fmaf(tt[r * kTile + j], qs[r * ld + c], k_acc);
        }
        dv[a] = v_acc;
        dk[a] = k_acc;
      }
    }
  }
  T* dk_dst = dqkv + ((size_t)b * S + k0) * row_stride + D + h * Dh;
  T* dv_dst = dk_dst + D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int j = i / Dh, c = i - j * Dh;
    if (i < kTile * Dh && j < cols) {
      dk_dst[(size_t)j * row_stride + c] = attn::from_float<T>(dk[a]);
      dv_dst[(size_t)j * row_stride + c] = attn::from_float<T>(dv[a]);
    }
  }
}

// Q, g, K, V [kTile or kKBlock][Dh+1]; P, Tt [kTile][kKBlock]; lse, δ
// [kTile]; bias [kKBlock].
__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kKBlock * (dh + 1) +
         2 * (size_t)kTile * kKBlock + 2 * (size_t)kTile + kKBlock;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_fs_dq_kernel(const T* __restrict__ qkv,
                                 const float* __restrict__ mask,
                                 const T* __restrict__ o,
                                 const float* __restrict__ lse,
                                 const T* __restrict__ g,
                                 T* __restrict__ dqkv, int S, int H, int Dh,
                                 float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;
  float* qs = smem;                     // [kTile][Dh + 1]
  float* gs = qs + kTile * ld;          // [kTile][Dh + 1]
  float* ks = gs + kTile * ld;          // [kKBlock][Dh + 1]
  float* vs = ks + kKBlock * ld;        // [kKBlock][Dh + 1]
  float* ps = vs + kKBlock * ld;        // [kTile][kKBlock]
  float* tt = ps + kTile * kKBlock;     // [kTile][kKBlock]
  float* lse_s = tt + kTile * kKBlock;  // [kTile]
  float* delta = lse_s + kTile;         // [kTile]
  float* bias = delta + kTile;          // [kKBlock]

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const int rows = min(kTile, S - q0);

  attn::load_tile(qs, q_src + (size_t)q0 * row_stride, row_stride, rows, Dh);
  attn::load_tile(gs, g + ((size_t)b * S + q0) * D + h * Dh, (size_t)D,
                  rows, Dh);
  for (int r = tid; r < rows; r += kThreads)
    lse_s[r] = lse[((size_t)b * H + h) * S + q0 + r];
  __syncthreads();
  row_delta(delta, gs, o + ((size_t)b * S + q0) * D + h * Dh, (size_t)D,
            rows, Dh);
  float dq[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dq[a] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kKBlock) {
    const int cols = min(kKBlock, S - k0);
    __syncthreads();  // the previous block's readers are done
    attn::load_tile(ks, q_src + D + (size_t)k0 * row_stride, row_stride,
                    cols, Dh);
    attn::load_tile(vs, q_src + 2 * D + (size_t)k0 * row_stride, row_stride,
                    cols, Dh);
    load_bias(bias, mask, b, S, k0, cols);
    __syncthreads();
    scores(ps, tt, kKBlock, qs, gs, ks, vs, bias, lse_s, rows, cols, Dh,
           scale);
    __syncthreads();
    grads_of_scores<T, kDropout>(ps, tt, kKBlock, rows, cols, q0, k0, b, h,
                                 delta, scale, drop);
    __syncthreads();
    // dQ[r] += Σ_j ds_c[r][j] · k_j
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kTile * Dh && r < rows) {
        const float* dr = tt + r * kKBlock;
        float acc = dq[a];
        for (int j = 0; j < cols; ++j) acc = fmaf(dr[j], ks[j * ld + c], acc);
        dq[a] = acc;
      }
    }
  }
  T* dq_dst = dqkv + ((size_t)b * S + q0) * row_stride + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kTile * Dh && r < rows)
      dq_dst[(size_t)r * row_stride + c] = attn::from_float<T>(dq[a]);
  }
}


// ---- bf16: the tensor-core kernels ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcStep = 64;        // query rows per step of the dK/dV walk
constexpr int kTcPLd = kTile + 8;  // the bf16 pd_c / ds_c tiles' row stride
static_assert(kTcStep == kTile && kKBlock == kTile,
              "the tensor-core tiles are 64 × 64 (attn::tc_warp)");
// The kernels are instantiated for kTiles = 8 (Dh ≤ 64) and 16 (Dh ≤ 128)
// n8 tiles of Dh, so that Dh = 64 holds no registers for Dh = 128: a dK/dV
// warp holds kTiles / 2 tiles each of dK and dV (16 keys × half of Dh), a
// dQ warp kTiles (16 queries × Dh).
__host__ __device__ inline int tc_tiles(int dh) { return dh <= 64 ? 8 : 16; }

// Bytes of shared memory of one tensor-core block (see the note). dK/dV:
// K, V and the Q, g and o rings (bf16 [64][L], eight in all), the bf16
// pd_c and ds_c tiles [64][72], the tile's bias. dQ: Q, g and the K and V
// rings (six), the two bias blocks; at the end the key halves' partial dQ,
// fp32 [64][Dh + 8], over the rings.
__host__ __device__ inline size_t tc_dkdv_smem_bytes(int dh) {
  return (2 * (size_t)kTile + 6 * (size_t)kTcStep) * attn::tc_ld(dh) *
             sizeof(bf16) +
         2 * (size_t)kTcStep * kTcPLd * sizeof(bf16) + kTile * sizeof(float);
}
__host__ __device__ inline size_t tc_dq_smem_bytes(int dh) {
  return 6 * (size_t)kTile * attn::tc_ld(dh) * sizeof(bf16) +
         2 * (size_t)kKBlock * sizeof(float);
}

// The elementwise step on a warp's [16 q][32 k] tile of accumulators (the
// layout of `tc_warp_abt<4>`: element (q_lo + 8·(e ≥ 2), k_first + 8t +
// 2·(lane % 4) + (e & 1)) in [t][e]): sc holds the q·k dots, tt the g·v
// dots. Per element, `scores` + `grads_of_scores`' arithmetic: p =
// exp((dot · scale + bias) − lse), the keep mask, pd, dp, ds = (p · (dp −
// δ)) · scale. Leaves pd_c = T(pd) in sc and ds_c = T(ds) in tt, zeros
// where q or k ≥ S. bias holds the 32 keys' bias, lse_* and d_* the lane's
// rows' lse and δ. At rate > 0 lanes 2m and 2m + 1 (the same 4 keys, rows
// q_lo and q_hi) draw one Philox block each, for q_lo and q_hi, and trade
// the two words the other needs.
template <bool kDropout>
__device__ __forceinline__ void tc_grads(float (&sc)[4][4], float (&tt)[4][4],
                                         const float* bias, float lse_lo,
                                         float lse_hi, float d_lo, float d_hi,
                                         int q_lo, int k_first, int S, int b,
                                         int h, float scale,
                                         const DropoutArgs& drop) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};  // the draws of [t][0 .. 3]
    if constexpr (kDropout) {
      const int k4 = (k_first + 8 * t + 4 * ((lane & 3) >> 1)) >> 2;
      const uint4 own =
          attn::dropout_bits4(drop.seed, b, h, odd ? q_lo + 8 : q_lo, k4);
      const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? own.x : own.z, 1);
      const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? own.y : own.w, 1);
      wd[0] = odd ? x0 : own.x;
      wd[1] = odd ? x1 : own.y;
      wd[2] = odd ? own.z : x0;
      wd[3] = odd ? own.w : x1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q_lo + 8 * (e >> 1);
      const int jj = 8 * t + 2 * (lane & 3) + (e & 1);
      float pd_c = 0.0f, ds_c = 0.0f;
      if (q < S && k_first + jj < S) {
        const float p = expf(__fsub_rn(
            __fadd_rn(__fmul_rn(sc[t][e], scale), bias[jj]),
            e < 2 ? lse_lo : lse_hi));
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

// The lane's rows' lse (0 past S).
__device__ __forceinline__ void tc_lse(float& lse_lo, float& lse_hi,
                                       const float* lse_bh, int q_lo,
                                       int S) {
  lse_lo = q_lo < S ? lse_bh[q_lo] : 0.0f;
  lse_hi = q_lo + 8 < S ? lse_bh[q_lo + 8] : 0.0f;
}

template <int kTiles, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_packed_fs_dkdv_tc_kernel(const bf16* __restrict__ qkv,
                                      const float* __restrict__ mask,
                                      const bf16* __restrict__ o,
                                      const float* __restrict__ lse,
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
  bf16* os = gs + 2 * tile;                      // 2 × [64][ld]
  bf16* pds = os + 2 * tile;                     // [64 q][kTcPLd] pd_c
  bf16* dss = pds + kTcStep * kTcPLd;            // [64 q][kTcPLd] ds_c
  float* bias = reinterpret_cast<float*>(dss + kTcStep * kTcPLd);  // [64]

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const bf16* g_base = g + (size_t)b * S * D + h * Dh;
  const bf16* o_base = o + (size_t)b * S * D + h * Dh;
  const float* lse_bh = lse + ((size_t)b * H + h) * S;
  const int cols = min(kTile, S - k0);
  const int n_blocks = (S + kTcStep - 1) / kTcStep;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // Query block i (Q, g, o) into ring stage i & 1.
  auto load_q = [&](int i) {
    const int q0 = i * kTcStep;
    const int rows = min(kTcStep, S - q0);
    const int s = (i & 1) * tile;
    attn::tc_cp_rows(qs + s, ld, q_base, row_stride, q0, kTcStep, 0, rows, Dh);
    attn::tc_cp_rows(gs + s, ld, g_base, (size_t)D, q0, kTcStep, 0, rows, Dh);
    attn::tc_cp_rows(os + s, ld, o_base, (size_t)D, q0, kTcStep, 0, rows, Dh);
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
    const int q0 = i * kTcStep;
    attn::cp_async_wait<0>();  // query block i
    __syncthreads();  // ... for every thread; block i − 1's products done
    if (i + 1 < n_blocks) load_q(i + 1);
    attn::cp_async_commit();
    const int s = (i & 1) * tile;
    const int q_lo = q0 + w.m0 + (lane >> 2);
    float lse_lo, lse_hi, d_lo, d_hi;
    tc_lse(lse_lo, lse_hi, lse_bh, q_lo, S);
    attn::tc_slab_delta(d_lo, d_hi, gs + s + w.m0 * ld, ld,
                        os + s + w.m0 * ld, (size_t)ld, S - q0 - w.m0, Dh);
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + s + w.m0 * ld, ld, ks + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + s + w.m0 * ld, ld, vs + w.k0 * ld, ld, kd);
    tc_grads<kDropout>(sc, tt, bias + w.k0, lse_lo, lse_hi, d_lo, d_hi,
                       q_lo, k0 + w.k0, S, b, h, scale, drop);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = w.m0 + (lane >> 2) + 8 * hi;
        *reinterpret_cast<__nv_bfloat162*>(pds + r * kTcPLd + j) =
            __floats2bfloat162_rn(sc[t][2 * hi], sc[t][2 * hi + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dss + r * kTcPLd + j) =
            __floats2bfloat162_rn(tt[t][2 * hi], tt[t][2 * hi + 1]);
      }
    }
    __syncthreads();
    // dV[k] += Σ_q pd_c[q][k] · g[q],  dK[k] += Σ_q ds_c[q][k] · q[q] for
    // the warp's keys w.m0 .. + 15 and columns w.c0 .., 16 queries a step.
    const int q_end = min(kTcStep, (S - q0 + 15) / 16 * 16);
    for (int c = 0; c < q_end; c += 16) {
      uint32_t fa[4];
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(pds + c * kTcPLd + w.m0,
                                               kTcPLd));
      attn::tc_mma_bt(dv, fa, attn::tc_lane_bt(gs + s + c * ld + w.c0, ld),
                      w.n);
      attn::ldsm_x4_trans(fa, attn::tc_lane_at(dss + c * kTcPLd + w.m0,
                                               kTcPLd));
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

template <int kTiles, bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_bwd_packed_fs_dq_tc_kernel(const bf16* __restrict__ qkv,
                                    const float* __restrict__ mask,
                                    const bf16* __restrict__ o,
                                    const float* __restrict__ lse,
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

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const int rows = min(kTile, S - q0);
  const int n_blocks = (S + kKBlock - 1) / kKBlock;
  const int tiles = Dh / 8;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // K block i, V block i and their bias into ring stage i & 1.
  auto load_kv = [&](int i) {
    const int k0 = i * kKBlock;
    const int k_rows = min(kKBlock, S - k0);
    attn::tc_cp_rows(ks + (i & 1) * tile, ld, q_base + D, row_stride, k0,
                     kKBlock, 0, k_rows, Dh);
    attn::tc_cp_rows(vs + (i & 1) * tile, ld, q_base + 2 * D, row_stride, k0,
                     kKBlock, 0, k_rows, Dh);
    if (tid < kKBlock)
      bias[(i & 1) * kKBlock + tid] =
          mask && tid < k_rows
              ? (1.0f - mask[(size_t)b * S + k0 + tid]) * -10000.0f
              : 0.0f;
  };
  attn::tc_cp_rows(qs, ld, q_base, row_stride, q0, kTile, 0, rows, Dh);
  attn::tc_cp_rows(gs, ld, g + (size_t)b * S * D + h * Dh, (size_t)D, q0,
                   kTile, 0, rows, Dh);
  load_kv(0);
  attn::cp_async_commit();
  // The k-depth's pad columns of Q, g and both ring stages stay zero.
  attn::tc_zero_cols(qs, ld, 6 * kTile, Dh, kd);
  const int q_lo = q0 + w.m0 + (lane >> 2);
  float lse_lo, lse_hi, d_lo, d_hi;
  tc_lse(lse_lo, lse_hi, lse + ((size_t)b * H + h) * S, q_lo, S);
  attn::cp_async_wait<0>();
  __syncthreads();  // g is staged
  attn::tc_slab_delta(d_lo, d_hi, gs + w.m0 * ld, ld,
                      o + ((size_t)b * S + q0 + w.m0) * D + h * Dh,
                      (size_t)D, rows - w.m0, Dh);
  float acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int i = 0; i < n_blocks; ++i) {
    attn::cp_async_wait<0>();  // K/V block i
    __syncthreads();  // ... for every thread; block i − 1 is done with
    if (i + 1 < n_blocks) load_kv(i + 1);
    attn::cp_async_commit();
    const bf16* kb = ks + (i & 1) * tile;
    const bf16* vb = vs + (i & 1) * tile;
    float sc[4][4] = {}, tt[4][4] = {};
    attn::tc_warp_abt<4>(sc, qs + w.m0 * ld, ld, kb + w.k0 * ld, ld, kd);
    attn::tc_warp_abt<4>(tt, gs + w.m0 * ld, ld, vb + w.k0 * ld, ld, kd);
    tc_grads<kDropout>(sc, tt, bias + (i & 1) * kKBlock + w.k0, lse_lo,
                       lse_hi, d_lo, d_hi, q_lo, i * kKBlock + w.k0, S, b, h,
                       scale, drop);
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

template <bool kDkdv, int kTiles, bool kDropout>
int launch_tc(const void* qkv, const void* mask, const void* o,
              const void* lse, const void* g, void* dqkv, int B, int S,
              int H, int Dh, float scale, DropoutArgs drop,
              cudaStream_t stream) {
  auto kernel = kDkdv ? attn_bwd_packed_fs_dkdv_tc_kernel<kTiles, kDropout>
                      : attn_bwd_packed_fs_dq_tc_kernel<kTiles, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kDkdv ? tc_dkdv_smem_bytes(Dh) : tc_dq_smem_bytes(Dh);
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, attn::kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<const bf16*>(o), static_cast<const float*>(lse),
      static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), S, H, Dh, scale,
      drop);
  return (int)cudaGetLastError();
}

template <bool kDkdv, bool kDropout>
int launch_tc(const void* qkv, const void* mask, const void* o,
              const void* lse, const void* g, void* dqkv, int B, int S,
              int H, int Dh, float scale, DropoutArgs drop,
              cudaStream_t stream) {
  if (tc_tiles(Dh) == 8)
    return launch_tc<kDkdv, 8, kDropout>(qkv, mask, o, lse, g, dqkv, B, S,
                                         H, Dh, scale, drop, stream);
  return launch_tc<kDkdv, 16, kDropout>(qkv, mask, o, lse, g, dqkv, B, S, H,
                                        Dh, scale, drop, stream);
}

template <bool kDkdv, typename T, bool kDropout>
int launch(const void* qkv, const void* mask, const void* o, const void* lse,
           const void* g, void* dqkv, int B, int S, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  auto kernel = kDkdv ? attn_bwd_packed_fs_dkdv_kernel<T, kDropout>
                      : attn_bwd_packed_fs_dq_kernel<T, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (kDkdv ? dkdv_smem_floats(Dh) : dq_smem_floats(Dh)) * sizeof(float);
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const T*>(g), static_cast<T*>(dqkv), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <bool kDkdv>
int entry(const void* qkv, const void* mask, const void* o, const void* lse,
          const void* g, void* dqkv, int B, int S, int H, int Dh,
          float scale, int dropout, unsigned long long seed,
          unsigned int threshold, float inv_keep, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores, bf16 on the tensor cores (see the note).
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<kDkdv, float, false>(qkv, mask, o, lse, g, dqkv, B, S, H,
                                         Dh, scale, drop, st);
    case 1:
      return launch<kDkdv, float, true>(qkv, mask, o, lse, g, dqkv, B, S, H,
                                        Dh, scale, drop, st);
    case 2:
    case 3:
      if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(o) |
           reinterpret_cast<uintptr_t>(g)) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dropout ? launch_tc<kDkdv, true>(qkv, mask, o, lse, g, dqkv, B,
                                              S, H, Dh, scale, drop, st)
                     : launch_tc<kDkdv, false>(qkv, mask, o, lse, g, dqkv, B,
                                               S, H, Dh, scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The two passes of #7, launched in this order on one stream by the
// wrapper. dtype: 0 = float32, 1 = bfloat16. mask may be null (no
// padding). o (the forward's output) and g are [B, S, D] and dqkv
// [B, S, 3D] in the input dtype, lse [B, H, S] fp32. The dK/dV pass writes
// dqkv's k and v columns, the dQ pass its q columns. dropout = 0 ignores
// seed/threshold/inv_keep. Each returns the cudaError_t of its launch.
int attn_bwd_packed_fs_dkdv(const void* qkv, const void* mask, const void* o,
                            const void* lse, const void* g, void* dqkv,
                            int B, int S, int H, int Dh, float scale,
                            int dropout, unsigned long long seed,
                            unsigned int threshold, float inv_keep,
                            int dtype, void* stream) {
  return entry<true>(qkv, mask, o, lse, g, dqkv, B, S, H, Dh, scale, dropout,
                     seed, threshold, inv_keep, dtype, stream);
}

int attn_bwd_packed_fs_dq(const void* qkv, const void* mask, const void* o,
                          const void* lse, const void* g, void* dqkv, int B,
                          int S, int H, int Dh, float scale, int dropout,
                          unsigned long long seed, unsigned int threshold,
                          float inv_keep, int dtype, void* stream) {
  return entry<false>(qkv, mask, o, lse, g, dqkv, B, S, H, Dh, scale,
                      dropout, seed, threshold, inv_keep, dtype, stream);
}

}  // extern "C"
