// Flash-streamed ingredients rel-attention forward for Hopper (sm_90a):
// the long-sequence MAG-XLNet forward.
//
// Replaces the TPU kernel `_attn_fwd_relik_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:4272), which the
// JAX model takes past its full-H rel reach when the bias ingredients are
// eligible (bi attention, P ≥ Q + K).
//
// What it computes, per batch row b, head h and query row q, from rw, rr
// [B, Q, D] (the content query and the scaled position query, head-major
// columns h·Dh + c), the position keys r [P, D] (P ≥ Q + K), k, v [B, K, D],
// ed [B, H, Q], segd and maskb [B, Q, K], all in the input dtype, over key
// blocks of kKBlock in order: the score of common.cuh's `relik_score`
//   s = ((rw · k) · scale + rr · r[Q − q + k]) + ed · segd + maskb
// (rel_shift(rr · rᵀ) + the segment delta + the mask, assembled here), then
// #6's online softmax with a running max m, a denominator l and a rescaled
// fp32 accumulator:
//   m' = max(m, max_k s);  α = exp(m − m');  e = exp(s − m');
//   l  ← l · α + Σ_k e;  e ← keep ? e · inv_keep : 0 (common.cuh's Philox
//   stream at (k >> 2, q, h, b));  acc ← acc · α + T(e) · v_block
// and out [B, Q, D] = T(acc / l), lse [B, H, Q] = m + log l (fp32), the
// residual #24 rebuilds p from. Nothing [B, H, Q, P]- or [B, H, Q, K]-sized
// exists. The reference's ef₀ term, constant along k, is softmax-invariant
// and is left out, as the TPU kernel leaves it out.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12, Dh=64)
// the three products (rw·kᵀ, rr·r over the shifted window, PV) are ~232
// GFLOP; rw, rr, k, v and out (377 MB) and segd and maskb (201 MB) are
// read or written once: operations bound at the bf16 tensor-core peak
// (0.23 ms, against 0.17 ms for the bytes).
//
// What the design does about that: one block per (64-row q tile, head,
// batch row), #6's plan. The TPU kernel shifts each row of a [qb, qb + kb]
// bd block with masked lane rolls (`_row_shift_block`); here the shift is
// index arithmetic: the block stages the window of 127 rows of r that its
// tile and the current key block read, and row qi reads window row
// (63 − qi) + j for key j, so bd costs one Dh-long dot per element, as ac
// does. The accumulators live in registers; any Q and K are taken, the
// ragged last tiles bounds-checked (the TPU kernel needs Q and K % 128 ==
// 0). Shared plan: q tiles [64][Dh] ×2, a k/v block [64][Dh+1], the r
// window [127][Dh+1], scores [64][64]: 98 KB at Dh = 64 (two blocks an SM)
// and 177 KB at Dh = 128. B·H·Q/64 = 9216 blocks at the driver's shape. The
// dots run on the CUDA cores in fp32, as #6's.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;   // 8 warps
constexpr int kQTile = 64;      // query rows per block
constexpr int kKBlock = 64;     // ops/fused_attention.py::FS_KEY_BLOCK
constexpr int kWin = kQTile + kKBlock - 1;  // r rows a (tile, block) reads
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;

// rw, rr tiles [kQTile][dh] each, k/v block [kKBlock][dh + 1], r window
// [kWin][dh + 1], scores [kQTile][kKBlock], the rows' m, l, α and ed
// [kQTile] each.
__host__ __device__ inline size_t smem_floats(int dh) {
  return 2 * (size_t)kQTile * dh + (size_t)(kKBlock + kWin) * (dh + 1) +
         (size_t)kQTile * kKBlock + 4 * (size_t)kQTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_relik_fs_kernel(const T* __restrict__ rw,
                             const T* __restrict__ rr,
                             const T* __restrict__ r, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ ed,
                             const T* __restrict__ segd,
                             const T* __restrict__ maskb,
                             T* __restrict__ out, float* __restrict__ lse,
                             int Q, int K, int P, int H, int Dh, float scale,
                             DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ld = Dh + 1;

  float* rws = smem;                       // [kQTile][Dh]
  float* rrs = rws + kQTile * Dh;          // [kQTile][Dh]
  float* kvs = rrs + kQTile * Dh;          // [kKBlock][Dh + 1]
  float* rwin = kvs + kKBlock * ld;        // [kWin][Dh + 1]
  float* ss = rwin + kWin * ld;            // [kQTile][kKBlock]
  float* m_s = ss + kQTile * kKBlock;      // [kQTile] running max
  float* l_s = m_s + kQTile;               // [kQTile] running denominator
  float* alpha_s = l_s + kQTile;           // [kQTile] this block's rescale
  float* ed_s = alpha_s + kQTile;          // [kQTile]

  const size_t q_off = (size_t)b * Q * D + h * Dh;
  const T* k_src = k + (size_t)b * K * D + h * Dh;
  const T* v_src = v + (size_t)b * K * D + h * Dh;
  const T* r_head = r + h * Dh;
  const size_t row_bh = ((size_t)b * H + h) * Q;   // ed and lse rows
  const size_t qk_row = (size_t)b * Q;             // segd and maskb rows
  const int q_rows = min(kQTile, Q - q0);

  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int rr_ = i / Dh, c = i - rr_ * Dh;
    const bool live = rr_ < q_rows;
    const size_t at = q_off + (size_t)(q0 + rr_) * D + c;
    rws[i] = live ? attn::to_float(rw[at]) : 0.0f;
    rrs[i] = live ? attn::to_float(rr[at]) : 0.0f;
  }
  for (int i = tid; i < kQTile; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
    ed_s[i] = i < q_rows ? attn::to_float(ed[row_bh + q0 + i]) : 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKBlock) {
    const int k_rows = min(kKBlock, K - k0);
    __syncthreads();  // the previous block's PV readers are done
    attn::load_tile(kvs, k_src + (size_t)k0 * D, (size_t)D, k_rows, Dh);
    attn::load_r_window(rwin, r_head, D, P, Q - q0 - (kQTile - 1) + k0, kWin,
                        Dh);
    __syncthreads();
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int rq = i / k_rows, j = i - rq * k_rows;
      const size_t qk = (qk_row + q0 + rq) * K + k0 + j;
      ss[rq * kKBlock + j] = attn::relik_score(
          rws + rq * Dh, rrs + rq * Dh, kvs + j * ld,
          rwin + (kQTile - 1 - rq + j) * ld, Dh, scale, ed_s[rq],
          attn::to_float(segd[qk]), attn::to_float(maskb[qk]));
    }
    __syncthreads();
    // The online softmax step, one warp per row (#6's).
    for (int rq = warp; rq < q_rows; rq += kThreads / 32) {
      float* sr = ss + rq * kKBlock;
      float mx = -INFINITY;
      for (int j = lane; j < k_rows; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[rq];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < k_rows; j += 32) {
        const float e = expf(sr[j] - m_new);
        sr[j] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if constexpr (kDropout) {
        const int qg = q0 + rq;
        for (int j0 = 4 * lane; j0 < k_rows; j0 += 128) {
          const uint4 bits =
              attn::dropout_bits4(drop.seed, b, h, qg, (k0 + j0) >> 2);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u;
            if (j < k_rows)
              sr[j] = attn::round_to<T>(attn::word(bits, u) >= drop.threshold
                                            ? __fmul_rn(sr[j], drop.inv_keep)
                                            : 0.0f);
          }
        }
      } else {
        for (int j = lane; j < k_rows; j += 32)
          sr[j] = attn::round_to<T>(sr[j]);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first block
        alpha_s[rq] = alpha;
        l_s[rq] = __fadd_rn(__fmul_rn(l_s[rq], alpha), sum);
        m_s[rq] = m_new;
      }
    }
    __syncthreads();  // k no longer needed: stage v
    attn::load_tile(kvs, v_src + (size_t)k0 * D, (size_t)D, k_rows, Dh);
    __syncthreads();
    // acc ← acc · α + T(e) · v_block
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int rq = i / Dh, c = i - rq * Dh;
      if (i < kQTile * Dh && rq < q_rows) {
        const float* er = ss + rq * kKBlock;
        float pv = 0.0f;
        for (int j = 0; j < k_rows; ++j) pv = fmaf(er[j], kvs[j * ld + c], pv);
        acc[a] = __fadd_rn(__fmul_rn(acc[a], alpha_s[rq]), pv);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int rq = i / Dh, c = i - rq * Dh;
    if (i < kQTile * Dh && rq < q_rows)
      out[q_off + (size_t)(q0 + rq) * D + c] =
          attn::from_float<T>(acc[a] / l_s[rq]);
  }
  for (int rq = tid; rq < q_rows; rq += kThreads)
    lse[row_bh + q0 + rq] = __fadd_rn(m_s[rq], logf(l_s[rq]));
}

template <typename T, bool kDropout>
int launch(const void* rw, const void* rr, const void* r, const void* k,
           const void* v, const void* ed, const void* segd,
           const void* maskb, void* out, void* lse, int B, int Q, int K,
           int P, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_relik_fs_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_relik_fs_kernel<T, kDropout>
      <<<grid, kThreads, smem_floats(Dh) * sizeof(float), stream>>>(
          static_cast<const T*>(rw), static_cast<const T*>(rr),
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ed),
          static_cast<const T*>(segd), static_cast<const T*>(maskb),
          static_cast<T*>(out), static_cast<float*>(lse), Q, K, P, H, Dh,
          scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for rw, rr, r, k, v, ed, segd, maskb
// and out; lse is [B, H, Q] fp32. P ≥ Q + K. dropout = 0 ignores
// seed/threshold/inv_keep. Returns the cudaError_t of the launch (0 on
// success); a shape the kernel does not take returns cudaErrorInvalidValue.
int attn_fwd_relik_fs(const void* rw, const void* rr, const void* r,
                      const void* k, const void* v, const void* ed,
                      const void* segd, const void* maskb, void* out,
                      void* lse, int B, int Q, int K, int P, int H, int Dh,
                      float scale, int dropout, unsigned long long seed,
                      unsigned int threshold, float inv_keep, int dtype,
                      void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(rw, rr, r, k, v, ed, segd, maskb, out, lse,
                                  B, Q, K, P, H, Dh, scale, drop, st);
    case 1:
      return launch<float, true>(rw, rr, r, k, v, ed, segd, maskb, out, lse,
                                 B, Q, K, P, H, Dh, scale, drop, st);
    case 2:
      return launch<__nv_bfloat16, false>(rw, rr, r, k, v, ed, segd, maskb,
                                          out, lse, B, Q, K, P, H, Dh, scale,
                                          drop, st);
    case 3:
      return launch<__nv_bfloat16, true>(rw, rr, r, k, v, ed, segd, maskb,
                                         out, lse, B, Q, K, P, H, Dh, scale,
                                         drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
