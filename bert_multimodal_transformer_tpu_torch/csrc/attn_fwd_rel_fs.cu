// Flash-streamed rel-attention forward for Hopper (sm_90a): the long
// MAG-XLNet forward over an assembled score bias, where the ingredients
// kernels (#23/#24) do not apply (rel_bias_impl "stream", bi_data, uni
// attention, long memory under "stream") past the head-blocked reach.
//
// Replaces the TPU kernel `_attn_fwd_rel_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1661).
//
// What it computes, per batch row b, head h and query row q, from q
// [B, Q, D], k and v [B, K, D] (head-major columns h·Dh + c) and the score
// bias ebias [B, H, Q, K], all in the input dtype, over key blocks of
// kKBlock in order: the online softmax of
//   s = (q · k in fp32) · scale + ebias    (the bias added in fp32)
// with a running max m, a denominator l and a rescaled fp32 accumulator:
//   m' = max(m, max_k s);  α = exp(m − m');  e = exp(s − m');
//   l  ← l · α + Σ_k e    (the undropped e)
//   e  ← keep ? e · inv_keep : 0 at rate > 0 (common.cuh's Philox stream
//        at counter (k >> 2, q, h, b), k the global key index, so every
//        rel tier drops the same elements for one seed)
//   acc ← acc · α + T(e) · V_block   (e rounded to the input dtype)
// then out [B, Q, D] = T(acc / l) and lse [B, H, Q] = m + log l (fp32), the
// residual #17 rebuilds p from. A masked key carries −1e30 in ebias, which
// stays finite: a key block masked whole leaves m finite, and the next
// real block's α = exp(−1e30 − m') is 0, never NaN. A row masked whole
// comes out uniform, as the whole-row tiers give it.
//
// What bounds it on the card: at the driver's stream path (B=48, Q=K=1024,
// H=12, Dh=64) ebias alone is 1.21 GB of the ≈1.51 GB read or written
// once; the two products are 4·B·H·Q·K·Dh ≈ 155 GFLOP: bytes bound at the
// bf16 tensor-core peak (0.45 ms against 0.16 ms for the operations).
//
// What the design does about that: #6's plan with separate q and k/v rows
// and the bias read per element: one block per (64-row q tile, head,
// batch row) holds its q tile, streams k and v in 64-row key blocks and
// reads each [64][64] ebias slice once, coalesced along the keys, into the
// score tile; the accumulators live in registers. Nothing Q·K-sized is
// written. Any Q and any K are taken, the ragged last tiles bounds-checked
// (the TPU kernel needs Q and K % 128 == 0; memory makes K = mem_len + Q).
// Shared plan: 49 KB at Dh = 64, 81 KB at Dh = 128; B·H·Q/64 = 9216 blocks
// at the driver's shape. The dots run on the CUDA cores in fp32, as #6's.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kQTile = 64;     // query rows per block
constexpr int kKBlock = 64;    // ops/fused_attention.py::FS_KEY_BLOCK
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;

// q tile [kQTile][dh], k/v block [kKBlock][dh + 1], scores
// [kQTile][kKBlock], the rows' m, l and α [kQTile] each.
__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)kQTile * dh + (size_t)kKBlock * (dh + 1) +
         (size_t)kQTile * kKBlock + 3 * (size_t)kQTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_rel_fs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ ebias, T* __restrict__ out,
                           float* __restrict__ lse, int Q, int K, int H,
                           int Dh, float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ldkv = Dh + 1;

  float* qs = smem;                        // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;           // [kKBlock][Dh + 1]
  float* ss = kvs + kKBlock * ldkv;        // [kQTile][kKBlock]
  float* m_s = ss + kQTile * kKBlock;      // [kQTile] running max
  float* l_s = m_s + kQTile;               // [kQTile] running denominator
  float* alpha_s = l_s + kQTile;           // [kQTile] this block's rescale

  const T* q_src = q + ((size_t)b * Q + q0) * D + h * Dh;
  const T* k_src = k + (size_t)b * K * D + h * Dh;
  const T* v_src = v + (size_t)b * K * D + h * Dh;
  const T* eb_rows = ebias + (((size_t)b * H + h) * Q + q0) * K;
  const int q_rows = min(kQTile, Q - q0);

  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? attn::to_float(q_src[(size_t)r * D + c]) : 0.0f;
  }
  for (int r = tid; r < kQTile; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKBlock) {
    const int k_rows = min(kKBlock, K - k0);
    __syncthreads();  // the previous block's PV readers are done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(k_src[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
    // s = (q · k) · scale + ebias, as the whole-row rel tiers.
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float dot = 0.0f;
      for (int c = 0; c < Dh; ++c) dot = fmaf(qr[c], kr[c], dot);
      ss[r * kKBlock + j] = __fadd_rn(
          __fmul_rn(dot, scale),
          attn::to_float(eb_rows[(size_t)r * K + k0 + j]));
    }
    __syncthreads();
    // The online softmax step, one warp per row.
    for (int r = warp; r < q_rows; r += kThreads / 32) {
      float* sr = ss + r * kKBlock;
      float mx = -INFINITY;
      for (int j = lane; j < k_rows; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
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
        const int qi = q0 + r;
        for (int j0 = 4 * lane; j0 < k_rows; j0 += 128) {
          const uint4 bits =
              attn::dropout_bits4(drop.seed, b, h, qi, (k0 + j0) >> 2);
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
        alpha_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // k no longer needed: stage v
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(v_src[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
    // acc ← acc · α + T(e) · V_block
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kQTile * Dh && r < q_rows) {
        const float* er = ss + r * kKBlock;
        float pv = 0.0f;
        for (int j = 0; j < k_rows; ++j)
          pv = fmaf(er[j], kvs[j * ldkv + c], pv);
        acc[a] = __fadd_rn(__fmul_rn(acc[a], alpha_s[r]), pv);
      }
    }
  }
  T* out_rows = out + ((size_t)b * Q + q0) * D + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kQTile * Dh && r < q_rows)
      out_rows[(size_t)r * D + c] = attn::from_float<T>(acc[a] / l_s[r]);
  }
  for (int r = tid; r < q_rows; r += kThreads)
    lse[((size_t)b * H + h) * Q + q0 + r] = __fadd_rn(m_s[r], logf(l_s[r]));
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, void* lse, int B, int Q, int K, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_fs_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_fs_kernel<T, kDropout>
      <<<grid, kThreads, smem_floats(Dh) * sizeof(float), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ebias),
          static_cast<T*>(out), static_cast<float*>(lse), Q, K, H, Dh, scale,
          drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* ebias,
             void* out, void* lse, int B, int Q, int K, int H, int Dh,
             float scale, bool dropout, DropoutArgs drop, cudaStream_t st) {
  if (dropout)
    return launch<T, true>(q, k, v, ebias, out, lse, B, Q, K, H, Dh, scale,
                           drop, st);
  return launch<T, false>(q, k, v, ebias, out, lse, B, Q, K, H, Dh, scale,
                          drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ebias and out alike). out is
// [B, Q, D], lse [B, H, Q] fp32. dropout = 0 ignores seed/threshold/
// inv_keep. Returns the cudaError_t of the launch (0 on success).
int attn_fwd_rel_fs(const void* q, const void* k, const void* v,
                    const void* ebias, void* out, void* lse, int B, int Q,
                    int K, int H, int Dh, float scale, int dropout,
                    unsigned long long seed, unsigned int threshold,
                    float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, ebias, out, lse, B, Q, K, H, Dh, scale,
                             dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, ebias, out, lse, B, Q, K, H,
                                     Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
