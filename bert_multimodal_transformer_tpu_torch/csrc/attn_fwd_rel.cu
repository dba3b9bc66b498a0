// Rel-attention forward with a full score bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_rel_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1413), the XLNet
// content and query streams' attention, in all its modes: serving (rate 0,
// nothing saved) and training (prob dropout at rate > 0, and with `save`
// the probs p and pd written for the backward).
//
// What it computes, per batch row b and head h:
//   q     [B, Q, D], k, v [B, K, D]   head-major columns h·Dh + c
//   ebias [B, H, Q, K]                the score bias assembled outside
//                                      (rel-shifted bd + segment ef − 1e30
//                                      · mask), in the input dtype
//   s    = (q_h · k_hᵀ accumulated in fp32) · scale + ebias[b, h]  (scale
//          after the dot, then the bias, as the TPU kernel)
//   p    = fp32 max-subtracted softmax over the keys (a row masked whole
//          comes out uniform, not NaN)
//   save: p_out[b, h] = T(p)
//   rate > 0: p ← keep ? p · inv_keep : 0 in fp32, keep from the Philox
//          stream of common.cuh at counter (k >> 2, q, h, b); save:
//          pd_out[b, h] = T(p)
//   out  [B, Q, D] = T(p) · v_h accumulated in fp32
// Input dtypes: fp32 and bf16, one for all tensors. Dh a multiple of 8 up
// to 128, K up to 512, any Q.
//
// What bounds it on the card: at XLNet's training shape (B=256, Q=K=50,
// H=12, Dh=64) the op is ~2 GFLOP over ~36 MB (q, k, v, the 15 MB ebias,
// out) plus 31 MB of saved probs: small next to the step's GEMMs, so its
// time is set by latency (the dependent load → dot → softmax → dot chain in
// each block) and by keeping the 132 SMs busy, not by HBM or tensor-core
// rate. Against its packed twin (attn_fwd_packed.cu) it reads the ebias
// row per element in place of a [S] mask bias: one more coalesced read of
// B·H·Q·K elements.
//
// What the design does about that: attn_fwd_packed.cu's plan, with q and
// k/v read from their own tensors (row stride D) so Q ≠ K works: one block
// per (q-tile of 16 rows, head, batch row), 6144 blocks at the serving
// shape; the q tile in shared memory, k_h and v_h streamed in 64-row chunks
// by stride (no head transpose in device memory); the tile's scores in
// shared memory (at most 16 × 512 fp32). Each lane draws one Philox block
// for 4 consecutive keys. The dots run on the CUDA cores in fp32: a
// tensor-core (`wgmma`) version is later work.

#include "common.cuh"

#include <cmath>

namespace {

using attn::DropoutArgs;
using attn::from_float;
using attn::round_to;
using attn::to_float;

constexpr int kThreads = 256;  // 8 warps
constexpr int kQTile = 16;     // query rows per block
constexpr int kKChunk = 64;    // key/value rows staged in shared memory
constexpr int kMaxDh = 128;
constexpr int kMaxK = 512;
constexpr int kAccPerThread = (kQTile * kMaxDh + kThreads - 1) / kThreads;

// Shared memory in floats: q tile [kQTile][dh], k/v chunk [kKChunk][dh + 1],
// scores [kQTile][k_len].
__host__ __device__ inline size_t smem_floats(int k_len, int dh) {
  return (size_t)kQTile * dh + (size_t)kKChunk * (dh + 1) +
         (size_t)kQTile * k_len;
}

template <typename T, bool kDropout, bool kSave>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_rel_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ ebias,
                        T* __restrict__ out, T* __restrict__ p_out,
                        T* __restrict__ pd_out, int Q, int K, int H, int Dh,
                        float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;

  float* qs = smem;                            // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;               // [kKChunk][Dh + 1]
  float* ps = kvs + kKChunk * ldkv;            // [kQTile][K]

  const T* q_base = q + (size_t)b * Q * D + h * Dh;
  const T* k_base = k + (size_t)b * K * D + h * Dh;
  const T* v_base = v + (size_t)b * K * D + h * Dh;
  // row q of ebias[b, h] and of the saved probs starts at head_row + q·K
  const size_t head_row = ((size_t)b * H + h) * Q;
  const int q_rows = min(kQTile, Q - q0);

  // q tile; rows past Q are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(q_base[(size_t)(q0 + r) * D + c]) : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + ebias[q0 + r][j], over K in
  // chunks.
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    const int k_rows = min(kKChunk, K - k0);
    __syncthreads();  // previous chunk's readers are done (and qs set)
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(k_base[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float acc = 0.0f;
      for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      const float eb =
          to_float(ebias[(head_row + q0 + r) * K + k0 + j]);
      // Scale after the dot, then add the bias, in this order.
      ps[r * K + k0 + j] = __fadd_rn(__fmul_rn(acc, scale), eb);
    }
  }
  __syncthreads();

  // fp32 max-subtracted softmax, one warp per row; probs rounded to T.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < q_rows; r += kThreads / 32) {
    float* pr = ps + r * K;
    float m = -INFINITY;
    for (int j = lane; j < K; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < K; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout && !kSave) {
      for (int j = lane; j < K; j += 32) pr[j] = round_to<T>(pr[j] / sum);
    } else {
      // Training modes: each lane takes 4 consecutive keys, one Philox
      // block for the 4 draws.
      const int qi = q0 + r;
      const size_t prow = (head_row + qi) * K;
      for (int j0 = 4 * lane; j0 < K; j0 += 128) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kDropout)
          bits = attn::dropout_bits4(drop.seed, b, h, qi, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < K) {
            float p = pr[j] / sum;
            if constexpr (kSave) p_out[prow + j] = from_float<T>(p);
            if constexpr (kDropout) {
              p = attn::word(bits, u) >= drop.threshold
                      ? __fmul_rn(p, drop.inv_keep)
                      : 0.0f;
              if constexpr (kSave) pd_out[prow + j] = from_float<T>(p);
            }
            pr[j] = round_to<T>(p);
          }
        }
      }
    }
  }

  // out[r][c] = Σ_j p[r][j] · v_j[c], fp32 accumulators in registers.
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    const int k_rows = min(kKChunk, K - k0);
    __syncthreads();  // softmax / previous chunk done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(v_base[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      if (i < kQTile * Dh) {
        const int r = i / Dh, c = i - r * Dh;
        if (r < q_rows) {
          const float* pr = ps + r * K + k0;
          float s_acc = acc[a];
          for (int j = 0; j < k_rows; ++j)
            s_acc = fmaf(pr[j], kvs[j * ldkv + c], s_acc);
          acc[a] = s_acc;
        }
      }
    }
  }
  T* out_base = out + (size_t)b * Q * D + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        out_base[(size_t)(q0 + r) * D + c] = from_float<T>(acc[a]);
    }
  }
}

template <typename T, bool kDropout, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, void* p, void* pd, int B, int Q, int K, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_kernel<T, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(K, Dh) * sizeof(float);
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_kernel<T, kDropout, kSave><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ebias),
      static_cast<T*>(out), static_cast<T*>(p), static_cast<T*>(pd), Q, K, H,
      Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* ebias,
             void* out, void* p, void* pd, int B, int Q, int K, int H,
             int Dh, float scale, bool dropout, DropoutArgs drop,
             cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch<T, true, true>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                                 scale, drop, st);
  if (dropout)
    return launch<T, true, false>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                                  scale, drop, st);
  if (save)
    return launch<T, false, true>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                                  scale, drop, st);
  return launch<T, false, false>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                                 scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, ebias, out, p and pd.
// p/pd: null for no save; with save, p gets the pre-dropout probs and,
// when dropout is on, pd the dropped and scaled ones ([B, H, Q, K]).
// dropout = 0 ignores seed/threshold/inv_keep. Returns the cudaError_t of
// the launch (0 on success). The Python wrapper checks the shapes; they are
// checked again here so that no call can index past the shared-memory plan.
int attn_fwd_rel(const void* q, const void* k, const void* v,
                 const void* ebias, void* out, void* p, void* pd, int B,
                 int Q, int K, int H, int Dh, float scale, int dropout,
                 unsigned long long seed, unsigned int threshold,
                 float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dropout && p != nullptr && pd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                             scale, dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, ebias, out, p, pd, B, Q, K, H,
                                     Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
