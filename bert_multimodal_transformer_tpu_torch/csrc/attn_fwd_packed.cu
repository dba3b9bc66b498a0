// Packed-layout attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_packed_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:996) in all its
// modes: serving (rate = 0, nothing saved) and training (prob dropout at
// rate > 0, and with `save` the probs p and pd written for the backward).
//
// What it computes, per batch row b and head h:
//   qkv  [B, S, 3D]  column packing i·D + h·Dh + c (q, then k, then v)
//   bias [S]         (1 − mask) · −10000, formed here from the fp32 mask
//   s    = (Q_h · K_hᵀ accumulated in fp32) · scale + bias   (scale after
//          the dot, as the TPU kernel)
//   p    = fp32 max-subtracted softmax over the keys
//   save: p_out[b, h] = T(p)                            ([B, H, S, S])
//   rate > 0: p ← keep ? p · inv_keep : 0 in fp32, keep from the Philox
//          stream of common.cuh (the TPU kernel's `jnp.where(bits >=
//          thresh, p * inv_keep, 0.0)`); save: pd_out[b, h] = T(p)
//   out  [B, S, D]   = T(p) · V_h accumulated in fp32, written in the input
//          dtype at columns h·Dh + c
// Input dtypes: fp32 and bf16. Dh a multiple of 8 up to 128, S up to 512.
// The serving instantiation (no dropout, no save) is the same code as
// before the training modes were added; the modes are template flags.
//
// What bounds it on the card: at the serving shape (B=128, S=50, H=12,
// Dh=64) the op is ~1 GFLOP and moves ~10 MB (the [B,S,3D] projection in,
// [B,S,D] out): a small op next to the QKV and FFN GEMMs around it, so its
// time is set by latency (launch, the dependent load → dot → softmax → dot
// chain inside each block) and by how many blocks keep the 132 SMs busy,
// not by HBM bandwidth or tensor-core rate. In training at B=256 with
// `save`, writing p and pd adds 2 · B·H·S²·2 B ≈ 31 MB, about 10 µs of
// HBM time, and the Philox draws ~10 integer rounds per 4 elements.
//
// What the design does about that: one block per (q-tile of 16 rows, head,
// batch row) gives B·H·ceil(S/16) = 6144 independent blocks at the serving
// shape, enough to fill every SM several times over. Each block reads its
// Q tile and streams K_h and V_h in 64-row chunks straight from the packed
// projection by stride, so no head transpose reaches device memory, and no
// [B,H,S,S] tensor either unless `save` asks for it. Scores for the tile
// live in shared memory (at most 16 × 512 fp32); the ragged edges (S = 50
// is not a multiple of 16 or 64) are masked by bounds checks. Each lane
// draws one Philox block for 4 consecutive keys and writes p/pd for them.
// The dots run on the CUDA cores in fp32: a tensor-core (`wgmma`) version
// with TMA loads is later work.

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
constexpr int kMaxS = 512;
// Each thread owns ceil(kQTile * kMaxDh / kThreads) output accumulators.
constexpr int kAccPerThread = (kQTile * kMaxDh + kThreads - 1) / kThreads;

// Shared memory in floats: Q tile [kQTile][dh], K/V chunk
// [kKChunk][dh + 1] (the +1 pad keeps the per-key rows on distinct banks),
// scores [kQTile][s], bias [s].
__host__ __device__ inline size_t smem_floats(int s, int dh) {
  return (size_t)kQTile * dh + (size_t)kKChunk * (dh + 1) +
         (size_t)kQTile * s + (size_t)s;
}

template <typename T, bool kDropout, bool kSave>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_packed_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ mask,
                           T* __restrict__ out, T* __restrict__ p_out,
                           T* __restrict__ pd_out, int S, int H, int Dh,
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
  float* ps = kvs + kKChunk * ldkv;            // [kQTile][S]
  float* bias = ps + kQTile * S;               // [S]

  const size_t row_stride = (size_t)3 * D;
  const T* base = qkv + (size_t)b * S * row_stride;
  const int q_rows = min(kQTile, S - q0);

  // Mask bias, as the TPU entry forms it: (1 − m) · −10000.
  for (int j = tid; j < S; j += kThreads) {
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + j]) * -10000.0f : 0.0f;
  }
  // Q tile; rows past S are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(base[(size_t)(q0 + r) * row_stride +
                                       h * Dh + c])
                       : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + bias[j], over K in chunks.
  for (int k0 = 0; k0 < S; k0 += kKChunk) {
    const int k_rows = min(kKChunk, S - k0);
    __syncthreads();  // previous chunk's readers are done (and qs/bias set)
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] =
          to_float(base[(size_t)(k0 + r) * row_stride + D + h * Dh + c]);
    }
    __syncthreads();
    for (int i = tid; i < kQTile * k_rows; i += kThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float acc = 0.0f;
      for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      // Scale after the dot, then add the bias, in this order.
      ps[r * S + k0 + j] = __fadd_rn(__fmul_rn(acc, scale), bias[k0 + j]);
    }
  }
  __syncthreads();

  // fp32 max-subtracted softmax, one warp per row; probs rounded to T.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < q_rows; r += kThreads / 32) {
    float* pr = ps + r * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout && !kSave) {
      for (int j = lane; j < S; j += 32) pr[j] = round_to<T>(pr[j] / sum);
    } else {
      // Training modes: each lane takes 4 consecutive keys, one Philox
      // block for the 4 draws.
      const int q = q0 + r;
      const size_t prow = (((size_t)b * H + h) * S + q) * S;
      for (int j0 = 4 * lane; j0 < S; j0 += 128) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kDropout)
          bits = attn::dropout_bits4(drop.seed, b, h, q, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < S) {
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
  for (int k0 = 0; k0 < S; k0 += kKChunk) {
    const int k_rows = min(kKChunk, S - k0);
    __syncthreads();  // softmax / previous chunk done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(
          base[(size_t)(k0 + r) * row_stride + 2 * D + h * Dh + c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      if (i < kQTile * Dh) {
        const int r = i / Dh, c = i - r * Dh;
        if (r < q_rows) {
          const float* pr = ps + r * S + k0;
          float s_acc = acc[a];
          for (int j = 0; j < k_rows; ++j)
            s_acc = fmaf(pr[j], kvs[j * ldkv + c], s_acc);
          acc[a] = s_acc;
        }
      }
    }
  }
  T* out_base = out + (size_t)b * S * D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        out_base[(size_t)(q0 + r) * D + h * Dh + c] = from_float<T>(acc[a]);
    }
  }
}

template <typename T, bool kDropout, bool kSave>
int launch(const void* qkv, const void* mask, void* out, void* p, void* pd,
           int B, int S, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in.
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_kernel<T, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(S, Dh) * sizeof(float);
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_kernel<T, kDropout, kSave><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<T*>(p), static_cast<T*>(pd), S, H, Dh,
      scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const void* mask, void* out, void* p, void* pd,
             int B, int S, int H, int Dh, float scale, bool dropout,
             DropoutArgs drop, cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch<T, true, true>(qkv, mask, out, p, pd, B, S, H, Dh, scale,
                                 drop, st);
  if (dropout)
    return launch<T, true, false>(qkv, mask, out, p, pd, B, S, H, Dh, scale,
                                  drop, st);
  if (save)
    return launch<T, false, true>(qkv, mask, out, p, pd, B, S, H, Dh, scale,
                                  drop, st);
  return launch<T, false, false>(qkv, mask, out, p, pd, B, S, H, Dh, scale,
                                 drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding).
// p/pd: null for no save; with save, p gets the pre-dropout probs and,
// when dropout is on, pd the dropped and scaled ones ([B, H, S, S] in the
// input dtype). dropout = 0 ignores seed/threshold/inv_keep.
// Returns the cudaError_t of the launch (0 on success). The shape limits
// are checked by the Python wrapper; they are checked again here so that
// no call can index past the shared-memory plan.
int attn_fwd_packed(const void* qkv, const void* mask, void* out, void* p,
                    void* pd, int B, int S, int H, int Dh, float scale,
                    int dropout, unsigned long long seed,
                    unsigned int threshold, float inv_keep, int dtype,
                    void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dropout && p != nullptr && pd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(qkv, mask, out, p, pd, B, S, H, Dh, scale,
                             dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(qkv, mask, out, p, pd, B, S, H, Dh,
                                     scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
