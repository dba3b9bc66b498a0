// Split-layout attention backward from saved probs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_saved_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:962, launched by
// `_bwd_saved_pallas` :1910), taken when the split forward saved p and pd
// (`fused_attention` with save on: the default while the prob residuals
// stay under 256 MB). It is the backward of tensor-parallel MAG-BERT
// training with head-sharded attention.
//
// What it computes, per batch row b and head h, from the saved probs p and
// pd [B, H, S, S] (input dtype; pd is p when the rate was 0), q, k, v and
// the context gradient g [B, H, S, Dh]:
//   dV   = pdᵀ · g;  d(pd) = g · Vᵀ;  t = pd ⊙ d(pd)
//   ds   = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q
// into dq, dk, dv [B, H, S, Dh]. No QK product, no softmax, no random
// draws. This is #3's function (attn_bwd_packed_saved.cu) on the split
// layout.
//
// What bounds it on the card: as #3, four S×S×Dh products per (b, h), ~2
// GFLOP at bert-base B=256 S=50 over ~30 MB of q, k, v, g and gradients
// plus ~31 MB of saved probs: latency-bound.
//
// What the design does about that: #3's plans and code on strides: one
// block per (head, batch row) holds the whole [S, S] problem in shared
// memory, every reduction inside the block, no atomics, bit-reproducible.
// bf16 runs attn_full_tc.cuh's tensor-core plan, fp32 common.cuh's
// `bwd_saved_head` (scalar fp32 products). The head's rows are contiguous
// (row stride Dh). Up to S = 140 at Dh = 64; #10 gives #3's bits on the
// same q, k, v.

#include "attn_full_tc.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_split_saved_kernel(const T* __restrict__ p,
                                const T* __restrict__ pd,
                                const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ g, T* __restrict__ dq,
                                T* __restrict__ dk, T* __restrict__ dv, int S,
                                int H, int Dh, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = (size_t)b * H + h;
  const size_t off = head * S * Dh;
  const size_t ld = (size_t)Dh;
  const attn::BwdHead<T> hd{q + off,  k + off,  v + off,  ld,
                            g + off,  ld,
                            dq + off, dk + off, dv + off, ld,
                            nullptr,  b,        h};
  attn::bwd_saved_head<T>(smem, hd, p + head * S * S, pd + head * S * S, S,
                          Dh, scale);
}

template <typename T>
int launch(const void* p, const void* pd, const void* q, const void* k,
           const void* v, const void* g, void* dq, void* dk, void* dv, int B,
           int S, int H, int Dh, float scale, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_split_saved_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::bwd_smem_floats(S, Dh) * sizeof(float);
  attn_bwd_split_saved_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(pd),
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), S, H, Dh,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd are the saved
// probs [B, H, S, S] (the same pointer twice when the rate was 0); q, k, v,
// g and the gradients [B, H, S, Dh]. Returns the cudaError_t of the launch
// (0 on success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue.
int attn_bwd_split_saved(const void* p, const void* pd, const void* q,
                         const void* k, const void* v, const void* g,
                         void* dq, void* dk, void* dv, int B, int S, int H,
                         int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      attn::bwd_smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(p, pd, q, k, v, g, dq, dk, dv, B, S, H, Dh, scale,
                           st);
    case 1: {
      // The tensor-core plan of attn_full_tc.cuh.
      using bf16 = __nv_bfloat16;
      const long long head = (long long)S * Dh;
      const full_tc::BwdGeom geom{static_cast<const bf16*>(q),
                                  static_cast<const bf16*>(k),
                                  static_cast<const bf16*>(v),
                                  head * H,
                                  head,
                                  Dh,
                                  static_cast<const bf16*>(g),
                                  head * H,
                                  head,
                                  Dh,
                                  static_cast<bf16*>(dq),
                                  static_cast<bf16*>(dk),
                                  static_cast<bf16*>(dv),
                                  head * H,
                                  head,
                                  Dh,
                                  static_cast<const bf16*>(p),
                                  static_cast<const bf16*>(pd)};
      return full_tc::launch_bwd(geom, B, S, H, Dh, scale, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
