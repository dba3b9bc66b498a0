// Packed-layout attention backward from saved probs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_packed_saved_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1108), taken when
// the forward saved p and pd (`fused_attention_packed` with save on: the
// default while the prob residuals stay under 256 MB).
//
// What it computes, per batch row b and head h, from the saved probs p and
// pd [B, H, S, S] (input dtype; pd is p when the rate was 0), qkv
// [B, S, 3D] and the context gradient g [B, S, D]:
//   dV   = pdᵀ · g_h                        (fp32 accumulate)
//   d(pd) = g_h · V_hᵀ                       (fp32)
//   t    = pd ⊙ d(pd);  ds = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K_h,   dK = ds_cᵀ · Q_h
// written into dqkv [B, S, 3D] at the columns q, k, v came from (dQ, then
// dK, then dV). No QK product, no softmax, no random draws.
//
// What bounds it on the card: at B=256, S=50, H=12, Dh=64 it is four
// S×S×Dh products per (b, h), ~2 GFLOP in all, over ~40 MB of qkv/g/dqkv
// plus ~31 MB of saved probs: 0.0503 ms at 3.35 TB/s, bytes-bound once the
// products leave the fp32 CUDA cores (as scalar loops they took 0.66 ms).
// dQ reduces over keys while dK and dV reduce over queries.
//
// What the design does about that: one block per (head, batch row) holds
// the whole [S, S] problem in shared memory, so every reduction stays
// inside the block, there are no atomics and the result is
// bit-reproducible; B·H = 3072 blocks fill the 132 SMs. bf16 runs
// attn_full_tc.cuh's tensor-core plan: Q, K, V, g and pd staged as bf16,
// each warp 16 query rows for d(pd) = g·Vᵀ, the softmax VJP and dQ (ds_c
// never leaving the registers on its way to dQ), then 16 keys for dV and
// dK by ldmatrix.trans. fp32 keeps the CUDA-core code, common.cuh's
// `bwd_saved_head` (the recompute backward's plan, which #10 and #19 run
// too): pd staged in shared memory, p read once row by row, scalar fp32
// products. Both reach S = max_bwd_seq_len(Dh) (140 at Dh = 64, 117 at
// Dh = 128), the fp32 plan's limit. A bf16 call always launches the
// tensor-core kernel or returns the launch's error.

#include "attn_full_tc.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_saved_kernel(const T* __restrict__ p,
                                 const T* __restrict__ pd,
                                 const T* __restrict__ qkv,
                                 const T* __restrict__ g,
                                 T* __restrict__ dqkv, int S, int H, int Dh,
                                 float scale) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row_stride = (size_t)3 * D;
  const T* q = qkv + (size_t)b * S * row_stride + h * Dh;
  T* dq = dqkv + (size_t)b * S * row_stride + h * Dh;
  const attn::BwdHead<T> hd{q,       q + D,  q + 2 * D,
                            row_stride,
                            g + (size_t)b * S * D + h * Dh,
                            (size_t)D,
                            dq,      dq + D, dq + 2 * D,
                            row_stride,
                            nullptr, b,      h};
  const size_t head = ((size_t)b * H + h) * S * S;
  attn::bwd_saved_head<T>(smem, hd, p + head, pd + head, S, Dh, scale);
}

template <typename T>
int launch(const void* p, const void* pd, const void* qkv, const void* g,
           void* dqkv, int B, int S, int H, int Dh, float scale,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_packed_saved_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::bwd_smem_floats(S, Dh) * sizeof(float);
  attn_bwd_packed_saved_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(pd),
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), S, H, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd are the saved
// probs [B, H, S, S] (the same pointer twice when the rate was 0), g the
// context gradient [B, S, D], dqkv the packed gradient [B, S, 3D].
// Returns the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_packed_saved(const void* p, const void* pd, const void* qkv,
                          const void* g, void* dqkv, int B, int S, int H,
                          int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      attn::bwd_smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(p, pd, qkv, g, dqkv, B, S, H, Dh, scale, st);
    case 1: {
      // The tensor-core plan of attn_full_tc.cuh.
      using bf16 = __nv_bfloat16;
      const int D = H * Dh;
      const bf16* q = static_cast<const bf16*>(qkv);
      bf16* dq = static_cast<bf16*>(dqkv);
      const full_tc::BwdGeom geom{q,
                                  q + D,
                                  q + 2 * D,
                                  (long long)S * 3 * D,
                                  Dh,
                                  3 * D,
                                  static_cast<const bf16*>(g),
                                  (long long)S * D,
                                  Dh,
                                  D,
                                  dq,
                                  dq + D,
                                  dq + 2 * D,
                                  (long long)S * 3 * D,
                                  Dh,
                                  3 * D,
                                  static_cast<const bf16*>(p),
                                  static_cast<const bf16*>(pd)};
      return full_tc::launch_bwd(geom, B, S, H, Dh, scale, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
