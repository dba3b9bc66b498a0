// Split-layout attention backward with probs recomputed, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:905, launched by
// `_bwd_pallas` :1882), taken when the split forward saved no probs
// (`fused_attention` with save off: past the 256 MB residual cap, or
// FUSED_ATTN_SAVE=0).
//
// What it computes, per batch row b and head h, from q, k, v [B, H, S, Dh],
// the fp32 mask [B, S], the context gradient g [B, H, S, Dh] and the
// forward's seed:
//   p    = the forward's fp32 softmax of (q · kᵀ) · scale + bias, recomputed
//          with attn_fwd_split.cu's op order
//   pd   = keep ? p · inv_keep : 0, the keep mask replayed from the Philox
//          stream at the forward's counter (k >> 2, q, h + h_off, b + b_off)
//   dV   = T(pd)ᵀ · g;  d(pd) = g · Vᵀ;  t = pd ⊙ d(pd)
//   ds   = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q
// into dq, dk, dv [B, H, S, Dh] (the TPU kernel's three outputs). This is
// #2's function (attn_bwd_packed.cu) on the split layout.
//
// What bounds it on the card: as #2, five S×S×Dh products per (b, h), ~2.4
// GFLOP at bert-base B=256 S=50 over ~30 MB of q, k, v, g and the three
// gradients: latency-bound. dQ reduces over keys while dK and dV reduce
// over queries.
//
// What the design does about that: bf16 runs on the tensor cores
// (attn_full_tc.cuh's `attn_full_tc_bwd_recompute_kernel`, #2's kernel too:
// #1's score and softmax code in front, so p has the forward's bits, the
// keep bit replayed by #1's lane pairs at the shard's offsets, then #3's
// phases on mma.sync). fp32 keeps the CUDA-core kernel below and its bits:
// #2's plan and code, common.cuh's `bwd_recompute_head`, one block per
// (head, batch row) holding the whole [S, S] problem in shared memory, so
// every reduction stays inside the block, with no atomics and
// bit-reproducible results; the keep bit rides in the sign of P. Here the
// head's rows are contiguous (row stride Dh). Both plans fit 227 KB up to S
// = 140 at Dh = 64 (S = 117 at Dh = 128); the Python wrapper's `split_tier`
// sends longer sequences to the einsum branch before any launch. A bf16
// call always launches the tensor-core kernel or returns the launch's error
// (cudaErrorMisalignedAddress where q, k, v or g does not start on the 16
// bytes cp.async copies).

#include "attn_full_tc.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ mask,
                          const T* __restrict__ g, T* __restrict__ dq,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int H, int Dh, float scale, int b_off, int h_off,
                          DropoutArgs drop) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t off = ((size_t)b * H + h) * S * Dh;
  const size_t ld = (size_t)Dh;
  const attn::BwdHead<T> hd{q + off,  k + off,  v + off,  ld,
                            g + off,  ld,
                            dq + off, dk + off, dv + off, ld,
                            mask ? mask + (size_t)b * S : nullptr,
                            b + b_off, h + h_off};
  attn::bwd_recompute_head<T, kDropout>(smem, hd, S, Dh, scale, drop);
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, void* dq, void* dk, void* dv, int B, int S, int H,
           int Dh, float scale, int b_off, int h_off, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_split_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::bwd_smem_floats(S, Dh) * sizeof(float);
  attn_bwd_split_kernel<T, kDropout><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, Dh, scale, b_off, h_off, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             const void* g, void* dq, void* dk, void* dv, int B, int S,
             int H, int Dh, float scale, int b_off, int h_off, bool dropout,
             DropoutArgs drop, cudaStream_t st) {
  if (dropout)
    return launch<T, true>(q, k, v, mask, g, dq, dk, dv, B, S, H, Dh, scale,
                           b_off, h_off, drop, st);
  return launch<T, false>(q, k, v, mask, g, dq, dk, dv, B, S, H, Dh, scale,
                          b_off, h_off, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, g and the gradients, all
// [B, H, S, Dh]. mask may be null (no padding). dropout = 0 ignores
// seed/threshold/inv_keep; b_off/h_off are the forward's. Returns the
// cudaError_t of the launch (0 on success); a shape past the shared-memory
// plan returns cudaErrorInvalidValue.
int attn_bwd_split(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, void* dq, void* dk,
                   void* dv, int B, int S, int H, int Dh, float scale,
                   int dropout, unsigned long long seed,
                   unsigned int threshold, float inv_keep, int b_off,
                   int h_off, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      b_off < 0 || h_off < 0 ||
      attn::bwd_smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, mask, g, dq, dk, dv, B, S, H, Dh, scale,
                             b_off, h_off, dropout != 0, drop, st);
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
                                  nullptr,
                                  nullptr};
      return full_tc::launch_bwd_recompute(
          geom, static_cast<const float*>(mask), B, S, H, Dh, scale,
          dropout != 0, b_off, h_off, drop, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
