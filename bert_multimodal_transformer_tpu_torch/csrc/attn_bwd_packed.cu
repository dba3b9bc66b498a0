// Packed-layout attention backward with probs recomputed, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_packed_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1051), taken when
// the forward saved no probs (`fused_attention_packed` with save off: past
// the 256 MB residual cap, or FUSED_ATTN_SAVE=0).
//
// What it computes, per batch row b and head h, from qkv [B, S, 3D], the
// fp32 mask, the context gradient g [B, S, D] and the forward's seed:
//   p    = the forward's fp32 softmax of (Q_h · K_hᵀ) · scale + bias,
//          recomputed with the same op order as attn_fwd_packed.cu
//   pd   = keep ? p · inv_keep : 0, the keep mask replayed from the same
//          Philox stream (common.cuh); pd = p at rate 0
//   dV   = T(pd)ᵀ · g_h                      (pd_c, fp32 accumulate)
//   d(pd) = g_h · V_hᵀ                        (fp32)
//   t    = pd ⊙ d(pd);  ds = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K_h,   dK = ds_cᵀ · Q_h
// written into dqkv [B, S, 3D] at the columns q, k, v came from (dQ, then
// dK, then dV, as the TPU kernel's `concatenate(dqs + dks + dvs)`).
//
// What bounds it on the card: at B=256, S=50, H=12, Dh=64 the backward is
// five S×S×Dh products per (b, h), ~2.4 GFLOP in all, over ~40 MB of
// qkv/g/dqkv traffic: a small, latency-bound op next to the training
// step's GEMMs, like the forward. dQ reduces over keys while dK and dV
// reduce over queries, so a split over query tiles would need a second
// pass or atomics.
//
// What the design does about that: one block per (head, batch row) holds
// the whole [S, S] problem in shared memory (common.cuh's plan and code,
// `bwd_recompute_head`, which the split-layout #9 runs too: two [S][Dh+1]
// staging tiles, the fp32 probs P and the gradient tile Tt), so
// every reduction stays inside the block, there are no atomics, and the
// result is bit-reproducible. B·H = 3072 blocks fill the 132 SMs. The
// keep bit of each element rides in the sign of its P entry (p >= 0), so
// the mask costs no extra memory. The plan fits 227 KB up to S = 140 at
// Dh = 64 (S = 117 at Dh = 128); the Python wrapper refuses longer
// sequences at the forward when a gradient will be needed. The products
// run on the CUDA cores in fp32; tensor cores are later work.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ mask,
                           const T* __restrict__ g, T* __restrict__ dqkv,
                           int S, int H, int Dh, float scale,
                           DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row_stride = (size_t)3 * D;
  const T* q = qkv + (size_t)b * S * row_stride + h * Dh;
  T* dq = dqkv + (size_t)b * S * row_stride + h * Dh;
  const attn::BwdHead<T> hd{q,      q + D,  q + 2 * D,
                            row_stride,
                            g + (size_t)b * S * D + h * Dh,
                            (size_t)D,
                            dq,     dq + D, dq + 2 * D,
                            row_stride,
                            mask ? mask + (size_t)b * S : nullptr,
                            b,      h};
  attn::bwd_recompute_head<T, kDropout>(smem, hd, S, Dh, scale, drop);
}

template <typename T, bool kDropout>
int launch(const void* qkv, const void* mask, const void* g, void* dqkv,
           int B, int S, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_packed_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::bwd_smem_floats(S, Dh) * sizeof(float);
  attn_bwd_packed_kernel<T, kDropout><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dqkv), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const void* mask, const void* g, void* dqkv,
             int B, int S, int H, int Dh, float scale, bool dropout,
             DropoutArgs drop, cudaStream_t st) {
  if (dropout)
    return launch<T, true>(qkv, mask, g, dqkv, B, S, H, Dh, scale, drop, st);
  return launch<T, false>(qkv, mask, g, dqkv, B, S, H, Dh, scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding). g is
// the context gradient [B, S, D], dqkv the packed gradient [B, S, 3D],
// both in the input dtype. dropout = 0 ignores seed/threshold/inv_keep.
// Returns the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_packed(const void* qkv, const void* mask, const void* g,
                    void* dqkv, int B, int S, int H, int Dh, float scale,
                    int dropout, unsigned long long seed,
                    unsigned int threshold, float inv_keep, int dtype,
                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      attn::bwd_smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(qkv, mask, g, dqkv, B, S, H, Dh, scale,
                             dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(qkv, mask, g, dqkv, B, S, H, Dh, scale,
                                     dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
