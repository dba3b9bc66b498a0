// Split-layout attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:852, launched by
// `_fwd_pallas` :1840) in all its modes: serving (rate = 0, nothing saved)
// and training (prob dropout at rate > 0, and with `save` the probs p and pd
// written for the backward). It is the attention of MAG-BERT under tensor
// parallelism with head-sharded attention, where each rank holds its local
// heads as separate q, k, v tensors (`fused_attention_tp`).
//
// What it computes, per batch row b and head h, from q, k, v [B, H, S, Dh]
// (contiguous) and the fp32 mask [B, S]:
//   s    = (q_bh · k_bhᵀ accumulated in fp32) · scale + (1 − m) · −10000
//   p    = fp32 max-subtracted softmax over the keys
//   save: p_out[b, h] = T(p)                            ([B, H, S, S])
//   rate > 0: p ← keep ? p · inv_keep : 0 in fp32, keep from the Philox
//          stream of common.cuh at counter (k >> 2, q, h + h_off, b + b_off);
//          save: pd_out[b, h] = T(p)
//   out  [B, H, S, Dh] = T(p) · v_bh accumulated in fp32, in the input dtype
// This is #1's function (attn_fwd_packed.cu) on another layout. h_off and
// b_off are the global head and batch row of the tensors' first (h, b): a
// head shard draws the mask the single-card model draws for the same global
// element, and data shards draw different masks. Input dtypes: fp32 and
// bf16. Dh a multiple of 8 up to 128, S up to 512.
//
// What bounds it on the card: as #1. At bert-base serving (B=128, S=50,
// H=12, Dh=64) the op is ~1 GFLOP over ~10 MB of q, k, v and out: latency
// (launch, the dependent load → dot → softmax → dot chain in each block)
// and occupancy bound, not HBM- or tensor-core-bound; under tensor
// parallelism each rank runs it at its H/mp local heads.
//
// What the design does about that: #1's plan and code, common.cuh's
// `fwd_rows`: one block per (16-row query tile, head, batch row), K and V
// streamed in 64-row chunks, the tile's scores in shared memory, the probs
// rounded to T, fp32 CUDA-core dots. Here the head's rows are contiguous
// (row stride Dh), so the staging loads are fully coalesced where the
// packed projection's are strided by 3D. A row's arithmetic is #1's, so #8
// gives #1's bits on the same q, k, v. Tensor cores are later work.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 16;     // query rows per block
constexpr int kMaxS = 512;

template <typename T, bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ mask, T* __restrict__ out,
                          T* __restrict__ p_out, T* __restrict__ pd_out,
                          int S, int H, int Dh, float scale, int b_off,
                          int h_off, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head_row = ((size_t)b * H + h) * S;  // row 0 of (b, h)
  const size_t off = head_row * Dh;
  const attn::RowsHead<T> hd{q + off,
                             k + off,
                             v + off,
                             (size_t)Dh,
                             mask ? mask + (size_t)b * S : nullptr,
                             out + off,
                             (size_t)Dh,
                             head_row,
                             b + b_off,
                             h + h_off};
  attn::fwd_rows<T, kQTile, kDropout, kSave>(smem, hd, blockIdx.x * kQTile,
                                             p_out, pd_out, S, Dh, scale,
                                             drop);
}

template <typename T, bool kDropout, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* p, void* pd, int B, int S, int H, int Dh,
           float scale, int b_off, int h_off, DropoutArgs drop,
           cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in.
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_split_kernel<T, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float);
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_split_kernel<T, kDropout, kSave><<<grid, attn::kFwdThreads, smem,
                                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<T*>(p), static_cast<T*>(pd), S, H, Dh,
      scale, b_off, h_off, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* out, void* p, void* pd, int B, int S, int H, int Dh,
             float scale, int b_off, int h_off, bool dropout,
             DropoutArgs drop, cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch<T, true, true>(q, k, v, mask, out, p, pd, B, S, H, Dh,
                                 scale, b_off, h_off, drop, st);
  if (dropout)
    return launch<T, true, false>(q, k, v, mask, out, p, pd, B, S, H, Dh,
                                  scale, b_off, h_off, drop, st);
  if (save)
    return launch<T, false, true>(q, k, v, mask, out, p, pd, B, S, H, Dh,
                                  scale, b_off, h_off, drop, st);
  return launch<T, false, false>(q, k, v, mask, out, p, pd, B, S, H, Dh,
                                 scale, b_off, h_off, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: [B, H, S, Dh]. mask may
// be null (no padding). p/pd: null for no save; with save, p gets the
// pre-dropout probs and, when dropout is on, pd the dropped and scaled ones
// ([B, H, S, S] in the input dtype). dropout = 0 ignores seed/threshold/
// inv_keep; b_off/h_off shift the Philox counter's batch row and head.
// Returns the cudaError_t of the launch (0 on success). The shape limits
// are checked by the Python wrapper and again here, so that no call can
// index past the shared-memory plan.
int attn_fwd_split(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* p, void* pd, int B,
                   int S, int H, int Dh, float scale, int dropout,
                   unsigned long long seed, unsigned int threshold,
                   float inv_keep, int b_off, int h_off, int dtype,
                   void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0 || b_off < 0 || h_off < 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dropout && p != nullptr && pd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, mask, out, p, pd, B, S, H, Dh, scale,
                             b_off, h_off, dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, mask, out, p, pd, B, S, H, Dh,
                                     scale, b_off, h_off, dropout != 0, drop,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
