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
// with TMA loads is later work. The block's work is common.cuh's
// `fwd_packed_rows`, which the head-blocked forward (#4,
// attn_fwd_packed_hb.cu) runs with a larger tile.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 16;     // query rows per block
constexpr int kMaxS = 512;

template <typename T, bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_packed_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ mask,
                           T* __restrict__ out, T* __restrict__ p_out,
                           T* __restrict__ pd_out, int S, int H, int Dh,
                           float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_packed_rows<T, kQTile, kDropout, kSave>(
      smem, qkv, mask, out, p_out, pd_out, S, H, Dh, scale, drop);
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
  const size_t smem = attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float);
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_kernel<T, kDropout, kSave><<<grid, attn::kFwdThreads, smem,
                                                stream>>>(
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
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0)
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
