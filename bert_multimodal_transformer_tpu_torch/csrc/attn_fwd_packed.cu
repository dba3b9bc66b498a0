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
// [B,S,D] out), 0.0117 ms at 3.35 TB/s; in training at B=256 with `save`,
// writing p and pd adds 2 · B·H·S²·2 B ≈ 31 MB (0.0327 ms in all), and the
// Philox draws ~10 integer rounds per 4 elements. Bytes bound it, if the
// dots leave the fp32 CUDA cores: run as fmaf chains they took 0.24 ms.
//
// What the design does about that: bf16 runs attn_full_tc.cuh's
// tensor-core plans (mma.sync from ldmatrix, operands staged by cp.async):
// up to S = 64 one block of ≤ 4 warps per (head, batch row) with the
// scores, the softmax, the keep mask and PV's A fragments in registers;
// past it #4's shared-memory score tile with the save modes. fp32 keeps
// the CUDA-core kernel below, unchanged: one block per (q-tile of 16 rows,
// head, batch row), 6144 blocks at the serving shape, Q tile and 64-row
// K/V chunks from the packed projection by stride, the tile's scores in
// shared memory (at most 16 × 512 fp32), each lane one Philox block for 4
// consecutive keys, fp32 dots (common.cuh's `fwd_packed_rows`, which #4's
// fp32 kernel runs with a larger tile). No head transpose reaches device
// memory, and no [B,H,S,S] tensor unless `save` asks for it. A bf16 call
// always launches the tensor-core kernel or returns the launch's error
// (cudaErrorMisalignedAddress where qkv does not start on the 16 bytes
// cp.async copies).

#include "attn_full_tc.cuh"

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
    case 1:  // the tensor-core plans of attn_full_tc.cuh
      return full_tc::launch_fwd(
          full_tc::packed_fwd_geom(qkv, mask, out, S, H, Dh),
          static_cast<__nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(pd),
          B, S, H, Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
