// Head-blocked packed attention forward for Hopper (sm_90a): the
// long-sequence forward past kernel #1's reach.
//
// Replaces the TPU kernel `_attn_fwd_packed_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1146), which the
// JAX entry takes where the full-H [H, S, S] scratch outgrows the TPU's
// scoped VMEM (S > ≈370 at bert-base bf16) and which reaches S = 640 there.
// On the TPU it splits the heads into blocks of hb; here heads are already
// one grid axis, so what carries over is its function and its reach.
//
// What it computes: #1's function without the saved probs. Per batch row
// b and head h, from qkv [B, S, 3D] (column packing i·D + h·Dh + c) and the
// fp32 mask: s = (Q_h · K_hᵀ in fp32) · scale + (1 − m) · −10000; an fp32
// max-subtracted softmax over the whole key row; at rate > 0 the keep mask
// of common.cuh's Philox stream, p ← keep ? p · inv_keep : 0 in fp32; the
// probs rounded to T; out [B, S, D] = T(p) · V_h accumulated in fp32. Its
// rows run common.cuh's `fwd_packed_rows`, the code #1 runs, so #4 gives
// #1's bits wherever both reach (S ≤ 512).
//
// What bounds it on the card: at the driver's training shape (B=48,
// S=512, H=12, Dh=64, bf16) the two products are 4·B·H·S²·Dh ≈ 39 GFLOP
// over ~19 MB of projection and context: operations bound on any core
// (0.04 ms at the bf16 tensor-core peak, 0.6 ms at the fp32 CUDA-core
// peak these dots run at). #1's 16-row q tile streams all of K_h and V_h
// for every 16 rows, so at S = 640 each head's K/V is read 40 times from
// L2.
//
// What the design does about that: one block per (32-row q tile, head,
// batch row) halves those re-reads. The shared plan at 32 rows is
// [32][S] fp32 scores + [32][Dh] Q + [64][Dh+1] K/V chunk + [S] bias:
// 107 KB at S = 640, Dh = 64 (two blocks an SM) and 131 KB at Dh = 128,
// inside 227 KB; a 64-row tile would need 195 KB at Dh = 64 and 227 KB at
// Dh = 128, one block an SM, for re-reads that L2 mostly serves already.
// B·H·S/32 = 9216 blocks at the training shape fill the 132 SMs.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 32;     // query rows per block
constexpr int kMaxS = 640;     // ops/fused_attention.py::HB_MAX_SEQ_LEN

template <typename T, bool kDropout>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_packed_hb_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ mask,
                              T* __restrict__ out, int S, int H, int Dh,
                              float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_packed_rows<T, kQTile, kDropout, false>(
      smem, qkv, mask, out, nullptr, nullptr, S, H, Dh, scale, drop);
}

template <typename T, bool kDropout>
int launch(const void* qkv, const void* mask, void* out, int B, int S,
           int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_hb_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float);
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_hb_kernel<T, kDropout>
      <<<grid, attn::kFwdThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(mask),
          static_cast<T*>(out), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const void* mask, void* out, int B, int S,
             int H, int Dh, float scale, bool dropout, DropoutArgs drop,
             cudaStream_t st) {
  if (dropout)
    return launch<T, true>(qkv, mask, out, B, S, H, Dh, scale, drop, st);
  return launch<T, false>(qkv, mask, out, B, S, H, Dh, scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding). out is
// [B, S, D] in the input dtype. dropout = 0 ignores seed/threshold/
// inv_keep. Returns the cudaError_t of the launch (0 on success); a shape
// past the shared-memory plan returns cudaErrorInvalidValue.
int attn_fwd_packed_hb(const void* qkv, const void* mask, void* out, int B,
                       int S, int H, int Dh, float scale, int dropout,
                       unsigned long long seed, unsigned int threshold,
                       float inv_keep, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0 ||
      attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(qkv, mask, out, B, S, H, Dh, scale, dropout != 0,
                             drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(qkv, mask, out, B, S, H, Dh, scale,
                                     dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
