// Head-blocked rel-attention forward for Hopper (sm_90a): the long-sequence
// forward past kernel #11's reach (K > 512).
//
// Replaces the TPU kernel `_attn_fwd_rel_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1560), which the
// JAX entry takes where the full-H [H, Q, K] scratch outgrows the TPU's
// scoped VMEM. On the TPU it splits the heads into blocks of hb; here heads
// are already one grid axis, so what carries over is its function and its
// reach.
//
// What it computes: #11's function without the saved probs. Per batch row
// b and head h, from q [B, Q, D], k, v [B, K, D] (head-major columns
// h·Dh + c) and the score bias ebias [B, H, Q, K] in the input dtype:
// s = (q_h · k_hᵀ in fp32) · scale + ebias[b, h]; an fp32 max-subtracted
// softmax over the whole key row; at rate > 0 the keep mask of common.cuh's
// Philox stream, p ← keep ? p · inv_keep : 0 in fp32; the probs rounded to
// T; out [B, Q, D] = T(p) · v_h accumulated in fp32. Its rows run
// common.cuh's `fwd_rel_rows`, the code #11 runs, so #14 gives #11's bits
// wherever both reach (K ≤ 512).
//
// What bounds it on the card: at the stream path's training shape (B=48,
// Q=K=512, H=12, Dh=64, bf16) the two products are 4·B·H·Q·K·Dh ≈ 39 GFLOP
// over ~19 MB of q/k/v/out and the 302 MB ebias read once: bytes bound at
// the bf16 tensor-core peak (0.09 ms), operations bound at the fp32
// CUDA-core peak these dots run at (0.6 ms). #11's 16-row q tile streams all
// of k_h and v_h for every 16 rows.
//
// What the design does about that: one block per (32-row q tile, head,
// batch row) halves those re-reads, as #4 does for #1. Shared plan: [32][K]
// fp32 scores + [32][Dh] q + [64][Dh+1] k/v chunk, 107 KB at K = 640,
// Dh = 64 (two blocks an SM) and 131 KB at Dh = 128, inside 227 KB.
// B·H·Q/32 = 9216 blocks at the training shape fill the 132 SMs. The dots
// run on the CUDA cores in fp32.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 32;     // query rows per block
constexpr int kMaxK = 640;     // ops/fused_attention.py::HB_MAX_SEQ_LEN

template <typename T, bool kDropout>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_rel_hb_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ ebias, T* __restrict__ out,
                           int Q, int K, int H, int Dh, float scale,
                           DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_rel_rows<T, kQTile, kDropout, false>(
      smem, q, k, v, ebias, out, nullptr, nullptr, Q, K, H, Dh, scale, drop);
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, int B, int Q, int K, int H, int Dh, float scale,
           DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_hb_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      attn::rel_fwd_smem_floats<kQTile>(K, Dh) * sizeof(float);
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_hb_kernel<T, kDropout>
      <<<grid, attn::kFwdThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ebias),
          static_cast<T*>(out), Q, K, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* ebias,
             void* out, int B, int Q, int K, int H, int Dh, float scale,
             bool dropout, DropoutArgs drop, cudaStream_t st) {
  if (dropout)
    return launch<T, true>(q, k, v, ebias, out, B, Q, K, H, Dh, scale, drop,
                           st);
  return launch<T, false>(q, k, v, ebias, out, B, Q, K, H, Dh, scale, drop,
                          st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, ebias and out. dropout = 0
// ignores seed/threshold/inv_keep. Returns the cudaError_t of the launch (0
// on success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue.
int attn_fwd_rel_hb(const void* q, const void* k, const void* v,
                    const void* ebias, void* out, int B, int Q, int K, int H,
                    int Dh, float scale, int dropout, unsigned long long seed,
                    unsigned int threshold, float inv_keep, int dtype,
                    void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0 ||
      attn::rel_fwd_smem_floats<kQTile>(K, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, ebias, out, B, Q, K, H, Dh, scale,
                             dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, ebias, out, B, Q, K, H, Dh,
                                     scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
