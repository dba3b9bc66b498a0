// Rel-attention forward with a full score bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_rel_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1413), the XLNet
// content and query streams' attention, in all its modes: serving (rate 0,
// nothing saved) and training (prob dropout at rate > 0, and with `save`
// the probs p and pd written for the backward).
//
// What it computes, per batch row b and head h:
//   q     [B, Q, D], k, v [B, K, D]   head-major columns h·Dh + c
//   ebias [B, H, Q, K]                the score bias assembled outside
//                                      (rel-shifted bd + segment ef − 1e30
//                                      · mask), in the input dtype
//   s    = (q_h · k_hᵀ accumulated in fp32) · scale + ebias[b, h]  (scale
//          after the dot, then the bias, as the TPU kernel)
//   p    = fp32 max-subtracted softmax over the keys (a row masked whole
//          comes out uniform, not NaN)
//   save: p_out[b, h] = T(p)
//   rate > 0: p ← keep ? p · inv_keep : 0 in fp32, keep from the Philox
//          stream of common.cuh at counter (k >> 2, q, h + h_off,
//          b + b_off); save: pd_out[b, h] = T(p)
//   out  [B, Q, D] = T(p) · v_h accumulated in fp32
// Input dtypes: fp32 and bf16, one for all tensors. Dh a multiple of 8 up
// to 128, K up to 512, any Q.
//
// What bounds it on the card: at XLNet's training shape (B=256, Q=K=50,
// H=12, Dh=64) the op is ~1 GFLOP over ~31 MB (q, k, v, the 15 MB ebias,
// out) plus 31 MB of saved probs: bytes-bound at 0.037 ms (0.014 ms at
// the serving shape, B=128, nothing saved). The CUDA-core kernel below
// took 0.24-0.56 ms there, latency-bound on its dependent load → fmaf dot
// → softmax → fmaf dot chain.
//
// What the design does about that: bf16 runs on the tensor cores
// (attn_rel_full_tc.cuh: the scores, softmax, keep mask and PV's A
// fragments in registers up to K = 64, #14's score tile with the save
// modes past it), mma.sync fed by ldmatrix from operands cp.async staged
// once. fp32 keeps the CUDA-core kernel and its bits: common.cuh's
// `fwd_rel_rows` (which #14 runs with larger tiles in fp32), one block per
// (q-tile of 16 rows, head, batch row), the q tile in shared memory, k_h
// and v_h streamed in 64-row chunks by stride, the tile's scores in shared
// memory (at most 16 × 512 fp32), each lane one Philox block for 4
// consecutive keys. The entry dispatches on the dtype; a bf16 call always
// launches a tensor-core kernel or returns the launch's error
// (cudaErrorMisalignedAddress where q, k or v does not start on the 16
// bytes cp.async copies).

#include "attn_rel_full_tc.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 16;     // query rows per block
constexpr int kMaxK = 512;

template <bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_rel_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ ebias,
                        float* __restrict__ out, float* __restrict__ p_out,
                        float* __restrict__ pd_out, int Q, int K, int H,
                        int Dh, float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_rel_rows<float, kQTile, kDropout, kSave>(
      smem, q, k, v, ebias, out, p_out, pd_out, Q, K, H, Dh, scale, drop);
}

template <bool kDropout, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, void* p, void* pd, int B, int Q, int K, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_kernel<kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      attn::rel_fwd_smem_floats<kQTile>(K, Dh) * sizeof(float);
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_kernel<kDropout, kSave>
      <<<grid, attn::kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ebias),
      static_cast<float*>(out), static_cast<float*>(p),
      static_cast<float*>(pd), Q, K, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

// fp32 on the CUDA cores.
int dispatch_fp32(const void* q, const void* k, const void* v,
                  const void* ebias, void* out, void* p, void* pd, int B,
                  int Q, int K, int H, int Dh, float scale, bool dropout,
                  DropoutArgs drop, cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch<true, true>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                              scale, drop, st);
  if (dropout)
    return launch<true, false>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                               scale, drop, st);
  if (save)
    return launch<false, true>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                               scale, drop, st);
  return launch<false, false>(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh,
                              scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, ebias, out, p and pd.
// p/pd: null for no save; with save, p gets the pre-dropout probs and,
// when dropout is on, pd the dropped and scaled ones ([B, H, Q, K]).
// dropout = 0 ignores seed/threshold/inv_keep; b_off/h_off (≥ 0) are the
// global batch row and head of the tensors' first (b, h) in the Philox
// counter (a tensor-parallel rank's shard). Returns the cudaError_t of the
// launch (0 on success). The Python wrapper checks the shapes; they are checked again
// here so that no call can index past the shared-memory plan.
int attn_fwd_rel(const void* q, const void* k, const void* v,
                 const void* ebias, void* out, void* p, void* pd, int B,
                 int Q, int K, int H, int Dh, float scale, int dropout,
                 unsigned long long seed, unsigned int threshold,
                 float inv_keep, int b_off, int h_off, int dtype,
                 void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dropout && p != nullptr && pd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_off < 0 || h_off < 0) return (int)cudaErrorInvalidValue;
  const DropoutArgs drop{seed, threshold, inv_keep, b_off, h_off};
  switch (dtype) {
    case 0:
      return dispatch_fp32(q, k, v, ebias, out, p, pd, B, Q, K, H, Dh, scale,
                           dropout != 0, drop, st);
    case 1: {  // the tensor-core plans of attn_rel_full_tc.cuh
      using bf16 = __nv_bfloat16;
      const rel_tc::FwdArgs a{static_cast<const bf16*>(q),
                              static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v),
                              static_cast<const bf16*>(ebias),
                              static_cast<bf16*>(out),
                              static_cast<bf16*>(p),
                              static_cast<bf16*>(pd),
                              B,
                              Q,
                              K,
                              H,
                              Dh,
                              scale};
      return rel_tc::launch_fwd(a, dropout != 0, drop, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
