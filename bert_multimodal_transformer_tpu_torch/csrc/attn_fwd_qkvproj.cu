// Packed attention forward with the QKV projection inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_qkvproj_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3082, launched by
// `_fwd_qkvproj_pallas` :3237) in all its modes: serving (rate = 0, nothing
// saved: the non-differentiated primal), training (prob dropout at rate > 0
// with the probs p and pd saved for the backward) and `emit_qkv` (the
// projection written out too, the `qkv_residual` backward's input).
//
// What it computes, per batch row b and head h, from x [B, S, D], the
// packed QKV weight in nn.Linear's layout w [3D, D] (row i·D + h·Dh + c is
// column c of head h's q (i = 0), k (1) or v (2)), its bias b3 [3D] and the
// fp32 mask [B, S]:
//   qkv_h [S, 3·Dh] = T(x_b · w_hᵀ accumulated in fp32 + b3_h)   (the TPU
//          kernel's `(x·W in fp32 + b).astype(dtype)`; the model's dense
//          layer instead rounds the product and then adds the bias in T)
//   then kernel #1's attention on it (attn_fwd_packed.cu): s = (q·kᵀ in
//   fp32) · scale + (1 − m)·−10000, the fp32 softmax, the Philox keep mask
//   of common.cuh at counter (k >> 2, q, h, b), saved p/pd, out [B, S, D] =
//   T(p)·v in fp32, written at columns h·Dh + c;
//   emit: qkv_out [B, S, 3D] = the projection at its packed columns.
// Input dtypes: fp32 and bf16 (fp32 products throughout, no TF32). Dh a
// multiple of 8 up to 128; S and Dh within the shared-memory plan below
// (ops/fused_attention.py::qkvproj_fits).
//
// What bounds it on the card: the projection is ~96% of the operations
// (at bert-base serving, B=128 S=50 D=768: 22.6 of 23.6 GFLOP), so on the
// card's tensor cores it would be operation-bound near 0.024 ms; its bytes
// (x, w, out: ~23 MB) take ~0.007 ms. Here the products run on the CUDA
// cores in fp32 (67 TFLOP/s peak), so it is bound by them: ~0.35 ms at
// the peak, more in practice, several times the split structure it
// replaces (a cuBLAS GEMM and #1).
//
// What the design does about that: one block per (head, batch row), B·H
// blocks (1536 at serving). The block projects its head's 3·Dh columns
// with common.cuh's `project_head` (64 × 64 output tiles, x and the head's
// weight rows streamed through shared memory in 32-deep slices, 4 × 4
// outputs a thread in fp32 registers), keeps the projected head in shared
// memory as T [S][3·Dh], and runs #1's row code (`fwd_rows`) on it, 16 query
// rows at a time: no qkv round trip through device memory unless `emit`
// asks for it. A row's attention arithmetic is #1's, so #18 gives #1's bits
// on its own (emitted) projection. Tensor-core products are later work.
//
// Shared memory: the head (S·3·Dh·sizeof(T), rounded up to 16 bytes), then
// the larger of the projection's two staging slices and #1's row plan.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 16;     // query rows per `fwd_rows` pass (#1's)
constexpr int kMaxS = 512;

template <typename T>
size_t smem_bytes(int S, int Dh) {
  const size_t work = attn::gemm_smem_floats() >
                              attn::fwd_smem_floats<kQTile>(S, Dh)
                          ? attn::gemm_smem_floats()
                          : attn::fwd_smem_floats<kQTile>(S, Dh);
  return (attn::qkvproj_head_floats<T>(S, Dh) + work) * sizeof(float);
}

template <typename T, bool kDropout, bool kSave, bool kEmit>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_qkvproj_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ b3,
                            const float* __restrict__ mask,
                            T* __restrict__ out, T* __restrict__ qkv_out,
                            T* __restrict__ p_out, T* __restrict__ pd_out,
                            int S, int H, int Dh, float scale,
                            DropoutArgs drop) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * Dh;
  T* head = reinterpret_cast<T*>(smem);               // [S][3·Dh]
  float* work = smem + attn::qkvproj_head_floats<T>(S, Dh);
  attn::project_head<T, kEmit>(work, head, x + (size_t)b * S * D, w, b3,
                               kEmit ? qkv_out + (size_t)b * S * 3 * D
                                     : nullptr,
                               S, D, Dh, h);
  __syncthreads();  // the head is written; the staging slices are free
  const attn::RowsHead<T> hd{head,
                             head + Dh,
                             head + 2 * Dh,
                             (size_t)3 * Dh,
                             mask ? mask + (size_t)b * S : nullptr,
                             out + (size_t)b * S * D + h * Dh,
                             (size_t)D,
                             ((size_t)b * H + h) * S,
                             b,
                             h};
  for (int q0 = 0; q0 < S; q0 += kQTile) {
    attn::fwd_rows<T, kQTile, kDropout, kSave>(work, hd, q0, p_out, pd_out,
                                               S, Dh, scale, drop);
    __syncthreads();  // this pass's readers are done before the next's
  }
}

template <typename T, bool kDropout, bool kSave, bool kEmit>
int launch(const void* x, const void* w, const void* b3, const void* mask,
           void* out, void* qkv_out, void* p, void* pd, int B, int S, int H,
           int Dh, float scale, DropoutArgs drop, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in.
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_qkvproj_kernel<T, kDropout, kSave, kEmit>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_qkvproj_kernel<T, kDropout, kSave, kEmit>
      <<<dim3(H, B), attn::kFwdThreads, smem_bytes<T>(S, Dh), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(b3), static_cast<const float*>(mask),
          static_cast<T*>(out), static_cast<T*>(qkv_out),
          static_cast<T*>(p), static_cast<T*>(pd), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b3, const void* mask,
             void* out, void* qkv_out, void* p, void* pd, int B, int S,
             int H, int Dh, float scale, bool dropout, DropoutArgs drop,
             cudaStream_t st) {
  if (smem_bytes<T>(S, Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const bool save = p != nullptr;
  const bool emit = qkv_out != nullptr;
  if (emit && !save) return (int)cudaErrorInvalidValue;
  if (emit && dropout)
    return launch<T, true, true, true>(x, w, b3, mask, out, qkv_out, p, pd,
                                       B, S, H, Dh, scale, drop, st);
  if (emit)
    return launch<T, false, true, true>(x, w, b3, mask, out, qkv_out, p, pd,
                                        B, S, H, Dh, scale, drop, st);
  if (dropout && save)
    return launch<T, true, true, false>(x, w, b3, mask, out, qkv_out, p, pd,
                                        B, S, H, Dh, scale, drop, st);
  if (dropout)
    return launch<T, true, false, false>(x, w, b3, mask, out, qkv_out, p,
                                         pd, B, S, H, Dh, scale, drop, st);
  if (save)
    return launch<T, false, true, false>(x, w, b3, mask, out, qkv_out, p,
                                         pd, B, S, H, Dh, scale, drop, st);
  return launch<T, false, false, false>(x, w, b3, mask, out, qkv_out, p, pd,
                                        B, S, H, Dh, scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x, w, b3, out, qkv_out, p, pd.
// x [B, S, D]; w [3D, D] (nn.Linear's layout); b3 [3D]; mask [B, S] fp32 or
// null (no padding); out [B, S, D]. qkv_out: null, or [B, S, 3D] for the
// projection (needs p). p/pd: null for no save; with save, p gets the
// pre-dropout probs and, when dropout is on, pd the dropped and scaled ones
// ([B, H, S, S]). dropout = 0 ignores seed/threshold/inv_keep. Returns the
// cudaError_t of the launch (0 on success); a shape past the shared-memory
// plan returns cudaErrorInvalidValue (the Python wrapper checks it first).
int attn_fwd_qkvproj(const void* x, const void* w, const void* b3,
                     const void* mask, void* out, void* qkv_out, void* p,
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
      return dispatch<float>(x, w, b3, mask, out, qkv_out, p, pd, B, S, H,
                             Dh, scale, dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(x, w, b3, mask, out, qkv_out, p, pd, B,
                                     S, H, Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
