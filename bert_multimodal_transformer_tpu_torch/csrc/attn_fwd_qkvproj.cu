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
// card's tensor cores it is operation-bound near 0.024 ms; its bytes (x,
// w, out: ~23 MB) take ~0.007 ms. A block that projects one (head, batch
// row) reads its head's weight rows (3·Dh × D) and its batch row of x from
// L2: ~0.57 GB at bert-base serving; the pace is set by those reads'
// latency between pipeline stages and by the ldmatrix traffic, not by the
// bound.
//
// What the design does about that: bf16 projects on the tensor cores
// (attn_full_tc.cuh's `project_head_tc`: mma.sync.m16n8k16 over 64-row ×
// 192-column passes, the fp32 sums in registers, the bias added in fp32
// before the one rounding) straight into the attention's layout, with no
// qkv round trip through device memory unless `emit` asks for it. Up to
// S = 64 a block of 16 warps takes one head of two batch rows
// (`kProjRegRows`), so each weight slice (64 deep, `kProjRegDepth`) that
// the two-stage cp.async ring brings serves both: 0.277-0.278 ms at
// serving against 0.318 for one batch row a block and 0.396 for 32-deep
// slices (bf16 B=128 S=50 on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_ab.py); a third stage bought nothing. The head lands in #1's
// register-plan tiles, q, k, v [S16][L] bf16 a batch row (rows past S and
// the k-depth's pad columns zero, the mask bias after them), on which warps
// 4i .. 4i + 3 run #1's compute half for batch row i (`fwd_reg_compute`:
// the scores, softmax, keep mask and PV on the tensor cores in registers),
// so #18 gives #1's bits on its own emitted projection. Past S = 64 one
// block of 8 warps a (head, batch row) keeps the head as [S][3·Dh] (the
// layout that fits to the reach, S = 468 at Dh = 64, with 32-deep slices)
// and runs #1's fp32 CUDA-core row code on it (`fwd_rows`, 16 query rows at
// a time), as fp32 does throughout: the projection runs on the tensor cores
// there too, the attention's products on the CUDA cores (ROADMAP). fp32
// keeps the CUDA-core projection (common.cuh's `project_head`, 64 × 64 fp32
// tiles) and its bits.
//
// Shared memory (ops/fused_attention.py::qkvproj_fwd_smem_bytes): bf16 to
// S = 64 #1's tiles and bias (`fwd_reg_smem_bytes`) for each batch row,
// then the ring (`proj_smem_bytes`): 144.5 KB at S = 50, Dh = 64, one
// block an SM; past it, and in fp32, the head (S·3·Dh elements, rounded up
// to 16 bytes) then the larger of the projection's staging and #1's row
// plan.

#include "attn_full_tc.cuh"

#include <type_traits>

namespace {

using attn::DropoutArgs;
using bf16 = __nv_bfloat16;

constexpr int kQTile = 16;     // query rows per `fwd_rows` pass (#1's)
constexpr int kMaxS = 512;

// The projection's staging in floats: fp32's gemm_tile slices, bf16's
// cp.async ring.
template <typename T>
size_t proj_floats(int Dh) {
  if constexpr (std::is_same<T, float>::value)
    return attn::gemm_smem_floats();
  return full_tc::proj_smem_bytes(Dh, 1, full_tc::kProjRowsDepth) /
         sizeof(float);
}

// The row plan's shared memory: the head [S][3·Dh], then the larger of the
// projection's staging and `fwd_rows`'.
template <typename T>
size_t smem_bytes(int S, int Dh) {
  const size_t rows = attn::fwd_smem_floats<kQTile>(S, Dh);
  const size_t work = proj_floats<T>(Dh) > rows ? proj_floats<T>(Dh) : rows;
  return (attn::qkvproj_head_floats<T>(S, Dh) + work) * sizeof(float);
}

// bf16 to S = 64: #1's register plan's tiles for each of the block's batch
// rows, then the projection's ring.
size_t reg_smem_bytes(int S, int Dh) {
  return full_tc::kProjRegRows * full_tc::fwd_reg_smem_bytes(S, Dh) +
         full_tc::proj_smem_bytes(Dh, full_tc::kProjRegRows,
                                  full_tc::kProjRegDepth);
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
  T* qkv_b = kEmit ? qkv_out + (size_t)b * S * 3 * D : nullptr;
  if constexpr (std::is_same<T, float>::value)
    attn::project_head<T, kEmit>(work, head, x + (size_t)b * S * D, w, b3,
                                 qkv_b, S, D, Dh, h);
  else
    full_tc::project_head_tc<1, full_tc::kProjRowsDepth, kEmit>(
        reinterpret_cast<unsigned char*>(work), head, 0, 3 * Dh, Dh, S,
        x + (size_t)b * S * D, w, b3, qkv_b, 1, S, D, Dh, h);
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

// bf16 to S = 64: the projection of kProjRegRows batch rows into #1's
// tiles (one set a batch row), then #1's compute half, warps 4i .. 4i + 3
// on batch row i.
template <int kDT, bool kDropout, bool kSave, bool kEmit>
__global__ void __launch_bounds__(
    full_tc::kProjRegRows * full_tc::kProjThreads,
    full_tc::kProjRegRows == 1 ? 2 : 1)
    attn_fwd_qkvproj_tc_reg_kernel(const bf16* __restrict__ x,
                                   const bf16* __restrict__ w,
                                   const bf16* __restrict__ b3,
                                   const float* __restrict__ mask,
                                   bf16* __restrict__ out,
                                   bf16* __restrict__ qkv_out,
                                   bf16* __restrict__ p_out,
                                   bf16* __restrict__ pd_out, int B, int S,
                                   int H, int Dh, float scale, bool pairs,
                                   DropoutArgs drop) {
  constexpr int kRows = full_tc::kProjRegRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, B - b0);
  const int D = H * Dh;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int sp = full_tc::rows16(S);
  const size_t tiles = full_tc::fwd_reg_smem_bytes(S, Dh);  // a batch row's
  full_tc::project_head_tc<kRows, full_tc::kProjRegDepth, kEmit>(
      smem_raw + kRows * tiles, reinterpret_cast<bf16*>(smem_raw),
      tiles / sizeof(bf16), ld, sp * ld, sp, x + (size_t)b0 * S * D, w, b3,
      kEmit ? qkv_out + (size_t)b0 * S * 3 * D : nullptr, n_rows, S, D, Dh,
      h);
  for (int i = 0; i < n_rows; ++i) {
    bf16* qs = reinterpret_cast<bf16*>(smem_raw + i * tiles);  // Q, K, V
    full_tc::fill_bias(reinterpret_cast<float*>(qs + 3 * sp * ld),
                       mask ? mask + (size_t)(b0 + i) * S : nullptr, S);
    attn::tc_zero_cols(qs, ld, 3 * sp, Dh, kd);  // Q, K and V's pad columns
  }
  __syncthreads();  // the tiles and the biases are in
  const int warp = threadIdx.x >> 5, i = warp >> 2;
  if (i >= n_rows || 16 * (warp & 3) >= sp) return;
  const int b = b0 + i;
  const attn::RowsHead<bf16> hd{nullptr,
                                nullptr,
                                nullptr,
                                0,
                                nullptr,
                                out + (size_t)b * S * D + h * Dh,
                                (size_t)D,
                                ((size_t)b * H + h) * S,
                                b,
                                h};
  full_tc::fwd_reg_compute<kDT, kDropout, kSave>(
      smem_raw + i * tiles, hd, p_out, pd_out, 16 * (warp & 3), S, Dh, scale,
      pairs, drop);
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

template <int kDT, bool kDropout, bool kSave, bool kEmit>
int launch_reg(const void* x, const void* w, const void* b3,
               const void* mask, void* out, void* qkv_out, void* p, void* pd,
               int B, int S, int H, int Dh, float scale, DropoutArgs drop,
               cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_qkvproj_tc_reg_kernel<kDT, kDropout, kSave, kEmit>,
      &attr_set);
  if (err != cudaSuccess) return (int)err;
  const bool pairs =
      S % 2 == 0 && full_tc::aligned(p, 4) && full_tc::aligned(pd, 4);
  constexpr int kRows = full_tc::kProjRegRows;
  attn_fwd_qkvproj_tc_reg_kernel<kDT, kDropout, kSave, kEmit>
      <<<dim3(H, (B + kRows - 1) / kRows), kRows * full_tc::kProjThreads,
         reg_smem_bytes(S, Dh), stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const bf16*>(b3), static_cast<const float*>(mask),
          static_cast<bf16*>(out), static_cast<bf16*>(qkv_out),
          static_cast<bf16*>(p), static_cast<bf16*>(pd), B, S, H, Dh, scale,
          pairs, drop);
  return (int)cudaGetLastError();
}

// One mode: bf16 to S = 64 on the register plan (by head width), else the
// row plan.
template <typename T, bool kDropout, bool kSave, bool kEmit>
int launch_mode(const void* x, const void* w, const void* b3,
                const void* mask, void* out, void* qkv_out, void* p,
                void* pd, int B, int S, int H, int Dh, float scale,
                DropoutArgs drop, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (S <= full_tc::kRegMaxS)
      return full_tc::dh_tiles(Dh) == 8
                 ? launch_reg<8, kDropout, kSave, kEmit>(
                       x, w, b3, mask, out, qkv_out, p, pd, B, S, H, Dh,
                       scale, drop, st)
                 : launch_reg<16, kDropout, kSave, kEmit>(
                       x, w, b3, mask, out, qkv_out, p, pd, B, S, H, Dh,
                       scale, drop, st);
  }
  return launch<T, kDropout, kSave, kEmit>(x, w, b3, mask, out, qkv_out, p,
                                           pd, B, S, H, Dh, scale, drop, st);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b3, const void* mask,
             void* out, void* qkv_out, void* p, void* pd, int B, int S,
             int H, int Dh, float scale, bool dropout, DropoutArgs drop,
             cudaStream_t st) {
  if (smem_bytes<T>(S, Dh) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, bf16>::value &&
      (!full_tc::aligned(x, 16) || !full_tc::aligned(w, 16)))
    return (int)cudaErrorMisalignedAddress;
  const bool save = p != nullptr;
  const bool emit = qkv_out != nullptr;
  if (emit && !save) return (int)cudaErrorInvalidValue;
  if (emit && dropout)
    return launch_mode<T, true, true, true>(x, w, b3, mask, out, qkv_out, p,
                                            pd, B, S, H, Dh, scale, drop, st);
  if (emit)
    return launch_mode<T, false, true, true>(x, w, b3, mask, out, qkv_out, p,
                                             pd, B, S, H, Dh, scale, drop,
                                             st);
  if (dropout && save)
    return launch_mode<T, true, true, false>(x, w, b3, mask, out, qkv_out, p,
                                             pd, B, S, H, Dh, scale, drop,
                                             st);
  if (dropout)
    return launch_mode<T, true, false, false>(x, w, b3, mask, out, qkv_out,
                                              p, pd, B, S, H, Dh, scale, drop,
                                              st);
  if (save)
    return launch_mode<T, false, true, false>(x, w, b3, mask, out, qkv_out,
                                              p, pd, B, S, H, Dh, scale, drop,
                                              st);
  return launch_mode<T, false, false, false>(x, w, b3, mask, out, qkv_out, p,
                                             pd, B, S, H, Dh, scale, drop,
                                             st);
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
// plan returns cudaErrorInvalidValue (the Python wrapper checks it first),
// bf16 x or w off the 16 bytes cp.async copies cudaErrorMisalignedAddress.
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
