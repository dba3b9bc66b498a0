// Saved-probs attention backward with the QKV projection's input gradient
// inside, for Hopper (sm_90a): two launches a call.
//
// Replaces the TPU kernel `_attn_bwd_qkvproj_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3140, launched by
// `_bwd_qkvproj_pallas` :3286), the backward of #18 (attn_fwd_qkvproj.cu).
//
// What it computes, from the saved probs p and pd [B, H, S, S] (input
// dtype; pd is p when the rate was 0), the context gradient g [B, S, D],
// the packed QKV weight in nn.Linear's layout w [3D, D] and its bias b3:
//   qkv  = the projection re-computed from x [B, S, D] exactly as #18 does
//          (`recompute`), or read from the qkv [B, S, 3D] #18 emitted
//   per (b, h), kernel #3's chain (attn_bwd_packed_saved.cu):
//          dV = pdᵀ·g;  d(pd) = g·Vᵀ;  t = pd ⊙ d(pd);
//          ds = (t − p·Σ_k t)·scale;  ds_c = T(ds);  dQ = ds_c·K;  dK = ds_cᵀ·Q
//          written into dqkv [B, S, 3D] at the packed columns (all in fp32,
//          each output rounded to T once)
//   dx [B, S, D] = T(dqkv · w accumulated in fp32)   (the TPU kernel's
//          `dqkv·Wᵀ`, computed in its body; dW = xᵀ·dqkv and db = Σ dqkv
//          stay plain products in the autograd function, as the TPU
//          package leaves them to XLA)
// Input dtypes: fp32 and bf16 (fp32 products, no TF32); Dh a multiple of 8
// up to 128, S within the shared-memory plan (ops/fused_attention.py::
// qkvproj_fits).
//
// What bounds it on the card: the two D × 3D products per row (the
// re-projection and dx) are ~97% of the operations at bert-base (B=256,
// S=50: 2 × 45.3 GFLOP against ~2 GFLOP of attention), so it is bound by
// operations: ~0.09 ms at the bf16 tensor-core peak, ~1.4 ms at the fp32
// CUDA-core peak that dx (and in fp32 the re-projection) runs at.
//
// What the design does about that: the TPU kernel's per-row grid becomes
// two launches, since dx needs every head's dqkv columns of a row and
// blocks share nothing. Launch 1 (`attn_bwd_qkvproj_heads`): one block per
// (head, batch row) re-projects its head into shared memory as [S][3·Dh]
// with the projection #18 runs (bf16: attn_full_tc.cuh's
// `project_head_tc` on the tensor cores; fp32: common.cuh's
// `project_head`), so its head has #18's bits, or reads it from the saved
// qkv by stride, then runs #3's `bwd_saved_head` on it (CUDA cores, fp32
// sums): every reduction stays in the block, no atomics,
// bit-reproducible. Launch 2 (`attn_bwd_qkvproj_dx`): dx = dqkv · w as
// 64 × 64 tiles of common.cuh's `gemm_tile` over the 3D-deep sum, B·S/64 ×
// D/64 blocks. The dqkv round trip (B·S·3D elements) is the price of the
// split; the TPU kernel kept it in VMEM and wrote it once too (for dW).
// The dQKV chain and dx on the tensor cores are later work (ROADMAP B.R11).

#include "attn_full_tc.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

// The re-projection's staging in floats: fp32's gemm_tile slices, bf16's
// cp.async ring (#18's).
template <typename T>
size_t proj_floats(int Dh) {
  if constexpr (std::is_same<T, float>::value)
    return attn::gemm_smem_floats();
  return full_tc::proj_smem_bytes(Dh, 1, full_tc::kProjRowsDepth) /
         sizeof(float);
}

template <typename T>
size_t heads_smem_bytes(int S, int Dh, bool recompute) {
  const size_t bwd = attn::bwd_smem_floats(S, Dh);
  if (!recompute) return bwd * sizeof(float);
  const size_t work = proj_floats<T>(Dh) > bwd ? proj_floats<T>(Dh) : bwd;
  return (attn::qkvproj_head_floats<T>(S, Dh) + work) * sizeof(float);
}

template <typename T, bool kRecompute>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_qkvproj_heads_kernel(const T* __restrict__ p,
                                  const T* __restrict__ pd,
                                  const T* __restrict__ src,
                                  const T* __restrict__ w,
                                  const T* __restrict__ b3,
                                  const T* __restrict__ g,
                                  T* __restrict__ dqkv, int S, int H, int Dh,
                                  float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * Dh;
  const T* q;      // this head's q rows; k and v follow at + seg, + 2·seg
  size_t ld, seg;
  float* work = smem;
  if constexpr (kRecompute) {
    T* head = reinterpret_cast<T*>(smem);           // [S][3·Dh]
    work = smem + attn::qkvproj_head_floats<T>(S, Dh);
    if constexpr (std::is_same<T, float>::value)
      attn::project_head<T, false>(work, head, src + (size_t)b * S * D, w,
                                   b3, nullptr, S, D, Dh, h);
    else
      full_tc::project_head_tc<1, full_tc::kProjRowsDepth, false>(
          reinterpret_cast<unsigned char*>(work), head, 0, 3 * Dh, Dh, S,
          src + (size_t)b * S * D, w, b3, nullptr, 1, S, D, Dh, h);
    __syncthreads();  // the head is written; the staging slices are free
    q = head;
    ld = (size_t)3 * Dh;
    seg = Dh;
  } else {
    q = src + (size_t)b * S * 3 * D + h * Dh;
    ld = (size_t)3 * D;
    seg = D;
  }
  T* dq = dqkv + (size_t)b * S * 3 * D + h * Dh;
  const attn::BwdHead<T> hd{q,       q + seg, q + 2 * seg,
                            ld,
                            g + (size_t)b * S * D + h * Dh,
                            (size_t)D,
                            dq,      dq + D,  dq + 2 * D,
                            (size_t)3 * D,
                            nullptr, b,       h};
  const size_t off = ((size_t)b * H + h) * S * S;
  attn::bwd_saved_head<T>(work, hd, p + off, pd + off, S, Dh, scale);
}

// dx[r][n] = T(Σ_k dqkv[r][k] · w[k][n]) over the 3D columns k, for the M
// = B·S rows r.
template <typename T>
__global__ void __launch_bounds__(attn::kGThreads)
    attn_bwd_qkvproj_dx_kernel(const T* __restrict__ dqkv,
                               const T* __restrict__ w, T* __restrict__ dx,
                               int M, int D) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * attn::kGM;
  const int n0 = blockIdx.x * attn::kGN;
  const int K = 3 * D;
  attn::gemm_tile<false>(
      smem, min(attn::kGM, M - m0), min(attn::kGN, D - n0), K,
      [=](int m, int k) {
        return attn::to_float(dqkv[(size_t)(m0 + m) * K + k]);
      },
      [=](int k, int n) { return attn::to_float(w[(size_t)k * D + n0 + n]); },
      [=](int m, int n, float acc) {
        dx[(size_t)(m0 + m) * D + n0 + n] = attn::from_float<T>(acc);
      });
}

template <typename T, bool kRecompute>
int launch_heads(const void* p, const void* pd, const void* src,
                 const void* w, const void* b3, const void* g, void* dqkv,
                 int B, int S, int H, int Dh, float scale,
                 cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_qkvproj_heads_kernel<T, kRecompute>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_qkvproj_heads_kernel<T, kRecompute>
      <<<dim3(H, B), kThreads, heads_smem_bytes<T>(S, Dh, kRecompute),
         stream>>>(static_cast<const T*>(p), static_cast<const T*>(pd),
                   static_cast<const T*>(src), static_cast<const T*>(w),
                   static_cast<const T*>(b3), static_cast<const T*>(g),
                   static_cast<T*>(dqkv), S, H, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* dqkv, const void* w, void* dx, int M, int D,
              cudaStream_t stream) {
  const dim3 grid((D + attn::kGN - 1) / attn::kGN,
                  (M + attn::kGM - 1) / attn::kGM);
  attn_bwd_qkvproj_dx_kernel<T>
      <<<grid, attn::kGThreads, attn::gemm_smem_floats() * sizeof(float),
         stream>>>(static_cast<const T*>(dqkv), static_cast<const T*>(w),
                   static_cast<T*>(dx), M, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch 1. dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd the
// saved probs [B, H, S, S] (the same pointer twice when the rate was 0);
// src x [B, S, D] with recompute != 0, else the saved qkv [B, S, 3D]; w
// [3D, D]; b3 [3D] (read only with recompute); g [B, S, D]; dqkv [B, S,
// 3D] receives the gradient. Returns the cudaError_t of the launch (0 on
// success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue, a bf16 x or w off the 16 bytes the re-projection's
// cp.async copies cudaErrorMisalignedAddress.
int attn_bwd_qkvproj_heads(const void* p, const void* pd, const void* src,
                           const void* w, const void* b3, const void* g,
                           void* dqkv, int B, int S, int H, int Dh,
                           float scale, int recompute, int dtype,
                           void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes =
      dtype == 0 ? heads_smem_bytes<float>(S, Dh, recompute != 0)
                 : heads_smem_bytes<__nv_bfloat16>(S, Dh, recompute != 0);
  if (bytes > attn::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && recompute &&
      (!full_tc::aligned(src, 16) || !full_tc::aligned(w, 16)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return recompute
                 ? launch_heads<float, true>(p, pd, src, w, b3, g, dqkv, B,
                                             S, H, Dh, scale, st)
                 : launch_heads<float, false>(p, pd, src, w, b3, g, dqkv, B,
                                              S, H, Dh, scale, st);
    case 1:
      return recompute ? launch_heads<__nv_bfloat16, true>(
                             p, pd, src, w, b3, g, dqkv, B, S, H, Dh, scale,
                             st)
                       : launch_heads<__nv_bfloat16, false>(
                             p, pd, src, w, b3, g, dqkv, B, S, H, Dh, scale,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch 2. dx [M, D] = dqkv [M, 3D] · w [3D, D], M = B·S rows; dtype as
// above. Returns the cudaError_t of the launch (0 on success).
int attn_bwd_qkvproj_dx(const void* dqkv, const void* w, void* dx, int M,
                        int D, int dtype, void* stream) {
  if (M < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if ((M + attn::kGM - 1) / attn::kGM > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dx<float>(dqkv, w, dx, M, D, st);
    case 1:
      return launch_dx<__nv_bfloat16>(dqkv, w, dx, M, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
