// Rel-attention backward from saved probs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_rel_saved_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1521), taken when
// the forward saved p and pd (`fused_rel_attention` with save on: the
// default while the prob residuals stay under 256 MB, every XLNet train
// step at the driver's shapes).
//
// What it computes, per batch row b and head h, from the saved probs p and
// pd [B, H, Q, K] (input dtype; pd is p when the rate was 0), q [B, Q, D],
// k, v [B, K, D] and the context gradient g [B, Q, D]:
//   dV    = pdᵀ · g_h                         (fp32 accumulate)
//   d(pd) = g_h · v_hᵀ                         (fp32)
//   t     = pd ⊙ d(pd);  ds = t − p · Σ_k t
//   debias[b, h] = T(ds)                       (unscaled, as the TPU kernel;
//                                                ebias itself is not read)
//   ds_c  = T(ds · scale);  dQ = ds_c · k_h,  dK = ds_cᵀ · q_h
// No QK product, no softmax, no random draws.
//
// What bounds it on the card: at B=256, Q=K=50, H=12, Dh=64 four Q×K×Dh
// products per (b, h), ~2 GFLOP, over ~31 MB of q/k/v/g and gradients,
// the 31 MB of saved probs and the 15 MB debias write (bf16): bytes-bound
// at 0.055 ms. The CUDA-core kernel below took 0.65 ms there, latency-bound
// on its dependent fp32 fmaf chains.
//
// What the design does about that: bf16 runs on the tensor cores
// (attn_rel_full_tc.cuh: attn_full_tc.cuh's saved-probs backward in the rel
// layout, d(pd), the VJP and debias from the accumulators in registers,
// dV and dK by ldmatrix.trans, the q rows in chunks where they do not fit
// at once). fp32 keeps the CUDA-core kernel and its bits: the recompute
// backward's plan (attn_bwd_rel.cu, common.cuh's rel_bwd_smem_floats), one
// block per (head, batch row) holding the [Q, K] problem in shared memory,
// pd staged for the dV product and the VJP, p read once from device memory
// row by row. Neither uses atomics: both are bit-reproducible. The entry
// dispatches on the dtype; a bf16 call always launches the tensor-core
// kernel or returns the launch's error.

#include "attn_rel_full_tc.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

__global__ void __launch_bounds__(kThreads)
    attn_bwd_rel_saved_kernel(const float* __restrict__ p,
                              const float* __restrict__ pd,
                              const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv,
                              float* __restrict__ debias, int Q, int K, int H,
                              int Dh, float scale) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* as = smem;                  // [Q][Dh + 1]: g, then q
  float* bs = as + Q * ld;           // [K][Dh + 1]: v, then k
  float* ps = bs + K * ld;           // [Q][K] pd
  float* tt = ps + Q * K;            // [Q][K] d(pd), then ds_c

  const size_t qoff = (size_t)b * Q * D + h * Dh;
  const size_t koff = (size_t)b * K * D + h * Dh;
  const size_t head = ((size_t)b * H + h) * Q * K;
  const float* p_head = p + head;
  const float* pd_head = pd + head;
  float* deb_head = debias + head;

  for (int i = tid; i < Q * K; i += kThreads)
    ps[i] = attn::to_float(pd_head[i]);
  attn::load_tile(as, g + qoff, (size_t)D, Q, Dh);
  attn::load_tile(bs, v + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::tile_abt(tt, as, bs, Q, K, Dh);                     // d(pd) = g · vᵀ
  attn::store_mtx(dv + koff, (size_t)D, ps, as, Q, K, Dh);  // dV = pdᵀ · g
  __syncthreads();

  auto pd_of = [ps](int i) { return ps[i]; };
  auto p_of = [p_head](int i) { return attn::to_float(p_head[i]); };
  auto ds_out = [deb_head](int i, float ds) { deb_head[i] = ds; };
  attn::softmax_vjp_rows<float>(tt, Q, K, scale, pd_of, p_of, ds_out);
  __syncthreads();  // g and v no longer needed: stage q and k

  attn::load_tile(as, q + qoff, (size_t)D, Q, Dh);
  attn::load_tile(bs, k + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::store_mx(dq + qoff, (size_t)D, tt, bs, Q, K, Dh);   // dQ = ds_c · k
  attn::store_mtx(dk + koff, (size_t)D, tt, as, Q, K, Dh);  // dK = ds_cᵀ · q
}

// fp32 on the CUDA cores.
int launch_fp32(const void* p, const void* pd, const void* q, const void* k,
                const void* v, const void* g, void* dq, void* dk, void* dv,
                void* debias, int B, int Q, int K, int H, int Dh, float scale,
                cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_rel_saved_kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::rel_bwd_smem_floats(Q, K, Dh) * sizeof(float);
  attn_bwd_rel_saved_kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(p), static_cast<const float*>(pd),
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(debias), Q, K, H, Dh,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd are the saved
// probs [B, H, Q, K] (the same pointer twice when the rate was 0), g the
// context gradient [B, Q, D]; dq [B, Q, D], dk and dv [B, K, D] and debias
// [B, H, Q, K] are written. Returns the cudaError_t of the launch (0 on
// success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue. The reach is the fp32 plan's
// (ops/fused_attention.py::rel_bwd_fits), which the bf16 plan covers.
int attn_bwd_rel_saved(const void* p, const void* pd, const void* q,
                       const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, void* debias, int B, int Q, int K,
                       int H, int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0 ||
      attn::rel_bwd_smem_floats(Q, K, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fp32(p, pd, q, k, v, g, dq, dk, dv, debias, B, Q, K, H,
                         Dh, scale, st);
    case 1: {  // the tensor-core plan of attn_rel_full_tc.cuh
      using bf16 = __nv_bfloat16;
      const rel_tc::BwdArgs a{static_cast<const bf16*>(p),
                              static_cast<const bf16*>(pd),
                              static_cast<const bf16*>(q),
                              static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v),
                              static_cast<const bf16*>(g),
                              static_cast<bf16*>(dq),
                              static_cast<bf16*>(dk),
                              static_cast<bf16*>(dv),
                              static_cast<bf16*>(debias),
                              B,
                              Q,
                              K,
                              H,
                              Dh,
                              scale};
      return rel_tc::launch_bwd(a, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
