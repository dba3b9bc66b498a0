// Packed-layout attention backward from saved probs, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_packed_saved_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1108), taken when
// the forward saved p and pd (`fused_attention_packed` with save on: the
// default while the prob residuals stay under 256 MB).
//
// What it computes, per batch row b and head h, from the saved probs p and
// pd [B, H, S, S] (input dtype; pd is p when the rate was 0), qkv
// [B, S, 3D] and the context gradient g [B, S, D]:
//   dV   = pdᵀ · g_h                        (fp32 accumulate)
//   d(pd) = g_h · V_hᵀ                       (fp32)
//   t    = pd ⊙ d(pd);  ds = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K_h,   dK = ds_cᵀ · Q_h
// written into dqkv [B, S, 3D] at the columns q, k, v came from (dQ, then
// dK, then dV). No QK product, no softmax, no random draws.
//
// What bounds it on the card: at B=256, S=50, H=12, Dh=64 it is four
// S×S×Dh products per (b, h), ~2 GFLOP in all, over ~40 MB of qkv/g/dqkv
// plus ~31 MB of saved probs: latency-bound next to the training step's
// GEMMs, as the forward. dQ reduces over keys while dK and dV reduce over
// queries.
//
// What the design does about that: one block per (head, batch row) holds
// the whole [S, S] problem in shared memory (common.cuh's plan, the same
// as the recompute backward's), so every reduction stays inside the block,
// there are no atomics and the result is bit-reproducible; B·H = 3072
// blocks fill the 132 SMs. pd is staged in shared memory for the dV
// product and the VJP, p is read once from device memory, row by row. The
// plan fits 227 KB up to S = 140 at Dh = 64. The products run on the CUDA
// cores in fp32; tensor cores are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_saved_kernel(const T* __restrict__ p,
                                 const T* __restrict__ pd,
                                 const T* __restrict__ qkv,
                                 const T* __restrict__ g,
                                 T* __restrict__ dqkv, int S, int H, int Dh,
                                 float scale) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* as = smem;                  // [S][Dh + 1]
  float* bs = as + S * ld;           // [S][Dh + 1]
  float* ps = bs + S * ld;           // [S][S] pd
  float* tt = ps + S * S;            // [S][S] d(pd), then ds_c

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const T* k_src = q_src + D;
  const T* v_src = q_src + 2 * D;
  const T* g_src = g + (size_t)b * S * D + h * Dh;
  const size_t head = ((size_t)b * H + h) * S * S;
  const T* p_head = p + head;
  const T* pd_head = pd + head;
  T* dq_dst = dqkv + (size_t)b * S * row_stride + h * Dh;
  T* dk_dst = dq_dst + D;
  T* dv_dst = dq_dst + 2 * D;

  for (int i = tid; i < S * S; i += kThreads)
    ps[i] = attn::to_float(pd_head[i]);
  attn::load_tile(as, g_src, (size_t)D, S, Dh);
  attn::load_tile(bs, v_src, row_stride, S, Dh);
  __syncthreads();
  attn::tile_abt(tt, as, bs, S, S, Dh);                   // d(pd) = g · Vᵀ
  attn::store_mtx(dv_dst, row_stride, ps, as, S, S, Dh);  // dV = pdᵀ · g
  __syncthreads();

  auto pd_of = [ps](int i) { return ps[i]; };
  auto p_of = [p_head](int i) { return attn::to_float(p_head[i]); };
  attn::softmax_vjp_rows<T>(tt, S, S, scale, pd_of, p_of,
                            attn::NoDsOut{});
  __syncthreads();  // g and V no longer needed: stage Q and K

  attn::load_tile(as, q_src, row_stride, S, Dh);
  attn::load_tile(bs, k_src, row_stride, S, Dh);
  __syncthreads();
  attn::store_mx(dq_dst, row_stride, tt, bs, S, S, Dh);   // dQ = ds_c · K
  attn::store_mtx(dk_dst, row_stride, tt, as, S, S, Dh);  // dK = ds_cᵀ · Q
}

template <typename T>
int launch(const void* p, const void* pd, const void* qkv, const void* g,
           void* dqkv, int B, int S, int H, int Dh, float scale,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_packed_saved_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::bwd_smem_floats(S, Dh) * sizeof(float);
  attn_bwd_packed_saved_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(pd),
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), S, H, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd are the saved
// probs [B, H, S, S] (the same pointer twice when the rate was 0), g the
// context gradient [B, S, D], dqkv the packed gradient [B, S, 3D].
// Returns the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_packed_saved(const void* p, const void* pd, const void* qkv,
                          const void* g, void* dqkv, int B, int S, int H,
                          int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      attn::bwd_smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(p, pd, qkv, g, dqkv, B, S, H, Dh, scale, st);
    case 1:
      return launch<__nv_bfloat16>(p, pd, qkv, g, dqkv, B, S, H, Dh, scale,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
