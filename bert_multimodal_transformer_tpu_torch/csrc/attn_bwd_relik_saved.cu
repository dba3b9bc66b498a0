// Full-H ingredients rel-attention backward from saved probs, for Hopper
// (sm_90a): the MAG-XLNet training backward under `rel_bias_impl=
// "inkernel"`.
//
// Replaces the TPU kernel `_attn_bwd_relik_saved_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3809), taken when
// #20 saved p and pd (the default while the prob residuals stay under
// 256 MB: every XLNet train step at the driver's shapes).
//
// What it computes, per batch row b and head h, from the saved probs p and
// pd [B, H, Q, K] (input dtype; pd is p when the rate was 0), rw, rr
// [B, Q, D], the position keys r [P, D], k, v [B, K, D], segd [B, Q, K] and
// the context gradient g [B, Q, D], every product accumulated in fp32:
//   dv    = pdᵀ · g_h
//   d(pd) = g_h · v_hᵀ;  t = pd ⊙ d(pd);  ds = t − p · Σ_k t
//   ded[b, h, q] = Σ_k ds · segd             (from the fp32 ds)
//   ds_c  = T(ds · scale);  drw = ds_c · k_h,  dk = ds_cᵀ · rw_h
//   ds_u  = T(ds);  drr[q] = Σ_k ds_u[q][k] · r[Q − q + k]
//   dr[p] = Σ_b Σ_q ds_u[b, h, q, p − Q + q] · rr[b, q]  (k in range)
// (the TPU kernel's `_relik_grads`: its `_log_unshift` places ds_u at the
// positions it multiplies, which here is the index Q − q + k). No score, no
// softmax, no random draws. drw, drr, dk, dv and ded are written in the
// input dtype; dr in fp32 (the wrapper casts it to r's dtype, as the JAX
// `_frelik_bwd`).
//
// What bounds it on the card: at B=256, Q=K=50, P=100, H=12, Dh=64 (bf16)
// six Q×K×Dh products per (b, h) (d(pd), dv, drw, dk, drr, dr), ~6 GFLOP,
// over ~210 MB: the 31 MB of saved probs and rw, rr, k, v and g (20 MB
// each) read, drw, drr, dk and dv (20 MB each) written: bytes bound (0.063
// ms). The deterministic d_r below adds its fp32 [B, P, D] workspace (79 MB
// written, then read by the sum) to what the card moves.
//
// What the design does about that: #13's plan: one block per (head, batch
// row) holds the [Q, K] problem in shared memory (common.cuh's
// `relik_bwd_smem_floats`: the rw/g, k/v and rr tiles, the window of Q + K
// − 1 rows of r the scores read, and three [Q][K] tiles), 3072 blocks at
// the training shape, every sum inside the block. d_r sums over the whole
// batch: the TPU grid adds each step's [P, D] into one block in order
// (:3773-3776), which Hopper's unordered blocks cannot do without float
// atomics, whose order changes from run to run. So each (b, h) block writes
// its own fp32 slice ws[b, :, h·Dh:(h+1)·Dh] of a [B, P, D] workspace, every
// row of it (zeros where no key is in range), and #24's third launch
// (`attn_bwd_relik_fs_dr`, attn_bwd_relik_fs.cu) sums it over b in a fixed
// order: two launches a call, bit-reproducible. The tail after d(pd) is
// common.cuh's `relik_bwd_tail`, shared with #21. The plan fits 227 KB up
// to Q = 50, K = 100 (the `--mem_len 50` path) and Q = K = 95 at Dh = 64.
// The products run on the CUDA cores in fp32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_relik_saved_kernel(
        const T* __restrict__ p, const T* __restrict__ pd,
        const T* __restrict__ rw, const T* __restrict__ rr,
        const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ segd,
        const T* __restrict__ g, T* __restrict__ drw, T* __restrict__ drr,
        T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ ded,
        float* __restrict__ ws, int Q, int K, int P, int H, int Dh,
        float scale) {
  extern __shared__ float smem[];
  const attn::RelikBwdSmem s = attn::relik_bwd_smem(smem, Q, K, Dh);
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t qoff = (size_t)b * Q * D + h * Dh;
  const size_t koff = (size_t)b * K * D + h * Dh;
  const size_t head = ((size_t)b * H + h) * Q * K;
  const T* p_head = p + head;
  const T* pd_head = pd + head;

  for (int i = threadIdx.x; i < Q * K; i += kThreads)
    s.ps[i] = attn::to_float(pd_head[i]);
  attn::load_tile(s.as, g + qoff, (size_t)D, Q, Dh);
  attn::load_tile(s.bs, v + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::tile_abt(s.tt, s.as, s.bs, Q, K, Dh);  // d(pd) = g · vᵀ
  __syncthreads();

  const float* ps = s.ps;
  auto pd_of = [ps](int i) { return ps[i]; };
  auto p_of = [p_head](int i) { return attn::to_float(p_head[i]); };
  attn::relik_bwd_tail<T>(s, pd_of, p_of, rw + qoff, rr + qoff, r + h * Dh,
                          k + koff, segd + (size_t)b * Q * K, drw + qoff,
                          drr + qoff, dk + koff, dv + koff,
                          ded + ((size_t)b * H + h) * Q,
                          ws + (size_t)b * P * D + h * Dh, Q, K, P, D, Dh,
                          scale);
}

template <typename T>
int launch(const void* p, const void* pd, const void* rw, const void* rr,
           const void* r, const void* k, const void* v, const void* segd,
           const void* g, void* drw, void* drr, void* dk, void* dv,
           void* ded, void* ws, int B, int Q, int K, int P, int H, int Dh,
           float scale, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_bwd_relik_saved_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::relik_bwd_smem_floats(Q, K, Dh) * sizeof(float);
  attn_bwd_relik_saved_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(pd),
      static_cast<const T*>(rw), static_cast<const T*>(rr),
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(segd),
      static_cast<const T*>(g), static_cast<T*>(drw), static_cast<T*>(drr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(ded),
      static_cast<float*>(ws), Q, K, P, H, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor but ws. p/pd are the
// saved probs [B, H, Q, K] (the same pointer twice when the rate was 0), g
// the context gradient [B, Q, D]; drw, drr [B, Q, D], dk, dv [B, K, D] and
// ded [B, H, Q] are written, and every element of ws, an fp32 [B, P, D]
// workspace that `attn_bwd_relik_fs_dr` then sums over B into dr. P ≥ Q +
// K. Returns the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_relik_saved(const void* p, const void* pd, const void* rw,
                         const void* rr, const void* r, const void* k,
                         const void* v, const void* segd, const void* g,
                         void* drw, void* drr, void* dk, void* dv, void* ded,
                         void* ws, int B, int Q, int K, int P, int H, int Dh,
                         float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0 ||
      attn::relik_bwd_smem_floats(Q, K, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(p, pd, rw, rr, r, k, v, segd, g, drw, drr, dk, dv,
                           ded, ws, B, Q, K, P, H, Dh, scale, st);
    case 1:
      return launch<__nv_bfloat16>(p, pd, rw, rr, r, k, v, segd, g, drw, drr,
                                   dk, dv, ded, ws, B, Q, K, P, H, Dh, scale,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
