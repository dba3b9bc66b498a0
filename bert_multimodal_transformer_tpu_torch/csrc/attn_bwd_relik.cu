// Full-H ingredients rel-attention backward with the probs recomputed, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_relik_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3758), taken when
// #20 saved no probs (past the 256 MB residual cap, or FUSED_ATTN_SAVE=0).
//
// What it computes, per batch row b and head h, from #20's inputs (rw, rr
// [B, Q, D], r [P, D], k, v [B, K, D], ed [B, H, Q], segd, maskb [B, Q, K]),
// the context gradient g [B, Q, D] and the forward's seed:
//   s, p  = #20's scores (common.cuh's `relik_score`, the same floats in the
//           same order) and its fp32 softmax, recomputed
//   pd    = keep ? p · inv_keep : 0, the keep mask replayed from the same
//           Philox stream; pd = p at rate 0
//   then #22's gradients (common.cuh's `relik_bwd_tail`): dv = T(pd)ᵀ · g,
//   ds = t − p · Σ_k t with t = pd ⊙ (g · vᵀ), ded = Σ_k ds · segd, drw,
//   dk from T(ds · scale), drr and this (b, h)'s fp32 dr rows from T(ds)
// drw, drr, dk, dv and ded in the input dtype; the dr rows go to an fp32
// [B, P, D] workspace that #24's third launch sums over B (the wrapper
// makes the two launches).
//
// What bounds it on the card: at B=256, Q=K=50, P=100, H=12, Dh=64 (bf16)
// eight Q×K×Dh products per (b, h) (ac and bd again, then #22's six), ~8
// GFLOP, over ~181 MB (rw, rr, k, v, g read and drw, drr, dk, dv written,
// 20 MB each; ed, segd, maskb, r): bytes bound (0.054 ms), plus the 79 MB dr
// workspace written and read back.
//
// What the design does about that: #12's plan with #22's tail: one block
// per (head, batch row) holds the [Q, K] problem in shared memory (the rw,
// k, rr tiles and the window of Q + K − 1 rows of r, from which every score
// reads its position key r[Q − q + k] at window row (Q − 1 − q) + k: the
// relative shift as index arithmetic, in place of the TPU kernel's
// log-shift). The softmax and the keep mask are common.cuh's
// `softmax_rows_keep_sign` (#12's), the keep bit riding in the sign of p.
// Bit-reproducible, no atomics; the same shared-memory plan as #22. The
// products run on the CUDA cores in fp32.

#include "common.cuh"

#include <cmath>

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_relik_kernel(
        const T* __restrict__ rw, const T* __restrict__ rr,
        const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ ed,
        const T* __restrict__ segd, const T* __restrict__ maskb,
        const T* __restrict__ g, T* __restrict__ drw, T* __restrict__ drr,
        T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ ded,
        float* __restrict__ ws, int Q, int K, int P, int H, int Dh,
        float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const attn::RelikBwdSmem s = attn::relik_bwd_smem(smem, Q, K, Dh);
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = Dh + 1;
  const size_t qoff = (size_t)b * Q * D + h * Dh;
  const size_t koff = (size_t)b * K * D + h * Dh;
  const T* r_head = r + h * Dh;
  const T* ed_bh = ed + ((size_t)b * H + h) * Q;
  const T* segd_b = segd + (size_t)b * Q * K;
  const T* maskb_b = maskb + (size_t)b * Q * K;

  attn::load_tile(s.as, rw + qoff, (size_t)D, Q, Dh);
  attn::load_tile(s.bs, k + koff, (size_t)D, K, Dh);
  attn::load_tile(s.cs, rr + qoff, (size_t)D, Q, Dh);
  attn::load_r_window(s.win, r_head, D, P, 1, Q + K - 1, Dh);
  __syncthreads();

  // Scores, exactly as #20's.
  for (int i = threadIdx.x; i < Q * K; i += kThreads) {
    const int q = i / K, j = i - q * K;
    s.ps[i] = attn::relik_score(
        s.as + q * ld, s.cs + q * ld, s.bs + j * ld,
        s.win + (Q - 1 - q + j) * ld, Dh, scale, attn::to_float(ed_bh[q]),
        attn::to_float(segd_b[i]), attn::to_float(maskb_b[i]));
  }
  __syncthreads();
  attn::softmax_rows_keep_sign<kDropout>(s.ps, Q, K, 0, b, h, drop);
  __syncthreads();  // rw and k no longer needed: stage g and v

  attn::load_tile(s.as, g + qoff, (size_t)D, Q, Dh);
  attn::load_tile(s.bs, v + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::tile_abt(s.tt, s.as, s.bs, Q, K, Dh);  // d(pd) = g · vᵀ
  __syncthreads();

  const float* ps = s.ps;
  const float inv_keep = drop.inv_keep;
  auto pd_of = [ps, inv_keep](int i) {
    return attn::pd_of_signed<kDropout>(ps[i], inv_keep);
  };
  auto p_of = [ps](int i) { return attn::p_of_signed<kDropout>(ps[i]); };
  attn::relik_bwd_tail<T>(s, pd_of, p_of, rw + qoff, rr + qoff, r_head,
                          k + koff, segd_b, drw + qoff, drr + qoff, dk + koff,
                          dv + koff, ded + ((size_t)b * H + h) * Q,
                          ws + (size_t)b * P * D + h * Dh, Q, K, P, D, Dh,
                          scale);
}

template <typename T, bool kDropout>
int launch(const void* rw, const void* rr, const void* r, const void* k,
           const void* v, const void* ed, const void* segd,
           const void* maskb, const void* g, void* drw, void* drr, void* dk,
           void* dv, void* ded, void* ws, int B, int Q, int K, int P, int H,
           int Dh, float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_bwd_relik_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::relik_bwd_smem_floats(Q, K, Dh) * sizeof(float);
  attn_bwd_relik_kernel<T, kDropout><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(rw), static_cast<const T*>(rr),
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ed),
      static_cast<const T*>(segd), static_cast<const T*>(maskb),
      static_cast<const T*>(g), static_cast<T*>(drw), static_cast<T*>(drr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(ded),
      static_cast<float*>(ws), Q, K, P, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor but ws. The inputs are
// #20's and g [B, Q, D]; drw, drr [B, Q, D], dk, dv [B, K, D] and ded
// [B, H, Q] are written, and every element of ws, an fp32 [B, P, D]
// workspace that `attn_bwd_relik_fs_dr` then sums over B into dr. P ≥ Q +
// K. dropout = 0 ignores seed/threshold/inv_keep. Returns the cudaError_t
// of the launch (0 on success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue.
int attn_bwd_relik(const void* rw, const void* rr, const void* r,
                   const void* k, const void* v, const void* ed,
                   const void* segd, const void* maskb, const void* g,
                   void* drw, void* drr, void* dk, void* dv, void* ded,
                   void* ws, int B, int Q, int K, int P, int H, int Dh,
                   float scale, int dropout, unsigned long long seed,
                   unsigned int threshold, float inv_keep, int dtype,
                   void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0 ||
      attn::relik_bwd_smem_floats(Q, K, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(rw, rr, r, k, v, ed, segd, maskb, g, drw,
                                  drr, dk, dv, ded, ws, B, Q, K, P, H, Dh,
                                  scale, drop, st);
    case 1:
      return launch<float, true>(rw, rr, r, k, v, ed, segd, maskb, g, drw,
                                 drr, dk, dv, ded, ws, B, Q, K, P, H, Dh,
                                 scale, drop, st);
    case 2:
      return launch<__nv_bfloat16, false>(rw, rr, r, k, v, ed, segd, maskb,
                                          g, drw, drr, dk, dv, ded, ws, B, Q,
                                          K, P, H, Dh, scale, drop, st);
    case 3:
      return launch<__nv_bfloat16, true>(rw, rr, r, k, v, ed, segd, maskb, g,
                                         drw, drr, dk, dv, ded, ws, B, Q, K,
                                         P, H, Dh, scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
