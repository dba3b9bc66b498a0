// Rel-attention backward with probs recomputed, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_rel_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1463), taken when
// the forward saved no probs (`fused_rel_attention` with save off: past the
// 256 MB residual cap, or FUSED_ATTN_SAVE=0).
//
// What it computes, per batch row b and head h, from q [B, Q, D], k, v
// [B, K, D], ebias [B, H, Q, K], the context gradient g [B, Q, D] and the
// forward's seed:
//   p     = the forward's fp32 softmax of (q_h · k_hᵀ) · scale + ebias[b, h],
//           recomputed with the same op order as attn_fwd_rel.cu
//   pd    = keep ? p · inv_keep : 0, the keep mask replayed from the same
//           Philox stream (common.cuh); pd = p at rate 0
//   dV    = T(pd)ᵀ · g_h                      (pd_c, fp32 accumulate)
//   d(pd) = g_h · v_hᵀ                         (fp32)
//   t     = pd ⊙ d(pd);  ds = t − p · Σ_k t
//   debias[b, h] = T(ds)                       (the score gradient before
//                                                the scale, as the TPU kernel)
//   ds_c  = T(ds · scale);  dQ = ds_c · k_h,  dK = ds_cᵀ · q_h
// written into dq [B, Q, D], dk and dv [B, K, D] at the columns q, k, v
// came from.
//
// What bounds it on the card: at B=256, Q=K=50, H=12, Dh=64 five Q×K×Dh
// products per (b, h), ~2.4 GFLOP, over ~40 MB of q/k/v/g and gradients
// plus the 15 MB ebias read and the 15 MB debias write (bf16): small and
// latency-bound, like the packed twin (attn_bwd_packed.cu). dQ reduces
// over keys while dK and dV reduce over queries.
//
// What the design does about that: bf16 runs on the tensor cores
// (attn_rel_full_tc.cuh's `attn_bwd_rel_tc_kernel`): #11's scores and
// softmax in front of #13's phases, one block per (head, batch row) over
// chunks of the query rows. p comes back with #11's bits (its register plan
// to K = 64, #14's score tile past it), the keep bit in its sign in an fp32
// tile; then d(pd), the VJP and debias from the accumulators in registers,
// pd_c over the probs tile, dV and dK by ldmatrix.trans; every product on
// mma.sync.m16n8k16. fp32 keeps the CUDA-core kernel below and its bits:
// attn_bwd_packed.cu's plan on a [Q, K] problem, one block per (head, batch
// row) holding it in shared memory (common.cuh's rel_bwd_smem_floats: a
// [Q][Dh+1] and a [K][Dh+1] staging tile, the fp32 probs P and the
// gradient tile Tt), so every reduction stays in the block, with no
// atomics, bit-reproducibly; the keep bit rides in the sign of P. The fp32
// plan fits 227 KB up to Q = K = 141 at Dh = 64 (ops/fused_attention.py::
// rel_bwd_fits, whose every shape the bf16 plan takes); the Python wrapper
// refuses more at the forward when a gradient will be needed. The entry
// dispatches on the dtype; a bf16 call always launches the tensor-core
// kernel or returns the launch's error.

#include "attn_rel_full_tc.cuh"

#include <cmath>

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDh = 128;

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rel_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ ebias,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ debias, int Q, int K, int H, int Dh,
                        float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* as = smem;                  // [Q][Dh + 1]: q, then g, then q
  float* bs = as + Q * ld;           // [K][Dh + 1]: k, then v, then k
  float* ps = bs + K * ld;           // [Q][K] p, sign bit = dropped
  float* tt = ps + Q * K;            // [Q][K] d(pd), then ds_c

  const size_t qoff = (size_t)b * Q * D + h * Dh;
  const size_t koff = (size_t)b * K * D + h * Dh;
  const size_t head = ((size_t)b * H + h) * Q * K;
  const float* eb_head = ebias + head;
  float* deb_head = debias + head;

  attn::load_tile(as, q + qoff, (size_t)D, Q, Dh);
  attn::load_tile(bs, k + koff, (size_t)D, K, Dh);
  __syncthreads();

  // Scores, exactly as the forward: (q · k) · scale, then + ebias.
  attn::tile_abt(ps, as, bs, Q, K, Dh);
  for (int i = tid; i < Q * K; i += kThreads)
    ps[i] = __fadd_rn(__fmul_rn(ps[i], scale), attn::to_float(eb_head[i]));
  __syncthreads();

  // fp32 softmax, one warp per row, the forward's loop and reduction
  // order; then the keep mask replayed into the sign bit.
  const int warp = tid / 32, lane = tid % 32;
  for (int qi = warp; qi < Q; qi += kThreads / 32) {
    float* pr = ps + qi * K;
    float m = -INFINITY;
    for (int j = lane; j < K; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < K; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout) {
      for (int j = lane; j < K; j += 32) pr[j] = pr[j] / sum;
    } else {
      for (int j0 = 4 * lane; j0 < K; j0 += 128) {
        const uint4 bits = attn::dropout_bits4(drop, b, h, qi, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < K) {
            const float p = pr[j] / sum;
            pr[j] = attn::word(bits, u) >= drop.threshold
                        ? p
                        : copysignf(p, -1.0f);
          }
        }
      }
    }
  }
  __syncthreads();  // q and k no longer needed: stage g and v

  attn::load_tile(as, g + qoff, (size_t)D, Q, Dh);
  attn::load_tile(bs, v + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::tile_abt(tt, as, bs, Q, K, Dh);  // d(pd) = g · vᵀ
  __syncthreads();

  const float inv_keep = drop.inv_keep;
  auto pd_of = [ps, inv_keep](int i) {
    const float x = ps[i];
    if constexpr (kDropout) return signbit(x) ? 0.0f : __fmul_rn(x, inv_keep);
    return x;
  };
  auto p_of = [ps](int i) { return kDropout ? fabsf(ps[i]) : ps[i]; };
  auto ds_out = [deb_head](int i, float ds) { deb_head[i] = ds; };
  attn::softmax_vjp_rows<float>(tt, Q, K, scale, pd_of, p_of, ds_out);
  __syncthreads();

  // P ← pd for the dV product.
  for (int i = tid; i < Q * K; i += kThreads) ps[i] = pd_of(i);
  __syncthreads();
  attn::store_mtx(dv + koff, (size_t)D, ps, as, Q, K, Dh);  // dV = pdᵀ · g
  __syncthreads();  // g and v no longer needed: stage q and k again

  attn::load_tile(as, q + qoff, (size_t)D, Q, Dh);
  attn::load_tile(bs, k + koff, (size_t)D, K, Dh);
  __syncthreads();
  attn::store_mx(dq + qoff, (size_t)D, tt, bs, Q, K, Dh);   // dQ = ds_c · k
  attn::store_mtx(dk + koff, (size_t)D, tt, as, Q, K, Dh);  // dK = ds_cᵀ · q
}

// fp32 on the CUDA cores.
template <bool kDropout>
int launch_fp32(const void* q, const void* k, const void* v,
                const void* ebias, const void* g, void* dq, void* dk,
                void* dv, void* debias, int B, int Q, int K, int H, int Dh,
                float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_rel_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::rel_bwd_smem_floats(Q, K, Dh) * sizeof(float);
  attn_bwd_rel_kernel<kDropout><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ebias),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(debias), Q, K, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor. g is the context
// gradient [B, Q, D]; dq [B, Q, D], dk and dv [B, K, D] and debias
// [B, H, Q, K] are written. dropout = 0 ignores seed/threshold/inv_keep;
// b_off/h_off (≥ 0) are the global batch row and head of the tensors'
// first (b, h) in the Philox counter (a tensor-parallel rank's shard).
// Returns the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_rel(const void* q, const void* k, const void* v,
                 const void* ebias, const void* g, void* dq, void* dk,
                 void* dv, void* debias, int B, int Q, int K, int H, int Dh,
                 float scale, int dropout, unsigned long long seed,
                 unsigned int threshold, float inv_keep, int b_off,
                 int h_off, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0 ||
      attn::rel_bwd_smem_floats(Q, K, Dh) * sizeof(float) >
          attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_off < 0 || h_off < 0) return (int)cudaErrorInvalidValue;
  const DropoutArgs drop{seed, threshold, inv_keep, b_off, h_off};
  switch (dtype) {
    case 0:
      return dropout ? launch_fp32<true>(q, k, v, ebias, g, dq, dk, dv,
                                         debias, B, Q, K, H, Dh, scale, drop,
                                         st)
                     : launch_fp32<false>(q, k, v, ebias, g, dq, dk, dv,
                                          debias, B, Q, K, H, Dh, scale, drop,
                                          st);
    case 1: {  // the tensor-core plan of attn_rel_full_tc.cuh
      using bf16 = __nv_bfloat16;
      rel_tc::BwdArgs a{nullptr,
                        nullptr,
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
      a.ebias = static_cast<const bf16*>(ebias);
      return rel_tc::launch_bwd_rc(a, dropout != 0, drop, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
