// Full-H ingredients rel-attention forward for Hopper (sm_90a): the MAG-XLNet
// forward under `rel_bias_impl="inkernel"`.
//
// Replaces the TPU kernel `_attn_fwd_relik_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3690), which the
// JAX model takes under "inkernel" while its full-H plan fits, in all its
// modes: serving (rate 0, nothing saved) and training (prob dropout at rate
// > 0, and with `save` the probs p and pd written for the backward).
//
// What it computes, per batch row b and head h, from rw, rr [B, Q, D] (the
// content query and the scaled position query, head-major columns h·Dh +
// c), the position keys r [P, D] (P ≥ Q + K), k, v [B, K, D], the segment
// delta ed [B, H, Q] and the seg-diff and mask biases segd, maskb [B, Q, K],
// all in the input dtype:
//   s    = ((rw · k) · scale + rr · r[Q − q + k]) + ed · segd + maskb
//          (common.cuh's `relik_score`, the TPU kernel's order of additions:
//          rel_shift(rr · rᵀ) + the segment delta + the mask, assembled here)
//   p    = fp32 max-subtracted softmax over the keys
//   save: p_out[b, h] = T(p)
//   rate > 0: p ← keep ? p · inv_keep : 0 in fp32, keep from the Philox
//          stream of common.cuh at counter (k >> 2, q, h + h_off,
//          b + b_off), the mask of #11 and #23 at the same seed; save:
//          pd_out[b, h] = T(p)
//   out  [B, Q, D] = T(p) · v_h accumulated in fp32
// The reference's ef₀ term, constant along k, is softmax-invariant and is
// left out, as the TPU kernel leaves it out. Dh a multiple of 8 up to 128,
// K up to 512, any Q.
//
// What bounds it on the card: at XLNet's serving shape (B=128, Q=K=50,
// P=100, H=12, Dh=64, bf16) the three products (rw·kᵀ, rr·r over the
// shifted window, PV) are ~1.5 GFLOP; rw, rr, k, v and out (9.8 MB each),
// segd and maskb (0.6 MB each) and r are read or written once: ~51 MB,
// bytes bound (0.015 ms). Against #11 it reads rr (9.8 MB) in place of the
// 7.7 MB ebias and adds a second Dh-long dot per score: what it saves is the
// assembly outside the kernel (the [B, H, Q, P] bd product, rel_shift's
// copies, the ef select and the mask add), not its own bytes.
//
// What the design does about that: bf16 runs on the tensor cores
// (attn_relik_full_tc.cuh: #11's plans with the scores built from the
// ingredients, ac = rw·kᵀ and bd from the wide product rr · r-windowᵀ read
// on its diagonal, all on mma.sync fed by ldmatrix from operands cp.async
// staged; the register plan up to K = 64, the score-tile plan past it).
// fp32 keeps the CUDA-core kernel below and its bits: #11's CUDA-core plan
// (common.cuh's `fwd_rel_rows`): one block per (q-tile of 16 rows, head,
// batch row), the rw and rr tiles in shared memory, k_h streamed in 64-row
// chunks by stride; with each key chunk the block stages the window of 79
// rows of r that its tile reads against that chunk, and row qi of the tile
// reads window row (15 − qi) + j for key k0 + j (the TPU kernel shifts the
// whole [H, Q, P] bd block with log-shift lane rolls, `_log_shift`; here the
// shift is index arithmetic, as in #23). The scores then go through #11's
// own softmax, dropout and PV (`fwd_rel_softmax_pv`), so against #11 fed
// the assembled ebias only the score's rounding differs. Shared plan: 78
// KB at K = 512 and Dh = 64, 123 KB at Dh = 128. The entry dispatches on
// the dtype; a bf16 call always launches a tensor-core kernel or returns
// the launch's error (cudaErrorMisalignedAddress where rw, rr, r, k or v
// does not start on the 16 bytes cp.async copies).

#include "attn_relik_full_tc.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 16;     // query rows per block (#11's)
constexpr int kMaxK = 512;
constexpr int kWin = kQTile + attn::kFwdKChunk - 1;  // r rows a chunk reads

// rw, rr tiles [kQTile][dh] each, the k/v chunk [kFwdKChunk][dh + 1], the r
// window [kWin][dh + 1], scores [kQTile][k_len], ed [kQTile].
__host__ __device__ inline size_t smem_floats(int k_len, int dh) {
  return 2 * (size_t)kQTile * dh +
         (size_t)(attn::kFwdKChunk + kWin) * (dh + 1) +
         (size_t)kQTile * k_len + kQTile;
}

template <typename T, bool kDropout, bool kSave>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_relik_kernel(const T* __restrict__ rw, const T* __restrict__ rr,
                          const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ ed,
                          const T* __restrict__ segd,
                          const T* __restrict__ maskb, T* __restrict__ out,
                          T* __restrict__ p_out, T* __restrict__ pd_out, int Q,
                          int K, int P, int H, int Dh, float scale,
                          DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* rws = smem;                           // [kQTile][Dh]
  float* rrs = rws + kQTile * Dh;              // [kQTile][Dh]
  float* kvs = rrs + kQTile * Dh;              // [kFwdKChunk][Dh + 1]
  float* rwin = kvs + attn::kFwdKChunk * ld;   // [kWin][Dh + 1]
  float* ps = rwin + kWin * ld;                // [kQTile][K]
  float* ed_s = ps + kQTile * K;               // [kQTile]

  const size_t q_off = (size_t)b * Q * D + h * Dh;
  const T* k_base = k + (size_t)b * K * D + h * Dh;
  const T* r_head = r + h * Dh;
  // row q of ed[b, h] and of the saved probs starts at head_row + q (·K)
  const size_t head_row = ((size_t)b * H + h) * Q;
  const size_t qk_row = (size_t)b * Q;         // segd and maskb rows
  const int q_rows = min(kQTile, Q - q0);

  // rw and rr tiles; rows past Q are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += attn::kFwdThreads) {
    const int rq = i / Dh, c = i - rq * Dh;
    const bool live = rq < q_rows;
    const size_t at = q_off + (size_t)(q0 + rq) * D + c;
    rws[i] = live ? attn::to_float(rw[at]) : 0.0f;
    rrs[i] = live ? attn::to_float(rr[at]) : 0.0f;
  }
  for (int i = tid; i < kQTile; i += attn::kFwdThreads)
    ed_s[i] = i < q_rows ? attn::to_float(ed[head_row + q0 + i]) : 0.0f;

  // Scores over K in chunks: the chunk's k rows and the r window its tile
  // reads, then one relik_score per element.
  for (int k0 = 0; k0 < K; k0 += attn::kFwdKChunk) {
    const int k_rows = min(attn::kFwdKChunk, K - k0);
    __syncthreads();  // previous chunk's readers are done (and tiles set)
    attn::load_tile(kvs, k_base + (size_t)k0 * D, (size_t)D, k_rows, Dh);
    attn::load_r_window(rwin, r_head, D, P, Q - q0 - (kQTile - 1) + k0, kWin,
                        Dh);
    __syncthreads();
    for (int i = tid; i < q_rows * k_rows; i += attn::kFwdThreads) {
      const int rq = i / k_rows, j = i - rq * k_rows;
      const size_t qk = (qk_row + q0 + rq) * K + k0 + j;
      ps[rq * K + k0 + j] = attn::relik_score(
          rws + rq * Dh, rrs + rq * Dh, kvs + j * ld,
          rwin + (kQTile - 1 - rq + j) * ld, Dh, scale, ed_s[rq],
          attn::to_float(segd[qk]), attn::to_float(maskb[qk]));
    }
  }
  attn::fwd_rel_softmax_pv<T, kQTile, kDropout, kSave>(
      kvs, ps, v + (size_t)b * K * D + h * Dh, out + q_off, p_out, pd_out,
      head_row, q0, q_rows, K, D, Dh, b, h, drop);
}

template <typename T, bool kDropout, bool kSave>
int launch(const void* rw, const void* rr, const void* r, const void* k,
           const void* v, const void* ed, const void* segd,
           const void* maskb, void* out, void* p, void* pd, int B, int Q,
           int K, int P, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_relik_kernel<T, kDropout, kSave>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_relik_kernel<T, kDropout, kSave>
      <<<grid, attn::kFwdThreads, smem_floats(K, Dh) * sizeof(float),
         stream>>>(
          static_cast<const T*>(rw), static_cast<const T*>(rr),
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ed),
          static_cast<const T*>(segd), static_cast<const T*>(maskb),
          static_cast<T*>(out), static_cast<T*>(p), static_cast<T*>(pd), Q,
          K, P, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* rw, const void* rr, const void* r, const void* k,
             const void* v, const void* ed, const void* segd,
             const void* maskb, void* out, void* p, void* pd, int B, int Q,
             int K, int P, int H, int Dh, float scale, bool dropout,
             DropoutArgs drop, cudaStream_t st) {
  const bool save = p != nullptr;
  if (dropout && save)
    return launch<T, true, true>(rw, rr, r, k, v, ed, segd, maskb, out, p,
                                 pd, B, Q, K, P, H, Dh, scale, drop, st);
  if (dropout)
    return launch<T, true, false>(rw, rr, r, k, v, ed, segd, maskb, out, p,
                                  pd, B, Q, K, P, H, Dh, scale, drop, st);
  if (save)
    return launch<T, false, true>(rw, rr, r, k, v, ed, segd, maskb, out, p,
                                  pd, B, Q, K, P, H, Dh, scale, drop, st);
  return launch<T, false, false>(rw, rr, r, k, v, ed, segd, maskb, out, p,
                                 pd, B, Q, K, P, H, Dh, scale, drop, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for rw, rr, r, k, v, ed, segd, maskb,
// out, p and pd. P ≥ Q + K. p/pd: null for no save; with save, p gets the
// pre-dropout probs and, when dropout is on, pd the dropped and scaled ones
// ([B, H, Q, K]). dropout = 0 ignores seed/threshold/inv_keep;
// b_off/h_off (≥ 0) are the global batch row and head of the tensors'
// first (b, h) in the Philox counter (a tensor-parallel rank's shard).
// Returns the cudaError_t of the launch (0 on success); a shape the kernel
// does not take returns cudaErrorInvalidValue.
int attn_fwd_relik(const void* rw, const void* rr, const void* r,
                   const void* k, const void* v, const void* ed,
                   const void* segd, const void* maskb, void* out, void* p,
                   void* pd, int B, int Q, int K, int P, int H, int Dh,
                   float scale, int dropout, unsigned long long seed,
                   unsigned int threshold, float inv_keep, int b_off,
                   int h_off, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || P < Q + K || H < 1 ||
      Dh < 8 || Dh > attn::kFwdMaxDh || Dh % 8 != 0 ||
      smem_floats(K, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dropout && p != nullptr && pd == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_off < 0 || h_off < 0) return (int)cudaErrorInvalidValue;
  const DropoutArgs drop{seed, threshold, inv_keep, b_off, h_off};
  switch (dtype) {
    case 0:
      return dispatch<float>(rw, rr, r, k, v, ed, segd, maskb, out, p, pd, B,
                             Q, K, P, H, Dh, scale, dropout != 0, drop, st);
    case 1: {  // the tensor-core plans of attn_relik_full_tc.cuh
      using bf16 = __nv_bfloat16;
      const relik_tc::FwdArgs a{static_cast<const bf16*>(rw),
                                static_cast<const bf16*>(rr),
                                static_cast<const bf16*>(r),
                                static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v),
                                static_cast<const bf16*>(ed),
                                static_cast<const bf16*>(segd),
                                static_cast<const bf16*>(maskb),
                                static_cast<bf16*>(out),
                                static_cast<bf16*>(p),
                                static_cast<bf16*>(pd),
                                B,
                                Q,
                                K,
                                P,
                                H,
                                Dh,
                                scale};
      return relik_tc::launch_fwd(a, dropout != 0, drop, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
