// Head-blocked rel-attention backward with probs recomputed, for Hopper
// (sm_90a): the training backward past kernel #12's reach.
//
// Replaces the TPU kernel `_attn_bwd_rel_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1601), the
// recompute backward of the head-blocked rel tier (nothing Q·K-sized saved).
//
// What it computes: #12's function. Per batch row b and head h, from q
// [B, Q, D], k, v [B, K, D], ebias [B, H, Q, K], the context gradient g
// [B, Q, D] and the forward's seed:
//   p     = the forward's whole-row fp32 softmax of (q_h · k_hᵀ) · scale +
//           ebias[b, h], recomputed
//   pd    = keep ? p · inv_keep : 0, the keep mask replayed (common.cuh)
//   dV    = T(pd)ᵀ · g_h;   d(pd) = g_h · v_hᵀ
//   t     = pd ⊙ d(pd);  ds = t − p · Σ_k t;  debias[b, h] = T(ds)
//   ds_c  = T(ds · scale);  dQ = ds_c · k_h,  dK = ds_cᵀ · q_h
// written into dq [B, Q, D], dk and dv [B, K, D] at the columns q, k, v
// came from.
//
// What bounds it on the card: at the stream path's training shape (B=48,
// Q=K=512, H=12, Dh=64) five Q×K×Dh products per (b, h), ~97 GFLOP, and
// the 302 MB ebias read and 302 MB debias write (bf16) of the ≈0.87 GB
// read or written once: bytes bound at the bf16 tensor-core peak (0.26 ms
// against 0.10 ms). dQ and debias live along the query rows while dK and
// dV reduce over them, and #12's plan, one block holding the whole [Q, K]
// problem, fits 227 KB only up to Q = K = 141.
//
// What the design does about that (bf16): the two tensor-core passes of
// attn_bwd_rel_tc.cuh with their own row statistics (#5's plan;
// `attn_bwd_rel_dq_tc_kernel`, then `attn_bwd_rel_dkdv_tc_kernel`,
// kOwnStats true), each a deterministic reduction inside its blocks: #14
// returns no lse, and #12's δ is Σ_k t, not Σ g ⊙ o. The dQ pass (one
// block per 64-query tile, head and batch row) walks the keys twice
// through one two-stage cp.async ring of K, V and the [64 q][64 k] ebias
// slice: first for the online max, denominator and δ·l of its rows (S =
// Q·Kᵀ and d(pd) = g·Vᵀ on mma.sync, the keep mask replayed), which it
// writes as m, 1/l and δ [3][B, H, Q] fp32 into ws; then for p = exp(s − m) · (1/l), ds, dQ and
// debias = T(ds), written over the slice it read and stored in 16-byte row
// chunks (m and 1/l apart: in a row masked whole every score is −1e30, where
// s − m is exact). The dK/dV pass (one block per 64-key tile), launched
// second, reads them and walks the queries, each query block's ebias slice
// in its own ring. Both passes assemble the scores from the same ebias bits
// and run the same elementwise step on the same statistics' bits, so they
// see the same ds bits. Nine products in all against the five of the
// minimum, ~174 GFLOP, and three ebias reads; nothing Q·K-sized in shared
// memory and no workspace for dK and dV: 90 KB (dK/dV) and 72.8 KB (dQ) at
// Dh = 64, two blocks an SM, 138 KB and 120.8 KB at Dh = 128, at any K
// (ops/fused_attention.py::rel_hb_bwd_smem_bytes). No atomics: the same
// bits twice. p = exp(s − m) · (1/l) and the online δ differ from #12's
// e / l and whole-row Σ t at the fp32 level, so bf16 #15 is held to #12
// within `rel_grads_bf16_bound`, no longer bit for bit.
//
// fp32 input keeps the CUDA-core kernel (`attn_bwd_rel_hb_kernel`), #12's
// bits wherever both reach (Q = K ≤ 141 at Dh = 64): #5's fp32 plan on a
// [Q, K] problem. One block per (head, batch row) walks its query rows in
// tiles of 32, in order. For each tile it recomputes the tile's whole score
// rows (row max and sum exact, as #12), replays the mask, forms ds for
// those rows, writes the tile's debias rows (a row's ds needs no other
// tile) and dQ rows, and adds the tile's dK and dV contributions into fp32
// accumulators that the block alone owns: [K][Dh] each in a device
// workspace (ws) the wrapper allocates, read and written by the same thread
// each tile. The last tile rounds them into dk and dv. Every sum runs in
// #12's order (a key's dK chain goes over the queries in ascending order,
// across tiles), with no atomics. Shared plan: P and Tt [32][K], q and g
// tiles and a k/v chunk [32][Dh+1] each, 213 KB at K = 640, Dh = 128, so
// one block an SM with 16 warps to hide the latency of its dependent chains
// (#5's finding). The products run on the CUDA cores in fp32. The entries
// dispatch on the dtype; a bf16 call always launches the tensor-core passes
// or returns the launch's error (cudaErrorMisalignedAddress where q, k, v
// or g does not start on the 16 bytes cp.async copies).

#include "attn_bwd_rel_tc.cuh"
#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 512;  // 16 warps
constexpr int kQTile = 32;     // query rows per step of the walk
constexpr int kKChunk = 32;    // key/value rows staged in shared memory
constexpr int kMaxDh = 128;
constexpr int kMaxK = 640;     // ops/fused_attention.py::HB_MAX_SEQ_LEN
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;  // dQ accumulators

__host__ __device__ inline size_t smem_floats(int k_len, int dh) {
  return 2 * (size_t)kQTile * k_len + 2 * (size_t)kQTile * (dh + 1) +
         (size_t)kKChunk * (dh + 1);
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rel_hb_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ ebias,
                           const T* __restrict__ g, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv,
                           T* __restrict__ debias, float* __restrict__ ws,
                           int Q, int K, int H, int Dh, float scale,
                           DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* ps = smem;                   // [kQTile][K] p (sign bit = dropped)
  float* tt = ps + kQTile * K;        // [kQTile][K] d(pd), then ds_c
  float* qs = tt + kQTile * K;        // [kQTile][Dh + 1]
  float* gs = qs + kQTile * ld;       // [kQTile][Dh + 1]
  float* kvs = gs + kQTile * ld;      // [kKChunk][Dh + 1]

  const T* q_src = q + (size_t)b * Q * D + h * Dh;
  const T* k_src = k + (size_t)b * K * D + h * Dh;
  const T* v_src = v + (size_t)b * K * D + h * Dh;
  const T* g_src = g + (size_t)b * Q * D + h * Dh;
  T* dq_dst = dq + (size_t)b * Q * D + h * Dh;
  T* dk_dst = dk + (size_t)b * K * D + h * Dh;
  T* dv_dst = dv + (size_t)b * K * D + h * Dh;
  const size_t head = ((size_t)b * H + h) * Q * K;
  // This block's fp32 dK and dV accumulators, [K][Dh] each.
  float* ws_dk = ws + (((size_t)b * H + h) * 2) * K * Dh;
  float* ws_dv = ws_dk + (size_t)K * Dh;

  const float inv_keep = drop.inv_keep;
  auto pd_of = [ps, inv_keep](int i) {
    return attn::pd_of_signed<kDropout>(ps[i], inv_keep);
  };
  auto p_of = [ps](int i) { return attn::p_of_signed<kDropout>(ps[i]); };

  for (int q0 = 0; q0 < Q; q0 += kQTile) {
    const int rows = min(kQTile, Q - q0);
    const bool first = q0 == 0, last = q0 + kQTile >= Q;
    const T* eb_tile = ebias + head + (size_t)q0 * K;
    T* deb_tile = debias + head + (size_t)q0 * K;
    __syncthreads();  // the previous tile's readers are done
    attn::load_tile(qs, q_src + (size_t)q0 * D, (size_t)D, rows, Dh);
    attn::load_tile(gs, g_src + (size_t)q0 * D, (size_t)D, rows, Dh);

    // Scores of the tile's rows, exactly as the forward: (q · k) · scale,
    // then + ebias; k streamed in chunks.
    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      const int kr = min(kKChunk, K - k0);
      __syncthreads();
      attn::load_tile(kvs, k_src + (size_t)k0 * D, (size_t)D, kr, Dh);
      __syncthreads();
      for (int i = tid; i < rows * kr; i += kThreads) {
        const int r = i / kr, j = i - r * kr;
        const float* qr = qs + r * ld;
        const float* kj = kvs + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kj[c], acc);
        ps[r * K + k0 + j] =
            __fadd_rn(__fmul_rn(acc, scale),
                      attn::to_float(eb_tile[(size_t)r * K + k0 + j]));
      }
    }
    __syncthreads();
    attn::softmax_rows_keep_sign<kDropout>(ps, rows, K, q0, b, h, drop);

    // d(pd) = g · vᵀ, v streamed in chunks.
    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      const int kr = min(kKChunk, K - k0);
      __syncthreads();
      attn::load_tile(kvs, v_src + (size_t)k0 * D, (size_t)D, kr, Dh);
      __syncthreads();
      for (int i = tid; i < rows * kr; i += kThreads) {
        const int r = i / kr, j = i - r * kr;
        const float* gr = gs + r * ld;
        const float* vj = kvs + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < Dh; ++c) acc = fmaf(gr[c], vj[c], acc);
        tt[r * K + k0 + j] = acc;
      }
    }
    __syncthreads();
    auto ds_out = [deb_tile](int i, float ds) {
      deb_tile[i] = attn::from_float<T>(ds);
    };
    attn::softmax_vjp_rows<T>(tt, rows, K, scale, pd_of, p_of, ds_out);
    __syncthreads();
    // P ← pd_c = T(pd) for the dV product.
    for (int i = tid; i < rows * K; i += kThreads)
      ps[i] = attn::round_to<T>(pd_of(i));
    __syncthreads();

    // dV[k] += Σ_r pd_c[r][k] · g[r]: the chain over queries continues
    // from the previous tiles' sum; the last tile writes it rounded.
    for (int i = tid; i < K * Dh; i += kThreads) {
      const int kk = i / Dh, c = i - kk * Dh;
      float acc = first ? 0.0f : ws_dv[i];
      for (int r = 0; r < rows; ++r)
        acc = fmaf(ps[r * K + kk], gs[r * ld + c], acc);
      if (last)
        dv_dst[(size_t)kk * D + c] = attn::from_float<T>(acc);
      else
        ws_dv[i] = acc;
    }

    // dQ = ds_c · k (registers, over k chunks in order) and dK[k] +=
    // Σ_r ds_c[r][k] · q[r] for the chunk's keys.
    float dq_acc[kAccPerThread];
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) dq_acc[a] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      const int kr = min(kKChunk, K - k0);
      __syncthreads();
      attn::load_tile(kvs, k_src + (size_t)k0 * D, (size_t)D, kr, Dh);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int i = tid + a * kThreads;
        const int r = i / Dh, c = i - r * Dh;
        if (i < kQTile * Dh && r < rows) {
          const float* dr = tt + r * K + k0;
          float acc = dq_acc[a];
          for (int j = 0; j < kr; ++j) acc = fmaf(dr[j], kvs[j * ld + c], acc);
          dq_acc[a] = acc;
        }
      }
      for (int i = tid; i < kr * Dh; i += kThreads) {
        const int j = i / Dh, c = i - j * Dh;
        const int kk = k0 + j;
        const size_t w = (size_t)kk * Dh + c;
        float acc = first ? 0.0f : ws_dk[w];
        for (int r = 0; r < rows; ++r)
          acc = fmaf(tt[r * K + kk], qs[r * ld + c], acc);
        if (last)
          dk_dst[(size_t)kk * D + c] = attn::from_float<T>(acc);
        else
          ws_dk[w] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kQTile * Dh && r < rows)
        dq_dst[(size_t)(q0 + r) * D + c] = attn::from_float<T>(dq_acc[a]);
    }
  }
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           const void* g, void* dq, void* dk, void* dv, void* debias,
           void* ws, int B, int Q, int K, int H, int Dh, float scale,
           DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_rel_hb_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(K, Dh) * sizeof(float);
  attn_bwd_rel_hb_kernel<T, kDropout><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ebias),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(debias), static_cast<float*>(ws),
      Q, K, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of #15. dtype: 0 = float32, 1 = bfloat16, for every tensor
// but ws. g is the context gradient [B, Q, D]; dq [B, Q, D], dk and dv
// [B, K, D] and debias [B, H, Q, K] are written. fp32: the CUDA-core
// kernel, the whole backward in one launch; ws an fp32 workspace of
// 2·B·H·K·Dh floats (contents ignored). bf16: the first of the two
// tensor-core passes, the statistics walk and dQ, which writes the rows'
// m, 1/l and δ into ws (fp32 [3][B, H, Q]), dq and debias;
// `attn_bwd_rel_hb_dkdv` is the second. dropout = 0 ignores
// seed/threshold/inv_keep. Returns the cudaError_t of the launch (0 on
// success); a shape past the dtype's shared-memory plan returns
// cudaErrorInvalidValue.
int attn_bwd_rel_hb(const void* q, const void* k, const void* v,
                    const void* ebias, const void* g, void* dq, void* dk,
                    void* dv, void* debias, void* ws, int B, int Q, int K,
                    int H, int Dh, float scale, int dropout,
                    unsigned long long seed, unsigned int threshold,
                    float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0 ||
      (dtype == 0 &&
       smem_floats(K, Dh) * sizeof(float) > attn::kMaxSmemBytes))
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dropout ? launch<float, true>(q, k, v, ebias, g, dq, dk, dv,
                                           debias, ws, B, Q, K, H, Dh, scale,
                                           drop, st)
                     : launch<float, false>(q, k, v, ebias, g, dq, dk, dv,
                                            debias, ws, B, Q, K, H, Dh, scale,
                                            drop, st);
    case 1:
      return rel_tc::launch_pass<false, true>(
          q, k, v, ebias, nullptr, static_cast<float*>(ws), g, dq, dk, dv,
          debias, B, Q, K, H, Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The second bf16 pass of #15, launched after `attn_bwd_rel_hb` on the same
// stream with the same arguments: the dK/dV pass, reading the statistics
// that the first wrote into ws, writes dk and dv. Returns the cudaError_t
// of the launch; any dtype but bfloat16 returns cudaErrorInvalidValue (fp32
// is one launch).
int attn_bwd_rel_hb_dkdv(const void* q, const void* k, const void* v,
                         const void* ebias, const void* g, void* dq, void* dk,
                         void* dv, void* debias, void* ws, int B, int Q,
                         int K, int H, int Dh, float scale, int dropout,
                         unsigned long long seed, unsigned int threshold,
                         float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0 || dtype != 1)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  return rel_tc::launch_pass<true, true>(
      q, k, v, ebias, nullptr, static_cast<float*>(ws), g, dq, dk, dv, debias,
      B, Q, K, H, Dh, scale, dropout != 0,
      DropoutArgs{seed, threshold, inv_keep},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
