// Head-blocked packed attention backward with probs recomputed, for Hopper
// (sm_90a): the training backward past kernel #2's reach.
//
// Replaces the TPU kernel `_attn_bwd_packed_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1195), the
// recompute backward of the head-blocked tier (nothing S²-sized saved).
//
// What it computes: #2's function. Per batch row b and head h, from qkv
// [B, S, 3D], the fp32 mask, the context gradient g [B, S, D] and the
// forward's seed:
//   p    = the forward's whole-row fp32 softmax, recomputed
//   pd   = keep ? p · inv_keep : 0, the keep mask replayed (common.cuh)
//   dV   = T(pd)ᵀ · g_h;   d(pd) = g_h · V_hᵀ
//   t    = pd ⊙ d(pd);  ds = (t − p · Σ_k t) · scale;  ds_c = T(ds)
//   dQ   = ds_c · K_h,     dK = ds_cᵀ · Q_h
// written into dqkv [B, S, 3D] at the columns q, k, v came from.
//
// What bounds it on the card: five S×S×Dh products per (b, h), ~97 GFLOP
// at the driver's training shape (B=48, S=512, H=12, Dh=64), operations
// bound on any core. The trouble is the reductions: dQ reduces over keys
// while dK and dV reduce over queries, and #2's plan, one block holding
// the whole [S, S] problem, fits 227 KB only up to S = 140.
//
// What the design does about that: one block per (head, batch row) walks
// its query rows in tiles of 32, in order. For each tile it recomputes the
// tile's whole score rows (row max and sum exact, as #2), replays the mask,
// forms ds for those rows, writes the tile's dQ rows, and adds the tile's
// dK and dV contributions into fp32 accumulators that the block alone owns:
// [S][Dh] each, 320 KB at S = 640, Dh = 64, so they live in a device
// workspace (ws) the wrapper allocates, read and written by the same
// thread each tile. The last tile rounds them into dqkv. Every sum runs in
// #2's order (a key's dK chain goes over the queries in ascending order,
// across tiles), so #5 gives #2's bits wherever both reach (S ≤ 140), with
// no atomics and bit-reproducible results. Shared plan: P and Tt
// [32][S], Q and g tiles [32][Dh+1], a [32][Dh+1] K/V chunk and the [S]
// bias, 211 KB at S = 640, Dh = 128 (up to S = 703 at Dh = 128, 798 at
// Dh = 64). That leaves one block an SM, so a block has 16 warps to hide
// the latency of its dependent chains and ws reads (on an H100 at the
// training shape, bf16 rate 0.1: 28.1 ms against 42.3 ms with 8 warps,
// the same bits; PERF.md).
// B·H = 576 blocks at the training shape fill the 132 SMs. The products
// run on the CUDA cores in fp32.

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 512;  // 16 warps
constexpr int kQTile = 32;     // query rows per step of the walk
constexpr int kKChunk = 32;    // key/value rows staged in shared memory
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;  // dQ accumulators

__host__ __device__ inline size_t smem_floats(int s, int dh) {
  return 2 * (size_t)kQTile * s + 2 * (size_t)kQTile * (dh + 1) +
         (size_t)kKChunk * (dh + 1) + (size_t)s;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_hb_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ mask,
                              const T* __restrict__ g, T* __restrict__ dqkv,
                              float* __restrict__ ws, int S, int H, int Dh,
                              float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* ps = smem;                   // [kQTile][S] p (sign bit = dropped)
  float* tt = ps + kQTile * S;        // [kQTile][S] d(pd), then ds_c
  float* qs = tt + kQTile * S;        // [kQTile][Dh + 1]
  float* gs = qs + kQTile * ld;       // [kQTile][Dh + 1]
  float* kvs = gs + kQTile * ld;      // [kKChunk][Dh + 1]
  float* bias = kvs + kKChunk * ld;   // [S]

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const T* k_src = q_src + D;
  const T* v_src = q_src + 2 * D;
  const T* g_src = g + (size_t)b * S * D + h * Dh;
  T* dq_dst = dqkv + (size_t)b * S * row_stride + h * Dh;
  T* dk_dst = dq_dst + D;
  T* dv_dst = dq_dst + 2 * D;
  // This block's fp32 dK and dV accumulators, [S][Dh] each.
  float* ws_dk = ws + (((size_t)b * H + h) * 2) * S * Dh;
  float* ws_dv = ws_dk + (size_t)S * Dh;

  const float inv_keep = drop.inv_keep;
  auto pd_of = [ps, inv_keep](int i) {
    return attn::pd_of_signed<kDropout>(ps[i], inv_keep);
  };
  auto p_of = [ps](int i) { return attn::p_of_signed<kDropout>(ps[i]); };

  for (int j = tid; j < S; j += kThreads)
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + j]) * -10000.0f : 0.0f;

  for (int q0 = 0; q0 < S; q0 += kQTile) {
    const int rows = min(kQTile, S - q0);
    const bool first = q0 == 0, last = q0 + kQTile >= S;
    __syncthreads();  // the previous tile's readers are done
    attn::load_tile(qs, q_src + (size_t)q0 * row_stride, row_stride, rows,
                    Dh);
    attn::load_tile(gs, g_src + (size_t)q0 * D, (size_t)D, rows, Dh);

    // Scores of the tile's rows, exactly as the forward: (q · k) · scale,
    // then + bias; K streamed in chunks.
    for (int k0 = 0; k0 < S; k0 += kKChunk) {
      const int kr = min(kKChunk, S - k0);
      __syncthreads();
      attn::load_tile(kvs, k_src + (size_t)k0 * row_stride, row_stride,
                      kr, Dh);
      __syncthreads();
      for (int i = tid; i < rows * kr; i += kThreads) {
        const int r = i / kr, j = i - r * kr;
        const float* qr = qs + r * ld;
        const float* kj = kvs + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kj[c], acc);
        ps[r * S + k0 + j] = __fadd_rn(__fmul_rn(acc, scale), bias[k0 + j]);
      }
    }
    __syncthreads();
    attn::softmax_rows_keep_sign<kDropout>(ps, rows, S, q0, b, h, drop);

    // d(pd) = g · Vᵀ, V streamed in chunks.
    for (int k0 = 0; k0 < S; k0 += kKChunk) {
      const int kr = min(kKChunk, S - k0);
      __syncthreads();
      attn::load_tile(kvs, v_src + (size_t)k0 * row_stride, row_stride,
                      kr, Dh);
      __syncthreads();
      for (int i = tid; i < rows * kr; i += kThreads) {
        const int r = i / kr, j = i - r * kr;
        const float* gr = gs + r * ld;
        const float* vj = kvs + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < Dh; ++c) acc = fmaf(gr[c], vj[c], acc);
        tt[r * S + k0 + j] = acc;
      }
    }
    __syncthreads();
    attn::softmax_vjp_rows<T>(tt, rows, S, scale, pd_of, p_of,
                              attn::NoDsOut{});
    __syncthreads();
    // P ← pd_c = T(pd) for the dV product.
    for (int i = tid; i < rows * S; i += kThreads)
      ps[i] = attn::round_to<T>(pd_of(i));
    __syncthreads();

    // dV[k] += Σ_r pd_c[r][k] · g[r]: the chain over queries continues
    // from the previous tiles' sum; the last tile writes it rounded.
    for (int i = tid; i < S * Dh; i += kThreads) {
      const int k = i / Dh, c = i - k * Dh;
      float acc = first ? 0.0f : ws_dv[i];
      for (int r = 0; r < rows; ++r)
        acc = fmaf(ps[r * S + k], gs[r * ld + c], acc);
      if (last)
        dv_dst[(size_t)k * row_stride + c] = attn::from_float<T>(acc);
      else
        ws_dv[i] = acc;
    }

    // dQ = ds_c · K (registers, over K chunks in order) and dK[k] +=
    // Σ_r ds_c[r][k] · q[r] for the chunk's keys.
    float dq[kAccPerThread];
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) dq[a] = 0.0f;
    for (int k0 = 0; k0 < S; k0 += kKChunk) {
      const int kr = min(kKChunk, S - k0);
      __syncthreads();
      attn::load_tile(kvs, k_src + (size_t)k0 * row_stride, row_stride,
                      kr, Dh);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int i = tid + a * kThreads;
        const int r = i / Dh, c = i - r * Dh;
        if (i < kQTile * Dh && r < rows) {
          const float* dr = tt + r * S + k0;
          float acc = dq[a];
          for (int j = 0; j < kr; ++j) acc = fmaf(dr[j], kvs[j * ld + c], acc);
          dq[a] = acc;
        }
      }
      for (int i = tid; i < kr * Dh; i += kThreads) {
        const int j = i / Dh, c = i - j * Dh;
        const int k = k0 + j;
        const size_t w = (size_t)k * Dh + c;
        float acc = first ? 0.0f : ws_dk[w];
        for (int r = 0; r < rows; ++r)
          acc = fmaf(tt[r * S + k], qs[r * ld + c], acc);
        if (last)
          dk_dst[(size_t)k * row_stride + c] = attn::from_float<T>(acc);
        else
          ws_dk[w] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kQTile * Dh && r < rows)
        dq_dst[(size_t)(q0 + r) * row_stride + c] = attn::from_float<T>(dq[a]);
    }
  }
}

template <typename T, bool kDropout>
int launch(const void* qkv, const void* mask, const void* g, void* dqkv,
           void* ws, int B, int S, int H, int Dh, float scale,
           DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  cudaError_t err =
      attn::allow_max_smem(attn_bwd_packed_hb_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(S, Dh) * sizeof(float);
  attn_bwd_packed_hb_kernel<T, kDropout>
      <<<dim3(H, B), kThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(mask),
          static_cast<const T*>(g), static_cast<T*>(dqkv),
          static_cast<float*>(ws), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const void* mask, const void* g, void* dqkv,
             void* ws, int B, int S, int H, int Dh, float scale,
             bool dropout, DropoutArgs drop, cudaStream_t st) {
  if (dropout)
    return launch<T, true>(qkv, mask, g, dqkv, ws, B, S, H, Dh, scale, drop,
                           st);
  return launch<T, false>(qkv, mask, g, dqkv, ws, B, S, H, Dh, scale, drop,
                          st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding). g is
// the context gradient [B, S, D], dqkv the packed gradient [B, S, 3D],
// both in the input dtype; ws an fp32 workspace of 2·B·H·S·Dh floats
// (contents ignored). dropout = 0 ignores seed/threshold/inv_keep. Returns
// the cudaError_t of the launch (0 on success); a shape past the
// shared-memory plan returns cudaErrorInvalidValue.
int attn_bwd_packed_hb(const void* qkv, const void* mask, const void* g,
                       void* dqkv, void* ws, int B, int S, int H, int Dh,
                       float scale, int dropout, unsigned long long seed,
                       unsigned int threshold, float inv_keep, int dtype,
                       void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0 ||
      smem_floats(S, Dh) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch<float>(qkv, mask, g, dqkv, ws, B, S, H, Dh, scale,
                             dropout != 0, drop, st);
    case 1:
      return dispatch<__nv_bfloat16>(qkv, mask, g, dqkv, ws, B, S, H, Dh,
                                     scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
