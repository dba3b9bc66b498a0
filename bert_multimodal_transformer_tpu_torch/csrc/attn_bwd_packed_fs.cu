// Flash-streamed packed attention backward for Hopper (sm_90a): the
// training backward past the head-blocked reach (S > 640).
//
// Replaces the TPU kernel `_attn_bwd_packed_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1328).
//
// What it computes, per batch row b and head h, from qkv [B, S, 3D], the
// fp32 mask, the forward's output o [B, S, D] and lse [B, H, S] (#6), the
// context gradient g [B, S, D] and the forward's seed, with every product
// accumulated in fp32:
//   δ_q  = Σ_c g[q][c] · o[q][c]        (from the rounded o, as the TPU
//          kernel; it stands for Σ_k pd ⊙ d(pd), which differs from it by
//          o's rounding, so the two are not interchangeable)
//   p    = exp((q · k) · scale + bias − lse_q), rebuilt per element
//   d(pd) = g · vᵀ;  with the replayed keep mask (common.cuh):
//   pd   = keep ? p · inv_keep : 0,  dp = keep ? d(pd) · inv_keep : 0
//   ds   = (p · (dp − δ)) · scale;  ds_c = T(ds);  pd_c = T(pd)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q,  dV = pd_cᵀ · g
// written into dqkv [B, S, 3D] at the columns q, k, v came from.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12,
// Dh=64) the five products are ~387 GFLOP: operations bound, 0.39 ms at
// the bf16 tensor-core peak. dQ reduces over keys while dK and dV reduce
// over queries; on the TPU the q-block grid axis runs in order and
// revisits the dK/dV output blocks, which Hopper's unordered blocks cannot
// do without atomics.
//
// What the design does about that: two launches, each a deterministic
// reduction inside its blocks, with no atomics and no S²-sized memory.
//   1. The dK/dV pass: one block per (64-key tile, head, batch row) holds
//      its K and V rows and walks the query rows in order, accumulating dK
//      and dV in fp32 registers; it rounds them once at the end.
//   2. The dQ pass: one block per (64-query tile, head, batch row) walks
//      the keys in blocks of 64 and accumulates dQ.
// Both rebuild p and d(pd) and form ds with the same code, so the two
// passes see the same ds bits; the price is the QKᵀ and g·Vᵀ products
// computed twice (seven products in place of five).
//
// bf16: the two tensor-core passes of attn_bwd_packed_tc.cuh
// (`attn_bwd_packed_dkdv_tc_kernel`, `attn_bwd_packed_dq_tc_kernel`, with
// kOwnStats false: lse is #6's, δ = Σ g ⊙ o by `tc_slab_delta`): all seven
// products on mma.sync from ldmatrix, the same ds bits in both passes; the
// note there has the plan. #5 runs the same passes on statistics of its own.
//
// fp32 input keeps the CUDA-core kernels (`attn_bwd_packed_fs_dkdv_kernel`,
// `attn_bwd_packed_fs_dq_kernel`): the dots in fp32 from fp32 shared
// memory, the dK/dV walk in query blocks of 32; shared plans at Dh = 128
// 113 KB and 162 KB (65 KB and 98 KB at Dh = 64). The entries dispatch on
// the dtype; a bf16 call always launches the tensor-core kernel or returns
// the launch's error (cudaErrorMisalignedAddress where qkv, o or g does not
// start on the 16 bytes cp.async copies).

#include "attn_bwd_packed_tc.cuh"
#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // keys a dK/dV block owns; queries a dQ block
constexpr int kStep = 32;      // query rows per step of the dK/dV walk
constexpr int kKBlock = 64;    // key rows per step of the dQ walk
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kTile * kMaxDh / kThreads;

// δ[r] = Σ_c g[r][c] · o[q0 + r][c] for the staged g rows (rows of Dh + 1),
// one warp per row, the same order in both passes.
template <typename T>
__device__ __forceinline__ void row_delta(float* delta, const float* gs,
                                          const T* o_rows, size_t o_stride,
                                          int rows, int Dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float sum = 0.0f;
    for (int c = lane; c < Dh; c += 32)
      sum = fmaf(gs[r * (Dh + 1) + c],
                 attn::to_float(o_rows[(size_t)r * o_stride + c]), sum);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) delta[r] = sum;
  }
}

// On a [rows][cols] tile of queries q0 + r against keys k0 + j: ps holds
// s · scale + bias − lse (as computed by `scores`), tt holds d(pd). Leaves
// pd_c in ps and ds_c in tt. cols is a multiple of 4 but for the last
// block of keys; k0 is a multiple of 4.
template <typename T, bool kDropout>
__device__ __forceinline__ void grads_of_scores(float* ps, float* tt,
                                                int ld, int rows, int cols,
                                                int q0, int k0, int b, int h,
                                                const float* delta,
                                                float scale,
                                                DropoutArgs drop) {
  const int quads = (cols + 3) / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i / quads, j0 = 4 * (i - r * quads);
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kDropout)
      bits = attn::dropout_bits4(drop.seed, b, h, q0 + r, (k0 + j0) >> 2);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j < cols) {
        const float p = expf(ps[r * ld + j]);
        float pd = p, dp = tt[r * ld + j];
        if constexpr (kDropout) {
          const bool keep = attn::word(bits, u) >= drop.threshold;
          pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
          dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
        }
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta[r])),
                                   scale);
        ps[r * ld + j] = attn::round_to<T>(pd);
        tt[r * ld + j] = attn::round_to<T>(ds);
      }
    }
  }
}

// ps[r][j] = (q_r · k_j) · scale + bias[j] − lse[r] and tt[r][j] = g_r · v_j
// for r < rows, j < cols (staged rows of Dh + 1; ps/tt rows of ld).
__device__ __forceinline__ void scores(float* ps, float* tt, int ld,
                                       const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       const float* bias, const float* lse,
                                       int rows, int cols, int Dh,
                                       float scale) {
  const int ldr = Dh + 1;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, j = i - r * cols;
    const float* qr = qs + r * ldr;
    const float* gr = gs + r * ldr;
    const float* kj = ks + j * ldr;
    const float* vj = vs + j * ldr;
    float s = 0.0f, t = 0.0f;
    for (int c = 0; c < Dh; ++c) {
      s = fmaf(qr[c], kj[c], s);
      t = fmaf(gr[c], vj[c], t);
    }
    ps[r * ld + j] =
        __fsub_rn(__fadd_rn(__fmul_rn(s, scale), bias[j]), lse[r]);
    tt[r * ld + j] = t;
  }
}

__device__ __forceinline__ void load_bias(float* bias, const float* mask,
                                          int b, int S, int k0, int cols) {
  for (int j = threadIdx.x; j < cols; j += blockDim.x)
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + k0 + j]) * -10000.0f
                   : 0.0f;
}

// K, V [kTile][Dh+1]; Q, g [kStep][Dh+1]; P, Tt [kStep][kTile]; lse, δ
// [kStep]; bias [kTile].
__host__ __device__ inline size_t dkdv_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kStep * (dh + 1) +
         2 * (size_t)kStep * kTile + 2 * (size_t)kStep + kTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_fs_dkdv_kernel(const T* __restrict__ qkv,
                                   const float* __restrict__ mask,
                                   const T* __restrict__ o,
                                   const float* __restrict__ lse,
                                   const T* __restrict__ g,
                                   T* __restrict__ dqkv, int S, int H,
                                   int Dh, float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;
  float* ks = smem;                     // [kTile][Dh + 1]
  float* vs = ks + kTile * ld;          // [kTile][Dh + 1]
  float* qs = vs + kTile * ld;          // [kStep][Dh + 1]
  float* gs = qs + kStep * ld;          // [kStep][Dh + 1]
  float* ps = gs + kStep * ld;          // [kStep][kTile]
  float* tt = ps + kStep * kTile;       // [kStep][kTile]
  float* lse_s = tt + kStep * kTile;    // [kStep]
  float* delta = lse_s + kStep;         // [kStep]
  float* bias = delta + kStep;          // [kTile]

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const T* g_src = g + (size_t)b * S * D + h * Dh;
  const T* o_src = o + (size_t)b * S * D + h * Dh;
  const float* lse_src = lse + ((size_t)b * H + h) * S;
  const int cols = min(kTile, S - k0);

  attn::load_tile(ks, q_src + D + (size_t)k0 * row_stride, row_stride, cols,
                  Dh);
  attn::load_tile(vs, q_src + 2 * D + (size_t)k0 * row_stride, row_stride,
                  cols, Dh);
  load_bias(bias, mask, b, S, k0, cols);
  float dk[kAccPerThread], dv[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dk[a] = dv[a] = 0.0f;

  for (int q0 = 0; q0 < S; q0 += kStep) {
    const int rows = min(kStep, S - q0);
    __syncthreads();  // the previous step's readers are done
    attn::load_tile(qs, q_src + (size_t)q0 * row_stride, row_stride, rows,
                    Dh);
    attn::load_tile(gs, g_src + (size_t)q0 * D, (size_t)D, rows, Dh);
    for (int r = tid; r < rows; r += kThreads) lse_s[r] = lse_src[q0 + r];
    __syncthreads();
    row_delta(delta, gs, o_src + (size_t)q0 * D, (size_t)D, rows, Dh);
    scores(ps, tt, kTile, qs, gs, ks, vs, bias, lse_s, rows, cols, Dh,
           scale);
    __syncthreads();
    grads_of_scores<T, kDropout>(ps, tt, kTile, rows, cols, q0, k0, b, h,
                                 delta, scale, drop);
    __syncthreads();
    // dV[j] += Σ_r pd_c[r][j] · g[r],  dK[j] += Σ_r ds_c[r][j] · q[r]
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int j = i / Dh, c = i - j * Dh;
      if (i < kTile * Dh && j < cols) {
        float v_acc = dv[a], k_acc = dk[a];
        for (int r = 0; r < rows; ++r) {
          v_acc = fmaf(ps[r * kTile + j], gs[r * ld + c], v_acc);
          k_acc = fmaf(tt[r * kTile + j], qs[r * ld + c], k_acc);
        }
        dv[a] = v_acc;
        dk[a] = k_acc;
      }
    }
  }
  T* dk_dst = dqkv + ((size_t)b * S + k0) * row_stride + D + h * Dh;
  T* dv_dst = dk_dst + D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int j = i / Dh, c = i - j * Dh;
    if (i < kTile * Dh && j < cols) {
      dk_dst[(size_t)j * row_stride + c] = attn::from_float<T>(dk[a]);
      dv_dst[(size_t)j * row_stride + c] = attn::from_float<T>(dv[a]);
    }
  }
}

// Q, g, K, V [kTile or kKBlock][Dh+1]; P, Tt [kTile][kKBlock]; lse, δ
// [kTile]; bias [kKBlock].
__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kKBlock * (dh + 1) +
         2 * (size_t)kTile * kKBlock + 2 * (size_t)kTile + kKBlock;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_packed_fs_dq_kernel(const T* __restrict__ qkv,
                                 const float* __restrict__ mask,
                                 const T* __restrict__ o,
                                 const float* __restrict__ lse,
                                 const T* __restrict__ g,
                                 T* __restrict__ dqkv, int S, int H, int Dh,
                                 float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;
  float* qs = smem;                     // [kTile][Dh + 1]
  float* gs = qs + kTile * ld;          // [kTile][Dh + 1]
  float* ks = gs + kTile * ld;          // [kKBlock][Dh + 1]
  float* vs = ks + kKBlock * ld;        // [kKBlock][Dh + 1]
  float* ps = vs + kKBlock * ld;        // [kTile][kKBlock]
  float* tt = ps + kTile * kKBlock;     // [kTile][kKBlock]
  float* lse_s = tt + kTile * kKBlock;  // [kTile]
  float* delta = lse_s + kTile;         // [kTile]
  float* bias = delta + kTile;          // [kKBlock]

  const size_t row_stride = (size_t)3 * D;
  const T* q_src = qkv + (size_t)b * S * row_stride + h * Dh;
  const int rows = min(kTile, S - q0);

  attn::load_tile(qs, q_src + (size_t)q0 * row_stride, row_stride, rows, Dh);
  attn::load_tile(gs, g + ((size_t)b * S + q0) * D + h * Dh, (size_t)D,
                  rows, Dh);
  for (int r = tid; r < rows; r += kThreads)
    lse_s[r] = lse[((size_t)b * H + h) * S + q0 + r];
  __syncthreads();
  row_delta(delta, gs, o + ((size_t)b * S + q0) * D + h * Dh, (size_t)D,
            rows, Dh);
  float dq[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dq[a] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kKBlock) {
    const int cols = min(kKBlock, S - k0);
    __syncthreads();  // the previous block's readers are done
    attn::load_tile(ks, q_src + D + (size_t)k0 * row_stride, row_stride,
                    cols, Dh);
    attn::load_tile(vs, q_src + 2 * D + (size_t)k0 * row_stride, row_stride,
                    cols, Dh);
    load_bias(bias, mask, b, S, k0, cols);
    __syncthreads();
    scores(ps, tt, kKBlock, qs, gs, ks, vs, bias, lse_s, rows, cols, Dh,
           scale);
    __syncthreads();
    grads_of_scores<T, kDropout>(ps, tt, kKBlock, rows, cols, q0, k0, b, h,
                                 delta, scale, drop);
    __syncthreads();
    // dQ[r] += Σ_j ds_c[r][j] · k_j
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kTile * Dh && r < rows) {
        const float* dr = tt + r * kKBlock;
        float acc = dq[a];
        for (int j = 0; j < cols; ++j) acc = fmaf(dr[j], ks[j * ld + c], acc);
        dq[a] = acc;
      }
    }
  }
  T* dq_dst = dqkv + ((size_t)b * S + q0) * row_stride + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kTile * Dh && r < rows)
      dq_dst[(size_t)r * row_stride + c] = attn::from_float<T>(dq[a]);
  }
}


template <bool kDkdv, typename T, bool kDropout>
int launch(const void* qkv, const void* mask, const void* o, const void* lse,
           const void* g, void* dqkv, int B, int S, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  auto kernel = kDkdv ? attn_bwd_packed_fs_dkdv_kernel<T, kDropout>
                      : attn_bwd_packed_fs_dq_kernel<T, kDropout>;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (kDkdv ? dkdv_smem_floats(Dh) : dq_smem_floats(Dh)) * sizeof(float);
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const T*>(g), static_cast<T*>(dqkv), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

template <bool kDkdv>
int entry(const void* qkv, const void* mask, const void* o, const void* lse,
          const void* g, void* dqkv, int B, int S, int H, int Dh,
          float scale, int dropout, unsigned long long seed,
          unsigned int threshold, float inv_keep, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores, bf16 on the tensor cores (see the note).
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<kDkdv, float, false>(qkv, mask, o, lse, g, dqkv, B, S, H,
                                         Dh, scale, drop, st);
    case 1:
      return launch<kDkdv, float, true>(qkv, mask, o, lse, g, dqkv, B, S, H,
                                        Dh, scale, drop, st);
    case 2:
    case 3:
      // lse is only read: the pass writes it with kOwnStats alone
      return packed_tc::launch_pass<kDkdv, false>(
          qkv, mask, o, static_cast<float*>(const_cast<void*>(lse)), g, dqkv,
          B, S, H, Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The two passes of #7, launched in this order on one stream by the
// wrapper. dtype: 0 = float32, 1 = bfloat16. mask may be null (no
// padding). o (the forward's output) and g are [B, S, D] and dqkv
// [B, S, 3D] in the input dtype, lse [B, H, S] fp32. The dK/dV pass writes
// dqkv's k and v columns, the dQ pass its q columns. dropout = 0 ignores
// seed/threshold/inv_keep. Each returns the cudaError_t of its launch.
int attn_bwd_packed_fs_dkdv(const void* qkv, const void* mask, const void* o,
                            const void* lse, const void* g, void* dqkv,
                            int B, int S, int H, int Dh, float scale,
                            int dropout, unsigned long long seed,
                            unsigned int threshold, float inv_keep,
                            int dtype, void* stream) {
  return entry<true>(qkv, mask, o, lse, g, dqkv, B, S, H, Dh, scale, dropout,
                     seed, threshold, inv_keep, dtype, stream);
}

int attn_bwd_packed_fs_dq(const void* qkv, const void* mask, const void* o,
                          const void* lse, const void* g, void* dqkv, int B,
                          int S, int H, int Dh, float scale, int dropout,
                          unsigned long long seed, unsigned int threshold,
                          float inv_keep, int dtype, void* stream) {
  return entry<false>(qkv, mask, o, lse, g, dqkv, B, S, H, Dh, scale,
                      dropout, seed, threshold, inv_keep, dtype, stream);
}

}  // extern "C"
