// Flash-streamed rel-attention backward for Hopper (sm_90a): the training
// backward of #16, the long MAG-XLNet path over an assembled score bias.
//
// Replaces the TPU kernel `_attn_bwd_rel_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1722).
//
// What it computes, per batch row b and head h, from q [B, Q, D], k and v
// [B, K, D], ebias [B, H, Q, K], the forward's output o [B, Q, D] and lse
// [B, H, Q] (#16), the context gradient g [B, Q, D] and the forward's seed,
// with every product accumulated in fp32:
//   δ_q  = Σ_c g[q][c] · o[q][c]        (from the rounded o, as the TPU
//          kernel)
//   p    = exp((q · k) · scale + ebias − lse_q), rebuilt per element
//   d(pd) = g · vᵀ;  with the replayed keep mask (common.cuh):
//   pd   = keep ? p · inv_keep : 0,  dp = keep ? d(pd) · inv_keep : 0
//   ds   = p · (dp − δ)   (the unscaled score gradient)
//   debias = T(ds);  ds_c = T(ds · scale);  pd_c = T(pd)
//   dQ   = ds_c · K,  dK = ds_cᵀ · Q,  dV = pd_cᵀ · g
// with dq [B, Q, D], dk, dv [B, K, D] and debias [B, H, Q, K] in the input
// dtype.
//
// What bounds it on the card: at the driver's stream path (B=48, Q=K=1024,
// H=12, Dh=64) reading ebias and writing debias move 2.42 GB of the ≈3.0 GB
// read or written once; the five products are ~387 GFLOP: bytes bound at
// the bf16 tensor-core peak (≈0.90 ms against 0.39 ms). dQ and debias
// reduce or live along the query rows, dK and dV reduce over them; on the
// TPU the q-block grid axis runs in order and revisits the dK/dV output
// blocks, which Hopper's unordered blocks cannot do without atomics.
//
// What the design does about that: #7's two launches, each a deterministic
// reduction inside its blocks, with no atomics and no workspace beyond
// ebias and debias themselves: a dK/dV pass, one block per (64-key tile,
// head, batch row), that holds its K and V rows and walks the query rows in
// order, accumulating dK and dV; then a dQ pass, one block per (64-query
// tile, head, batch row), that walks the keys in blocks of 64, accumulates
// dQ and writes debias once, from the pass that owns the query rows. Both
// rebuild p and d(pd) and form ds with the same code from the same staged
// values, so the two passes see the same ds bits, and debias is the ds the
// dK pass used. The price is the QKᵀ and g·Vᵀ products and the ebias read
// taken twice. Any Q and any K (K ≠ Q under memory), the ragged tails
// bounds-checked.
//
// bf16: the two tensor-core passes of attn_bwd_rel_tc.cuh
// (`attn_bwd_rel_dkdv_tc_kernel`, `attn_bwd_rel_dq_tc_kernel`, kOwnStats
// false: lse is #16's, δ = Σ g ⊙ o by `tc_slab_delta`), #7's passes
// (attn_bwd_packed_tc.cuh) with q and k/v from their own tensors and each
// [64 q][64 k] ebias slice staged by cp.async in a two-stage ring beside
// its query block (dK/dV pass) or key block (dQ pass), as #16 stages it:
// 16-byte copies where K % 8 == 0 and ebias starts on 16 bytes, plain
// loads otherwise (K = 562 under a 50-row memory). Every product on
// mma.sync from ldmatrix; the dQ pass writes T(ds) over the slice it read
// and stores the tile in 16-byte row chunks. Shared plans 108 KB (dK/dV,
// two blocks an SM) and 72 KB at Dh = 64, 172 KB and 120 KB at Dh = 128
// (ops/fused_attention.py::rel_fs_bwd_smem_bytes).
//
// fp32 input keeps the CUDA-core kernels (`attn_bwd_rel_fs_dkdv_kernel`,
// `attn_bwd_rel_fs_dq_kernel`): the dots in fp32 from fp32 shared memory,
// the dK/dV walk in query steps of 32; shared plans at Dh = 64 65 KB and
// 98 KB (113 KB and 162 KB at Dh = 128). The entries dispatch on the dtype;
// a bf16 call always launches the tensor-core kernel or returns the
// launch's error (cudaErrorMisalignedAddress where q, k, v, o or g does not
// start on the 16 bytes cp.async copies).

#include "attn_bwd_rel_tc.cuh"
#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // keys a dK/dV block owns; queries a dQ block
constexpr int kStep = 32;      // query rows per step of the dK/dV walk
constexpr int kKBlock = 64;    // key rows per step of the dQ walk
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kTile * kMaxDh / kThreads;

// δ[r] = Σ_c g[r][c] · o_rows[r][c] for the staged g rows (rows of Dh + 1),
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

// ps[r][j] = (q_r · k_j) · scale + ebias[r][j] − lse[r] and tt[r][j] =
// g_r · v_j for r < rows, j < cols (staged rows of Dh + 1; ps/tt rows of
// ld; eb points at ebias[b][h][q0][k0], rows K apart).
template <typename T>
__device__ __forceinline__ void scores(float* ps, float* tt, int ld,
                                       const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       const T* eb, int K, const float* lse,
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
    ps[r * ld + j] = __fsub_rn(
        __fadd_rn(__fmul_rn(s, scale), attn::to_float(eb[(size_t)r * K + j])),
        lse[r]);
    tt[r * ld + j] = t;
  }
}

// On a [rows][cols] tile of queries q0 + r against keys k0 + j: ps holds
// s · scale + ebias − lse (as `scores` computes it), tt holds d(pd).
// Leaves pd_c in ps and ds_c in tt; with kDebias also writes debias =
// T(ds) at db (debias[b][h][q0][k0], rows K apart). k0 is a multiple of 4.
template <typename T, bool kDropout, bool kDebias>
__device__ __forceinline__ void grads_of_scores(
    float* ps, float* tt, int ld, int rows, int cols, int q0, int k0, int b,
    int h, const float* delta, float scale, DropoutArgs drop, T* db, int K) {
  const int quads = (cols + 3) / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i / quads, j0 = 4 * (i - r * quads);
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kDropout)
      bits = attn::dropout_bits4(drop, b, h, q0 + r, (k0 + j0) >> 2);
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
        const float ds = __fmul_rn(p, __fsub_rn(dp, delta[r]));
        if constexpr (kDebias)
          db[(size_t)r * K + j] = attn::from_float<T>(ds);
        ps[r * ld + j] = attn::round_to<T>(pd);
        tt[r * ld + j] = attn::round_to<T>(__fmul_rn(ds, scale));
      }
    }
  }
}

// K, V [kTile][Dh+1]; Q, g [kStep][Dh+1]; P, Tt [kStep][kTile]; lse, δ
// [kStep].
__host__ __device__ inline size_t dkdv_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kStep * (dh + 1) +
         2 * (size_t)kStep * kTile + 2 * (size_t)kStep;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rel_fs_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ ebias,
                                const T* __restrict__ o,
                                const float* __restrict__ lse,
                                const T* __restrict__ g, T* __restrict__ dk,
                                T* __restrict__ dv, int Q, int K, int H,
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

  const size_t q_base = (size_t)b * Q * D + h * Dh;  // q, g, o rows
  const size_t k_base = ((size_t)b * K + k0) * D + h * Dh;
  const T* eb_rows = ebias + ((size_t)b * H + h) * Q * K + k0;
  const float* lse_src = lse + ((size_t)b * H + h) * Q;
  const int cols = min(kTile, K - k0);

  attn::load_tile(ks, k + k_base, (size_t)D, cols, Dh);
  attn::load_tile(vs, v + k_base, (size_t)D, cols, Dh);
  float dk_acc[kAccPerThread], dv_acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dk_acc[a] = dv_acc[a] = 0.0f;

  for (int q0 = 0; q0 < Q; q0 += kStep) {
    const int rows = min(kStep, Q - q0);
    __syncthreads();  // the previous step's readers are done
    attn::load_tile(qs, q + q_base + (size_t)q0 * D, (size_t)D, rows, Dh);
    attn::load_tile(gs, g + q_base + (size_t)q0 * D, (size_t)D, rows, Dh);
    for (int r = tid; r < rows; r += kThreads) lse_s[r] = lse_src[q0 + r];
    __syncthreads();
    row_delta(delta, gs, o + q_base + (size_t)q0 * D, (size_t)D, rows, Dh);
    scores(ps, tt, kTile, qs, gs, ks, vs, eb_rows + (size_t)q0 * K, K, lse_s,
           rows, cols, Dh, scale);
    __syncthreads();
    grads_of_scores<T, kDropout, false>(ps, tt, kTile, rows, cols, q0, k0,
                                        b, h, delta, scale, drop,
                                        static_cast<T*>(nullptr), K);
    __syncthreads();
    // dV[j] += Σ_r pd_c[r][j] · g[r],  dK[j] += Σ_r ds_c[r][j] · q[r]
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int j = i / Dh, c = i - j * Dh;
      if (i < kTile * Dh && j < cols) {
        float v_acc = dv_acc[a], k_acc = dk_acc[a];
        for (int r = 0; r < rows; ++r) {
          v_acc = fmaf(ps[r * kTile + j], gs[r * ld + c], v_acc);
          k_acc = fmaf(tt[r * kTile + j], qs[r * ld + c], k_acc);
        }
        dv_acc[a] = v_acc;
        dk_acc[a] = k_acc;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int j = i / Dh, c = i - j * Dh;
    if (i < kTile * Dh && j < cols) {
      dk[k_base + (size_t)j * D + c] = attn::from_float<T>(dk_acc[a]);
      dv[k_base + (size_t)j * D + c] = attn::from_float<T>(dv_acc[a]);
    }
  }
}

// Q, g [kTile][Dh+1]; K, V [kKBlock][Dh+1]; P, Tt [kTile][kKBlock]; lse, δ
// [kTile].
__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)kKBlock * (dh + 1) +
         2 * (size_t)kTile * kKBlock + 2 * (size_t)kTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rel_fs_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ ebias,
                              const T* __restrict__ o,
                              const float* __restrict__ lse,
                              const T* __restrict__ g, T* __restrict__ dq,
                              T* __restrict__ debias, int Q, int K, int H,
                              int Dh, float scale, DropoutArgs drop) {
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

  const size_t q_base = ((size_t)b * Q + q0) * D + h * Dh;  // q, g, o, dq
  const size_t k_base = (size_t)b * K * D + h * Dh;
  const size_t eb_off = (((size_t)b * H + h) * Q + q0) * K;
  const int rows = min(kTile, Q - q0);

  attn::load_tile(qs, q + q_base, (size_t)D, rows, Dh);
  attn::load_tile(gs, g + q_base, (size_t)D, rows, Dh);
  for (int r = tid; r < rows; r += kThreads)
    lse_s[r] = lse[((size_t)b * H + h) * Q + q0 + r];
  __syncthreads();
  row_delta(delta, gs, o + q_base, (size_t)D, rows, Dh);
  float dq_acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) dq_acc[a] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKBlock) {
    const int cols = min(kKBlock, K - k0);
    __syncthreads();  // the previous block's readers are done
    attn::load_tile(ks, k + k_base + (size_t)k0 * D, (size_t)D, cols, Dh);
    attn::load_tile(vs, v + k_base + (size_t)k0 * D, (size_t)D, cols, Dh);
    __syncthreads();
    scores(ps, tt, kKBlock, qs, gs, ks, vs, ebias + eb_off + k0, K, lse_s,
           rows, cols, Dh, scale);
    __syncthreads();
    grads_of_scores<T, kDropout, true>(ps, tt, kKBlock, rows, cols, q0, k0,
                                       b, h, delta, scale, drop,
                                       debias + eb_off + k0, K);
    __syncthreads();
    // dQ[r] += Σ_j ds_c[r][j] · k_j
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kTile * Dh && r < rows) {
        const float* dr = tt + r * kKBlock;
        float acc = dq_acc[a];
        for (int j = 0; j < cols; ++j) acc = fmaf(dr[j], ks[j * ld + c], acc);
        dq_acc[a] = acc;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kTile * Dh && r < rows)
      dq[q_base + (size_t)r * D + c] = attn::from_float<T>(dq_acc[a]);
  }
}

// The dK/dV pass writes dk and dv (dq and debias untouched); the dQ pass
// dq and debias.
template <bool kDkdv, typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           const void* o, const void* lse, const void* g, void* dq, void* dk,
           void* dv, void* debias, int B, int Q, int K, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *et = static_cast<const T*>(ebias);
  const T *ot = static_cast<const T*>(o), *gt = static_cast<const T*>(g);
  const float* lt = static_cast<const float*>(lse);
  if constexpr (kDkdv) {
    auto kernel = attn_bwd_rel_fs_dkdv_kernel<T, kDropout>;
    const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((K + kTile - 1) / kTile, H, B);
    kernel<<<grid, kThreads, dkdv_smem_floats(Dh) * sizeof(float), stream>>>(
        qt, kt, vt, et, ot, lt, gt, static_cast<T*>(dk), static_cast<T*>(dv),
        Q, K, H, Dh, scale, drop);
  } else {
    auto kernel = attn_bwd_rel_fs_dq_kernel<T, kDropout>;
    const cudaError_t err = attn::allow_max_smem(kernel, &attr_set);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Q + kTile - 1) / kTile, H, B);
    kernel<<<grid, kThreads, dq_smem_floats(Dh) * sizeof(float), stream>>>(
        qt, kt, vt, et, ot, lt, gt, static_cast<T*>(dq),
        static_cast<T*>(debias), Q, K, H, Dh, scale, drop);
  }
  return (int)cudaGetLastError();
}

template <bool kDkdv>
int entry(const void* q, const void* k, const void* v, const void* ebias,
          const void* o, const void* lse, const void* g, void* dq, void* dk,
          void* dv, void* debias, int B, int Q, int K, int H, int Dh,
          float scale, int dropout, unsigned long long seed,
          unsigned int threshold, float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<kDkdv, float, false>(q, k, v, ebias, o, lse, g, dq, dk,
                                         dv, debias, B, Q, K, H, Dh, scale,
                                         drop, st);
    case 1:
      return launch<kDkdv, float, true>(q, k, v, ebias, o, lse, g, dq, dk, dv,
                                        debias, B, Q, K, H, Dh, scale, drop,
                                        st);
    case 2:
    case 3:
      // lse is only read: the pass writes it with kOwnStats alone
      return rel_tc::launch_pass<kDkdv, false>(
          q, k, v, ebias, o, static_cast<float*>(const_cast<void*>(lse)), g,
          dq, dk, dv, debias, B, Q, K, H, Dh, scale, dropout != 0, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The two passes of #17, launched in this order on one stream by the
// wrapper. dtype: 0 = float32, 1 = bfloat16 (every tensor but lse). q, o, g
// and dq are [B, Q, D], k, v, dk and dv [B, K, D], ebias and debias
// [B, H, Q, K], lse [B, H, Q] fp32. The dK/dV pass writes dk and dv, the dQ
// pass dq and debias. dropout = 0 ignores seed/threshold/inv_keep. Each
// returns the cudaError_t of its launch.
int attn_bwd_rel_fs_dkdv(const void* q, const void* k, const void* v,
                         const void* ebias, const void* o, const void* lse,
                         const void* g, void* dq, void* dk, void* dv,
                         void* debias, int B, int Q, int K, int H, int Dh,
                         float scale, int dropout, unsigned long long seed,
                         unsigned int threshold, float inv_keep, int dtype,
                         void* stream) {
  return entry<true>(q, k, v, ebias, o, lse, g, dq, dk, dv, debias, B, Q, K,
                     H, Dh, scale, dropout, seed, threshold, inv_keep, dtype,
                     stream);
}

int attn_bwd_rel_fs_dq(const void* q, const void* k, const void* v,
                       const void* ebias, const void* o, const void* lse,
                       const void* g, void* dq, void* dk, void* dv,
                       void* debias, int B, int Q, int K, int H, int Dh,
                       float scale, int dropout, unsigned long long seed,
                       unsigned int threshold, float inv_keep, int dtype,
                       void* stream) {
  return entry<false>(q, k, v, ebias, o, lse, g, dq, dk, dv, debias, B, Q, K,
                      H, Dh, scale, dropout, seed, threshold, inv_keep, dtype,
                      stream);
}

}  // extern "C"
