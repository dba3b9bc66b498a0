// Saved-probs attention backward with the QKV projection's input gradient
// inside, for Hopper (sm_90a): two launches a call.
//
// Replaces the TPU kernel `_attn_bwd_qkvproj_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:3140, launched by
// `_bwd_qkvproj_pallas` :3286), the backward of #18 (attn_fwd_qkvproj.cu).
//
// What it computes, from the saved probs p and pd [B, H, S, S] (input
// dtype; pd is p when the rate was 0), the context gradient g [B, S, D],
// the packed QKV weight in nn.Linear's layout w [3D, D] and its bias b3:
//   qkv  = the projection re-computed from x [B, S, D] exactly as #18 does
//          (`recompute`), or read from the qkv [B, S, 3D] #18 emitted
//   per (b, h), kernel #3's chain (attn_bwd_packed_saved.cu):
//          dV = pdᵀ·g;  d(pd) = g·Vᵀ;  t = pd ⊙ d(pd);
//          ds = (t − p·Σ_k t)·scale;  ds_c = T(ds);  dQ = ds_c·K;  dK = ds_cᵀ·Q
//          written into dqkv [B, S, 3D] at the packed columns (every
//          product summed in fp32, each output rounded to T once)
//   dx [B, S, D] = T(dqkv · w accumulated in fp32)   (the TPU kernel's
//          `dqkv·Wᵀ`, computed in its body as a default-precision dot with
//          an fp32 accumulator; dW = xᵀ·dqkv and db = Σ dqkv stay plain
//          products in the autograd function, as the TPU package leaves
//          them to XLA)
// Input dtypes: fp32 and bf16 (fp32 keeps its CUDA-core kernels: fp32
// products, no TF32); Dh a multiple of 8 up to 128, S within the
// shared-memory plan (ops/fused_attention.py::qkvproj_fits).
//
// What bounds it on the card: the two D × 3D products per row (the
// re-projection and dx) are ~97% of the operations at bert-base (B=256,
// S=50: 2 × 45.3 GFLOP against ~2 GFLOP of attention), so it is bound by
// operations: ~0.09 ms at the bf16 tensor-core peak.
//
// What the design does about that: the TPU kernel's per-row grid becomes
// two launches, since dx needs every head's dqkv columns of a row and
// blocks share nothing. In bf16 every product runs on mma.sync.m16n8k16
// (fp32 accumulate), from the pieces of attn_full_tc.cuh and common.cuh.
//
// Launch 1, bf16 (`attn_bwd_qkvproj_heads_tc_kernel`): a block per head
// and one or two batch rows fills, for each of its batch rows, #3's tiles
// (Q, K, V, g [S16][L] bf16, rows past S and the pad columns zero) and
// runs #3's compute half on them (`bwd_saved_phase1` and
// `bwd_saved_phase2`, the phases #3 and #10 run): so the dqkv of a call
// from the saved qkv is #3's on the same (p, pd, qkv, g), bit for bit.
// Re-projecting, `project_head_tc` writes q, k and v straight into the
// tiles with #18's bits (so from x and from #18's emitted qkv are the same
// bits), while g arrives by cp.async; the projection's cp.async ring lies
// over the pd and ds_c tiles, which are filled after it. To S = 64 a block
// takes kBwdProjRows = 2 batch rows (16 warps; a 64-deep weight slice
// serves both, as in #18), warps 4i .. 4i + 3 running the phases of batch
// row i; past it one batch row and max(8, S16 / 16) warps, 32-deep slices.
// From the saved qkv a block is #3's: one batch row, S16 / 16 warps, the
// staging half copying q, k, v by cp.async with the row stride 3D.
//
// Launch 2, bf16 (`attn_bwd_qkvproj_dx_tc_kernel`): dx [M, D] =
// T(dqkv [M, 3D] · w [3D, D]), M = B·S, in 128 × 128 block tiles of 8
// warps (each 32 rows × 64 columns: 2 × 8 m16n8 tiles in registers), the
// 3D-deep sum streamed through a kDxStages-stage cp.async ring of 64-deep
// slices; dqkv (k contiguous) by ldmatrix, w (n contiguous) by
// ldmatrix.trans; rows past M, columns past D and depth past 3D zero-filled
// and masked; the fp32 sum rounded once. The dqkv round trip (B·S·3D
// elements) is the price of the split; the TPU kernel kept it in VMEM and
// wrote it once too (for dW).
//
// fp32 keeps the CUDA-core kernels and their bits: launch 1
// (`attn_bwd_qkvproj_heads_kernel`) re-projects with common.cuh's
// `project_head` into [S][3·Dh] and runs `bwd_saved_head`; launch 2
// (`attn_bwd_qkvproj_dx_kernel`) is 64 × 64 tiles of `gemm_tile`.

#include "attn_full_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: the fp32 kernels
constexpr int kMaxDh = 128;

// ---- fp32: the CUDA-core kernels --------------------------------------------

size_t heads_smem_bytes(int S, int Dh, bool recompute) {
  const size_t bwd = attn::bwd_smem_floats(S, Dh);
  if (!recompute) return bwd * sizeof(float);
  const size_t proj = attn::gemm_smem_floats();
  const size_t work = proj > bwd ? proj : bwd;
  return (attn::qkvproj_head_floats<float>(S, Dh) + work) * sizeof(float);
}

template <bool kRecompute>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_qkvproj_heads_kernel(const float* __restrict__ p,
                                  const float* __restrict__ pd,
                                  const float* __restrict__ src,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b3,
                                  const float* __restrict__ g,
                                  float* __restrict__ dqkv, int S, int H,
                                  int Dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * Dh;
  const float* q;  // this head's q rows; k and v follow at + seg, + 2·seg
  size_t ld, seg;
  float* work = smem;
  if constexpr (kRecompute) {
    float* head = smem;  // [S][3·Dh]
    work = smem + attn::qkvproj_head_floats<float>(S, Dh);
    attn::project_head<float, false>(work, head, src + (size_t)b * S * D, w,
                                     b3, nullptr, S, D, Dh, h);
    __syncthreads();  // the head is written; the staging slices are free
    q = head;
    ld = (size_t)3 * Dh;
    seg = Dh;
  } else {
    q = src + (size_t)b * S * 3 * D + h * Dh;
    ld = (size_t)3 * D;
    seg = D;
  }
  float* dq = dqkv + (size_t)b * S * 3 * D + h * Dh;
  const attn::BwdHead<float> hd{q,       q + seg, q + 2 * seg,
                                ld,
                                g + (size_t)b * S * D + h * Dh,
                                (size_t)D,
                                dq,      dq + D,  dq + 2 * D,
                                (size_t)3 * D,
                                nullptr, b,       h};
  const size_t off = ((size_t)b * H + h) * S * S;
  attn::bwd_saved_head<float>(work, hd, p + off, pd + off, S, Dh, scale);
}

// dx[r][n] = Σ_k dqkv[r][k] · w[k][n] over the 3D columns k, for the M =
// B·S rows r.
__global__ void __launch_bounds__(attn::kGThreads)
    attn_bwd_qkvproj_dx_kernel(const float* __restrict__ dqkv,
                               const float* __restrict__ w,
                               float* __restrict__ dx, int M, int D) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * attn::kGM;
  const int n0 = blockIdx.x * attn::kGN;
  const int K = 3 * D;
  attn::gemm_tile<false>(
      smem, min(attn::kGM, M - m0), min(attn::kGN, D - n0), K,
      [=](int m, int k) { return dqkv[(size_t)(m0 + m) * K + k]; },
      [=](int k, int n) { return w[(size_t)k * D + n0 + n]; },
      [=](int m, int n, float acc) {
        dx[(size_t)(m0 + m) * D + n0 + n] = acc;
      });
}

template <bool kRecompute>
int launch_heads_fp32(const void* p, const void* pd, const void* src,
                      const void* w, const void* b3, const void* g,
                      void* dqkv, int B, int S, int H, int Dh, float scale,
                      cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_qkvproj_heads_kernel<kRecompute>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_qkvproj_heads_kernel<kRecompute>
      <<<dim3(H, B), kThreads, heads_smem_bytes(S, Dh, kRecompute),
         stream>>>(static_cast<const float*>(p),
                   static_cast<const float*>(pd),
                   static_cast<const float*>(src),
                   static_cast<const float*>(w),
                   static_cast<const float*>(b3),
                   static_cast<const float*>(g), static_cast<float*>(dqkv),
                   S, H, Dh, scale);
  return (int)cudaGetLastError();
}

int launch_dx_fp32(const void* dqkv, const void* w, void* dx, int M, int D,
                   cudaStream_t stream) {
  const dim3 grid((D + attn::kGN - 1) / attn::kGN,
                  (M + attn::kGM - 1) / attn::kGM);
  attn_bwd_qkvproj_dx_kernel<<<grid, attn::kGThreads,
                               attn::gemm_smem_floats() * sizeof(float),
                               stream>>>(static_cast<const float*>(dqkv),
                                         static_cast<const float*>(w),
                                         static_cast<float*>(dx), M, D);
  return (int)cudaGetLastError();
}

// ---- bf16, launch 1: #3's compute half on each batch row's tiles -------------

// Threads of a block: rows · 8 warps re-projecting (at least one warp a
// 16-row slab), one warp a slab from the saved qkv (#3's block).
__host__ __device__ constexpr int heads_tc_threads(int rows, int nt,
                                                   bool recompute) {
  return recompute && rows * full_tc::kProjThreads > nt / 2 * 32
             ? rows * full_tc::kProjThreads
             : nt / 2 * 32;
}

// Shared memory of a block of `rows` batch rows: each row's Q, K, V, g
// tiles, then each row's pd and ds_c tiles, over which the projection's
// ring lies when it is the larger (ops/fused_attention.py::
// qkvproj_tc_bwd_smem_bytes).
size_t heads_tc_smem_bytes(int S, int Dh, int rows, bool recompute) {
  const size_t sp = full_tc::rows16(S);
  const size_t qkvg = 4 * sp * attn::tc_ld(Dh) * sizeof(bf16);
  size_t tail = (size_t)rows * 2 * sp * full_tc::bwd_pld(S) * sizeof(bf16);
  if (recompute) {
    const size_t ring = full_tc::proj_smem_bytes(
        Dh, rows,
        rows > 1 ? full_tc::kProjRegDepth : full_tc::kProjRowsDepth);
    if (ring > tail) tail = ring;
  }
  return rows * qkvg + tail;
}

template <int kRows, int kNT, int kDT, bool kRecompute>
__global__ void __launch_bounds__(heads_tc_threads(kRows, kNT, kRecompute))
    attn_bwd_qkvproj_heads_tc_kernel(const bf16* __restrict__ p,
                                     const bf16* __restrict__ pd,
                                     const bf16* __restrict__ src,
                                     const bf16* __restrict__ w,
                                     const bf16* __restrict__ b3,
                                     const bf16* __restrict__ g,
                                     bf16* __restrict__ dqkv, int B, int S,
                                     int H, int Dh, float scale,
                                     bool pairs) {
  constexpr int kDepth =
      kRows > 1 ? full_tc::kProjRegDepth : full_tc::kProjRowsDepth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, B - b0);
  const int D = H * Dh;
  const int ld = attn::tc_ld(Dh), sp = full_tc::rows16(S);
  const int qkvg = 4 * sp * ld, pd_ds = 2 * sp * full_tc::bwd_pld(S);
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  bf16* tail = base + kRows * qkvg;  // the pd, ds_c tiles; the ring first
  auto head_off = [&](int i) {
    return ((size_t)(b0 + i) * H + h) * S * S;
  };
  if constexpr (kRecompute) {
    // g by cp.async under the projection (its first wait takes g too)
    for (int i = 0; i < n_rows; ++i)
      attn::tc_cp_rows(base + i * qkvg + 3 * sp * ld, ld,
                       g + (size_t)(b0 + i) * S * D + h * Dh, D, 0, sp, 0, S,
                       Dh);
    attn::cp_async_commit();
    full_tc::project_head_tc<kRows, kDepth, false>(
        reinterpret_cast<unsigned char*>(tail), base, qkvg, ld, sp * ld, sp,
        src + (size_t)b0 * S * D, w, b3, nullptr, n_rows, S, D, Dh, h);
    __syncthreads();  // Q, K, V are in; the ring's readers are done
    for (int i = 0; i < n_rows; ++i)
      full_tc::bwd_saved_stage(base + i * qkvg, tail + i * pd_ds, nullptr,
                               nullptr, nullptr, 0, nullptr, D,
                               pd + head_off(i), S, Dh, pairs);
  } else {
    const bf16* q = src + (size_t)b0 * S * 3 * D + h * Dh;
    full_tc::bwd_saved_stage(base, tail, q, q + D, q + 2 * D, 3 * D,
                             g + (size_t)b0 * S * D + h * Dh, D,
                             pd + head_off(0), S, Dh, pairs);
  }
  attn::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int i = kRows > 1 ? warp >> 2 : 0;
  const int m0 = 16 * (kRows > 1 ? warp & 3 : warp);
  const bool live = i < n_rows && m0 < sp;
  bf16* dq = dqkv + (size_t)(b0 + i) * S * 3 * D + h * Dh;
  if (live)
    full_tc::bwd_saved_phase1<kNT, kDT>(base + i * qkvg, tail + i * pd_ds, dq,
                                        3 * D, p + head_off(i), m0, S, Dh,
                                        scale, pairs);
  __syncthreads();  // every row's ds_c is in
  if (live)
    full_tc::bwd_saved_phase2<kDT>(base + i * qkvg, tail + i * pd_ds, dq + D,
                                   dq + 2 * D, 3 * D, m0, S, Dh);
}

template <int kRows, int kNT, int kDT, bool kRecompute>
int launch_heads_tc_build(const void* p, const void* pd, const void* src,
                          const void* w, const void* b3, const void* g,
                          void* dqkv, int B, int S, int H, int Dh,
                          float scale, bool pairs, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_bwd_qkvproj_heads_tc_kernel<kRows, kNT, kDT, kRecompute>,
      &attr_set);
  if (err != cudaSuccess) return (int)err;
  const int slabs = full_tc::rows16(S) / 16 * 32;
  const int threads = kRecompute && kRows * full_tc::kProjThreads > slabs
                          ? kRows * full_tc::kProjThreads
                          : slabs;
  attn_bwd_qkvproj_heads_tc_kernel<kRows, kNT, kDT, kRecompute>
      <<<dim3(H, (B + kRows - 1) / kRows), threads,
         heads_tc_smem_bytes(S, Dh, kRows, kRecompute), stream>>>(
          static_cast<const bf16*>(p), static_cast<const bf16*>(pd),
          static_cast<const bf16*>(src), static_cast<const bf16*>(w),
          static_cast<const bf16*>(b3), static_cast<const bf16*>(g),
          static_cast<bf16*>(dqkv), B, S, H, Dh, scale, pairs);
  return (int)cudaGetLastError();
}

// The plan by shape: re-projecting to S = 64 kBwdProjRows batch rows a
// block, past it one; from the saved qkv #3's block and build (its key
// tiles: 8 to S = 64, the Dh class's whole reach past it).
template <int kDT>
int launch_heads_tc_dt(const void* p, const void* pd, const void* src,
                       const void* w, const void* b3, const void* g,
                       void* dqkv, int B, int S, int H, int Dh, float scale,
                       bool recompute, bool pairs, cudaStream_t st) {
  constexpr int kWide =
      kDT == 8 ? full_tc::kBwdTiles64 : full_tc::kBwdTiles128;
  constexpr int kSmall = full_tc::kBwdSmallTiles;
  const bool small = full_tc::rows16(S) / 8 <= kSmall;
  if (recompute)
    return S <= full_tc::kRegMaxS
               ? launch_heads_tc_build<full_tc::kBwdProjRows, kSmall, kDT,
                                       true>(p, pd, src, w, b3, g, dqkv, B,
                                             S, H, Dh, scale, pairs, st)
               : launch_heads_tc_build<1, kWide, kDT, true>(
                     p, pd, src, w, b3, g, dqkv, B, S, H, Dh, scale, pairs,
                     st);
  return small ? launch_heads_tc_build<1, kSmall, kDT, false>(
                     p, pd, src, w, b3, g, dqkv, B, S, H, Dh, scale, pairs,
                     st)
               : launch_heads_tc_build<1, kWide, kDT, false>(
                     p, pd, src, w, b3, g, dqkv, B, S, H, Dh, scale, pairs,
                     st);
}

// ---- bf16, launch 2: dx on the tensor cores ---------------------------------

constexpr int kDxM = 128, kDxN = 128, kDxK = 64;  // block tile, slice depth
constexpr int kDxWM = 32, kDxWN = 64;  // a warp's tile
constexpr int kDxStages = 3;
constexpr int kDxMinBlocks = 2;        // blocks an SM the build is held to
constexpr int kDxWarpsM = kDxM / kDxWM;
constexpr int kDxThreads = kDxWarpsM * (kDxN / kDxWN) * 32;
constexpr int kDxMT = kDxWM / 16, kDxNT = kDxWN / 8;  // a warp's mma tiles
constexpr int kDxALd = kDxK + 8;       // dqkv slice rows, bf16
constexpr int kDxBLd = kDxN + 8;       // w slice rows, bf16
constexpr int kDxStageElems = kDxM * kDxALd + kDxK * kDxBLd;

constexpr size_t dx_tc_smem_bytes() {
  return (size_t)kDxStages * kDxStageElems * sizeof(bf16);
}

__global__ void __launch_bounds__(kDxThreads, kDxMinBlocks)
    attn_bwd_qkvproj_dx_tc_kernel(const bf16* __restrict__ dqkv,
                                  const bf16* __restrict__ w,
                                  bf16* __restrict__ dx, int M, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int K = 3 * D;
  const int m0 = blockIdx.y * kDxM, n0 = blockIdx.x * kDxN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % kDxWarpsM) * kDxWM, wn = (warp / kDxWarpsM) * kDxWN;
  const int n_slices = (K + kDxK - 1) / kDxK;
  // Slice i into stage i % kDxStages: dqkv rows m0 .. m0 + kDxM − 1 at
  // depth k0 .. k0 + kDxK − 1, then w rows k0 .. k0 + kDxK − 1 at columns
  // n0 .. n0 + kDxN − 1; 16-byte chunks (K and D are multiples of 8),
  // zeros past M, K and D.
  auto load = [&](int i) {
    const int k0 = i * kDxK;
    bf16* as = ring + (i % kDxStages) * kDxStageElems;
    bf16* bs = as + kDxM * kDxALd;
    for (int e = threadIdx.x; e < kDxM * (kDxK / 8); e += kDxThreads) {
      const int r = e / (kDxK / 8), c = (e - r * (kDxK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      attn::cp_async16(as + r * kDxALd + c,
                       ok ? dqkv + (size_t)(m0 + r) * K + k0 + c : dqkv, ok);
    }
    for (int e = threadIdx.x; e < kDxK * (kDxN / 8); e += kDxThreads) {
      const int r = e / (kDxN / 8), c = (e - r * (kDxN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < D;
      attn::cp_async16(bs + r * kDxBLd + c,
                       ok ? w + (size_t)(k0 + r) * D + n0 + c : w, ok);
    }
  };
  float acc[kDxMT][kDxNT][4];
#pragma unroll
  for (int mt = 0; mt < kDxMT; ++mt)
#pragma unroll
    for (int t = 0; t < kDxNT; ++t)
      acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < kDxStages - 1; ++i) {
    if (i < n_slices) load(i);
    attn::cp_async_commit();
  }
  for (int i = 0; i < n_slices; ++i) {
    attn::cp_async_wait<kDxStages - 2>();  // slice i
    __syncthreads();  // ... for every thread; slice i − 1's readers are done
    if (i + kDxStages - 1 < n_slices) load(i + kDxStages - 1);
    attn::cp_async_commit();
    const bf16* as = ring + (i % kDxStages) * kDxStageElems;
    const bf16* bs = as + kDxM * kDxALd;
#pragma unroll
    for (int kk = 0; kk < kDxK; kk += 16) {
      // every fragment of the step first, so the ldmatrix latencies
      // overlap, then the products
      uint32_t fa[kDxMT][4], fb[kDxNT / 2][4];
#pragma unroll
      for (int mt = 0; mt < kDxMT; ++mt)
        attn::ldsm_x4(fa[mt], attn::tc_lane_a(as + (wm + 16 * mt) * kDxALd +
                                                  kk,
                                              kDxALd));
      const bf16* bt = attn::tc_lane_bt(bs + kk * kDxBLd + wn, kDxBLd);
#pragma unroll
      for (int t = 0; t < kDxNT / 2; ++t)
        attn::ldsm_x4_trans(fb[t], bt + 16 * t);
#pragma unroll
      for (int t = 0; t < kDxNT / 2; ++t)
#pragma unroll
        for (int mt = 0; mt < kDxMT; ++mt) {
          attn::mma_bf16(acc[mt][2 * t], fa[mt], fb[t][0], fb[t][1]);
          attn::mma_bf16(acc[mt][2 * t + 1], fa[mt], fb[t][2], fb[t][3]);
        }
    }
  }
  attn::cp_async_wait<0>();
  // The fp32 sums, rounded once; rows past M and columns past D dropped.
#pragma unroll
  for (int mt = 0; mt < kDxMT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = m0 + wm + 16 * mt + (lane >> 2) + 8 * hi;
      if (r >= M) continue;
#pragma unroll
      for (int t = 0; t < kDxNT; ++t) {
        const int c = n0 + wn + 8 * t + 2 * (lane & 3);
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * D + c) =
              __floats2bfloat162_rn(acc[mt][t][2 * hi],
                                    acc[mt][t][2 * hi + 1]);
      }
    }
}

int launch_dx_tc(const void* dqkv, const void* w, void* dx, int M, int D,
                 cudaStream_t stream) {
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (!full_tc::aligned(dqkv, 16) || !full_tc::aligned(w, 16) ||
      !full_tc::aligned(dx, 4))
    return (int)cudaErrorMisalignedAddress;
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_bwd_qkvproj_dx_tc_kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + kDxN - 1) / kDxN, (M + kDxM - 1) / kDxM);
  attn_bwd_qkvproj_dx_tc_kernel<<<grid, kDxThreads, dx_tc_smem_bytes(),
                                  stream>>>(static_cast<const bf16*>(dqkv),
                                            static_cast<const bf16*>(w),
                                            static_cast<bf16*>(dx), M, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch 1. dtype: 0 = float32, 1 = bfloat16, for every tensor. p/pd the
// saved probs [B, H, S, S] (the same pointer twice when the rate was 0);
// src x [B, S, D] with recompute != 0, else the saved qkv [B, S, 3D]; w
// [3D, D]; b3 [3D] (read only with recompute); g [B, S, D]; dqkv [B, S,
// 3D] receives the gradient. Returns the cudaError_t of the launch (0 on
// success); a shape past the shared-memory plan returns
// cudaErrorInvalidValue, a bf16 src, w or g off the 16 bytes cp.async
// copies cudaErrorMisalignedAddress.
int attn_bwd_qkvproj_heads(const void* p, const void* pd, const void* src,
                           const void* w, const void* b3, const void* g,
                           void* dqkv, int B, int S, int H, int Dh,
                           float scale, int recompute, int dtype,
                           void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (heads_smem_bytes(S, Dh, recompute != 0) > attn::kMaxSmemBytes)
      return (int)cudaErrorInvalidValue;
    return recompute ? launch_heads_fp32<true>(p, pd, src, w, b3, g, dqkv,
                                               B, S, H, Dh, scale, st)
                     : launch_heads_fp32<false>(p, pd, src, w, b3, g, dqkv,
                                                B, S, H, Dh, scale, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // bf16: the tensor-core plan
  const int rows =
      recompute && S <= full_tc::kRegMaxS ? full_tc::kBwdProjRows : 1;
  const int wide = full_tc::dh_tiles(Dh) == 8 ? full_tc::kBwdTiles64
                                              : full_tc::kBwdTiles128;
  if (full_tc::rows16(S) / 8 > wide ||
      heads_tc_smem_bytes(S, Dh, rows, recompute != 0) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (!full_tc::aligned(src, 16) || !full_tc::aligned(g, 16) ||
      (recompute && !full_tc::aligned(w, 16)))
    return (int)cudaErrorMisalignedAddress;
  const bool pairs =
      S % 2 == 0 && full_tc::aligned(p, 4) && full_tc::aligned(pd, 4);
  return full_tc::dh_tiles(Dh) == 8
             ? launch_heads_tc_dt<8>(p, pd, src, w, b3, g, dqkv, B, S, H, Dh,
                                     scale, recompute != 0, pairs, st)
             : launch_heads_tc_dt<16>(p, pd, src, w, b3, g, dqkv, B, S, H,
                                      Dh, scale, recompute != 0, pairs, st);
}

// Launch 2. dx [M, D] = dqkv [M, 3D] · w [3D, D], M = B·S rows; dtype as
// above (bf16: D a multiple of 8, dqkv and w 16-byte aligned). Returns the
// cudaError_t of the launch (0 on success).
int attn_bwd_qkvproj_dx(const void* dqkv, const void* w, void* dx, int M,
                        int D, int dtype, void* stream) {
  if (M < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if ((M + attn::kGM - 1) / attn::kGM > 65535)
        return (int)cudaErrorInvalidConfiguration;
      return launch_dx_fp32(dqkv, w, dx, M, D, st);
    case 1:
      if ((M + kDxM - 1) / kDxM > 65535)
        return (int)cudaErrorInvalidConfiguration;
      return launch_dx_tc(dqkv, w, dx, M, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
