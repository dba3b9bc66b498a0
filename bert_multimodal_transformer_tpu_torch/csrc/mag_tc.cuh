// The bf16 plans of the fused MAG gate forward #25 (`mag_fwd_tc_kernel`,
// mag_fwd.cu) and backward #26 (`mag_bwd_tc_kernel`, mag_bwd.cu) on the
// tensor cores, and what the two kernels share: the products
// (`gate_products`), the cluster's rank-order sums and the launch.
//
// What #25 computes is mag_common.cuh's gate, y = LayerNorm(α · H_m + t),
// with bf16 activations t [N, D], v [N, Dv], a [N, Da] and fp32 weights
// (x·W layout). The TPU kernel runs its six dots at Precision.HIGHEST, so
// a product here must keep fp32 precision. A bf16 activation is exact in
// bf16, and each fp32 weight w is split, as it arrives, into three bf16
// planes: w₁ = bf16(w), w₂ = bf16(w − w₁), w₃ = bf16(w − w₁ − w₂) (each
// difference exact in fp32), which hold w to 2⁻²⁴ of itself. A bf16 ×
// bf16 product is exact in fp32, so x·w₁ + x·w₂ + x·w₃ summed in fp32 on
// mma.sync.m16n8k16 is the fp32 product up to the order of the sum and
// that last 2⁻²⁴; no activation is split and there are no cross terms.
// The weights still cross L2 as fp32, 4 bytes each, and the gate stays one
// launch.
//
// The plan. A block of 8 warps owns kRows = 64 rows and kCols = 128
// output columns, warp w the columns 16w .. 16w + 15 for all 64 rows: the
// weights are the A operand (16 output columns × 16 deep: a lane reads its
// eight fp32 values from shared memory and splits them into the three
// planes' A fragments in registers), the activations the B operand (8 row
// tiles of n8, by ldmatrix). Both stream through a kStages-stage cp.async
// ring of kSlice-deep slices: the block's 64 activation rows in bf16 and
// the weight's rows at the block's 128 columns in fp32. A block
// walks six segments of the depth: t against W_hv_t then v against W_hv_v
// into pv, v against W_v into dv_; H_m = ReLU(pv + b_hv) ⊙ (dv_ + b_v)
// goes to an fp32 tile in shared memory; then t against W_ha_t and a
// against W_ha_a into pa, a against W_a into da_, and H_m += ReLU(pa +
// b_ha) ⊙ (da_ + b_a) (mag_common.cuh's `displacement`, rounding for
// rounding). Two accumulator sets of 8 n8 tiles (64 fp32 a lane) are live
// at most. The modality widths are padded to the 16-deep step with zeros
// in both operands (weights past the width read as 0, the ring's columns
// past it zero-filled).
//
// Whole rows. The norms, α and the LayerNorm need every column of a row,
// and a 64-row fp32 H_m at D = 768 (192 KB) does not fit beside the
// operands. So the D / kCols blocks of a row block form a thread block
// cluster (6 at D = 768, 8 at MAX_D = 1024: the portable limit), each
// holding its own [64][kCols] of H_m, and they trade per-row partial sums
// through distributed shared memory: ‖t‖² and ‖H_m‖², then (α known) Σ f,
// then (μ known) Σ (f − μ)², f = α·H_m + t: the two-pass order of
// `row_norms` and `row_moments`, each block's partial summed lane by lane
// in column order, then the warp's xor tree, then the cluster's blocks in
// rank order, so every block of the cluster reads the same totals. One
// warp takes eight rows. The weights then cross L2 once per 64 rows
// (N / 64 · 6 MB at D = 768) where the CUDA-core plan read them once per
// 16.
//
// Shared memory (ops/mag_fused.py::tc_smem_bytes): the ring, kStages ×
// ([64][kSlice + 8] bf16 and [kSlice][kCols + 4] fp32), the H_m tile
// [64][kCols + 4] fp32 and three [64][2] partial-sum rows: 99 KB whatever
// D, Dv and Da, two blocks an SM.

#pragma once

#include <cooperative_groups.h>

#include "mag_common.cuh"

namespace mag_tc {

using bf16 = __nv_bfloat16;

// A block's rows: 128 (16 warps, one block an SM, half the weight
// traffic) ran 0.95 ms against 0.88 at N = 12800 and 0.31 against 0.16 at
// N = 2400 (bf16 D = 768, NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py).
constexpr int kRows = 64;
constexpr int kGroups = kRows / 64;  // 8 warps for each 64 rows
constexpr int kThreads = 256 * kGroups;
constexpr int kCols = 128;          // a block's output columns, 16 a warp
constexpr int kSlice = 32;          // the ring's slice depth
constexpr int kStages = 3;
constexpr int kLd = kSlice + 8;     // an activation row, bf16 (ldmatrix)
constexpr int kWLd = kCols + 4;     // a weight row, fp32 (conflict-free)
constexpr int kHmLd = kCols + 4;    // an H_m tile row, fp32
// A stage: the activations [kRows][kLd] bf16, then the weights
// [kSlice][kWLd] fp32.
constexpr int kStageBytes =
    kRows * kLd * 2 + kSlice * kWLd * 4;
constexpr int kRowTiles = 8;       // a warp's n8 row tiles: 64 rows
constexpr int kMaxCluster = mag::kMaxD / kCols;

__host__ __device__ inline int cluster_blocks(int D) {
  return (D + kCols - 1) / kCols;
}

__host__ __device__ inline size_t smem_bytes() {
  return (size_t)kStages * kStageBytes +
         (size_t)kRows * kHmLd * sizeof(float) +
         (size_t)3 * kRows * 2 * sizeof(float);
}

// A lane's eight values of the A fragment of one 16-deep step from the
// stage's fp32 weight slice ws [kSlice][kWLd] (depth row, block column):
// rows kk + 2·(lane % 4) + {0, 1, 8, 9} at the warp's columns cw + lane /
// 4 + {0, 8}; w[e] holds depth + (e & 1) + 8·(e >> 2) and column +
// 8·((e >> 1) & 1), so (w[2i], w[2i + 1]) is register i of the fragment.
__device__ __forceinline__ void fetch_a(float (&w)[8], const float* ws,
                                        int kk, int cw) {
  const int lane = threadIdx.x & 31;
  const float* base = ws + (kk + 2 * (lane & 3)) * kWLd + cw + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e] = base[((e & 1) + 8 * (e >> 2)) * kWLd + 8 * ((e >> 1) & 1)];
}

// The three bf16 planes of the fragment: plane p is the bf16 rounding of
// what planes 0 .. p − 1 left (each remainder exact in fp32).
__device__ __forceinline__ void split3(const float (&w)[8],
                                       uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = w[2 * i], y = w[2 * i + 1];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      a[p][i] = *reinterpret_cast<const uint32_t*>(&h);
      x = __fsub_rn(x, __low2float(h));
      y = __fsub_rn(y, __high2float(h));
    }
  }
}

// One segment of the depth: acc[j] += W[k][c0 + m] · X[r0 + 8j + n][k]
// over the segment's K (the warp's 16 columns × its 64 rows from r0), its
// slices (activations and weights) taken from the ring in turn.
// `advance` waits for the next slice and returns its stage (every thread
// calls it at the same steps). mma.sync rounds its fp32 sums toward zero,
// so a running sum over a long depth drifts toward zero, by up to an ulp
// of the sum each product. With kStepSums each 16-deep step's three planes
// go into a zeroed partial that is added to acc in a rounded fp32 add: the
// drift then stays within a step's sum, whose sign varies from step to
// step. #26's fp32 outputs need that; #25's bf16 output does not.
template <bool kStepSums, typename Advance>
__device__ __forceinline__ void segment(float (&acc)[kRowTiles][4], int K,
                                        int r0, int cw, bool live,
                                        Advance&& advance) {
  const int lane = threadIdx.x & 31;
  const int steps = (K + 15) / 16;
  const unsigned char* stage = nullptr;  // set at the segment's first step
  // a slice's two steps at once, so one step's loads and split overlap
  // the other's products (5% at N = 12800, chip_ab.py)
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    if (s % (kSlice / 16) == 0) stage = advance();
    if (!live) continue;
    const int kk = (s % (kSlice / 16)) * 16;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const float* ws =
        reinterpret_cast<const float*>(stage + kRows * kLd * sizeof(bf16));
    float w[8];
    fetch_a(w, ws, kk, cw);
    uint32_t a[3][4];
    split3(w, a);
    // every B fragment of the step first, so the ldmatrix latencies
    // overlap, then the 24 products plane by plane, so that the products
    // into one accumulator lie 8 apart
    const bf16* pb = xs + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                     ((lane >> 3) & 1) * 8 + kk;
    uint32_t fb[kRowTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kRowTiles / 2; ++j)
      attn::ldsm_x4(fb[j], pb + j * 16 * kLd);
    if constexpr (kStepSums) {
#pragma unroll
      for (int j = 0; j < kRowTiles / 2; ++j) {
        float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          attn::mma_bf16(s0, a[p], fb[j][0], fb[j][1]);
          attn::mma_bf16(s1, a[p], fb[j][2], fb[j][3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[2 * j][q] = __fadd_rn(acc[2 * j][q], s0[q]);
          acc[2 * j + 1][q] = __fadd_rn(acc[2 * j + 1][q], s1[q]);
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < kRowTiles / 2; ++j) {
          attn::mma_bf16(acc[2 * j], a[p], fb[j][0], fb[j][1]);
          attn::mma_bf16(acc[2 * j + 1], a[p], fb[j][2], fb[j][3]);
        }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRowTiles][4]) {
#pragma unroll
  for (int j = 0; j < kRowTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// Lane element e of row tile j: row 8j + 2·(lane % 4) + (e & 1), column
// lane / 4 + 8·(e >> 1) of the warp's 16.
__device__ __forceinline__ int acc_row(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}

// The six products of the block's kRows rows from row0 × kCols columns
// from col0, in two halves of two accumulator sets, through the NS-stage
// ring at smem_raw (NS × kStageBytes), with or without step sums
// (`segment`). The slices in order: t, v, v (pv, pv,
// dv_), then t, a, a (pa, pa, da_), each segment's depth in kSlice-deep
// slices. `first(acc0, acc1)` takes pv and dv_, `second(acc0, acc1)` pa
// and da_, neither with its bias; `second` runs once every cp.async of its
// thread has landed, while other warps may still read the ring's last
// slice. Slice i goes into stage i % NS: rows row0 .. row0 + 63 at
// depth k0 .. k0 + kSlice − 1 of its segment's activations, zeros past N
// and the width, then its weight's rows k0 .. k0 + kSlice − 1 at the
// block's columns, zeros past the width and D; by 16-byte cp.async where
// `vec` says the rows are 16-byte aligned (bits 0-2: t, v, a; bit 3: the
// weights), else by plain loads.
template <int NS, bool kStepSums, typename First, typename Second>
__device__ __forceinline__ void gate_products(
    unsigned char* smem_raw, const bf16* __restrict__ t,
    const bf16* __restrict__ v, const bf16* __restrict__ a,
    const mag::Params& p, int N, int D, int Dv, int Da, int vec, int row0,
    int col0, First&& first, Second&& second) {
  const int warp = threadIdx.x >> 5;
  const int cw = 16 * (warp % 8);  // the warp's columns in the block's 128
  const int r0 = 64 * (warp / 8);   // and its first row
  const bool live = col0 + cw < D;
  const int n_t = (D + kSlice - 1) / kSlice;
  const int n_v = (Dv + kSlice - 1) / kSlice;
  const int n_a = (Da + kSlice - 1) / kSlice;
  const int ends[6] = {n_t,
                       n_t + n_v,
                       n_t + 2 * n_v,
                       2 * n_t + 2 * n_v,
                       2 * n_t + 2 * n_v + n_a,
                       2 * n_t + 2 * n_v + 2 * n_a};
  const int total = ends[5];
  auto load = [&](int i) {
    int seg = 0;
#pragma unroll
    for (int e = 0; e < 5; ++e) seg += i >= ends[e];
    const int j = i - (seg == 0   ? 0
                       : seg == 1 ? ends[0]
                       : seg == 2 ? ends[1]
                       : seg == 3 ? ends[2]
                       : seg == 4 ? ends[3]
                                  : ends[4]);
    const bf16* src = seg == 0 || seg == 3 ? t : seg < 3 ? v : a;
    const int width = seg == 0 || seg == 3 ? D : seg < 3 ? Dv : Da;
    const float* W = seg == 0   ? p.w_hv_t
                     : seg == 1 ? p.w_hv_v
                     : seg == 2 ? p.w_v
                     : seg == 3 ? p.w_ha_t
                     : seg == 4 ? p.w_ha_a
                                : p.w_a;
    const int vec_x = seg == 0 || seg == 3 ? 1 : seg < 3 ? 2 : 4;
    const int k0 = j * kSlice;
    unsigned char* stage = smem_raw + (i % NS) * kStageBytes;
    bf16* xs = reinterpret_cast<bf16*>(stage);
    float* ws = reinterpret_cast<float*>(stage + kRows * kLd * sizeof(bf16));
    if (vec & vec_x) {
      for (int e = threadIdx.x; e < kRows * (kSlice / 8); e += kThreads) {
        const int r = e / (kSlice / 8), c = (e - r * (kSlice / 8)) * 8;
        const bool ok = row0 + r < N && k0 + c < width;
        attn::cp_async16(
            xs + r * kLd + c,
            ok ? src + (size_t)(row0 + r) * width + k0 + c : src, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kRows * kSlice; e += kThreads) {
        const int r = e / kSlice, c = e - r * kSlice;
        xs[r * kLd + c] = row0 + r < N && k0 + c < width
                              ? src[(size_t)(row0 + r) * width + k0 + c]
                              : __float2bfloat16(0.0f);
      }
    }
    if (vec & 8) {
      for (int e = threadIdx.x; e < kSlice * (kCols / 4); e += kThreads) {
        const int r = e / (kCols / 4), c = (e - r * (kCols / 4)) * 4;
        const bool ok = k0 + r < width && col0 + c < D;
        attn::cp_async16(ws + r * kWLd + c,
                         ok ? W + (size_t)(k0 + r) * D + col0 + c : W, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kSlice * kCols; e += kThreads) {
        const int r = e / kCols, c = e - r * kCols;
        ws[r * kWLd + c] = k0 + r < width && col0 + c < D
                               ? W[(size_t)(k0 + r) * D + col0 + c]
                               : 0.0f;
      }
    }
  };
  int next = 0;  // the next slice to consume
  auto advance = [&]() {
    attn::cp_async_wait<NS - 2>();  // slice `next`
    __syncthreads();  // ... for every thread; slice next − 1's readers done
    if (next + NS - 1 < total) load(next + NS - 1);
    attn::cp_async_commit();
    const unsigned char* stage = smem_raw + (next % NS) * kStageBytes;
    ++next;
    return stage;
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < total) load(i);
    attn::cp_async_commit();
  }

  float acc0[kRowTiles][4], acc1[kRowTiles][4];
  zero(acc0);
  segment<kStepSums>(acc0, D, r0, cw, live, advance);
  segment<kStepSums>(acc0, Dv, r0, cw, live, advance);
  zero(acc1);
  segment<kStepSums>(acc1, Dv, r0, cw, live, advance);
  first(acc0, acc1);
  zero(acc0);
  segment<kStepSums>(acc0, D, r0, cw, live, advance);
  segment<kStepSums>(acc0, Da, r0, cw, live, advance);
  zero(acc1);
  segment<kStepSums>(acc1, Da, r0, cw, live, advance);
  attn::cp_async_wait<0>();
  second(acc0, acc1);
}

// Σ over the cluster's nc blocks, in rank order, of their
// part[(round · kRows + row) · 2 + x].
__device__ __forceinline__ float rank_sum(
    cooperative_groups::cluster_group& cluster, float* part, int nc,
    int round, int row, int x) {
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < nc)
      s += cluster.map_shared_rank(part, q)[(round * kRows + row) * 2 + x];
  return s;
}

// ---- bf16 #26, the backward chain (mag_bwd.cu) ----------------------------
//
// The same blocks, clusters and products, then the chain over whole rows.
// The chain needs ReLU(pv), dv_, ReLU(pa) and da_ of every element after the
// cluster's totals are known: four [64][kCols] fp32 tiles, 135 KB, too many
// beside a ring for two blocks an SM, and at one block an SM the clusters of
// 6, each within one GPC, leave SMs idle (a 16-warp block of that kind ran
// 1.64 ms at N = 12800 where this plan ran 1.19, both without step sums,
// chip_ab.py, NVIDIA H100 80GB HBM3 at 700 W). So the first half's two go to
// shared memory as [kRows][kHmLd] tiles and the second half's stay in their
// accumulators, and the ring has kBwdStages = 2 stages (H_m is recomputed
// from the four, rounding for rounding as `displacement`). The products take
// step sums (`segment`), so that the fp32 outputs do not drift from the
// plain chain's. Once the products end, the ring's bytes take the block's
// [kRows][kCols] slices of t and dy (bf16, rows kSliceLd apart), each row's
// scalars and the warps' partial sums. The chain then runs in the
// accumulators' layout (a lane: 16 rows × 2 columns of its warp's 16). Five
// cluster rounds, each a per-row sum: a lane's terms in column order, the
// row's 8 lanes by the xor tree over lane bits 2-4, the 8 warps in order,
// the cluster's blocks in rank order: ‖t‖² and ‖H_m‖²; Σ f; Σ (f − μ)²; Σ
// dxh and Σ dxh · x̂; Σ df · H_m (f = α · H_m + t, dxh = dy · γ, df = inv ·
// (dxh − m1 − x̂ · m2)). Thread r < kRows turns row r's totals into its
// scalars (α, μ, inv, m1, m2, the clamp's coefficients), so every block of a
// cluster holds the same ones. x̂ leaves in round four, the other five
// outputs after round five, each written once from the block's own elements.

constexpr int kTileBytes = kRows * kHmLd * (int)sizeof(float);
constexpr int kBwdStages = 2;
constexpr int kBwdRounds = 5;
constexpr int kSliceLd = kCols + 8;  // a t or dy slice row, bf16
constexpr int kScalars = 8;          // a row's scalars
static_assert(2 * kRows * kSliceLd * (int)sizeof(bf16) +
                      kRows * kScalars * (int)sizeof(float) +
                      kThreads / 32 * kRows * 2 * (int)sizeof(float) <=
                  kBwdStages * kStageBytes,
              "the chain's buffers fit in the ring's bytes");

// bf16 #26's shared memory (ops/mag_fused.py::tc_bwd_smem_bytes): the
// ring, the first half's two tiles and kBwdRounds [kRows][2] rows of
// partial sums: 114176 bytes whatever D, Dv and Da, two blocks an SM.
__host__ __device__ inline size_t bwd_smem_bytes() {
  return (size_t)kBwdStages * kStageBytes + 2 * (size_t)kTileBytes +
         (size_t)kBwdRounds * kRows * 2 * sizeof(float);
}

// Rows of `width` elements of `elem` bytes from x, each 16-byte aligned.
inline bool rows16(const void* x, int width, int elem) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (size_t)width * elem % 16 == 0;
}

// `gate_products`' vec bits for t, v, a and the weights.
inline int gate_vec(const void* t, const void* v, const void* a,
                    const mag::Params& p, int D, int Dv, int Da) {
  const float* ws[6] = {p.w_hv_t, p.w_hv_v, p.w_v, p.w_ha_t, p.w_ha_a, p.w_a};
  bool vec_w = true;
  for (const float* w : ws) vec_w = vec_w && rows16(w, D, 4);
  return (rows16(t, D, 2) ? 1 : 0) | (rows16(v, Dv, 2) ? 2 : 0) |
         (rows16(a, Da, 2) ? 4 : 0) | (vec_w ? 8 : 0);
}

// A launch of a gate kernel: the grid's blocks in clusters of
// cluster_blocks(D) along x, one cluster a row block, `smem` bytes of
// dynamic shared memory each. Returns the cudaError_t of the launch.
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kernel)(Params...),
                           unsigned long long* attr_set, size_t smem, int N,
                           int D, cudaStream_t stream, Args... args) {
  const cudaError_t err = mag::prepare(kernel, attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nc = cluster_blocks(D);
  const long long blocks = (long long)nc * ((N + kRows - 1) / kRows);
  if (nc > kMaxCluster || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace mag_tc
