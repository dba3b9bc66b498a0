// The bf16 plan of the fused MAG gate forward #25 (mag_fwd.cu) on the
// tensor cores.
//
// What it computes is mag_common.cuh's gate, y = LayerNorm(α · H_m + t),
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
// calls it at the same steps).
template <typename Advance>
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
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < kRowTiles / 2; ++j) {
        attn::mma_bf16(acc[2 * j], a[p], fb[j][0], fb[j][1]);
        attn::mma_bf16(acc[2 * j + 1], a[p], fb[j][2], fb[j][3]);
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

__global__ void __launch_bounds__(kThreads, 2 / kGroups)
    mag_fwd_tc_kernel(const bf16* __restrict__ t, const bf16* __restrict__ v,
                      const bf16* __restrict__ a, mag::Params p,
                      bf16* __restrict__ out, int N, int D, int Dv, int Da,
                      float beta, int vec) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hm = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  float* part = hm + kRows * kHmLd;  // [3][kRows][2]
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / nc) * kRows;
  const int col0 = rank * kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = 16 * (warp % 8);  // the warp's columns in the block's 128
  const int r0 = 64 * (warp / 8);   // and its first row
  const int c0 = col0 + cw;
  const bool live = c0 < D;

  // The slices in order: t, v, v (pv, pv, dv_), then t, a, a (pa, pa,
  // da_), each segment's depth in kSlice-deep slices.
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
  // Slice i into stage i % kStages: rows row0 .. row0 + 63 at depth k0 ..
  // k0 + kSlice − 1 of its segment's activations, zeros past N and the
  // width, then its weight's rows k0 .. k0 + kSlice − 1 at the block's
  // columns, zeros past the width and D; by 16-byte cp.async where `vec`
  // says the rows are 16-byte aligned (bits 0-2: t, v, a; bit 3: the
  // weights), else by plain loads.
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
    unsigned char* stage = smem_raw + (i % kStages) * kStageBytes;
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
    attn::cp_async_wait<kStages - 2>();  // slice `next`
    __syncthreads();  // ... for every thread; slice next − 1's readers done
    if (next + kStages - 1 < total) load(next + kStages - 1);
    attn::cp_async_commit();
    const unsigned char* stage = smem_raw + (next % kStages) * kStageBytes;
    ++next;
    return stage;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load(i);
    attn::cp_async_commit();
  }

  // The products and H_m, in two halves of two accumulator sets each.
  float acc0[kRowTiles][4], acc1[kRowTiles][4];
  zero(acc0);
  segment(acc0, D, r0, cw, live, advance);
  segment(acc0, Dv, r0, cw, live, advance);
  zero(acc1);
  segment(acc1, Dv, r0, cw, live, advance);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + acc_col(e);
    const float bhv = live && c < D ? __ldg(p.b_hv + c) : 0.0f;
    const float bv = live && c < D ? __ldg(p.b_v + c) : 0.0f;
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j)
      hm[(r0 + acc_row(j, e)) * kHmLd + cw + acc_col(e)] =
          c < D ? __fmul_rn(fmaxf(acc0[j][e] + bhv, 0.0f), acc1[j][e] + bv)
                : 0.0f;
  }
  zero(acc0);
  segment(acc0, D, r0, cw, live, advance);
  segment(acc0, Da, r0, cw, live, advance);
  zero(acc1);
  segment(acc1, Da, r0, cw, live, advance);
  attn::cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + acc_col(e);
    const float bha = live && c < D ? __ldg(p.b_ha + c) : 0.0f;
    const float ba = live && c < D ? __ldg(p.b_a + c) : 0.0f;
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      float* h = hm + (r0 + acc_row(j, e)) * kHmLd + cw + acc_col(e);
      if (c < D)
        *h = __fadd_rn(*h, __fmul_rn(fmaxf(acc0[j][e] + bha, 0.0f),
                                     acc1[j][e] + ba));
    }
  }
  __syncthreads();  // the block's H_m is in

  // Whole rows across the cluster: warp w takes rows 8w .. 8w + 7, lane l
  // the block's columns l, l + 32, l + 64, l + 96 (those < D).
  const int cols = min(kCols, D - col0);  // may be ≤ 0 for no block
  constexpr int kPer = kCols / 32;
  float tv[8][kPer];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + 8 * warp + r;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      tv[r][u] = row < N && c < cols
                     ? __bfloat162float(t[(size_t)row * D + col0 + c])
                     : 0.0f;
    }
  }
  auto rank_sum = [&](int which, int row, int x) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < nc)
        s += cluster.map_shared_rank(part, q)[(which * kRows + row) * 2 + x];
    return s;
  };
  // ‖t‖², ‖H_m‖²
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = 8 * warp + r;
    const float* hr = hm + lr * kHmLd;
    float tt = 0.0f, hh = 0.0f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      if (c < cols) {
        tt = fmaf(tv[r][u], tv[r][u], tt);
        hh = fmaf(hr[c], hr[c], hh);
      }
    }
    tt = mag::warp_sum(tt);
    hh = mag::warp_sum(hh);
    if (lane == 0) {
      part[lr * 2] = tt;
      part[lr * 2 + 1] = hh;
    }
  }
  cluster.sync();
  float alpha[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = 8 * warp + r;
    const float em = sqrtf(rank_sum(0, lr, 0));
    const float hn = sqrtf(rank_sum(0, lr, 1));
    const float hn1 = hn == 0.0f ? 1.0f : hn;
    alpha[r] = fminf(__fmul_rn(em / (hn1 + mag::kEps), beta), 1.0f);
    const float* hr = hm + lr * kHmLd;
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      if (c < cols) sum += fmaf(alpha[r], hr[c], tv[r][u]);
    }
    sum = mag::warp_sum(sum);
    if (lane == 0) part[(kRows + lr) * 2] = sum;
  }
  cluster.sync();
  float mu[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = 8 * warp + r;
    mu[r] = rank_sum(1, lr, 0) / (float)D;
    const float* hr = hm + lr * kHmLd;
    float sq = 0.0f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      if (c < cols) {
        const float f = fmaf(alpha[r], hr[c], tv[r][u]) - mu[r];
        sq = fmaf(f, f, sq);
      }
    }
    sq = mag::warp_sum(sq);
    if (lane == 0) part[(2 * kRows + lr) * 2] = sq;
  }
  cluster.sync();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = 8 * warp + r, row = row0 + lr;
    const float inv = rsqrtf(rank_sum(2, lr, 0) / (float)D + mag::kLnEps);
    if (row >= N) continue;
    const float* hr = hm + lr * kHmLd;
    bf16* yr = out + (size_t)row * D + col0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = lane + 32 * u;
      if (c < cols) {
        const float f = fmaf(alpha[r], hr[c], tv[r][u]) - mu[r];
        yr[c] = __float2bfloat16(fmaf(f * inv, __ldg(p.ln_g + col0 + c),
                                      __ldg(p.ln_b + col0 + c)));
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

// The launch: the grid's blocks in clusters of cluster_blocks(D) along x,
// one cluster a row block. Returns the cudaError_t of the launch.
inline int launch(const void* t, const void* v, const void* a,
                  const mag::Params& p, void* out, int N, int D, int Dv,
                  int Da, float beta, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = mag::prepare(mag_fwd_tc_kernel, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nc = cluster_blocks(D);
  const long long blocks = (long long)nc * ((N + kRows - 1) / kRows);
  if (nc > kMaxCluster || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // 16-byte copies where every row starts 16-byte aligned
  auto rows16 = [](const void* x, int width, int elem) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           (size_t)width * elem % 16 == 0;
  };
  const float* ws[6] = {p.w_hv_t, p.w_hv_v, p.w_v, p.w_ha_t, p.w_ha_a, p.w_a};
  bool vec_w = true;
  for (const float* w : ws) vec_w = vec_w && rows16(w, D, 4);
  const int vec = (rows16(t, D, 2) ? 1 : 0) | (rows16(v, Dv, 2) ? 2 : 0) |
                  (rows16(a, Da, 2) ? 4 : 0) | (vec_w ? 8 : 0);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, mag_fwd_tc_kernel, static_cast<const bf16*>(t),
      static_cast<const bf16*>(v), static_cast<const bf16*>(a), p,
      static_cast<bf16*>(out), N, D, Dv, Da, beta, vec);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace mag_tc
