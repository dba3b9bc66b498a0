// Fused MAG gate backward chain for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mag_bwd_kernel`
// (bert_multimodal_transformer_tpu/ops/mag_pallas.py:186): from the
// gate's inputs and the output cotangent dy it recomputes the forward of
// mag_common.cuh and runs the LayerNorm backward, the α / norm-clamp
// backward and the gate / ReLU backward, emitting six [N, D] fp32 tensors:
//   dpv, dpa  ∂L/∂(gate pre-activations)
//   ddv, dda  ∂L/∂(displacement projections)
//   dt        the direct text-path cotangent (LayerNorm and ‖t‖ terms; the
//             caller adds dpv·W_hv_tᵀ + dpa·W_ha_tᵀ)
//   xhat      the normalized LayerNorm input, for dγ
// The weight and input gradients are plain fp32 products outside
// (ops/mag_fused.py), as the TPU package leaves them to XLA.
//
// Edge semantics, as the TPU kernel (mag_pallas.py:241-254): min's VJP is
// 1 below the tie, 0.5 at thresh == 1 and 0 above; ‖H_m‖ = 0 counts as 1
// and passes no gradient to the norm (`live`); ‖t‖ = 0 passes none to t
// (mag_common.cuh's `clamp_backward`).
//
// What bounds it on the card: the recompute is the forward's six products,
// 35.0 GFLOP at N = 12800, D = 768, Dv = 47, Da = 74, at fp32 precision
// (the TPU kernel's dots run at Precision.HIGHEST). With bf16 activations
// the least time for that precision is three bf16 passes on the tensor
// cores (each fp32 weight split into three bf16 planes), 3 × 35.0 GFLOP at
// 989 TFLOP/s: 0.106 ms. The bytes, t, v, a and dy read once, the six
// fp32 outputs (236 MB) written once, take 0.085 ms at 3.35 TB/s. So the
// products bound it, and the outputs nearly so. With fp32 activations the
// products run at the fp32 rate outside the tensor cores, 0.52 ms.
//
// What the design does about that. bf16 (`mag_bwd_tc_kernel`, below, on
// mag_tc.cuh's plan): #25's tensor-core products (three weight planes on
// mma.sync, 64 rows × 128 columns a block, a cluster of D / 128 blocks a row
// block), the four products kept on chip through the five cluster rounds of
// row sums (two as fp32 tiles in shared memory, two in their accumulators,
// so that two blocks share an SM), and every output written once. fp32
// (`mag_bwd_kernel`): the CUDA-core plan of mag_common.cuh. The chain needs
// the four products again after the row reductions, and four [16][D] fp32
// tiles do not fit in shared memory beside t and H_m: each thread writes its
// pieces of pv, pa, dv_ and da_ straight into the dpv, dpa, ddv and dda
// output rows, and the last pass reads them back (from L2) and overwrites
// them with the gradients. One warp per row runs the reductions (‖t‖, ‖H_m‖,
// mean, variance, mean(dxh), mean(dxh·x̂), Σ df·H_m) out of shared memory,
// recomputing x̂ and df where a pass needs them.

#include "mag_common.cuh"
#include "mag_tc.cuh"

// ---- bf16 #26 on the tensor cores (mag_tc.cuh's plan) ------------------

namespace mag_tc {

__global__ void __launch_bounds__(kThreads, 2)
    mag_bwd_tc_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ t,
                      const bf16* __restrict__ v, const bf16* __restrict__ a,
                      mag::Params p, float* __restrict__ dpv,
                      float* __restrict__ dpa, float* __restrict__ ddv,
                      float* __restrict__ dda, float* __restrict__ dt,
                      float* __restrict__ xhat, int N, int D, int Dv, int Da,
                      float beta, int vec) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(kThreads == 8 * 32, "one warp to each 16 columns");
  // after the ring: ReLU(pv) and dv_ [kRows][kHmLd], the partial sums
  float* gvs = reinterpret_cast<float*>(smem_raw + kBwdStages * kStageBytes);
  float* dvs = gvs + kRows * kHmLd;
  float* part = dvs + kRows * kHmLd;  // [kBwdRounds][kRows][2]
  // in the ring's bytes once the products end
  bf16* ts = reinterpret_cast<bf16*>(smem_raw);
  bf16* dys = ts + kRows * kSliceLd;
  float* scal = reinterpret_cast<float*>(dys + kRows * kSliceLd);
  float* wsum = scal + kRows * kScalars;  // [8 warps][kRows][2]
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / nc) * kRows;
  const int col0 = rank * kCols;
  const int cols = min(kCols, D - col0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = 16 * warp;  // the warp's columns in the block's 128
  const int c0 = col0 + cw;

  // The products: ReLU(pv + b_hv) and dv_ + b_v into their tiles, ReLU(pa
  // + b_ha) and da_ + b_a kept in the lane's accumulator elements; zeros
  // past D.
  float ga[kRowTiles][4], da[kRowTiles][4];
  gate_products<kBwdStages, true>(
      smem_raw, t, v, a, p, N, D, Dv, Da, vec, row0, col0,
      [&](const float(&acc0)[kRowTiles][4], const float(&acc1)[kRowTiles][4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + acc_col(e);
          const float bhv = c < D ? __ldg(p.b_hv + c) : 0.0f;
          const float bv = c < D ? __ldg(p.b_v + c) : 0.0f;
#pragma unroll
          for (int j = 0; j < kRowTiles; ++j) {
            const int i = acc_row(j, e) * kHmLd + cw + acc_col(e);
            gvs[i] = c < D ? fmaxf(acc0[j][e] + bhv, 0.0f) : 0.0f;
            dvs[i] = c < D ? acc1[j][e] + bv : 0.0f;
          }
        }
      },
      [&](const float(&acc0)[kRowTiles][4], const float(&acc1)[kRowTiles][4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + acc_col(e);
          const float bha = c < D ? __ldg(p.b_ha + c) : 0.0f;
          const float ba = c < D ? __ldg(p.b_a + c) : 0.0f;
#pragma unroll
          for (int j = 0; j < kRowTiles; ++j) {
            ga[j][e] = c < D ? fmaxf(acc0[j][e] + bha, 0.0f) : 0.0f;
            da[j][e] = c < D ? acc1[j][e] + ba : 0.0f;
          }
        }
      });
  __syncthreads();  // every warp is done with the ring; the tiles are in

  // The block's slices of t and dy, zero past N and D: by cp.async where
  // the rows are 16-byte aligned (bits 0 and 4 of vec).
  auto stage = [&](bf16* dst, const bf16* src, bool async) {
    if (async) {
      for (int e = threadIdx.x; e < kRows * (kCols / 8); e += kThreads) {
        const int r = e / (kCols / 8), c = (e - r * (kCols / 8)) * 8;
        const bool ok = row0 + r < N && c < cols;
        attn::cp_async16(
            dst + r * kSliceLd + c,
            ok ? src + (size_t)(row0 + r) * D + col0 + c : src, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
        const int r = e / kCols, c = e - r * kCols;
        dst[r * kSliceLd + c] = row0 + r < N && c < cols
                                    ? src[(size_t)(row0 + r) * D + col0 + c]
                                    : __float2bfloat16(0.0f);
      }
    }
  };
  stage(ts, t, vec & 1);
  stage(dys, dy, vec & 16);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();

  // Lane element e of row tile j: row acc_row(j, e), block column cb[e].
  int cb[4];
  bool in[4];
  float gam[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cb[e] = cw + acc_col(e);
    in[e] = cb[e] < cols;
    gam[e] = in[e] ? __ldg(p.ln_g + col0 + cb[e]) : 0.0f;
  }
  auto hm_of = [&](int j, int e) {
    const int i = acc_row(j, e) * kHmLd + cb[e];
    return __fadd_rn(__fmul_rn(gvs[i], dvs[i]),
                     __fmul_rn(ga[j][e], da[j][e]));
  };
  auto t_of = [&](int j, int e) {
    return __bfloat162float(ts[acc_row(j, e) * kSliceLd + cb[e]]);
  };
  auto dxh_of = [&](int j, int e) {
    return __bfloat162float(dys[acc_row(j, e) * kSliceLd + cb[e]]) * gam[e];
  };
  // row scalar k: 0 α, 1 μ, 2 inv, 3 m1, 4 m2, 5 t_coef, 6 h_coef
  auto sc = [&](int j, int e, int k) {
    return scal[acc_row(j, e) * kScalars + k];
  };
  auto store = [&](float* out, int j, int e, float x) {
    const int row = row0 + acc_row(j, e);
    if (row < N) out[(size_t)row * D + col0 + cb[e]] = x;
  };
  // One round: terms(j, e, sums) adds element (j, e)'s terms into its
  // row's one or two sums; then the row's 8 lanes (the xor tree over lane
  // bits 2-4), the 8 warps in order, part[rd], the cluster's barrier.
  auto sum_round = [&](int rd, auto&& terms) {
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      float x[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (in[e]) terms(j, e, x[e & 1]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float y = x[s][k];
          y += __shfl_xor_sync(0xffffffffu, y, 4);
          y += __shfl_xor_sync(0xffffffffu, y, 8);
          y += __shfl_xor_sync(0xffffffffu, y, 16);
          x[s][k] = y;
        }
      if (lane < 4) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float* w = wsum + (warp * kRows + 8 * j + 2 * lane + s) * 2;
          w[0] = x[s][0];
          w[1] = x[s][1];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kRows) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        s0 += wsum[(w * kRows + threadIdx.x) * 2];
        s1 += wsum[(w * kRows + threadIdx.x) * 2 + 1];
      }
      part[(rd * kRows + threadIdx.x) * 2] = s0;
      part[(rd * kRows + threadIdx.x) * 2 + 1] = s1;
    }
    cluster.sync();
  };
  // thread r < kRows: row r's totals over the cluster, in rank order
  const int r = threadIdx.x;
  auto total = [&](int rd, int k) {
    return rank_sum(cluster, part, nc, rd, r, k);
  };
  float* rs = scal + r * kScalars;

  // 1: ‖t‖², ‖H_m‖² → α
  sum_round(0, [&](int j, int e, float(&x)[2]) {
    const float tv = t_of(j, e), h = hm_of(j, e);
    x[0] = fmaf(tv, tv, x[0]);
    x[1] = fmaf(h, h, x[1]);
  });
  if (r < kRows) rs[0] = mag::norms_of(total(0, 0), total(0, 1), beta).alpha;
  __syncthreads();
  // 2: Σ f → μ
  sum_round(1, [&](int j, int e, float(&x)[2]) {
    x[0] += fmaf(sc(j, e, 0), hm_of(j, e), t_of(j, e));
  });
  if (r < kRows) rs[1] = total(1, 0) / (float)D;
  __syncthreads();
  // 3: Σ (f − μ)² → inv
  sum_round(2, [&](int j, int e, float(&x)[2]) {
    const float c = fmaf(sc(j, e, 0), hm_of(j, e), t_of(j, e)) - sc(j, e, 1);
    x[0] = fmaf(c, c, x[0]);
  });
  if (r < kRows) rs[2] = rsqrtf(total(2, 0) / (float)D + mag::kLnEps);
  __syncthreads();
  auto xhat_of = [&](int j, int e) {
    return (fmaf(sc(j, e, 0), hm_of(j, e), t_of(j, e)) - sc(j, e, 1)) *
           sc(j, e, 2);
  };
  // 4: Σ dxh, Σ dxh · x̂ → m1, m2; x̂ leaves
  sum_round(3, [&](int j, int e, float(&x)[2]) {
    const float xh = xhat_of(j, e), dxh = dxh_of(j, e);
    x[0] += dxh;
    x[1] = fmaf(dxh, xh, x[1]);
    store(xhat, j, e, xh);
  });
  if (r < kRows) {
    rs[3] = total(3, 0) / (float)D;
    rs[4] = total(3, 1) / (float)D;
  }
  __syncthreads();
  auto df_of = [&](int j, int e) {
    return sc(j, e, 2) *
           (dxh_of(j, e) - sc(j, e, 3) - xhat_of(j, e) * sc(j, e, 4));
  };
  // 5: Σ df · H_m → dalpha → the α / norm-clamp backward
  sum_round(4, [&](int j, int e, float(&x)[2]) {
    x[0] = fmaf(df_of(j, e), hm_of(j, e), x[0]);
  });
  if (r < kRows) {
    const mag::ClampGrad g = mag::clamp_backward(
        mag::norms_of(total(0, 0), total(0, 1), beta), total(4, 0), beta);
    rs[5] = g.t_coef;
    rs[6] = g.h_coef;
  }
  __syncthreads();
  // the gate / ReLU backward
#pragma unroll
  for (int j = 0; j < kRowTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!in[e]) continue;
      const int i = acc_row(j, e) * kHmLd + cb[e];
      const float gv = gvs[i], dv = dvs[i];
      const float df = df_of(j, e);
      const float dhm = fmaf(sc(j, e, 0), df, sc(j, e, 6) * hm_of(j, e));
      store(dpv, j, e, gv > 0.0f ? dhm * dv : 0.0f);
      store(dpa, j, e, ga[j][e] > 0.0f ? dhm * da[j][e] : 0.0f);
      store(ddv, j, e, dhm * gv);
      store(dda, j, e, dhm * ga[j][e]);
      store(dt, j, e, fmaf(sc(j, e, 5), t_of(j, e), df));
    }
  cluster.sync();  // no block leaves while another reads its partial sums
}

// bf16 #26: the six [N, D] fp32 outputs dpv, dpa, ddv, dda, dt, xhat from
// dy, t, v and a.
inline int launch_bwd(const void* dy, const void* t, const void* v,
                      const void* a, const mag::Params& p,
                      float* const out[6], int N, int D, int Dv, int Da,
                      float beta, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int vec =
      gate_vec(t, v, a, p, D, Dv, Da) | (rows16(dy, D, 2) ? 16 : 0);
  return launch_clusters(
      mag_bwd_tc_kernel, &attr_set, bwd_smem_bytes(), N, D, stream,
      static_cast<const bf16*>(dy), static_cast<const bf16*>(t),
      static_cast<const bf16*>(v), static_cast<const bf16*>(a), p, out[0],
      out[1], out[2], out[3], out[4], out[5], N, D, Dv, Da, beta, vec);
}

}  // namespace mag_tc

namespace {

using mag::kRows;
using mag::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mag_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ t,
                   const T* __restrict__ v, const T* __restrict__ a,
                   mag::Params p, float* dpv, float* dpa, float* ddv,
                   float* dda, float* __restrict__ dt,
                   float* __restrict__ xhat, int N, int D, int Dv, int Da,
                   float beta) {
  extern __shared__ float smem[];
  const mag::Smem s = mag::carve(smem, D, Dv, Da);
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int tid = threadIdx.x;

  mag::load_rows(s.t, s.ldt, t, row0, rows, D);
  mag::load_rows(s.v, s.ldv, v, row0, rows, Dv);
  mag::load_rows(s.a, s.lda, a, row0, rows, Da);
  __syncthreads();

  // ---- recompute the forward: products into the output rows, H_m into
  // shared memory ----
  for (int c0 = 0; c0 < D; c0 += mag::kCols) {
    float pv[kRows], pa[kRows], dv[kRows], da[kRows];
    mag::chunk_products(s, p, D, Dv, Da, c0, pv, pa, dv, da);
    const int col = c0 + tid;
    if (col < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s.hm[r * D + col] = mag::displacement(pv[r], pa[r], dv[r], da[r]);
        if (r < rows) {
          const size_t off = (size_t)(row0 + r) * D + col;
          dpv[off] = pv[r];
          dpa[off] = pa[r];
          ddv[off] = dv[r];
          dda[off] = da[r];
        }
      }
    }
  }
  __syncthreads();  // H_m and the product rows are complete for the block

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* tr = s.t + r * s.ldt;
    const float* hr = s.hm + r * D;
    const size_t off = (size_t)(row0 + r) * D;
    const T* dyr = dy + off;
    const mag::RowNorms n = mag::row_norms(tr, hr, D, beta);
    float mu, inv;
    mag::row_moments(tr, hr, D, n.alpha, &mu, &inv);
    // x̂[k], recomputed by the same expression in every pass.
    auto xhat_of = [&](int k) {
      return (fmaf(n.alpha, hr[k], tr[k]) - mu) * inv;
    };

    // ---- LayerNorm backward: m1 = mean(dxh), m2 = mean(dxh · x̂) ----
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float xh = xhat_of(k);
      const float dxh = attn::to_float(dyr[k]) * __ldg(p.ln_g + k);
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
      xhat[off + k] = xh;
    }
    const float m1 = mag::warp_sum(s1) / (float)D;
    const float m2 = mag::warp_sum(s2) / (float)D;
    auto df_of = [&](int k) {
      const float dxh = attn::to_float(dyr[k]) * __ldg(p.ln_g + k);
      return inv * (dxh - m1 - xhat_of(k) * m2);
    };

    // ---- α / norm-clamp backward ----
    float s3 = 0.0f;
    for (int k = lane; k < D; k += 32) s3 = fmaf(df_of(k), hr[k], s3);
    const mag::ClampGrad g = mag::clamp_backward(n, mag::warp_sum(s3), beta);

    // ---- gate / displacement backward, over the product rows ----
    for (int k = lane; k < D; k += 32) {
      const float df = df_of(k);
      const float dhm = fmaf(n.alpha, df, g.h_coef * hr[k]);
      const float pv = dpv[off + k], pa = dpa[off + k];
      const float dv = ddv[off + k], da = dda[off + k];
      dpv[off + k] = pv > 0.0f ? dhm * dv : 0.0f;
      dpa[off + k] = pa > 0.0f ? dhm * da : 0.0f;
      ddv[off + k] = dhm * fmaxf(pv, 0.0f);
      dda[off + k] = dhm * fmaxf(pa, 0.0f);
      dt[off + k] = fmaf(g.t_coef, tr[k], df);
    }
  }
}

template <typename T>
int launch(const void* dy, const void* t, const void* v, const void* a,
           const mag::Params& p, float* const out[6], int N, int D, int Dv,
           int Da, float beta, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      mag::prepare(mag_bwd_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = mag::smem_floats(D, Dv, Da) * sizeof(float);
  const unsigned grid = (unsigned)((N + kRows - 1) / kRows);
  mag_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(t),
      static_cast<const T*>(v), static_cast<const T*>(a), p, out[0], out[1],
      out[2], out[3], out[4], out[5], N, D, Dv, Da, beta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core plan), 1 = bfloat16 (the tensor-core
// plan), for dy and t [N, D], v [N, Dv] and a [N, Da]; the eleven params
// (Params order, no ln_b) and the six outputs dpv, dpa, ddv, dda, dt, xhat
// ([N, D]) are fp32. Returns the cudaError_t
// of the launch (0 on success); the shape limits are checked again here.
int mag_bwd(const void* dy, const void* t, const void* v, const void* a,
            const float* w_hv_v, const float* w_hv_t, const float* b_hv,
            const float* w_ha_a, const float* w_ha_t, const float* b_ha,
            const float* w_v, const float* b_v, const float* w_a,
            const float* b_a, const float* ln_g, float* dpv, float* dpa,
            float* ddv, float* dda, float* dt, float* xhat, int N, int D,
            int Dv, int Da, float beta, int dtype, void* stream) {
  if (N < 1 || D < 1 || D > mag::kMaxD || Dv < 1 || Da < 1 ||
      mag::smem_floats(D, Dv, Da) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const mag::Params p{w_hv_v, w_hv_t, b_hv, w_ha_a, w_ha_t, b_ha,
                      w_v,    b_v,    w_a,  b_a,    ln_g,   nullptr};
  float* const out[6] = {dpv, dpa, ddv, dda, dt, xhat};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(dy, t, v, a, p, out, N, D, Dv, Da, beta, st);
    case 1:
      return mag_tc::launch_bwd(dy, t, v, a, p, out, N, D, Dv, Da, beta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
