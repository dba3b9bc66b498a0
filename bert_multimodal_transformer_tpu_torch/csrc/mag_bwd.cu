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
// and passes no gradient to the norm (`live`); ‖t‖ = 0 passes none to t.
//
// What bounds it on the card: the recompute is the forward's 35.0 GFLOP
// at N = 12800 (0.52 ms of fp32 FMAs at 67 TFLOP/s); the six fp32 outputs
// are 236 MB at N = 12800, 0.07 ms at 3.35 TB/s. So, like the forward,
// fp32 FMAs bound it.
//
// What the design does about that: the products run as in mag_fwd.cu.
// The chain needs the four products again after the row reductions, and
// four [16][D] fp32 tiles do not fit in shared memory beside t and H_m:
// each thread writes its pieces of pv, pa, dv_ and da_ straight into the
// dpv, dpa, ddv and dda output rows (their final size and place), and the
// last pass reads them back and overwrites them with the gradients. Those
// rows were written by the same block just before (a __syncthreads orders
// them), so the re-read is served from L2. One warp per row runs the
// reductions (‖t‖, ‖H_m‖, mean, variance, mean(dxh), mean(dxh·x̂),
// Σ df·H_m) out of shared memory, recomputing x̂ and df where a pass needs
// them rather than keeping another [16][D] tile.

#include "mag_common.cuh"

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
    const float dalpha = mag::warp_sum(s3);
    const float dmin = n.thresh < 1.0f ? 1.0f
                       : n.thresh == 1.0f ? 0.5f
                                          : 0.0f;
    const float dthresh = dalpha * dmin;
    const float den = n.hn1 + mag::kEps;
    const float dem = dthresh * beta / den;
    const float dhn1 = -dthresh * beta * n.em / (den * den);
    const float live = n.hn != 0.0f ? 1.0f : 0.0f;
    const float dhn = dhn1 * live;
    const float em_safe = n.em == 0.0f ? 1.0f : n.em;
    const float t_coef = (dem / em_safe) * (n.em == 0.0f ? 0.0f : 1.0f);
    const float h_coef = (dhn / n.hn1) * live;

    // ---- gate / displacement backward, over the product rows ----
    for (int k = lane; k < D; k += 32) {
      const float df = df_of(k);
      const float dhm = fmaf(n.alpha, df, h_coef * hr[k]);
      const float pv = dpv[off + k], pa = dpa[off + k];
      const float dv = ddv[off + k], da = dda[off + k];
      dpv[off + k] = pv > 0.0f ? dhm * dv : 0.0f;
      dpa[off + k] = pa > 0.0f ? dhm * da : 0.0f;
      ddv[off + k] = dhm * fmaxf(pv, 0.0f);
      dda[off + k] = dhm * fmaxf(pa, 0.0f);
      dt[off + k] = fmaf(t_coef, tr[k], df);
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

// dtype: 0 = float32, 1 = bfloat16, for dy and t [N, D], v [N, Dv] and
// a [N, Da]; the eleven params (Params order, no ln_b) and the six outputs
// dpv, dpa, ddv, dda, dt, xhat ([N, D]) are fp32. Returns the cudaError_t
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
      return launch<__nv_bfloat16>(dy, t, v, a, p, out, N, D, Dv, Da, beta,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
