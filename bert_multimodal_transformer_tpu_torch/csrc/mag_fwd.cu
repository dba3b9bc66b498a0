// Fused MAG gate forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mag_kernel`
// (bert_multimodal_transformer_tpu/ops/mag_pallas.py:50): the whole gate of
// mag_common.cuh for each row, y = LayerNorm(α · H_m + t) in the text
// dtype, with the six products, the two row norms, the α clamp and the
// LayerNorm in one launch.
//
// What bounds it on the card: the six products are 2·D·(2D + 2Dv + 2Da)
// operations a row (2.73 MFLOP at D = 768, Dv = 47, Da = 74), 35.0 GFLOP
// at N = 12800. The TPU kernel runs its dots at Precision.HIGHEST, so
// they keep fp32 precision: at the H100's 67 TFLOP/s of fp32 outside the
// tensor cores 0.52 ms; as bf16 activations against three bf16 planes of
// each weight on the tensor cores (3 × 35.0 GFLOP at 989 TFLOP/s) 0.106
// ms. The bytes (t, v, a, the output and ~6 MB of weights, about 49 MB at
// bf16 N = 12800) take 0.015 ms at 3.35 TB/s.
//
// What the design does about that. bf16 (`mag_fwd_tc_kernel`,
// mag_tc.cuh): every product on mma.sync.m16n8k16 with each fp32 weight
// split into three bf16 planes as it arrives, 64 rows × 128 columns a
// block, the blocks of a row block in a thread block cluster that trades
// the row sums through distributed shared memory. fp32 (`mag_fwd_kernel`):
// the CUDA-core plan of mag_common.cuh, each thread one output column of a
// 256-column chunk for the block's 16 rows, its four products in
// registers, with its weight column fetched ahead into registers; per four
// k steps a warp issues 16 float4 broadcasts of the activations and 8
// weight loads for 128 FMAs, and no barrier. H_m for the block's rows is
// written to shared memory chunk by chunk, so the norms, α and the
// LayerNorm run out of shared memory, and only y goes back to device
// memory. One block per 16 rows, two blocks an SM at D = 768.

#include "mag_common.cuh"
#include "mag_tc.cuh"

namespace {

using mag::kRows;
using mag::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mag_fwd_kernel(const T* __restrict__ t, const T* __restrict__ v,
                   const T* __restrict__ a, mag::Params p, T* __restrict__ out,
                   int N, int D, int Dv, int Da, float beta) {
  extern __shared__ float smem[];
  const mag::Smem s = mag::carve(smem, D, Dv, Da);
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int tid = threadIdx.x;

  mag::load_rows(s.t, s.ldt, t, row0, rows, D);
  mag::load_rows(s.v, s.ldv, v, row0, rows, Dv);
  mag::load_rows(s.a, s.lda, a, row0, rows, Da);
  __syncthreads();

  for (int c0 = 0; c0 < D; c0 += mag::kCols) {
    float pv[kRows], pa[kRows], dv[kRows], da[kRows];
    mag::chunk_products(s, p, D, Dv, Da, c0, pv, pa, dv, da);
    const int col = c0 + tid;
    if (col < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s.hm[r * D + col] = mag::displacement(pv[r], pa[r], dv[r], da[r]);
    }
  }
  __syncthreads();

  // One warp per row: α, the LayerNorm, the output.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* tr = s.t + r * s.ldt;
    const float* hr = s.hm + r * D;
    const mag::RowNorms n = mag::row_norms(tr, hr, D, beta);
    float mu, inv;
    mag::row_moments(tr, hr, D, n.alpha, &mu, &inv);
    T* yr = out + (size_t)(row0 + r) * D;
    for (int k = lane; k < D; k += 32) {
      const float c = fmaf(n.alpha, hr[k], tr[k]) - mu;
      yr[k] = attn::from_float<T>(
          fmaf(c * inv, __ldg(p.ln_g + k), __ldg(p.ln_b + k)));
    }
  }
}

template <typename T>
int launch(const void* t, const void* v, const void* a, const mag::Params& p,
           void* out, int N, int D, int Dv, int Da, float beta,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      mag::prepare(mag_fwd_kernel<T>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = mag::smem_floats(D, Dv, Da) * sizeof(float);
  const unsigned grid = (unsigned)((N + kRows - 1) / kRows);
  mag_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(v),
      static_cast<const T*>(a), p, static_cast<T*>(out), N, D, Dv, Da, beta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core plan), 1 = bfloat16 (the tensor-core
// plan), for t [N, D], v [N, Dv], a [N, Da] and out [N, D]; the twelve
// params are fp32 (mag_common.cuh's Params order).
// Returns the cudaError_t of the launch (0 on success). The Python wrapper
// checks the shapes; they are checked again here so that no call can index
// past the shared-memory plan.
int mag_fwd(const void* t, const void* v, const void* a, const float* w_hv_v,
            const float* w_hv_t, const float* b_hv, const float* w_ha_a,
            const float* w_ha_t, const float* b_ha, const float* w_v,
            const float* b_v, const float* w_a, const float* b_a,
            const float* ln_g, const float* ln_b, void* out, int N, int D,
            int Dv, int Da, float beta, int dtype, void* stream) {
  if (N < 1 || D < 1 || D > mag::kMaxD || Dv < 1 || Da < 1 ||
      mag::smem_floats(D, Dv, Da) * sizeof(float) > attn::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const mag::Params p{w_hv_v, w_hv_t, b_hv, w_ha_a, w_ha_t, b_ha,
                      w_v,    b_v,    w_a,  b_a,    ln_g,   ln_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(t, v, a, p, out, N, D, Dv, Da, beta, st);
    case 1:
      return mag_tc::launch(t, v, a, p, out, N, D, Dv, Da, beta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
