// The CUDA-core plan of the fused MAG-gate kernels in fp32: the forward
// #25 (mag_fwd.cu) and the backward #26 (mag_bwd.cu) — the block's
// shared-memory plan, the recomputed products of one column chunk — and
// what the bf16 tensor-core plans of both (mag_tc.cuh) share with them: the
// gate's parameters, its constants, warp sums and the row functions
// `norms_of`, `row_norms`, `row_moments` and `clamp_backward`.
//
// The gate, per row of the flattened [N, D] text stream (ops/mag.py):
//   pv  = v·W_hv_v + t·W_hv_t + b_hv        gate_v = ReLU(pv)
//   pa  = a·W_ha_a + t·W_ha_t + b_ha        gate_a = ReLU(pa)
//   dv_ = v·W_v + b_v                       da_ = a·W_a + b_a
//   H_m = gate_v ⊙ dv_ + gate_a ⊙ da_
//   α   = min(‖t‖ / (‖H_m‖' + 1e-6) · β, 1),  ‖H_m‖' = ‖H_m‖, or 1 where 0
//   y   = LayerNorm(α · H_m + t), eps 1e-5
// with t [N, D], v [N, Dv], a [N, Da] in the activation dtype, read as fp32;
// the weights fp32 in the x·W ([in, out]) layout; in this plan every
// product and sum in fp32 on the CUDA cores (the TPU kernel runs its dots
// at Precision.HIGHEST, so plain TF32 or bf16 weights would change the
// result; mag_tc.cuh keeps fp32 precision on the tensor cores by splitting
// each weight into three bf16 planes).
//
// The plan. A block owns kRows whole rows, because the two row norms and
// the LayerNorm need whole rows; 256 threads. Its shared memory holds, in
// fp32: the text rows t [kRows][D'], H_m [kRows][D] and the modality rows
// v [kRows][Dv'] and a [kRows][Da'] (' = rounded up to a multiple of kK,
// the padding zero): 106 KB at D = 768, so two blocks share an SM. The
// output columns go in chunks of kCols = 256: thread tid owns column
// c0 + tid of the chunk for all kRows rows and keeps its four products
// pv, pa, dv_, da_ in registers (64 fp32). The TPU kernel kept all six
// weight matrices resident in VMEM; here each thread reads its own column
// of each weight straight from device memory (coalesced across the warp;
// the ~6 MB of weights stay in the 50 MB L2), kK rows at a time into
// registers, fetching the next kK while it multiplies the current ones: no
// thread reads another's weights, so the products need no barrier. The
// activations are read from shared memory as float4 warp-wide broadcasts:
// per four k steps a warp issues 16 of them and 8 weight loads for 128
// FMAs. Two blocks an SM, and so at most 128 registers a thread, was worth
// more than a deeper fetch or a wider tile on the card (PERF.md, the
// findings on the MAG kernels). The modality products run the same loop
// over the true Dv and Da: the padding is zero in both operands.

#pragma once

#include "common.cuh"

namespace mag {

constexpr int kThreads = 256;
constexpr int kRows = 16;         // rows per block
constexpr int kCols = kThreads;   // output columns per chunk, one a thread
constexpr int kK = 8;             // weight rows fetched ahead into registers
constexpr int kMaxD = 1024;
constexpr float kEps = 1e-6f;    // ops/mag.py EPS
constexpr float kLnEps = 1e-5f;  // the gate's LayerNorm eps

// A row width rounded up to whole weight slices.
__host__ __device__ inline int padded(int width) {
  return (width + kK - 1) / kK * kK;
}

// Shared memory of a block, in floats.
__host__ __device__ inline size_t smem_floats(int D, int Dv, int Da) {
  return (size_t)kRows * (padded(D) + D + padded(Dv) + padded(Da));
}

// The gate's parameters, fp32, x·W layout.
struct Params {
  const float* w_hv_v;  // [Dv, D]
  const float* w_hv_t;  // [D, D]
  const float* b_hv;    // [D]
  const float* w_ha_a;  // [Da, D]
  const float* w_ha_t;  // [D, D]
  const float* b_ha;    // [D]
  const float* w_v;     // [Dv, D]
  const float* b_v;     // [D]
  const float* w_a;     // [Da, D]
  const float* b_a;     // [D]
  const float* ln_g;    // [D]
  const float* ln_b;    // [D] (the forward only)
};

struct Smem {
  float* t;   // [kRows][ldt]
  float* hm;  // [kRows][D]
  float* v;   // [kRows][ldv]
  float* a;   // [kRows][lda]
  int ldt, ldv, lda;
};

// Every array starts at a multiple of kRows = 16 floats and every row at a
// multiple of kK = 8 floats, so the float4 reads are aligned.
__device__ inline Smem carve(float* smem, int D, int Dv, int Da) {
  Smem s;
  s.ldt = padded(D);
  s.ldv = padded(Dv);
  s.lda = padded(Da);
  s.t = smem;
  s.hm = s.t + kRows * s.ldt;
  s.v = s.hm + kRows * D;
  s.a = s.v + kRows * s.ldv;
  return s;
}

// dst[r][c] = src[(row0 + r) · width + c] as fp32 for r < rows and
// c < width; 0 elsewhere in dst's [kRows][ld].
template <typename T>
__device__ inline void load_rows(float* dst, int ld, const T* src, int row0,
                                 int rows, int width) {
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const int r = i / ld, c = i - r * ld;
    dst[i] = r < rows && c < width
                 ? attn::to_float(src[(size_t)(row0 + r) * width + c])
                 : 0.0f;
  }
}

// attn::allow_max_smem, and the shared-memory carveout at its largest so
// that two blocks of ~107 KB (D = 768) fit on one SM.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, unsigned long long* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool first = !(*done & (1ull << (device & 63)));
  err = attn::allow_max_smem(kernel, done);
  if (err != cudaSuccess || !first) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// w[kk] = W[k0 + kk][col] for the kK rows from k0; 0 past K or D.
__device__ __forceinline__ void fetch(float (&w)[kK],
                                      const float* __restrict__ W, int K,
                                      int D, int k0, int col) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const int k = k0 + kk;
    w[kk] = k < K && col < D ? __ldg(W + (size_t)k * D + col) : 0.0f;
  }
}

// acc1[r] += Σ_{k<K} x[r][k] · W1[k][c0 + tid] and acc2 likewise with W2,
// for the kRows rows: x in shared memory [kRows][ldx] (zero from K to
// ldx), W1 and W2 [K, D] in device memory.
__device__ inline void products(const float* x, int ldx, int K,
                                const float* __restrict__ W1,
                                const float* __restrict__ W2, int D, int c0,
                                float acc1[kRows], float acc2[kRows]) {
  const int col = c0 + threadIdx.x;
  float w1[kK], w2[kK], next1[kK], next2[kK];
  fetch(w1, W1, K, D, 0, col);
  fetch(w2, W2, K, D, 0, col);
  for (int k0 = 0; k0 < K; k0 += kK) {
    if (k0 + kK < K) {
      fetch(next1, W1, K, D, k0 + kK, col);
      fetch(next2, W2, K, D, k0 + kK, col);
    }
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + r * ldx + k0 + kk);
        acc1[r] = fmaf(xv.x, w1[kk], acc1[r]);
        acc1[r] = fmaf(xv.y, w1[kk + 1], acc1[r]);
        acc1[r] = fmaf(xv.z, w1[kk + 2], acc1[r]);
        acc1[r] = fmaf(xv.w, w1[kk + 3], acc1[r]);
        acc2[r] = fmaf(xv.x, w2[kk], acc2[r]);
        acc2[r] = fmaf(xv.y, w2[kk + 1], acc2[r]);
        acc2[r] = fmaf(xv.z, w2[kk + 2], acc2[r]);
        acc2[r] = fmaf(xv.w, w2[kk + 3], acc2[r]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      w1[kk] = next1[kk];
      w2[kk] = next2[kk];
    }
  }
}

// The four products of this thread's column c0 + tid for the block's rows,
// biases added: pv, pa (the gates' pre-activations) and dv, da (the
// displacement projections), from s.t, s.v and s.a (loaded, and a barrier
// passed, before the call). Columns past D hold zeros.
__device__ inline void chunk_products(const Smem& s, const Params& p, int D,
                                      int Dv, int Da, int c0,
                                      float pv[kRows], float pa[kRows],
                                      float dv[kRows], float da[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) pv[r] = pa[r] = dv[r] = da[r] = 0.0f;
  products(s.t, s.ldt, D, p.w_hv_t, p.w_ha_t, D, c0, pv, pa);
  products(s.v, s.ldv, Dv, p.w_hv_v, p.w_v, D, c0, pv, dv);
  products(s.a, s.lda, Da, p.w_ha_a, p.w_a, D, c0, pa, da);
  const int col = c0 + threadIdx.x;
  if (col < D) {
    const float bhv = __ldg(p.b_hv + col), bha = __ldg(p.b_ha + col);
    const float bv = __ldg(p.b_v + col), ba = __ldg(p.b_a + col);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pv[r] += bhv;
      pa[r] += bha;
      dv[r] += bv;
      da[r] += ba;
    }
  }
}

// H_m of one element from its four products.
__device__ __forceinline__ float displacement(float pv, float pa, float dv,
                                              float da) {
  return __fadd_rn(__fmul_rn(fmaxf(pv, 0.0f), dv),
                   __fmul_rn(fmaxf(pa, 0.0f), da));
}

// The row scale α and the norms it comes from.
struct RowNorms {
  float em;      // ‖t‖
  float hn;      // ‖H_m‖
  float hn1;     // ‖H_m‖, or 1 where it is 0
  float thresh;  // ‖t‖ / (hn1 + 1e-6) · β
  float alpha;   // min(thresh, 1)
};

// The norms of a row from its totals ‖t‖² (tt) and ‖H_m‖² (hh).
__device__ __forceinline__ RowNorms norms_of(float tt, float hh, float beta) {
  RowNorms n;
  n.em = sqrtf(tt);
  n.hn = sqrtf(hh);
  n.hn1 = n.hn == 0.0f ? 1.0f : n.hn;
  n.thresh = __fmul_rn(n.em / (n.hn1 + kEps), beta);
  n.alpha = fminf(n.thresh, 1.0f);
  return n;
}

// One warp: the norms of row tr (text) and hr (H_m), each of length D.
__device__ inline RowNorms row_norms(const float* tr, const float* hr, int D,
                                     float beta) {
  const int lane = threadIdx.x % 32;
  float tt = 0.0f, hh = 0.0f;
  for (int k = lane; k < D; k += 32) {
    tt = fmaf(tr[k], tr[k], tt);
    hh = fmaf(hr[k], hr[k], hh);
  }
  return norms_of(warp_sum(tt), warp_sum(hh), beta);
}

// The α / norm-clamp backward of a row from dalpha = Σ df · H_m, with the
// TPU kernel's edges (mag_pallas.py:241-254): min's VJP is 1 below the
// tie, 0.5 at thresh == 1 and 0 above; ‖H_m‖ = 0 passes no gradient to the
// norm (`live`), ‖t‖ = 0 none to t. The row's gradients are then dt = df +
// t_coef · t and dH_m = α · df + h_coef · H_m.
struct ClampGrad {
  float t_coef, h_coef;
};

__device__ __forceinline__ ClampGrad clamp_backward(const RowNorms& n,
                                                    float dalpha,
                                                    float beta) {
  const float dmin = n.thresh < 1.0f ? 1.0f
                     : n.thresh == 1.0f ? 0.5f
                                        : 0.0f;
  const float dthresh = dalpha * dmin;
  const float den = n.hn1 + kEps;
  const float dem = dthresh * beta / den;
  const float dhn1 = -dthresh * beta * n.em / (den * den);
  const float live = n.hn != 0.0f ? 1.0f : 0.0f;
  const float dhn = dhn1 * live;
  const float em_safe = n.em == 0.0f ? 1.0f : n.em;
  ClampGrad g;
  g.t_coef = (dem / em_safe) * (n.em == 0.0f ? 0.0f : 1.0f);
  g.h_coef = (dhn / n.hn1) * live;
  return g;
}

// One warp: the mean and 1/sqrt(var + eps) of f[k] = α·hr[k] + tr[k].
__device__ inline void row_moments(const float* tr, const float* hr, int D,
                                   float alpha, float* mu, float* inv) {
  const int lane = threadIdx.x % 32;
  float sum = 0.0f;
  for (int k = lane; k < D; k += 32) sum += fmaf(alpha, hr[k], tr[k]);
  const float m = warp_sum(sum) / (float)D;
  float sq = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float c = fmaf(alpha, hr[k], tr[k]) - m;
    sq = fmaf(c, c, sq);
  }
  *mu = m;
  *inv = rsqrtf(warp_sum(sq) / (float)D + kLnEps);
}

}  // namespace mag
