// Helpers shared by the port's kernels: dtype conversion and the opt-in to
// the largest dynamic shared memory (every kernel); the Philox4x32-10
// dropout stream, the whole-row forward's blocks (#1 and #4 packed, #11
// and #14 rel), the recompute backward's softmax rows (#2, #5, #12, #15)
// and the small shared-memory products of the backward kernels (the
// attention kernels: attn_{fwd,bwd}_packed*.cu, attn_{fwd,bwd}_rel*.cu and
// attn_{fwd,bwd}_relik_fs.cu).
//
// The dropout stream. Element (b, h, q, k) of the [B, H, Q, K] probs is
// kept iff its 32-bit draw is >= threshold, where
//   threshold = min(round(rate · 2^32), 2^32 − 1)
// (the TPU package's `_dropout_threshold`) and
//   draw(b, h, q, k) = Philox4x32-10(counter = (k >> 2, q, h, b),
//                                    key     = (seed & 0xffffffff,
//                                               seed >> 32))[k & 3]
// with words numbered x, y, z, w = 0, 1, 2, 3. The draw is a pure function
// of (seed, b, h, q, k), so the mask does not depend on how a kernel tiles
// the work, and the backward replays the forward's mask exactly. A kept
// element is scaled by inv_keep = fp32(1 / (1 − rate)) in fp32.
// `ops/fused_attention.py::philox4x32_10` is the same function in plain
// PyTorch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace attn {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rounds an fp32 value to T and back (a cast to the input dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Largest dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

struct DropoutArgs {
  unsigned long long seed;
  unsigned int threshold;  // keep iff draw >= threshold
  float inv_keep;          // fp32(1 / (1 − rate))
};

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the Random123 reference constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The draws of keys 4·k4 .. 4·k4 + 3 of row (b, h, q).
__device__ __forceinline__ uint4 dropout_bits4(unsigned long long seed, int b,
                                               int h, int q, int k4) {
  return philox4x32_10(
      make_uint4((uint32_t)k4, (uint32_t)q, (uint32_t)h, (uint32_t)b),
      make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// ---- the whole-row packed forward (kernels #1 and #4) ---------------------
//
// One block of kFwdThreads threads computes kQTile query rows q0 =
// blockIdx.x · kQTile of head h = blockIdx.y, batch row b = blockIdx.z:
// scores over the whole key row in a [kQTile][S] fp32 shared tile (K
// streamed in kFwdKChunk-row chunks by stride from the packed projection),
// a max-subtracted fp32 softmax one warp per row, the Philox keep mask, the
// probs rounded to T, and PV accumulated in fp32 registers (V streamed the
// same way). #1 runs it with 16-row tiles up to S = 512 and the save modes;
// #4 with 32-row tiles up to S = 640. The arithmetic of a row does not
// depend on kQTile, so the two give the same bits where both reach.

constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kFwdKChunk = 64;    // key/value rows staged in shared memory
constexpr int kFwdMaxDh = 128;

// Shared memory in floats: Q tile [kQTile][dh], K/V chunk
// [kFwdKChunk][dh + 1] (the +1 pad keeps the per-key rows on distinct
// banks), scores [kQTile][s], bias [s].
template <int kQTile>
__host__ __device__ inline size_t fwd_smem_floats(int s, int dh) {
  return (size_t)kQTile * dh + (size_t)kFwdKChunk * (dh + 1) +
         (size_t)kQTile * s + (size_t)s;
}

template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_packed_rows(
    float* smem, const T* __restrict__ qkv, const float* __restrict__ mask,
    T* __restrict__ out, T* __restrict__ p_out, T* __restrict__ pd_out,
    int S, int H, int Dh, float scale, DropoutArgs drop) {
  // Each thread owns ceil(kQTile * kFwdMaxDh / kFwdThreads) accumulators.
  constexpr int kAccPerThread =
      (kQTile * kFwdMaxDh + kFwdThreads - 1) / kFwdThreads;
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;

  float* qs = smem;                            // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;               // [kFwdKChunk][Dh + 1]
  float* ps = kvs + kFwdKChunk * ldkv;         // [kQTile][S]
  float* bias = ps + kQTile * S;               // [S]

  const size_t row_stride = (size_t)3 * D;
  const T* base = qkv + (size_t)b * S * row_stride;
  const int q_rows = min(kQTile, S - q0);

  // Mask bias, as the TPU entry forms it: (1 − m) · −10000.
  for (int j = tid; j < S; j += kFwdThreads) {
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + j]) * -10000.0f : 0.0f;
  }
  // Q tile; rows past S are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kFwdThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(base[(size_t)(q0 + r) * row_stride +
                                       h * Dh + c])
                       : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + bias[j], over K in chunks.
  for (int k0 = 0; k0 < S; k0 += kFwdKChunk) {
    const int k_rows = min(kFwdKChunk, S - k0);
    __syncthreads();  // previous chunk's readers are done (and qs/bias set)
    for (int i = tid; i < k_rows * Dh; i += kFwdThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] =
          to_float(base[(size_t)(k0 + r) * row_stride + D + h * Dh + c]);
    }
    __syncthreads();
    for (int i = tid; i < kQTile * k_rows; i += kFwdThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float acc = 0.0f;
      for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      // Scale after the dot, then add the bias, in this order.
      ps[r * S + k0 + j] = __fadd_rn(__fmul_rn(acc, scale), bias[k0 + j]);
    }
  }
  __syncthreads();

  // fp32 max-subtracted softmax, one warp per row; probs rounded to T.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < q_rows; r += kFwdThreads / 32) {
    float* pr = ps + r * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout && !kSave) {
      for (int j = lane; j < S; j += 32) pr[j] = round_to<T>(pr[j] / sum);
    } else {
      // Training modes: each lane takes 4 consecutive keys, one Philox
      // block for the 4 draws.
      const int q = q0 + r;
      const size_t prow = (((size_t)b * H + h) * S + q) * S;
      for (int j0 = 4 * lane; j0 < S; j0 += 128) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kDropout)
          bits = dropout_bits4(drop.seed, b, h, q, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < S) {
            float p = pr[j] / sum;
            if constexpr (kSave) p_out[prow + j] = from_float<T>(p);
            if constexpr (kDropout) {
              p = word(bits, u) >= drop.threshold
                      ? __fmul_rn(p, drop.inv_keep)
                      : 0.0f;
              if constexpr (kSave) pd_out[prow + j] = from_float<T>(p);
            }
            pr[j] = round_to<T>(p);
          }
        }
      }
    }
  }

  // out[r][c] = Σ_j p[r][j] · v_j[c], fp32 accumulators in registers.
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += kFwdKChunk) {
    const int k_rows = min(kFwdKChunk, S - k0);
    __syncthreads();  // softmax / previous chunk done
    for (int i = tid; i < k_rows * Dh; i += kFwdThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(
          base[(size_t)(k0 + r) * row_stride + 2 * D + h * Dh + c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kFwdThreads;
      if (i < kQTile * Dh) {
        const int r = i / Dh, c = i - r * Dh;
        if (r < q_rows) {
          const float* pr = ps + r * S + k0;
          float s_acc = acc[a];
          for (int j = 0; j < k_rows; ++j)
            s_acc = fmaf(pr[j], kvs[j * ldkv + c], s_acc);
          acc[a] = s_acc;
        }
      }
    }
  }
  T* out_base = out + (size_t)b * S * D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kFwdThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        out_base[(size_t)(q0 + r) * D + h * Dh + c] = from_float<T>(acc[a]);
    }
  }
}

// ---- the whole-row rel forward (kernels #11 and #14) ----------------------
//
// #11's block, with q and k/v read from their own tensors (row stride D) so
// that Q ≠ K works and with a full score bias ebias [B, H, Q, K] in place of
// the [S] mask bias: one block of kFwdThreads threads computes kQTile query
// rows q0 = blockIdx.x · kQTile of head h = blockIdx.y, batch row b =
// blockIdx.z; scores (q · k) · scale + ebias over the whole key row in a
// [kQTile][K] fp32 shared tile, the softmax one warp per row, the Philox
// keep mask, the probs rounded to T, PV in fp32 registers. #11 runs it with
// 16-row tiles up to K = 512 and the save modes; #14 with 32-row tiles up
// to K = 640. A row's arithmetic does not depend on kQTile, so the two give
// the same bits where both reach.

// Shared memory in floats: q tile [kQTile][dh], k/v chunk
// [kFwdKChunk][dh + 1], scores [kQTile][k_len].
template <int kQTile>
__host__ __device__ inline size_t rel_fwd_smem_floats(int k_len, int dh) {
  return (size_t)kQTile * dh + (size_t)kFwdKChunk * (dh + 1) +
         (size_t)kQTile * k_len;
}

template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_rel_rows(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ ebias, T* __restrict__ out,
    T* __restrict__ p_out, T* __restrict__ pd_out, int Q, int K, int H,
    int Dh, float scale, DropoutArgs drop) {
  constexpr int kAccPerThread =
      (kQTile * kFwdMaxDh + kFwdThreads - 1) / kFwdThreads;
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;

  float* qs = smem;                            // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;               // [kFwdKChunk][Dh + 1]
  float* ps = kvs + kFwdKChunk * ldkv;         // [kQTile][K]

  const T* q_base = q + (size_t)b * Q * D + h * Dh;
  const T* k_base = k + (size_t)b * K * D + h * Dh;
  const T* v_base = v + (size_t)b * K * D + h * Dh;
  // row q of ebias[b, h] and of the saved probs starts at head_row + q·K
  const size_t head_row = ((size_t)b * H + h) * Q;
  const int q_rows = min(kQTile, Q - q0);

  // q tile; rows past Q are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kFwdThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(q_base[(size_t)(q0 + r) * D + c]) : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + ebias[q0 + r][j], over K in
  // chunks.
  for (int k0 = 0; k0 < K; k0 += kFwdKChunk) {
    const int k_rows = min(kFwdKChunk, K - k0);
    __syncthreads();  // previous chunk's readers are done (and qs set)
    for (int i = tid; i < k_rows * Dh; i += kFwdThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(k_base[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
    for (int i = tid; i < q_rows * k_rows; i += kFwdThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float acc = 0.0f;
      for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      const float eb = to_float(ebias[(head_row + q0 + r) * K + k0 + j]);
      // Scale after the dot, then add the bias, in this order.
      ps[r * K + k0 + j] = __fadd_rn(__fmul_rn(acc, scale), eb);
    }
  }
  __syncthreads();

  // fp32 max-subtracted softmax, one warp per row; probs rounded to T.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < q_rows; r += kFwdThreads / 32) {
    float* pr = ps + r * K;
    float m = -INFINITY;
    for (int j = lane; j < K; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < K; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout && !kSave) {
      for (int j = lane; j < K; j += 32) pr[j] = round_to<T>(pr[j] / sum);
    } else {
      // Training modes: each lane takes 4 consecutive keys, one Philox
      // block for the 4 draws.
      const int qi = q0 + r;
      const size_t prow = (head_row + qi) * K;
      for (int j0 = 4 * lane; j0 < K; j0 += 128) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kDropout)
          bits = dropout_bits4(drop.seed, b, h, qi, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < K) {
            float p = pr[j] / sum;
            if constexpr (kSave) p_out[prow + j] = from_float<T>(p);
            if constexpr (kDropout) {
              p = word(bits, u) >= drop.threshold
                      ? __fmul_rn(p, drop.inv_keep)
                      : 0.0f;
              if constexpr (kSave) pd_out[prow + j] = from_float<T>(p);
            }
            pr[j] = round_to<T>(p);
          }
        }
      }
    }
  }

  // out[r][c] = Σ_j p[r][j] · v_j[c], fp32 accumulators in registers.
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kFwdKChunk) {
    const int k_rows = min(kFwdKChunk, K - k0);
    __syncthreads();  // softmax / previous chunk done
    for (int i = tid; i < k_rows * Dh; i += kFwdThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(v_base[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kFwdThreads;
      if (i < kQTile * Dh) {
        const int r = i / Dh, c = i - r * Dh;
        if (r < q_rows) {
          const float* pr = ps + r * K + k0;
          float s_acc = acc[a];
          for (int j = 0; j < k_rows; ++j)
            s_acc = fmaf(pr[j], kvs[j * ldkv + c], s_acc);
          acc[a] = s_acc;
        }
      }
    }
  }
  T* out_base = out + (size_t)b * Q * D + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kFwdThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        out_base[(size_t)(q0 + r) * D + c] = from_float<T>(acc[a]);
    }
  }
}

// ---- the recompute backward's softmax rows (kernels #2, #5, #12, #15) ---
//
// In place on `rows` rows of scores (row r at ps + r · S, query q0 + r): the
// forward's fp32 softmax, one warp per row with the forward's loop and
// reduction order; at rate > 0 the keep mask replayed into the sign bit
// (p >= 0, so a dropped element is stored as −p and costs no memory).
template <bool kDropout>
__device__ __forceinline__ void softmax_rows_keep_sign(float* ps, int rows,
                                                       int S, int q0, int b,
                                                       int h,
                                                       DropoutArgs drop) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float* pr = ps + (size_t)r * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout) {
      for (int j = lane; j < S; j += 32) pr[j] = pr[j] / sum;
    } else {
      const int q = q0 + r;
      for (int j0 = 4 * lane; j0 < S; j0 += 128) {
        const uint4 bits = dropout_bits4(drop.seed, b, h, q, j0 >> 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j < S) {
            const float p = pr[j] / sum;
            pr[j] = word(bits, u) >= drop.threshold ? p
                                                    : copysignf(p, -1.0f);
          }
        }
      }
    }
  }
}

// pd (fp32) and p of an element stored by softmax_rows_keep_sign.
template <bool kDropout>
__device__ __forceinline__ float pd_of_signed(float x, float inv_keep) {
  if constexpr (kDropout) return signbit(x) ? 0.0f : __fmul_rn(x, inv_keep);
  return x;
}
template <bool kDropout>
__device__ __forceinline__ float p_of_signed(float x) {
  return kDropout ? fabsf(x) : x;
}

// ---- the backward kernels' shared-memory plan and products --------------
//
// One block per (head, batch row) holds, in fp32: two staging tiles (A, B;
// rows of Dh + 1 floats, the +1 pad keeps per-row reads on distinct banks),
// the probs tile P and the gradient tile Tt. The packed kernels' problem is
// [S, S] (A and B hold S rows each) plus the [S] mask bias; the rel kernels'
// is [Q, K] (A holds Q rows, B holds K rows) with the bias read from ebias.
// The products below take the rectangular [Q, K] form; the packed kernels
// call them with Q = K = S.

__host__ __device__ inline size_t bwd_smem_floats(int s, int dh) {
  return 2 * (size_t)s * (dh + 1) + 2 * (size_t)s * s + (size_t)s;
}

__host__ __device__ inline size_t rel_bwd_smem_floats(int q, int k, int dh) {
  return (size_t)(q + k) * (dh + 1) + 2 * (size_t)q * k;
}

// dst[r][c] = src[r · row_stride + c] for r < rows, c < Dh (one head's
// column block of a projection or of the context gradient).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t row_stride, int rows,
                                          int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < rows * Dh; i += blockDim.x) {
    const int r = i / Dh, c = i - r * Dh;
    dst[r * ld + c] = to_float(src[(size_t)r * row_stride + c]);
  }
}

// out[q][k] = Σ_c a[q][c] · b[k][c] for q < Q, k < K, fp32, c ascending.
__device__ __forceinline__ void tile_abt(float* out, const float* a,
                                         const float* b, int Q, int K,
                                         int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < Q * K; i += blockDim.x) {
    const int q = i / K, k = i - q * K;
    const float* ar = a + q * ld;
    const float* br = b + k * ld;
    float acc = 0.0f;
    for (int c = 0; c < Dh; ++c) acc = fmaf(ar[c], br[c], acc);
    out[i] = acc;
  }
}

// dst[r · row_stride + c] = Σ_j m[r][j] · x[j][c]   (m [Q][K], x [K][Dh+1];
// Q output rows)
template <typename T>
__device__ __forceinline__ void store_mx(T* dst, size_t row_stride,
                                         const float* m, const float* x,
                                         int Q, int K, int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    const int r = i / Dh, c = i - r * Dh;
    const float* mr = m + r * K;
    float acc = 0.0f;
    for (int j = 0; j < K; ++j) acc = fmaf(mr[j], x[j * ld + c], acc);
    dst[(size_t)r * row_stride + c] = from_float<T>(acc);
  }
}

// dst[r · row_stride + c] = Σ_j m[j][r] · x[j][c]   (mᵀ · x: m [Q][K],
// x [Q][Dh+1]; K output rows)
template <typename T>
__device__ __forceinline__ void store_mtx(T* dst, size_t row_stride,
                                          const float* m, const float* x,
                                          int Q, int K, int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < K * Dh; i += blockDim.x) {
    const int r = i / Dh, c = i - r * Dh;
    float acc = 0.0f;
    for (int j = 0; j < Q; ++j) acc = fmaf(m[j * K + r], x[j * ld + c], acc);
    dst[(size_t)r * row_stride + c] = from_float<T>(acc);
  }
}

// The softmax VJP through the dropout, in place on tt = d(pd) = g · vᵀ
// ([Q][K]), one warp per row (the TPU kernels' compacted form):
//   t  = pd ⊙ d(pd);   ds = t − p · Σ_k t;   tt ← T(ds · scale)
// pd_of(i) and p_of(i) give element i = q·K + k of pd and p in fp32;
// ds_out(i, ds) receives the unscaled ds (the rel kernels' debias).
template <typename T, typename PdOf, typename POf, typename DsOut>
__device__ __forceinline__ void softmax_vjp_rows(float* tt, int Q, int K,
                                                 float scale, PdOf pd_of,
                                                 POf p_of, DsOut ds_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < Q; q += blockDim.x / 32) {
    float* tr = tt + q * K;
    float sum = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float t = __fmul_rn(pd_of(q * K + k), tr[k]);
      tr[k] = t;
      sum += t;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int k = lane; k < K; k += 32) {
      const float ds = __fsub_rn(tr[k], __fmul_rn(p_of(q * K + k), sum));
      ds_out(q * K + k, ds);
      tr[k] = round_to<T>(__fmul_rn(ds, scale));
    }
  }
}

// For the packed kernels, which emit no ds.
struct NoDsOut {
  __device__ __forceinline__ void operator()(int, float) const {}
};

// ---- the ingredients rel kernels (#23, #24) ------------------------------
//
// The score of query q against key k is assembled from its ingredients:
//   s = ((rw_q · k_k) · scale + rr_q · r[Q − q + k]) + ed_q · segd[q][k]
//       + maskb[q][k]
// (the reference's order of additions; rr carries the scale already). For
// a tile of query rows q0 .. q0 + qt − 1 against keys k0 .. k0 + kt − 1 the
// rows of r that it reads form one window, [Q − q0 − qt + 1 + k0,
// Q − q0 + k0 + kt): row qi of the tile reads window row (qt − 1 − qi) + j
// for key k0 + j. The relative shift is this index arithmetic.

// dst[w][c] = r_head[(w0 + w) · D + c] for w < rows (rows of Dh + 1),
// zero where w0 + w falls outside [0, P) (only ragged tiles reach there).
template <typename T>
__device__ __forceinline__ void load_r_window(float* dst, const T* r_head,
                                              int D, int P, int w0, int rows,
                                              int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < rows * Dh; i += blockDim.x) {
    const int w = i / Dh, c = i - w * Dh;
    const int p = w0 + w;
    dst[w * ld + c] =
        p >= 0 && p < P ? to_float(r_head[(size_t)p * D + c]) : 0.0f;
  }
}

// s above for one element: rw_r, rr_r the query's rows, k_j its key's row,
// r_j its position key's row (Dh floats each), fp32 dots.
__device__ __forceinline__ float relik_score(const float* rw_r,
                                             const float* rr_r,
                                             const float* k_j,
                                             const float* r_j, int Dh,
                                             float scale, float ed,
                                             float segd, float maskb) {
  float ac = 0.0f, bd = 0.0f;
  for (int c = 0; c < Dh; ++c) {
    ac = fmaf(rw_r[c], k_j[c], ac);
    bd = fmaf(rr_r[c], r_j[c], bd);
  }
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ac, scale), bd), __fmul_rn(ed, segd)),
      maskb);
}

// Opt a kernel into `kMaxSmemBytes` of dynamic shared memory, once per
// device (bit d of *done: set on device d).
template <typename Kernel>
inline cudaError_t allow_max_smem(Kernel kernel, unsigned long long* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmemBytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

}  // namespace attn
