// Helpers shared by the port's kernels: dtype conversion and the opt-in to
// the largest dynamic shared memory (every kernel); the operand staging and
// mma.sync pieces of the tensor-core kernels (#4, #6, #7, #14, #23, #24
// bf16, the last section); the Philox4x32-10
// dropout stream, the whole-row forward's blocks (#1 and #4 packed, #8
// split, #18 on a projected head, #11, #14 and fp32 #20 rel), the recompute
// backward's softmax rows (#2, #5, #9, #12, #15, #21), the full-H backward
// of one head (#2, #3 packed, #9, #10 split, #19), the small shared-memory
// products of the backward kernels, the ingredients kernels' score and
// full-H backward tail, and the QKV-projection kernels' tiled products
// (#18, #19) (the attention kernels: attn_{fwd,bwd}_packed*.cu,
// attn_{fwd,bwd}_split*.cu, attn_{fwd,bwd}_qkvproj.cu,
// attn_{fwd,bwd}_rel*.cu and attn_{fwd,bwd}_relik*.cu).
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

// ---- the whole-row forward (kernels #1 and #4 fp32 packed, #8 split) ------
//
// One block of kFwdThreads threads computes kQTile query rows q0 ..
// q0 + kQTile − 1 of one (head, batch row): scores over the whole key row
// in a [kQTile][S] fp32 shared tile (K streamed in kFwdKChunk-row chunks by
// stride), a max-subtracted fp32 softmax one warp per row, the Philox keep
// mask, the probs rounded to T, and PV accumulated in fp32 registers (V
// streamed the same way). `fwd_rows` takes the head's rows by pointer and
// row stride, so one code serves every layout: the packed projection
// [B, S, 3D] (#1 with 16-row tiles up to S = 512 and the save modes, #4's
// fp32 instantiation with 32-row tiles up to S = 640; `fwd_packed_rows`,
// q0 = blockIdx.x · kQTile), the split q, k, v [B, H, S, Dh] (#8,
// attn_fwd_split.cu) and a head projected into shared memory (#18,
// attn_fwd_qkvproj.cu, which walks q0 over the rows itself). The arithmetic
// of a row depends on neither kQTile nor the layout, so all of them give
// the same bits where they reach. (#4's bf16 kernel keeps a row's softmax
// arithmetic but sums its products on the tensor cores:
// attn_fwd_packed_hb.cu.)

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

// Where one (head, batch row) of the whole-row forward lives: row r of its
// q, k and v at q/k/v + r · ld (Dh columns each), row r of its output at
// out + r · out_ld, its fp32 [S] mask at mask (null: no padding), row r of
// its saved probs at (prob_row + r) · S of p_out/pd_out; the dropout draws
// are taken at batch row drop_b, head drop_h of the Philox counter.
template <typename T>
struct RowsHead {
  const T* q;
  const T* k;
  const T* v;
  size_t ld;
  const float* mask;
  T* out;
  size_t out_ld;
  size_t prob_row;
  int drop_b;
  int drop_h;
};

template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_rows(float* smem, const RowsHead<T>& hd,
                                         int q0, T* __restrict__ p_out,
                                         T* __restrict__ pd_out, int S,
                                         int Dh, float scale,
                                         DropoutArgs drop) {
  // Each thread owns ceil(kQTile * kFwdMaxDh / kFwdThreads) accumulators.
  constexpr int kAccPerThread =
      (kQTile * kFwdMaxDh + kFwdThreads - 1) / kFwdThreads;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;
  const size_t ld = hd.ld;

  float* qs = smem;                            // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;               // [kFwdKChunk][Dh + 1]
  float* ps = kvs + kFwdKChunk * ldkv;         // [kQTile][S]
  float* bias = ps + kQTile * S;               // [S]

  const int q_rows = min(kQTile, S - q0);

  // Mask bias, as the TPU entry forms it: (1 − m) · −10000.
  for (int j = tid; j < S; j += kFwdThreads) {
    bias[j] = hd.mask ? (1.0f - hd.mask[j]) * -10000.0f : 0.0f;
  }
  // Q tile; rows past S are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kFwdThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(hd.q[(size_t)(q0 + r) * ld + c]) : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + bias[j], over K in chunks.
  for (int k0 = 0; k0 < S; k0 += kFwdKChunk) {
    const int k_rows = min(kFwdKChunk, S - k0);
    __syncthreads();  // previous chunk's readers are done (and qs/bias set)
    for (int i = tid; i < k_rows * Dh; i += kFwdThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(hd.k[(size_t)(k0 + r) * ld + c]);
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
      const size_t prow = (hd.prob_row + q) * S;
      for (int j0 = 4 * lane; j0 < S; j0 += 128) {
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kDropout)
          bits = dropout_bits4(drop.seed, hd.drop_b, hd.drop_h, q, j0 >> 2);
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
      kvs[r * ldkv + c] = to_float(hd.v[(size_t)(k0 + r) * ld + c]);
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
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kFwdThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        hd.out[(size_t)(q0 + r) * hd.out_ld + c] = from_float<T>(acc[a]);
    }
  }
}

// `fwd_rows` on the packed projection qkv [B, S, 3D] (column packing
// i·D + h·Dh + c) for head h = blockIdx.y of batch row b = blockIdx.z,
// out [B, S, D], saved probs [B, H, S, S].
template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_packed_rows(
    float* smem, const T* __restrict__ qkv, const float* __restrict__ mask,
    T* __restrict__ out, T* __restrict__ p_out, T* __restrict__ pd_out,
    int S, int H, int Dh, float scale, DropoutArgs drop) {
  const int D = H * Dh;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q = qkv + (size_t)b * S * 3 * D + h * Dh;
  const RowsHead<T> hd{q,
                       q + D,
                       q + 2 * D,
                       (size_t)3 * D,
                       mask ? mask + (size_t)b * S : nullptr,
                       out + (size_t)b * S * D + h * Dh,
                       (size_t)D,
                       ((size_t)b * H + h) * S,
                       b,
                       h};
  fwd_rows<T, kQTile, kDropout, kSave>(smem, hd, blockIdx.x * kQTile, p_out,
                                       pd_out, S, Dh, scale, drop);
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
// the same bits where both reach. Everything after the scores
// (`fwd_rel_softmax_pv`) is fp32 #20's too, which builds its scores from
// the bias ingredients (attn_fwd_relik.cu).

// Shared memory in floats: q tile [kQTile][dh], k/v chunk
// [kFwdKChunk][dh + 1], scores [kQTile][k_len].
template <int kQTile>
__host__ __device__ inline size_t rel_fwd_smem_floats(int k_len, int dh) {
  return (size_t)kQTile * dh + (size_t)kFwdKChunk * (dh + 1) +
         (size_t)kQTile * k_len;
}

// The whole-row rel forward's tail (fp32 #11, #14 and #20), after a block's
// scores are in ps [kQTile][K] (fp32, rows q0 .. q0 + q_rows − 1 of head h,
// batch row b): the softmax one warp per row, the Philox keep mask, the
// probs rounded to T (with kSave, p and pd written to rows head_row + q of
// p_out and pd_out), and PV in fp32 registers with v_base's rows (row
// stride D) streamed in kFwdKChunk-row chunks through kvs
// [kFwdKChunk][Dh + 1]; out_base[q · D + c] receives the output. It starts
// with a barrier, so the caller's score writes are visible.
template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_rel_softmax_pv(
    float* kvs, float* ps, const T* __restrict__ v_base,
    T* __restrict__ out_base, T* __restrict__ p_out, T* __restrict__ pd_out,
    size_t head_row, int q0, int q_rows, int K, int D, int Dh, int b, int h,
    DropoutArgs drop) {
  constexpr int kAccPerThread =
      (kQTile * kFwdMaxDh + kFwdThreads - 1) / kFwdThreads;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;
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

template <typename T, int kQTile, bool kDropout, bool kSave>
__device__ __forceinline__ void fwd_rel_rows(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ ebias, T* __restrict__ out,
    T* __restrict__ p_out, T* __restrict__ pd_out, int Q, int K, int H,
    int Dh, float scale, DropoutArgs drop) {
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
  fwd_rel_softmax_pv<T, kQTile, kDropout, kSave>(
      kvs, ps, v_base, out + (size_t)b * Q * D + h * Dh, p_out, pd_out,
      head_row, q0, q_rows, K, D, Dh, b, h, drop);
}

// ---- the recompute backward's softmax rows (#2, #5, #12, #15, #21) ----
//
// In place on `rows` rows of scores (row r at ps + r · ld, ld = S unless
// given; query q0 + r): the forward's fp32 softmax, one warp per row with
// the forward's loop and reduction order; at rate > 0 the keep mask
// replayed into the sign bit (p >= 0, so a dropped element is stored as −p
// and costs no memory).
template <bool kDropout>
__device__ __forceinline__ void softmax_rows_keep_sign(float* ps, int rows,
                                                       int S, int q0, int b,
                                                       int h,
                                                       DropoutArgs drop,
                                                       int ld = 0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float* pr = ps + (size_t)r * (ld ? ld : S);
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

// ---- the full-H backward of one (head, batch row) (#2, #3; #9, #10; #19) -
//
// One block holds the whole [S, S] problem of one (head, batch row) in the
// plan of `bwd_smem_floats`: A and B [S][Dh+1], P and Tt [S][S], the [S]
// mask bias. The head's rows are taken by pointer and row stride, so the
// packed kernels (#2 attn_bwd_packed.cu, #3 attn_bwd_packed_saved.cu: row
// stride 3D into qkv and dqkv, D into g) and the split ones (#9
// attn_bwd_split.cu, #10 attn_bwd_split_saved.cu: row stride Dh into
// [B, H, S, Dh]) run the same code and give the same bits.
template <typename T>
struct BwdHead {
  const T* q;           // row r of q, k, v at + r · ld
  const T* k;
  const T* v;
  size_t ld;
  const T* g;           // row r of the context gradient at + r · g_ld
  size_t g_ld;
  T* dq;                // row r of dq, dk, dv at + r · d_ld
  T* dk;
  T* dv;
  size_t d_ld;
  const float* mask;    // the batch row's fp32 [S] mask (null: no padding)
  int drop_b;           // the Philox counter's batch row and head
  int drop_h;
};

// The recompute backward (#2, #9): the forward's scores, fp32 softmax and
// keep mask (into the sign bit) again, then
//   dV = T(pd)ᵀ · g;  d(pd) = g · Vᵀ;  t = pd ⊙ d(pd);
//   ds = (t − p · Σ_k t) · scale;  ds_c = T(ds);  dQ = ds_c · K;  dK = ds_cᵀ · Q
template <typename T, bool kDropout>
__device__ __forceinline__ void bwd_recompute_head(float* smem,
                                                   const BwdHead<T>& hd,
                                                   int S, int Dh, float scale,
                                                   DropoutArgs drop) {
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* as = smem;                  // [S][Dh + 1]
  float* bs = as + S * ld;           // [S][Dh + 1]
  float* ps = bs + S * ld;           // [S][S] p, sign bit = dropped
  float* tt = ps + S * S;            // [S][S] d(pd), then ds_c
  float* bias = tt + S * S;          // [S]

  for (int j = tid; j < S; j += blockDim.x)
    bias[j] = hd.mask ? (1.0f - hd.mask[j]) * -10000.0f : 0.0f;
  load_tile(as, hd.q, hd.ld, S, Dh);
  load_tile(bs, hd.k, hd.ld, S, Dh);
  __syncthreads();

  // Scores, exactly as the forward: (q · k) · scale, then + bias.
  for (int i = tid; i < S * S; i += blockDim.x) {
    const int q = i / S, k = i - q * S;
    const float* qr = as + q * ld;
    const float* kr = bs + k * ld;
    float acc = 0.0f;
    for (int c = 0; c < Dh; ++c) acc = fmaf(qr[c], kr[c], acc);
    ps[i] = __fadd_rn(__fmul_rn(acc, scale), bias[k]);
  }
  __syncthreads();

  // fp32 softmax with the forward's loop and reduction order; the keep
  // mask replayed into the sign bit.
  softmax_rows_keep_sign<kDropout>(ps, S, S, 0, hd.drop_b, hd.drop_h, drop);
  __syncthreads();  // Q and K no longer needed: stage g and V

  load_tile(as, hd.g, hd.g_ld, S, Dh);
  load_tile(bs, hd.v, hd.ld, S, Dh);
  __syncthreads();
  tile_abt(tt, as, bs, S, S, Dh);  // d(pd) = g · Vᵀ
  __syncthreads();

  const float inv_keep = drop.inv_keep;
  auto pd_of = [ps, inv_keep](int i) {
    return pd_of_signed<kDropout>(ps[i], inv_keep);
  };
  auto p_of = [ps](int i) { return p_of_signed<kDropout>(ps[i]); };
  softmax_vjp_rows<T>(tt, S, S, scale, pd_of, p_of, NoDsOut{});
  __syncthreads();

  // P ← pd_c = T(pd) for the dV product.
  for (int i = tid; i < S * S; i += blockDim.x) ps[i] = round_to<T>(pd_of(i));
  __syncthreads();
  store_mtx(hd.dv, hd.d_ld, ps, as, S, S, Dh);  // dV = pd_cᵀ · g
  __syncthreads();  // g and V no longer needed: stage Q and K again

  load_tile(as, hd.q, hd.ld, S, Dh);
  load_tile(bs, hd.k, hd.ld, S, Dh);
  __syncthreads();
  store_mx(hd.dq, hd.d_ld, tt, bs, S, S, Dh);   // dQ = ds_c · K
  store_mtx(hd.dk, hd.d_ld, tt, as, S, S, Dh);  // dK = ds_cᵀ · Q
}

// The saved-probs backward (#3, #10, #19) from this head's saved p and pd
// ([S][S] each, T; pd is p when the rate was 0): no QK product, no
// softmax, no random draws; the mask and drop fields of hd are unused.
template <typename T>
__device__ __forceinline__ void bwd_saved_head(float* smem,
                                               const BwdHead<T>& hd,
                                               const T* __restrict__ p_head,
                                               const T* __restrict__ pd_head,
                                               int S, int Dh, float scale) {
  const int tid = threadIdx.x;
  const int ld = Dh + 1;

  float* as = smem;                  // [S][Dh + 1]
  float* bs = as + S * ld;           // [S][Dh + 1]
  float* ps = bs + S * ld;           // [S][S] pd
  float* tt = ps + S * S;            // [S][S] d(pd), then ds_c

  for (int i = tid; i < S * S; i += blockDim.x) ps[i] = to_float(pd_head[i]);
  load_tile(as, hd.g, hd.g_ld, S, Dh);
  load_tile(bs, hd.v, hd.ld, S, Dh);
  __syncthreads();
  tile_abt(tt, as, bs, S, S, Dh);               // d(pd) = g · Vᵀ
  store_mtx(hd.dv, hd.d_ld, ps, as, S, S, Dh);  // dV = pdᵀ · g
  __syncthreads();

  auto pd_of = [ps](int i) { return ps[i]; };
  auto p_of = [p_head](int i) { return to_float(p_head[i]); };
  softmax_vjp_rows<T>(tt, S, S, scale, pd_of, p_of, NoDsOut{});
  __syncthreads();  // g and V no longer needed: stage Q and K

  load_tile(as, hd.q, hd.ld, S, Dh);
  load_tile(bs, hd.k, hd.ld, S, Dh);
  __syncthreads();
  store_mx(hd.dq, hd.d_ld, tt, bs, S, S, Dh);   // dQ = ds_c · K
  store_mtx(hd.dk, hd.d_ld, tt, as, S, S, Dh);  // dK = ds_cᵀ · Q
}

// ---- the ingredients rel kernels (#20-#24) -------------------------------
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

// relik_score's sum from its two dot products, for #23's tensor-core
// kernel: ((ac · scale + bd) + ed · segd) + maskb.
__device__ __forceinline__ float relik_combine(float ac, float bd,
                                               float scale, float ed,
                                               float segd, float maskb) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ac, scale), bd), __fmul_rn(ed, segd)),
      maskb);
}

// ---- the full-H ingredients rel backward (#21, #22) ----------------------
//
// One block per (head h, batch row b) holds the whole [Q, K] problem, as
// #12/#13 do, with the bias ingredients beside it. Shared memory, fp32:
//   as  [Q][Dh+1]        rw, then g, then rw again
//   bs  [K][Dh+1]        k, then v, then k again
//   cs  [Q][Dh+1]        rr
//   win [Q+K−1][Dh+1]    the rows 1 .. Q+K−1 of r that the scores read:
//                        score (q, k) reads r[Q − q + k], window row
//                        (Q − 1 − q) + k
//   ps, tt, us [Q][K]    p (pd), d(pd) then ds_c, ds_u

struct RelikBwdSmem {
  float* as;
  float* bs;
  float* cs;
  float* win;
  float* ps;
  float* tt;
  float* us;
};

__host__ __device__ inline size_t relik_bwd_smem_floats(int q, int k,
                                                        int dh) {
  return (size_t)(3 * q + 2 * k - 1) * (dh + 1) + 3 * (size_t)q * k;
}

__device__ __forceinline__ RelikBwdSmem relik_bwd_smem(float* smem, int Q,
                                                       int K, int Dh) {
  const int ld = Dh + 1;
  RelikBwdSmem s;
  s.as = smem;
  s.bs = s.as + Q * ld;
  s.cs = s.bs + K * ld;
  s.win = s.cs + Q * ld;
  s.ps = s.win + (Q + K - 1) * ld;
  s.tt = s.ps + Q * K;
  s.us = s.tt + Q * K;
  return s;
}

// The gradients from d(pd) (in s.tt, with g staged in s.as), shared by the
// saved-probs and the recompute backward. pd_of(i) and p_of(i) give element
// i = q·K + k of pd and p in fp32. In order:
//   t = pd ⊙ d(pd);  ds = t − p · Σ_k t   (one warp per row)
//   ded[q] = Σ_k ds · segd (fp32 ds);  ds_u = T(ds);  ds_c = T(ds · scale)
//   dv = T(pd)ᵀ · g
//   then with rw, k, rr and the r window staged:
//   drw = ds_c · k;  dk = ds_cᵀ · rw;  drr[q] = Σ_k ds_u[q][k] · r[Q − q + k]
//   ws_bh[p] = Σ_q ds_u[q][p − Q + q] · rr[q] for every p < P (0 where no
//   key is in range): this (b, h)'s fp32 slice of the [B, P, D] dr
//   workspace, written whole, so the workspace needs no zeroing.
// Row pointers: *_q at (b, query 0, head column h·Dh), *_k at (b, key 0,
// h·Dh), r_head at column h·Dh, segd_b at segd[b], ded_bh at ded[b, h];
// row stride D.
template <typename T, typename PdOf, typename POf>
__device__ __forceinline__ void relik_bwd_tail(
    const RelikBwdSmem& s, PdOf pd_of, POf p_of, const T* __restrict__ rw_q,
    const T* __restrict__ rr_q, const T* __restrict__ r_head,
    const T* __restrict__ k_k, const T* __restrict__ segd_b,
    T* __restrict__ drw_q, T* __restrict__ drr_q, T* __restrict__ dk_k,
    T* __restrict__ dv_k, T* __restrict__ ded_bh, float* __restrict__ ws_bh,
    int Q, int K, int P, int D, int Dh, float scale) {
  const int ld = Dh + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < Q; q += blockDim.x / 32) {
    float* tr = s.tt + q * K;
    float sum = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float t = __fmul_rn(pd_of(q * K + k), tr[k]);
      tr[k] = t;
      sum += t;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float dsd = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float ds = __fsub_rn(tr[k], __fmul_rn(p_of(q * K + k), sum));
      dsd = fmaf(ds, to_float(segd_b[(size_t)q * K + k]), dsd);
      s.us[q * K + k] = round_to<T>(ds);
      tr[k] = round_to<T>(__fmul_rn(ds, scale));
    }
    for (int o = 16; o > 0; o >>= 1)
      dsd += __shfl_xor_sync(0xffffffffu, dsd, o);
    if (lane == 0) ded_bh[q] = from_float<T>(dsd);
  }
  __syncthreads();

  // P ← pd_c = T(pd) for the dV product (g is still in as).
  for (int i = threadIdx.x; i < Q * K; i += blockDim.x)
    s.ps[i] = round_to<T>(pd_of(i));
  __syncthreads();
  store_mtx(dv_k, (size_t)D, s.ps, s.as, Q, K, Dh);  // dV = pd_cᵀ · g
  __syncthreads();  // g and v no longer needed: stage rw, k, rr, r

  load_tile(s.as, rw_q, (size_t)D, Q, Dh);
  load_tile(s.bs, k_k, (size_t)D, K, Dh);
  load_tile(s.cs, rr_q, (size_t)D, Q, Dh);
  load_r_window(s.win, r_head, D, P, 1, Q + K - 1, Dh);
  __syncthreads();
  store_mx(drw_q, (size_t)D, s.tt, s.bs, Q, K, Dh);   // drw = ds_c · k
  store_mtx(dk_k, (size_t)D, s.tt, s.as, Q, K, Dh);   // dk = ds_cᵀ · rw
  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    const int q = i / Dh, c = i - q * Dh;
    const float* ur = s.us + q * K;
    const float* wr = s.win + (Q - 1 - q) * ld + c;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(ur[k], wr[k * ld], acc);
    drr_q[(size_t)q * D + c] = from_float<T>(acc);
  }
  for (int i = threadIdx.x; i < P * Dh; i += blockDim.x) {
    const int p = i / Dh, c = i - p * Dh;
    const int q_lo = max(0, Q - p), q_hi = min(Q, Q + K - p);
    float acc = 0.0f;
    for (int q = q_lo; q < q_hi; ++q)
      acc = fmaf(s.us[q * K + p - Q + q], s.cs[q * ld + c], acc);
    ws_bh[(size_t)p * D + c] = acc;
  }
}

// ---- the QKV-projection kernels' tiled products (#18, #19) ---------------
//
// `gemm_tile`: one block of kGThreads threads computes a [kGM][kGN] fp32
// tile of C = A · B over K in kGK-deep slices staged in shared memory (A
// column-major as as[k][m], B as bs[k][n], rows padded by 4 floats so the
// float4 reads stay 16-byte aligned); each thread keeps a 4 × 4 register
// tile (rows 4·ty .. 4·ty + 3, columns 4·tx .. 4·tx + 3) and every element
// is one fmaf chain over k ascending. a_at(m, k) and b_at(k, n) read A
// and B (m, n relative to the tile, k absolute; only in-range indices are
// read, the rest staged as 0), store(m, n, acc) receives the in-range
// results. kBKFast: B's elements are contiguous along k (the rows of
// nn.Linear's [3D, D] weight for the projection), so the staging loop
// walks k fastest; else along n (that weight read as [3D, D] for dx).
// CUDA-core fp32 products: fp32's projection in #18/#19 and #19's dx in
// both dtypes (bf16's projection runs on the tensor cores:
// attn_full_tc.cuh's `project_head_tc`).
constexpr int kGM = 64, kGN = 64, kGK = 32;
constexpr int kGThreads = 256;       // 16 × 16 threads, 4 × 4 outputs each
constexpr int kGLd = kGM + 4;        // as/bs row stride (kGM == kGN)

__host__ __device__ inline size_t gemm_smem_floats() {
  return 2 * (size_t)kGK * kGLd;
}

template <bool kBKFast, typename ALoad, typename BLoad, typename Store>
__device__ __forceinline__ void gemm_tile(float* smem, int M, int N, int K,
                                          ALoad a_at, BLoad b_at,
                                          Store store) {
  float* as = smem;               // [kGK][kGLd]
  float* bs = as + kGK * kGLd;    // [kGK][kGLd]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kGK) {
    __syncthreads();  // the previous slice's (or tile's) readers are done
    for (int i = tid; i < kGM * kGK; i += kGThreads) {
      const int m = i / kGK, k = i - m * kGK;
      as[k * kGLd + m] = m < M && k0 + k < K ? a_at(m, k0 + k) : 0.0f;
    }
    for (int i = tid; i < kGN * kGK; i += kGThreads) {
      const int n = kBKFast ? i / kGK : i % kGN;
      const int k = kBKFast ? i - n * kGK : i / kGN;
      bs[k * kGLd + n] = n < N && k0 + k < K ? b_at(k0 + k, n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(as + k * kGLd +
                                                         4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(bs + k * kGLd +
                                                         4 * tx);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * ty + i, n = 4 * tx + j;
      if (m < M && n < N) store(m, n, acc[i][j]);
    }
}

// A head's rows of the packed projection, kept in shared memory as T
// [S][3·Dh] (its q, then k, then v columns; row stride 3·Dh), padded to a
// whole number of float4 so the fp32 work area after it stays aligned.
template <typename T>
__host__ __device__ inline size_t qkvproj_head_floats(int s, int dh) {
  return ((size_t)s * 3 * dh * sizeof(T) + 15) / 16 * 4;
}

// Projects head h of batch row b into `head`: for j < 3·Dh, with row(j) =
// (j / Dh)·D + h·Dh + j % Dh its row of w (nn.Linear's [3D, D] layout) and
// column of the packed projection,
//   head[r][j] = T(Σ_c x_b[r][c] · w[row(j)][c] + b3[row(j)])
// with the sum in fp32 (`gemm_tile`) and the bias added in fp32 before the
// one rounding: the TPU kernel's `(x·W in fp32 + b).astype(dtype)`. With
// kEmit the same values go to qkv_b[r][row(j)] ([S, 3D], the batch row's
// projection). `work` holds `gemm_smem_floats()`; the caller synchronises
// before reading `head`.
template <typename T, bool kEmit>
__device__ __forceinline__ void project_head(float* work, T* head,
                                             const T* __restrict__ x_b,
                                             const T* __restrict__ w,
                                             const T* __restrict__ b3,
                                             T* __restrict__ qkv_b, int S,
                                             int D, int Dh, int h) {
  const int N = 3 * Dh;
  for (int m0 = 0; m0 < S; m0 += kGM) {
    for (int n0 = 0; n0 < N; n0 += kGN) {
      const auto row = [=](int j) {
        return (size_t)(j / Dh) * D + h * Dh + j % Dh;
      };
      gemm_tile<true>(
          work, min(kGM, S - m0), min(kGN, N - n0), D,
          [=](int m, int k) {
            return to_float(x_b[(size_t)(m0 + m) * D + k]);
          },
          [=](int k, int n) { return to_float(w[row(n0 + n) * D + k]); },
          [=](int m, int n, float acc) {
            const size_t r = row(n0 + n);
            const T v = from_float<T>(__fadd_rn(acc, to_float(b3[r])));
            head[(size_t)(m0 + m) * N + n0 + n] = v;
            if constexpr (kEmit) qkv_b[(size_t)(m0 + m) * 3 * D + r] = v;
          });
    }
  }
}

// ---- the tensor-core kernels (#4, #6, #7, #14, #23, #24 bf16) -------------
//
// The bf16 instantiations of #6 (attn_fwd_packed_fs.cu) and #23
// (attn_fwd_relik_fs.cu) share the flash-streamed plan below; #4
// (attn_fwd_packed_hb.cu) and #14 (attn_fwd_rel_hb.cu) share the whole-row
// softmax at the end of the section; #7's and #24's passes
// (attn_bwd_packed_fs.cu, attn_bwd_relik_fs.cu) and the rest take
// its staging and mma pieces with two more operand forms: an A operand
// stored depth-major (#7's pd_cᵀ and ds_cᵀ, read from [q][k] tiles by
// ldmatrix.trans, `tc_lane_at`) and an A operand taken straight from a
// product's fp32 accumulators (#7's ds_c in the dQ pass: the accumulators of
// two neighbouring n8 tiles, packed to bf16 pairs by `pack_bf16`, are the A
// fragment of a 16-deep step). The flash-streamed plan: A block of
// kTcThreads threads holds a kTcQTile-row query tile of one (head, batch
// row) and walks the keys in kTcKBlock-key blocks. Operands are staged as
// bf16 in shared memory, rows of `tc_ld(dh)` elements: Dh rounded up to 16
// (the k-depth of mma.m16n8k16, the pad columns zero) plus 8, so the eight
// 16-byte rows one ldmatrix reads fall on distinct banks. cp.async brings
// them in (the rows past a ragged edge zero-filled). Products run on
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, fragments from ldmatrix: a
// bf16 × bf16 product is exact in fp32, so a dot differs from an fp32
// CUDA-core dot of the same values only in the order of its sum. Scores go
// to a [kTcQTile][kTcSsLd] fp32 tile, on which `tc_softmax_step` runs the
// online softmax with each row's arithmetic as the fp32 kernels' (a warp
// takes eight rows at once); the weights e go to a [kTcQTile][kTcEsLd] bf16
// tile, the A operand of PV, whose fp32 accumulators stay in registers
// (`tc_pv`).

constexpr int kTcThreads = 256;          // 8 warps
constexpr int kTcQTile = 64;
constexpr int kTcKBlock = 64;            // FS_KEY_BLOCK
constexpr int kTcSsLd = kTcKBlock + 8;   // fp32 score tile row stride
constexpr int kTcEsLd = kTcKBlock + 8;   // bf16 weight tile row stride
constexpr int kTcMaxDh = 128;
// PV's n8 tiles a warp holds: the 8 warps split the output [64][Dh] into
// four 16-row slabs × two column halves.
constexpr int kTcPvTiles = kTcMaxDh / 16;

__host__ __device__ inline int tc_depth(int dh) { return (dh + 15) / 16 * 16; }
__host__ __device__ inline int tc_ld(int dh) { return tc_depth(dh) + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// dst row r (r < rows, row stride ld) = Dh bf16 of src row row0 + r (row
// stride src_ld from base), for lo ≤ r < hi; zeros elsewhere. Asynchronous
// (cp.async): the caller commits and waits. Dh % 8 == 0, base and src_ld
// 16-byte aligned.
__device__ __forceinline__ void tc_cp_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* base,
                                           size_t src_ld, long long row0,
                                           int rows, int lo, int hi, int Dh) {
  const int chunks = Dh / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r >= lo && r < hi;
    cp_async16(dst + r * ld + c * 8,
               ok ? base + (row0 + r) * (long long)src_ld + c * 8 : base, ok);
  }
}

// Columns [c0, c1) of rows [0, rows) of dst (row stride ld) set to 0.
__device__ __forceinline__ void tc_zero_cols(__nv_bfloat16* dst, int ld,
                                             int rows, int c0, int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w;
    dst[r * ld + c0 + i - r * w] = __float2bfloat16(0.0f);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a · b on one m16n8k16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 as one A/B register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The lane addresses below are each ldmatrix x4's row pointers for one
// warp's 16 × 16 operand.

// An A operand stored row-major (rows m, depth contiguous): for ldsm_x4.
__device__ __forceinline__ const __nv_bfloat16* tc_lane_a(
    const __nv_bfloat16* a, int lda) {
  const int lane = threadIdx.x & 31;
  return a + (lane & 15) * lda + (lane >> 4) * 8;
}

// An A operand stored depth-major ([k][m], m contiguous): for ldsm_x4_trans.
__device__ __forceinline__ const __nv_bfloat16* tc_lane_at(
    const __nv_bfloat16* a, int lda) {
  const int lane = threadIdx.x & 31;
  return a + ((lane & 7) + (lane >> 4) * 8) * lda + ((lane >> 3) & 1) * 8;
}

// A B operand stored depth-major ([k][n], n contiguous), n8 tiles t and
// t + 1 at column 8t: for ldsm_x4_trans (fragments 0, 1 of tile t and 2, 3
// of tile t + 1), as `tc_pv` reads V.
__device__ __forceinline__ const __nv_bfloat16* tc_lane_bt(
    const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  return b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
}

// acc[t] += fa · B[0 .. 16)[8t .. 8t + 8) for t < n ≤ nt: fa one warp's A
// fragment of a 16-deep step, bt = tc_lane_bt(B at that step's first row
// and the tiles' first column, ldb). For odd n the last ldmatrix also reads
// the 8 columns after tile n − 1, which must lie inside B's rows.
template <int nt>
__device__ __forceinline__ void tc_mma_bt(float (&acc)[nt][4],
                                          const uint32_t (&fa)[4],
                                          const __nv_bfloat16* bt, int n) {
#pragma unroll
  for (int t = 0; t < nt; t += 2) {
    if (t < n) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, bt + t * 8);
      mma_bf16(acc[t], fa, fb[0], fb[1]);
      if (t + 1 < n) mma_bf16(acc[t + 1], fa, fb[2], fb[3]);
    }
  }
}

// One warp: acc[t] += A[0..16) · B[8t .. 8t + 8)ᵀ over depth kd (a
// multiple of 16) for t < nt (even), A and B row-major bf16 in shared
// memory (rows of lda, ldb). Element (i, j) of tile t lies in acc[t] at
// [2·(i ≥ 8) + (j & 1)] for i = lane / 4 (+ 8), j = 2·(lane % 4) (+ 1).
template <int nt>
__device__ __forceinline__ void tc_warp_abt(float (&acc)[nt][4],
                                            const __nv_bfloat16* a, int lda,
                                            const __nv_bfloat16* b, int ldb,
                                            int kd) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa = tc_lane_a(a, lda);
  const __nv_bfloat16* pb =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < kd; k += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, pa + k);
#pragma unroll
    for (int t = 0; t < nt; t += 2) {
      uint32_t fb[4];
      ldsm_x4(fb, pb + t * 8 * ldb + k);
      mma_bf16(acc[t], fa, fb[0], fb[1]);
      mma_bf16(acc[t + 1], fa, fb[2], fb[3]);
    }
  }
}

// Where a warp's tiles lie: PV's output rows m0 .. m0 + 15 and n8 tiles
// c0/8 .. c0/8 + n − 1 (the four 16-row slabs × two column halves of
// [kTcQTile][Dh]); the score products' rows m0 and keys k0 .. k0 + 31.
struct TcWarp {
  int m0, c0, n, k0;
};

__device__ __forceinline__ TcWarp tc_warp(int Dh) {
  const int warp = threadIdx.x >> 5;
  const int tiles = Dh / 8, half = (tiles + 1) / 2;
  const int first = (warp >> 2) * half;
  return {(warp & 3) * 16, first * 8, max(0, min(half, tiles - first)),
          (warp >> 2) * 32};
}

// The online softmax step of a key block on the fp32 score tile ss (keys
// < k_rows): m' = max(m, max s), e = exp(s − m'), l ← l·α + Σe (undropped),
// α = exp(m − m'); the weights (dropped by the Philox mask at (k >> 2, q,
// h, b) at rate > 0) rounded to bf16 into es, zeros past k_rows. Warp w
// takes rows w, w + 8, ..., w + 56, its eight rows' reductions interleaved
// so that their shuffle chains overlap; each row's arithmetic, and the
// order of its max and sum, are the fp32 kernels' one-warp-per-row step's.
// Rows past the ragged q tile run on their zero-query scores and are never
// stored; at rate > 0 they draw no Philox.
template <bool kDropout>
__device__ __forceinline__ void tc_softmax_step(
    float* ss, __nv_bfloat16* es, float* m_s, float* l_s, float* alpha_s,
    int q_rows, int k_rows, int q0, int k0, int b, int h,
    const DropoutArgs& drop) {
  constexpr int kWarps = kTcThreads / 32;
  constexpr int kRows = kTcQTile / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float x[kRows][2], m_new[kRows], sum[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float* sr = ss + (warp + kWarps * i) * kTcSsLd;
    m_new[i] = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      x[i][u] = j < k_rows ? sr[j] : -INFINITY;
      m_new[i] = fmaxf(m_new[i], x[i][u]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], o));
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    m_new[i] = fmaxf(m_s[r], m_new[i]);
    sum[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      float e = 0.0f;
      if (j < k_rows) {
        e = expf(x[i][u] - m_new[i]);
        sum[i] += e;
      }
      if constexpr (kDropout)
        ss[r * kTcSsLd + j] = e;
      else
        es[r * kTcEsLd + j] = __float2bfloat16(e);
    }
  }
  if constexpr (kDropout) {
    __syncwarp();
    // The warp's 8 rows × 16 groups of four keys, four groups a lane.
#pragma unroll
    for (int t = 0; t < kRows * (kTcKBlock / 4) / 32; ++t) {
      const int task = lane + 32 * t;
      const int r = warp + kWarps * (task >> 4);
      const int j0 = 4 * (task & 15);
      const float* sr = ss + r * kTcSsLd;
      __nv_bfloat16* er = es + r * kTcEsLd;
      const uint4 bits =
          r < q_rows && j0 < k_rows
              ? dropout_bits4(drop.seed, b, h, q0 + r, (k0 + j0) >> 2)
              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        er[j] = __float2bfloat16(
            r < q_rows && j < k_rows && word(bits, u) >= drop.threshold
                ? __fmul_rn(sr[j], drop.inv_keep)
                : 0.0f);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    if (lane == i && r < q_rows) {
      const float alpha = expf(m_s[r] - m_new[i]);  // 0 at the first block
      alpha_s[r] = alpha;
      l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum[i]);
      m_s[r] = m_new[i];
    }
  }
}

// acc ← acc · α + es · V for the warp's PV tiles (w): es [kTcQTile]
// [kTcEsLd] bf16, v the staged [kTcKBlock][ldv] value block (rows past
// the block's keys zero), alpha_s the rows' rescale.
__device__ __forceinline__ void tc_pv(float (&acc)[kTcPvTiles][4],
                                      const TcWarp& w,
                                      const __nv_bfloat16* es,
                                      const __nv_bfloat16* v, int ldv,
                                      const float* alpha_s) {
  const int lane = threadIdx.x & 31;
  const float a_lo = alpha_s[w.m0 + (lane >> 2)];
  const float a_hi = alpha_s[w.m0 + (lane >> 2) + 8];
#pragma unroll
  for (int t = 0; t < kTcPvTiles; ++t) {
    acc[t][0] *= a_lo;
    acc[t][1] *= a_lo;
    acc[t][2] *= a_hi;
    acc[t][3] *= a_hi;
  }
  const __nv_bfloat16* pe = tc_lane_a(es + w.m0 * kTcEsLd, kTcEsLd);
  const __nv_bfloat16* pv = tc_lane_bt(v + w.c0, ldv);
#pragma unroll
  for (int k = 0; k < kTcKBlock; k += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, pe + k);
    tc_mma_bt(acc, fa, pv + k * ldv, w.n);
  }
}

// out row q (< q_rows; row stride D from out_tile, the tile's first row at
// its head's first column) = bf16(acc / l); lse row q = m + log l.
__device__ __forceinline__ void tc_store_out(
    const float (&acc)[kTcPvTiles][4], const TcWarp& w,
    __nv_bfloat16* out_tile, int D, float* lse_tile, const float* m_s,
    const float* l_s, int q_rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = w.m0 + (lane >> 2) + 8 * hi;
    if (r >= q_rows) continue;
    const float l = l_s[r];
#pragma unroll
    for (int t = 0; t < kTcPvTiles; ++t) {
      if (t < w.n) {
        *reinterpret_cast<__nv_bfloat162*>(
            out_tile + (size_t)r * D + w.c0 + t * 8 + 2 * (lane & 3)) =
            __halves2bfloat162(__float2bfloat16(acc[t][2 * hi] / l),
                               __float2bfloat16(acc[t][2 * hi + 1] / l));
      }
    }
  }
  for (int r = threadIdx.x; r < q_rows; r += blockDim.x)
    lse_tile[r] = __fadd_rn(m_s[r], logf(l_s[r]));
}

// #23's r window, 64 rows at a time: dst rows r < 64 = r_head rows p0 + r
// (row stride D, Dh columns) where 0 ≤ p0 + r < P, zeros elsewhere, by
// cp.async (the caller commits). The window of a (q tile, key block) pair,
// rows Q − q0 − 63 + k0 .. + 127 as in `load_r_window`, is two such
// chunks, and the next key block's window shares one of them.
__device__ __forceinline__ void relik_tc_r_chunk(__nv_bfloat16* dst, int ld,
                                                 const __nv_bfloat16* r_head,
                                                 int D, int P, long long p0,
                                                 int Dh) {
  const long long lo = p0 < 0 ? -p0 : 0;
  const long long hi = P - p0;
  tc_cp_rows(dst, ld, r_head, (size_t)D, p0, kTcKBlock,
             (int)min(lo, (long long)kTcKBlock),
             (int)max(0ll, min(hi, (long long)kTcKBlock)), Dh);
}

// δ of the 16 rows of a warp's slab (rows past `rows` give 0): δ[r] =
// Σ_c g[r][c] · o[r][c] in fp32, c = lane, lane + 32, ... then the warp's
// xor tree (one order, so #7's and #24's two passes get the same bits). The
// 16 rows' chains run side by side. Returns the lane's rows, lane / 4
// (d_lo) and lane / 4 + 8 (d_hi).
__device__ __forceinline__ void tc_slab_delta(float& d_lo, float& d_hi,
                                              const __nv_bfloat16* g_rows,
                                              int g_ld,
                                              const __nv_bfloat16* o_rows,
                                              size_t o_ld, int rows, int Dh) {
  const int lane = threadIdx.x & 31;
  float sum[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    sum[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < kTcMaxDh / 32; ++u) {
      const int c = lane + 32 * u;
      if (r < rows && c < Dh)
        sum[r] = fmaf(__bfloat162float(g_rows[r * g_ld + c]),
                      __bfloat162float(o_rows[(size_t)r * o_ld + c]), sum[r]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 16; ++r)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
  d_lo = d_hi = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((lane >> 2) == r) {
      d_lo = sum[r];
      d_hi = sum[r + 8];
    }
  }
}

// ---- the head-blocked forwards on the tensor cores (#4, #14 bf16) --------
//
// The whole-row softmax of rows r = warp, warp + 8, ... < q_rows of an fp32
// score tile ss (rows of ssld, n keys ≤ kTcHbMaxLen), in `fwd_rows`'
// arithmetic and order: max, e = exp(s − max) summed lane-strided then by
// the xor tree, p = e / sum; at rate > 0 the keep mask of (b, h, q0 + r, k),
// each lane taking four consecutive keys for one Philox block. The row's
// ≤ 20 values a lane stay in registers. The probs, rounded to bf16, go over
// the first half of their own row as bf16 [keys], zeros from n to the next
// multiple of 16 (the keys PV reads). With kSave (#1's and #8's score-tile
// plan, attn_full_tc.cuh) each row's p, and at rate > 0 its pd, also go to
// row prow0 + r of p_out / pd_out ([.][n] bf16).
constexpr int kTcHbMaxLen = 640;  // ops/fused_attention.py::HB_MAX_SEQ_LEN
constexpr int kTcHbRowRegs = kTcHbMaxLen / 32;

template <bool kDropout, bool kSave = false>
__device__ __forceinline__ void tc_hb_softmax_rows(
    float* ss, int ssld, int q_rows, int n, int q0, int b, int h,
    const DropoutArgs& drop, size_t prow0 = 0,
    __nv_bfloat16* __restrict__ p_out = nullptr,
    __nv_bfloat16* __restrict__ pd_out = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n16 = (n + 15) / 16 * 16;
  for (int r = warp; r < q_rows; r += kTcThreads / 32) {
    float* sr = ss + r * ssld;
    __nv_bfloat16* pr = reinterpret_cast<__nv_bfloat16*>(sr);
    const size_t prow = (prow0 + r) * n;
    float x[kTcHbRowRegs];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kTcHbRowRegs; ++u) {
      const int j = lane + 32 * u;
      x[u] = j < n ? sr[j] : -INFINITY;
      m = fmaxf(m, x[u]);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kTcHbRowRegs; ++u) {
      if (lane + 32 * u < n) {
        x[u] = expf(x[u] - m);
        sum += x[u];
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (!kDropout) {
      __syncwarp();  // every lane has read its scores: write the probs
#pragma unroll
      for (int u = 0; u < kTcHbRowRegs; ++u) {
        const int j = lane + 32 * u;
        if (j < n16) {
          const __nv_bfloat16 p = __float2bfloat16(j < n ? x[u] / sum : 0.0f);
          pr[j] = p;
          if (kSave && j < n) p_out[prow + j] = p;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kTcHbRowRegs; ++u) {
        const int j = lane + 32 * u;
        if (j < n) {
          sr[j] = x[u] / sum;
          if constexpr (kSave) p_out[prow + j] = __float2bfloat16(sr[j]);
        }
      }
      __syncwarp();
      uint2 w[kTcHbRowRegs / 4];
#pragma unroll
      for (int t = 0; t < kTcHbRowRegs / 4; ++t) {
        const int j0 = 4 * lane + 128 * t;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (j0 < n) {
          const float4 p4 = *reinterpret_cast<const float4*>(sr + j0);
          const uint4 bits = dropout_bits4(drop.seed, b, h, q0 + r, j0 >> 2);
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = j0 + u < n && word(bits, u) >= drop.threshold
                       ? __fmul_rn(p[u], drop.inv_keep)
                       : 0.0f;
            if (kSave && j0 + u < n)
              pd_out[prow + j0 + u] = __float2bfloat16(v[u]);
          }
        }
        w[t] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
      __syncwarp();  // every lane has read its probs: write them as bf16
#pragma unroll
      for (int t = 0; t < kTcHbRowRegs / 4; ++t) {
        const int j0 = 4 * lane + 128 * t;
        if (j0 < n16) *reinterpret_cast<uint2*>(pr + j0) = w[t];
      }
    }
  }
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
