// Packed-layout attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_fwd_packed_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:996) on the
// serving path: rate = 0 (no prob dropout), no saved probs.
//
// What it computes, per batch row b and head h:
//   qkv  [B, S, 3D]  column packing i·D + h·Dh + c (q, then k, then v)
//   bias [S]         (1 − mask) · −10000, formed here from the fp32 mask
//   s    = (Q_h · K_hᵀ accumulated in fp32) · scale + bias   (scale after
//          the dot, as the TPU kernel)
//   p    = fp32 max-subtracted softmax over the keys, then rounded to the
//          input dtype (the TPU kernel's `p.astype(qkv.dtype)`)
//   out  [B, S, D]   = p · V_h accumulated in fp32, written in the input
//          dtype at columns h·Dh + c
// Input dtypes: fp32 and bf16. Dh a multiple of 8 up to 128, S up to 512.
//
// What bounds it on the card: at the serving shape (B=128, S=50, H=12,
// Dh=64) the op is ~1 GFLOP and moves ~10 MB (the [B,S,3D] projection in,
// [B,S,D] out): a small op next to the QKV and FFN GEMMs around it, so its
// time is set by latency (launch, the dependent load → dot → softmax → dot
// chain inside each block) and by how many blocks keep the 132 SMs busy,
// not by HBM bandwidth or tensor-core rate.
//
// What the design does about that: one block per (q-tile of 16 rows, head,
// batch row) gives B·H·ceil(S/16) = 6144 independent blocks at the serving
// shape, enough to fill every SM several times over. Each block reads its
// Q tile and streams K_h and V_h in 64-row chunks straight from the packed
// projection by stride, so no head transpose or [B,H,S,S] tensor ever
// reaches device memory. Scores for the tile live in shared memory (at
// most 16 × 512 fp32); the ragged edges (S = 50 is not a multiple of 16 or
// 64) are masked by bounds checks. The dots run on the CUDA cores in fp32:
// a tensor-core (`wgmma`) version with TMA loads is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kQTile = 16;     // query rows per block
constexpr int kKChunk = 64;    // key/value rows staged in shared memory
constexpr int kMaxDh = 128;
constexpr int kMaxS = 512;
// Each thread owns ceil(kQTile * kMaxDh / kThreads) output accumulators.
constexpr int kAccPerThread = (kQTile * kMaxDh + kThreads - 1) / kThreads;

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

// Rounds an fp32 value to T and back (the probs' cast to the input dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Shared memory in floats: Q tile [kQTile][dh], K/V chunk
// [kKChunk][dh + 1] (the +1 pad keeps the per-key rows on distinct banks),
// scores [kQTile][s], bias [s].
__host__ __device__ inline size_t smem_floats(int s, int dh) {
  return (size_t)kQTile * dh + (size_t)kKChunk * (dh + 1) +
         (size_t)kQTile * s + (size_t)s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_packed_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ mask,
                           T* __restrict__ out, int S, int H, int Dh,
                           float scale) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ldkv = Dh + 1;

  float* qs = smem;                            // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;               // [kKChunk][Dh + 1]
  float* ps = kvs + kKChunk * ldkv;            // [kQTile][S]
  float* bias = ps + kQTile * S;               // [S]

  const size_t row_stride = (size_t)3 * D;
  const T* base = qkv + (size_t)b * S * row_stride;
  const int q_rows = min(kQTile, S - q0);

  // Mask bias, as the TPU entry forms it: (1 − m) · −10000.
  for (int j = tid; j < S; j += kThreads) {
    bias[j] = mask ? (1.0f - mask[(size_t)b * S + j]) * -10000.0f : 0.0f;
  }
  // Q tile; rows past S are zero-filled and never written out.
  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? to_float(base[(size_t)(q0 + r) * row_stride +
                                       h * Dh + c])
                       : 0.0f;
  }

  // Scores: s[r][j] = (q_r · k_j) · scale + bias[j], over K in chunks.
  for (int k0 = 0; k0 < S; k0 += kKChunk) {
    const int k_rows = min(kKChunk, S - k0);
    __syncthreads();  // previous chunk's readers are done (and qs/bias set)
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] =
          to_float(base[(size_t)(k0 + r) * row_stride + D + h * Dh + c]);
    }
    __syncthreads();
    for (int i = tid; i < kQTile * k_rows; i += kThreads) {
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
  for (int r = warp; r < q_rows; r += kThreads / 32) {
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
    for (int j = lane; j < S; j += 32) pr[j] = round_to<T>(pr[j] / sum);
  }

  // out[r][c] = Σ_j p[r][j] · v_j[c], fp32 accumulators in registers.
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += kKChunk) {
    const int k_rows = min(kKChunk, S - k0);
    __syncthreads();  // softmax / previous chunk done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = to_float(
          base[(size_t)(k0 + r) * row_stride + 2 * D + h * Dh + c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
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
    const int i = tid + a * kThreads;
    if (i < kQTile * Dh) {
      const int r = i / Dh, c = i - r * Dh;
      if (r < q_rows)
        out_base[(size_t)(q0 + r) * D + h * Dh + c] = from_float<T>(acc[a]);
    }
  }
}

template <typename T>
int launch(const void* qkv, const void* mask, void* out, int B, int S, int H,
           int Dh, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(S, Dh) * sizeof(float);
  // Above 48 KB a block's dynamic shared memory needs an opt-in; set it
  // once per device, to the largest size any accepted shape asks for.
  static unsigned long long attr_set = 0;  // bit d: set on device d
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const size_t max_smem = smem_floats(kMaxS, kMaxDh) * sizeof(float);
    err = cudaFuncSetAttribute(attn_fwd_packed_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    attr_set |= bit;
  }
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<T*>(out), S, H, Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding).
// Returns the cudaError_t of the launch (0 on success). The shape limits
// are checked by the Python wrapper; they are checked again here so that
// no call can index past the shared-memory plan.
int attn_fwd_packed(const void* qkv, const void* mask, void* out, int B,
                    int S, int H, int Dh, float scale, int dtype,
                    void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(qkv, mask, out, B, S, H, Dh, scale, st);
    case 1:
      return launch<__nv_bfloat16>(qkv, mask, out, B, S, H, Dh, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* attn_fwd_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
