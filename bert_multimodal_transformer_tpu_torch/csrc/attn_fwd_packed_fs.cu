// Flash-streamed packed attention forward for Hopper (sm_90a): the
// long-sequence forward past the head-blocked reach (S > 640).
//
// Replaces the TPU kernel `_attn_fwd_packed_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1256).
//
// What it computes, per batch row b, head h and query row q, from qkv
// [B, S, 3D] and the fp32 mask, over key blocks of kKBlock in order: the
// online softmax of s = (q · k in fp32) · scale + (1 − m) · −10000 with a
// running max m, a denominator l and a rescaled fp32 accumulator:
//   m' = max(m, max_k s);  α = exp(m − m');  e = exp(s − m');
//   l  ← l · α + Σ_k e    (the undropped e)
//   e  ← keep ? e · inv_keep : 0 at rate > 0 (common.cuh's Philox stream,
//        the element (b, h, q, k) kept as in every other tier)
//   acc ← acc · α + T(e) · V_block   (e rounded to the input dtype)
// then out [B, S, D] = T(acc / l) and lse [B, H, S] = m + log l (fp32),
// the residual the backward (#7) rebuilds p from. Dropout on the
// unnormalised weights against the undropped l is dropout on the probs, as
// the TPU kernel has it. The rounding differs from the whole-row tiers (e
// is rounded before PV, divided by l after), so #6 is held to its own
// plain version, which runs this recurrence at the same key-block width.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12, Dh=64)
// the two products are 4·B·H·S²·Dh ≈ 155 GFLOP over ~19 MB of projection
// and context: operations bound, 0.156 ms at the bf16 tensor-core peak.
// Nothing S²-sized may exist.
//
// What the design does about that (bf16, `attn_fwd_packed_fs_tc_kernel`):
// both products run on the tensor cores, common.cuh's "flash-streamed
// forwards on the tensor cores" plan. One block of 8 warps per (64-row q
// tile, head, batch row), 9216 blocks at the driver's shape, walks the keys
// in 64-key blocks. Q, K and V are staged as bf16 by cp.async, K and V in
// two-stage rings: block k + 1 is in flight while block k is computed (the
// K block waited for before its scores, the V block only before PV). S =
// Q·Kᵀ on mma.m16n8k16 (each warp a 16-row × 32-key slab, fragments by
// ldmatrix) goes to the fp32 score tile as (dot·scale) + bias, the order of
// the fp32 kernel; the online softmax and the Philox keep mask run there,
// each row's arithmetic as before (e rounded to bf16 before PV, l summed
// from the undropped e, α = exp(m − m'); a warp takes eight rows at once so
// their shuffle chains overlap), writing e as bf16; PV runs on the
// same mma (e by ldmatrix, V by ldmatrix.trans), its fp32 accumulators in
// registers, rescaled by α each block. Any S is taken: the ragged last q
// tile and key block are zero-filled and bounds-checked (the TPU kernel
// needs S % 128 == 0). Any Dh % 8 == 0 up to 128: Q and K are zero-padded
// to a multiple of 16 for the mma's k-depth. Shared plan
// (`tc_smem_bytes`, ops/fused_attention.py::fs_fwd_smem_bytes): Q [64][L],
// K and V rings 2 × [64][L] each (bf16, L = Dh rounded up to 16, + 8), the
// fp32 scores [64][72], the bf16 weights [64][72], the rows' m, l, α and
// two bias blocks: 73.3 KB at Dh = 64 (two blocks an SM, as the registers
// allow), 113.3 KB at Dh = 128.
//
// fp32 input keeps the CUDA-core kernel (`attn_fwd_packed_fs_kernel<float>`:
// fp32 dots from fp32 shared memory, about one FMA per two shared-memory
// loads; shared plan `smem_floats`, 81 KB at Dh = 128, 49 KB at Dh = 64):
// a TF32 product would not hold the fp32 checks' 1e-5. The entry
// dispatches on the dtype; a bf16 call always launches the tensor-core
// kernel or returns the launch's error (cudaErrorMisalignedAddress where
// qkv does not start on the 16 bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kQTile = 64;     // query rows per block
constexpr int kKBlock = 64;    // ops/fused_attention.py::FS_KEY_BLOCK
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;

// Q tile [kQTile][dh], K/V block [kKBlock][dh + 1], scores
// [kQTile][kKBlock], the rows' m, l and α [kQTile] each, bias [kKBlock].
__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)kQTile * dh + (size_t)kKBlock * (dh + 1) +
         (size_t)kQTile * kKBlock + 3 * (size_t)kQTile + kKBlock;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_packed_fs_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ mask,
                              T* __restrict__ out, float* __restrict__ lse,
                              int S, int H, int Dh, float scale,
                              DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ldkv = Dh + 1;

  float* qs = smem;                        // [kQTile][Dh]
  float* kvs = qs + kQTile * Dh;           // [kKBlock][Dh + 1]
  float* ss = kvs + kKBlock * ldkv;        // [kQTile][kKBlock]
  float* m_s = ss + kQTile * kKBlock;      // [kQTile] running max
  float* l_s = m_s + kQTile;               // [kQTile] running denominator
  float* alpha_s = l_s + kQTile;           // [kQTile] this block's rescale
  float* bias = alpha_s + kQTile;          // [kKBlock]

  const size_t row_stride = (size_t)3 * D;
  const T* base = qkv + (size_t)b * S * row_stride;
  const int q_rows = min(kQTile, S - q0);

  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? attn::to_float(base[(size_t)(q0 + r) * row_stride +
                                             h * Dh + c])
                       : 0.0f;
  }
  for (int r = tid; r < kQTile; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kKBlock) {
    const int k_rows = min(kKBlock, S - k0);
    __syncthreads();  // the previous block's PV readers are done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(
          base[(size_t)(k0 + r) * row_stride + D + h * Dh + c]);
    }
    for (int j = tid; j < k_rows; j += kThreads)
      bias[j] = mask ? (1.0f - mask[(size_t)b * S + k0 + j]) * -10000.0f
                     : 0.0f;
    __syncthreads();
    // s = (q · k) · scale + bias, as the whole-row tiers.
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float dot = 0.0f;
      for (int c = 0; c < Dh; ++c) dot = fmaf(qr[c], kr[c], dot);
      ss[r * kKBlock + j] = __fadd_rn(__fmul_rn(dot, scale), bias[j]);
    }
    __syncthreads();
    // The online softmax step, one warp per row.
    for (int r = warp; r < q_rows; r += kThreads / 32) {
      float* sr = ss + r * kKBlock;
      float mx = -INFINITY;
      for (int j = lane; j < k_rows; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < k_rows; j += 32) {
        const float e = expf(sr[j] - m_new);
        sr[j] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if constexpr (kDropout) {
        const int q = q0 + r;
        for (int j0 = 4 * lane; j0 < k_rows; j0 += 128) {
          const uint4 bits =
              attn::dropout_bits4(drop.seed, b, h, q, (k0 + j0) >> 2);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u;
            if (j < k_rows)
              sr[j] = attn::round_to<T>(attn::word(bits, u) >= drop.threshold
                                            ? __fmul_rn(sr[j], drop.inv_keep)
                                            : 0.0f);
          }
        }
      } else {
        for (int j = lane; j < k_rows; j += 32)
          sr[j] = attn::round_to<T>(sr[j]);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 at the first block
        alpha_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // K no longer needed: stage V
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(
          base[(size_t)(k0 + r) * row_stride + 2 * D + h * Dh + c]);
    }
    __syncthreads();
    // acc ← acc · α + T(e) · V_block
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / Dh, c = i - r * Dh;
      if (i < kQTile * Dh && r < q_rows) {
        const float* er = ss + r * kKBlock;
        float pv = 0.0f;
        for (int j = 0; j < k_rows; ++j)
          pv = fmaf(er[j], kvs[j * ldkv + c], pv);
        acc[a] = __fadd_rn(__fmul_rn(acc[a], alpha_s[r]), pv);
      }
    }
  }
  T* out_base = out + (size_t)b * S * D;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kQTile * Dh && r < q_rows)
      out_base[(size_t)(q0 + r) * D + h * Dh + c] =
          attn::from_float<T>(acc[a] / l_s[r]);
  }
  for (int r = tid; r < q_rows; r += kThreads)
    lse[((size_t)b * H + h) * S + q0 + r] = __fadd_rn(m_s[r], logf(l_s[r]));
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using bf16 = __nv_bfloat16;

// Bytes of shared memory of one tensor-core block at head width dh (see
// the note): Q, the K and V rings (bf16 [64][L] each, five in all), the
// fp32 scores, the bf16 weights, m, l, α and the two bias blocks.
__host__ __device__ inline size_t tc_smem_bytes(int dh) {
  return 5 * (size_t)kQTile * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)kQTile * attn::kTcSsLd * sizeof(float) +
         (size_t)kQTile * attn::kTcEsLd * sizeof(bf16) +
         (3 * (size_t)kQTile + 2 * (size_t)kKBlock) * sizeof(float);
}

template <bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_packed_fs_tc_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ mask,
                                 bf16* __restrict__ out,
                                 float* __restrict__ lse, int S, int H,
                                 int Dh, float scale, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kQTile * ld;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* ks = qs + tile;                          // 2 × [64][ld]
  bf16* vs = ks + 2 * tile;                      // 2 × [64][ld]
  float* ss = reinterpret_cast<float*>(vs + 2 * tile);  // [64][kTcSsLd]
  bf16* es = reinterpret_cast<bf16*>(ss + kQTile * attn::kTcSsLd);
  float* m_s = reinterpret_cast<float*>(es + kQTile * attn::kTcEsLd);
  float* l_s = m_s + kQTile;
  float* alpha_s = l_s + kQTile;
  float* bias = alpha_s + kQTile;                // 2 × [64]

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const int q_rows = min(kQTile, S - q0);
  const int n_blocks = (S + kKBlock - 1) / kKBlock;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // K block i (and its bias) into ring stage i & 1, V block i likewise:
  // each its own cp.async group.
  auto load_k = [&](int i) {
    const int k0 = i * kKBlock;
    attn::tc_cp_rows(ks + (i & 1) * tile, ld, q_base + D, row_stride, k0,
                     kKBlock, 0, min(kKBlock, S - k0), Dh);
    if (tid < kKBlock)
      bias[(i & 1) * kKBlock + tid] =
          mask && k0 + tid < S ? (1.0f - mask[(size_t)b * S + k0 + tid]) *
                                     -10000.0f
                               : 0.0f;
  };
  auto load_v = [&](int i) {
    const int k0 = i * kKBlock;
    attn::tc_cp_rows(vs + (i & 1) * tile, ld, q_base + 2 * D, row_stride, k0,
                     kKBlock, 0, min(kKBlock, S - k0), Dh);
  };

  attn::tc_cp_rows(qs, ld, q_base, row_stride, q0, kQTile, 0, q_rows, Dh);
  load_k(0);
  attn::cp_async_commit();  // Q and K block 0
  load_v(0);
  attn::cp_async_commit();  // V block 0
  // The k-depth's pad columns of Q and of both K stages stay zero.
  attn::tc_zero_cols(qs, ld, 3 * kQTile, Dh, kd);
  for (int r = tid; r < kQTile; r += attn::kTcThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
    alpha_s[r] = 0.0f;
  }
  float acc[attn::kTcPvTiles][4];
#pragma unroll
  for (int t = 0; t < attn::kTcPvTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int i = 0; i < n_blocks; ++i) {
    const int k0 = i * kKBlock;
    const int k_rows = min(kKBlock, S - k0);
    attn::cp_async_wait<1>();  // K block i (V block i may be in flight)
    __syncthreads();  // ... for every thread; block i − 1's PV is done
    if (i + 1 < n_blocks) load_k(i + 1);
    attn::cp_async_commit();
    if (i + 1 < n_blocks) load_v(i + 1);
    attn::cp_async_commit();
    // s = (q · k) · scale + bias into the fp32 score tile.
    {
      float sc[4][4] = {};
      attn::tc_warp_abt<4>(sc, qs + w.m0 * ld, ld,
                           ks + (i & 1) * tile + w.k0 * ld, ld, kd);
      const float* bi = bias + (i & 1) * kKBlock;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = w.m0 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<float2*>(ss + r * attn::kTcSsLd + j) = make_float2(
              __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), bi[j]),
              __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), bi[j + 1]));
        }
      }
    }
    __syncthreads();
    attn::tc_softmax_step<kDropout>(ss, es, m_s, l_s, alpha_s, q_rows,
                                    k_rows, q0, k0, b, h, drop);
    attn::cp_async_wait<2>();  // V block i
    __syncthreads();
    attn::tc_pv(acc, w, es, vs + (i & 1) * tile, ld, alpha_s);
  }
  attn::tc_store_out(acc, w, out + ((size_t)b * S + q0) * D + h * Dh, D,
                     lse + ((size_t)b * H + h) * S + q0, m_s, l_s, q_rows);
}

template <bool kDropout>
int launch_tc(const void* qkv, const void* mask, void* out, void* lse, int B,
              int S, int H, int Dh, float scale, DropoutArgs drop,
              cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_fs_tc_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_fs_tc_kernel<kDropout>
      <<<grid, attn::kTcThreads, tc_smem_bytes(Dh), stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
          static_cast<bf16*>(out), static_cast<float*>(lse), S, H, Dh, scale,
          drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kDropout>
int launch(const void* qkv, const void* mask, void* out, void* lse, int B,
           int S, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_fs_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_fs_kernel<T, kDropout>
      <<<grid, kThreads, smem_floats(Dh) * sizeof(float), stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(mask),
          static_cast<T*>(out), static_cast<float*>(lse), S, H, Dh, scale,
          drop);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding). out is
// [B, S, D] in the input dtype, lse [B, H, S] fp32. dropout = 0 ignores
// seed/threshold/inv_keep. Returns the cudaError_t of the launch (0 on
// success).
int attn_fwd_packed_fs(const void* qkv, const void* mask, void* out,
                       void* lse, int B, int S, int H, int Dh, float scale,
                       int dropout, unsigned long long seed,
                       unsigned int threshold, float inv_keep, int dtype,
                       void* stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores, bf16 on the tensor cores (see the note).
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(qkv, mask, out, lse, B, S, H, Dh, scale,
                                  drop, st);
    case 1:
      return launch<float, true>(qkv, mask, out, lse, B, S, H, Dh, scale,
                                 drop, st);
    case 2:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return launch_tc<false>(qkv, mask, out, lse, B, S, H, Dh, scale, drop,
                              st);
    case 3:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return launch_tc<true>(qkv, mask, out, lse, B, S, H, Dh, scale, drop,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
