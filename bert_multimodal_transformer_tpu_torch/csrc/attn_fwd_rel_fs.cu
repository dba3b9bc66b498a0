// Flash-streamed rel-attention forward for Hopper (sm_90a): the long
// MAG-XLNet forward over an assembled score bias, where the ingredients
// kernels (#23/#24) do not apply (rel_bias_impl "stream", bi_data, uni
// attention, long memory under "stream") past the head-blocked reach.
//
// Replaces the TPU kernel `_attn_fwd_rel_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1661).
//
// What it computes, per batch row b, head h and query row q, from q
// [B, Q, D], k and v [B, K, D] (head-major columns h·Dh + c) and the score
// bias ebias [B, H, Q, K], all in the input dtype, over key blocks of
// kKBlock in order: the online softmax of
//   s = (q · k in fp32) · scale + ebias    (the bias added in fp32)
// with a running max m, a denominator l and a rescaled fp32 accumulator:
//   m' = max(m, max_k s);  α = exp(m − m');  e = exp(s − m');
//   l  ← l · α + Σ_k e    (the undropped e)
//   e  ← keep ? e · inv_keep : 0 at rate > 0 (common.cuh's Philox stream
//        at counter (k >> 2, q, h, b), k the global key index, so every
//        rel tier drops the same elements for one seed)
//   acc ← acc · α + T(e) · V_block   (e rounded to the input dtype)
// then out [B, Q, D] = T(acc / l) and lse [B, H, Q] = m + log l (fp32), the
// residual #17 rebuilds p from. A masked key carries −1e30 in ebias, which
// stays finite: a key block masked whole leaves m finite, and the next
// real block's α = exp(−1e30 − m') is 0, never NaN. A row masked whole
// comes out uniform, as the whole-row tiers give it.
//
// What bounds it on the card: at the driver's stream path (B=48, Q=K=1024,
// H=12, Dh=64) ebias alone is 1.21 GB of the ≈1.51 GB read or written
// once; the two products are 4·B·H·Q·K·Dh ≈ 155 GFLOP: bytes bound at the
// bf16 tensor-core peak (0.45 ms against 0.16 ms for the operations).
//
// What the design does about that (bf16, `attn_fwd_rel_fs_tc_kernel`): #6's
// tensor-core plan (common.cuh's flash-streamed forwards on the tensor
// cores) with q and k/v from their own tensors and the ebias in place of
// the mask bias. One block of 8 warps per (64-row q tile, head, batch row),
// 9216 blocks at the driver's shape, walks the keys in 64-key blocks; q is
// staged once, k and v in two-stage cp.async rings, and each block's
// [64][64] ebias slice comes by cp.async beside its k block, so key block
// k + 1's bias (the bytes) is in flight while block k is computed: 16-byte
// copies where K % 8 == 0 and ebias starts on 16 bytes, plain loads
// otherwise (with the memory K = mem_len + Q, for example 562). S = Q·Kᵀ
// on mma.m16n8k16 (each warp a 16-row × 32-key slab, fragments by
// ldmatrix) goes to the fp32 score tile as (dot · scale) + eb, the fp32
// kernel's order; the online softmax and the Philox keep mask run there
// (`tc_softmax_step`, each row's arithmetic as the fp32 kernel's, e
// rounded to bf16 before PV, l from the undropped e); PV runs on the same
// mma, its fp32 accumulators in registers, rescaled by α each block. Any Q
// and K are taken (the ragged q tile and key block zero-filled and
// bounds-checked), any Dh % 8 == 0 up to 128 (q and k zero-padded to a
// k-depth of 16). Shared plan (`tc_smem_bytes`, ops/fused_attention.py::
// rel_fs_fwd_smem_bytes): q, the k and v rings (bf16 [64][L] each, five in
// all, L = Dh rounded up to 16, + 8), the ebias ring 2 × bf16 [64][72],
// the fp32 scores and bf16 weights [64][72], the rows' m, l and α: 90.8 KB
// at Dh = 64 (two blocks an SM), 130.8 KB at Dh = 128.
//
// fp32 input keeps the CUDA-core kernel (`attn_fwd_rel_fs_kernel<float>`:
// #6's fp32 plan with separate q and k/v rows and the bias read per
// element, one block per (64-row q tile, head, batch row), k and v through
// one fp32 stage, the dots in fp32 from fp32 shared memory; shared plan
// `smem_floats`, 49 KB at Dh = 64, 81 KB at Dh = 128). The entry
// dispatches on the dtype; a bf16 call always launches the tensor-core
// kernel or returns the launch's error (cudaErrorMisalignedAddress where
// q, k or v does not start on the 16 bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;  // 8 warps
constexpr int kQTile = 64;     // query rows per block
constexpr int kKBlock = 64;    // ops/fused_attention.py::FS_KEY_BLOCK
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;

// q tile [kQTile][dh], k/v block [kKBlock][dh + 1], scores
// [kQTile][kKBlock], the rows' m, l and α [kQTile] each.
__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)kQTile * dh + (size_t)kKBlock * (dh + 1) +
         (size_t)kQTile * kKBlock + 3 * (size_t)kQTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_rel_fs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ ebias, T* __restrict__ out,
                           float* __restrict__ lse, int Q, int K, int H,
                           int Dh, float scale, DropoutArgs drop) {
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

  const T* q_src = q + ((size_t)b * Q + q0) * D + h * Dh;
  const T* k_src = k + (size_t)b * K * D + h * Dh;
  const T* v_src = v + (size_t)b * K * D + h * Dh;
  const T* eb_rows = ebias + (((size_t)b * H + h) * Q + q0) * K;
  const int q_rows = min(kQTile, Q - q0);

  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int r = i / Dh, c = i - r * Dh;
    qs[i] = r < q_rows ? attn::to_float(q_src[(size_t)r * D + c]) : 0.0f;
  }
  for (int r = tid; r < kQTile; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKBlock) {
    const int k_rows = min(kKBlock, K - k0);
    __syncthreads();  // the previous block's PV readers are done
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(k_src[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
    // s = (q · k) · scale + ebias, as the whole-row rel tiers.
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int r = i / k_rows, j = i - r * k_rows;
      const float* qr = qs + r * Dh;
      const float* kr = kvs + j * ldkv;
      float dot = 0.0f;
      for (int c = 0; c < Dh; ++c) dot = fmaf(qr[c], kr[c], dot);
      ss[r * kKBlock + j] = __fadd_rn(
          __fmul_rn(dot, scale),
          attn::to_float(eb_rows[(size_t)r * K + k0 + j]));
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
        const int qi = q0 + r;
        for (int j0 = 4 * lane; j0 < k_rows; j0 += 128) {
          const uint4 bits =
              attn::dropout_bits4(drop.seed, b, h, qi, (k0 + j0) >> 2);
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
    __syncthreads();  // k no longer needed: stage v
    for (int i = tid; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, c = i - r * Dh;
      kvs[r * ldkv + c] = attn::to_float(v_src[(size_t)(k0 + r) * D + c]);
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
  T* out_rows = out + ((size_t)b * Q + q0) * D + h * Dh;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / Dh, c = i - r * Dh;
    if (i < kQTile * Dh && r < q_rows)
      out_rows[(size_t)r * D + c] = attn::from_float<T>(acc[a] / l_s[r]);
  }
  for (int r = tid; r < q_rows; r += kThreads)
    lse[((size_t)b * H + h) * Q + q0 + r] = __fadd_rn(m_s[r], logf(l_s[r]));
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, void* lse, int B, int Q, int K, int H, int Dh,
           float scale, DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_rel_fs_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_fs_kernel<T, kDropout>
      <<<grid, kThreads, smem_floats(Dh) * sizeof(float), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ebias),
          static_cast<T*>(out), static_cast<float*>(lse), Q, K, H, Dh, scale,
          drop);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kEbLd = kKBlock + 8;  // the bf16 ebias slices' row stride

// Bytes of shared memory of one tensor-core block at head width dh (see
// the note): q and the k and v rings (bf16 [64][L] each, five in all), the
// ebias ring, the fp32 scores, the bf16 weights, m, l and α.
__host__ __device__ inline size_t tc_smem_bytes(int dh) {
  return 5 * (size_t)kQTile * attn::tc_ld(dh) * sizeof(bf16) +
         2 * (size_t)kQTile * kEbLd * sizeof(bf16) +
         (size_t)kQTile * attn::kTcSsLd * sizeof(float) +
         (size_t)kQTile * attn::kTcEsLd * sizeof(bf16) +
         3 * (size_t)kQTile * sizeof(float);
}

template <bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_rel_fs_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ ebias,
                              bf16* __restrict__ out,
                              float* __restrict__ lse, int Q, int K, int H,
                              int Dh, float scale, int vec_eb,
                              DropoutArgs drop) {
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
  bf16* ebs = vs + 2 * tile;                     // 2 × [64][kEbLd]
  float* ss = reinterpret_cast<float*>(ebs + 2 * kQTile * kEbLd);
  bf16* es = reinterpret_cast<bf16*>(ss + kQTile * attn::kTcSsLd);
  float* m_s = reinterpret_cast<float*>(es + kQTile * attn::kTcEsLd);
  float* l_s = m_s + kQTile;
  float* alpha_s = l_s + kQTile;

  const bf16* q_base = q + (size_t)b * Q * D + h * Dh;
  const bf16* k_base = k + (size_t)b * K * D + h * Dh;
  const bf16* v_base = v + (size_t)b * K * D + h * Dh;
  const bf16* eb_rows = ebias + (((size_t)b * H + h) * Q + q0) * K;
  const int q_rows = min(kQTile, Q - q0);
  const int n_blocks = (K + kKBlock - 1) / kKBlock;
  const attn::TcWarp w = attn::tc_warp(Dh);

  // K block i and its [64][64] ebias slice into ring stage i & 1 (zeros
  // past Q and K), V block i likewise: each its own cp.async group (the
  // plain ebias loads where !vec_eb complete before the call returns).
  auto load_k = [&](int i) {
    const int k0 = i * kKBlock;
    attn::tc_cp_rows(ks + (i & 1) * tile, ld, k_base, (size_t)D, k0, kKBlock,
                     0, min(kKBlock, K - k0), Dh);
    bf16* e = ebs + (i & 1) * kQTile * kEbLd;
    if (vec_eb) {
      for (int x = tid; x < kQTile * (kKBlock / 8); x += attn::kTcThreads) {
        const int r = x / (kKBlock / 8), c = (x % (kKBlock / 8)) * 8;
        const bool ok = r < q_rows && k0 + c < K;
        attn::cp_async16(e + r * kEbLd + c,
                         ok ? eb_rows + (size_t)r * K + k0 + c : eb_rows, ok);
      }
    } else {
      for (int x = tid; x < kQTile * kKBlock; x += attn::kTcThreads) {
        const int r = x / kKBlock, c = x % kKBlock;
        e[r * kEbLd + c] = r < q_rows && k0 + c < K
                               ? eb_rows[(size_t)r * K + k0 + c]
                               : __float2bfloat16(0.0f);
      }
    }
  };
  auto load_v = [&](int i) {
    const int k0 = i * kKBlock;
    attn::tc_cp_rows(vs + (i & 1) * tile, ld, v_base, (size_t)D, k0, kKBlock,
                     0, min(kKBlock, K - k0), Dh);
  };

  attn::tc_cp_rows(qs, ld, q_base, (size_t)D, q0, kQTile, 0, q_rows, Dh);
  load_k(0);
  attn::cp_async_commit();  // q, k block 0 and its ebias
  load_v(0);
  attn::cp_async_commit();  // v block 0
  // The k-depth's pad columns of q and of both k stages stay zero.
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
    const int k_rows = min(kKBlock, K - k0);
    attn::cp_async_wait<1>();  // k block i (v block i may be in flight)
    __syncthreads();  // ... for every thread; block i − 1's PV is done
    if (i + 1 < n_blocks) load_k(i + 1);
    attn::cp_async_commit();
    if (i + 1 < n_blocks) load_v(i + 1);
    attn::cp_async_commit();
    // s = (q · k) · scale + eb into the fp32 score tile.
    {
      float sc[4][4] = {};
      attn::tc_warp_abt<4>(sc, qs + w.m0 * ld, ld,
                           ks + (i & 1) * tile + w.k0 * ld, ld, kd);
      const bf16* e = ebs + (i & 1) * kQTile * kEbLd;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = w.m0 + (lane >> 2) + 8 * hi;
          const float2 eb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(e + r * kEbLd + j));
          *reinterpret_cast<float2*>(ss + r * attn::kTcSsLd + j) = make_float2(
              __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), eb.x),
              __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), eb.y));
        }
      }
    }
    __syncthreads();
    attn::tc_softmax_step<kDropout>(ss, es, m_s, l_s, alpha_s, q_rows,
                                    k_rows, q0, k0, b, h, drop);
    attn::cp_async_wait<2>();  // v block i
    __syncthreads();
    attn::tc_pv(acc, w, es, vs + (i & 1) * tile, ld, alpha_s);
  }
  attn::tc_store_out(acc, w, out + ((size_t)b * Q + q0) * D + h * Dh, D,
                     lse + ((size_t)b * H + h) * Q + q0, m_s, l_s, q_rows);
}

template <bool kDropout>
int launch_tc(const void* q, const void* k, const void* v, const void* ebias,
              void* out, void* lse, int B, int Q, int K, int H, int Dh,
              float scale, DropoutArgs drop, cudaStream_t stream) {
  const int vec_eb =
      K % 8 == 0 && reinterpret_cast<uintptr_t>(ebias) % 16 == 0;
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_fwd_rel_fs_tc_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_fs_tc_kernel<kDropout>
      <<<grid, attn::kTcThreads, tc_smem_bytes(Dh), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(ebias),
          static_cast<bf16*>(out), static_cast<float*>(lse), Q, K, H, Dh,
          scale, vec_eb, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, ebias and out alike). out is
// [B, Q, D], lse [B, H, Q] fp32. dropout = 0 ignores seed/threshold/
// inv_keep. Returns the cudaError_t of the launch (0 on success).
int attn_fwd_rel_fs(const void* q, const void* k, const void* v,
                    const void* ebias, void* out, void* lse, int B, int Q,
                    int K, int H, int Dh, float scale, int dropout,
                    unsigned long long seed, unsigned int threshold,
                    float inv_keep, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores, bf16 on the tensor cores (see the note).
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(q, k, v, ebias, out, lse, B, Q, K, H, Dh,
                                  scale, drop, st);
    case 1:
      return launch<float, true>(q, k, v, ebias, out, lse, B, Q, K, H, Dh,
                                 scale, drop, st);
    case 2:
    case 3:
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dropout ? launch_tc<true>(q, k, v, ebias, out, lse, B, Q, K, H,
                                       Dh, scale, drop, st)
                     : launch_tc<false>(q, k, v, ebias, out, lse, B, Q, K, H,
                                        Dh, scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
