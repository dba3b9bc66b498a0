// Head-blocked rel-attention forward for Hopper (sm_90a): the long-sequence
// forward past kernel #11's reach (K > 512).
//
// Replaces the TPU kernel `_attn_fwd_rel_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1560), which the
// JAX entry takes where the full-H [H, Q, K] scratch outgrows the TPU's
// scoped VMEM. On the TPU it splits the heads into blocks of hb; here heads
// are already one grid axis, so what carries over is its function and its
// reach.
//
// What it computes: #11's function without the saved probs. Per batch row
// b and head h, from q [B, Q, D], k, v [B, K, D] (head-major columns
// h·Dh + c) and the score bias ebias [B, H, Q, K] in the input dtype:
// s = (q_h · k_hᵀ in fp32) · scale + ebias[b, h]; an fp32 max-subtracted
// softmax over the whole key row; at rate > 0 the keep mask of common.cuh's
// Philox stream, p ← keep ? p · inv_keep : 0 in fp32; the probs rounded to
// T; out [B, Q, D] = T(p) · v_h accumulated in fp32.
//
// What bounds it on the card: at the stream path's training shape (B=48,
// Q=K=512, H=12, Dh=64, bf16) the two products are 4·B·H·Q·K·Dh ≈ 39 GFLOP
// over ~19 MB of q/k/v/out and the 302 MB ebias read once: bytes bound
// (0.135 ms at 3.35 TB/s; 0.04 ms for the products at the bf16
// tensor-core peak).
//
// What the design does about that (bf16, `attn_fwd_rel_hb_tc_kernel`):
// #4's tensor-core plan (attn_fwd_packed_hb.cu) with q and k/v from their
// own tensors (Q ≠ K) and the ebias in place of the [S] mask bias. One
// block of 8 warps per (32-row q tile, head, batch row), 9216 blocks at the
// training shape. The block's ebias rows are read first, 16 bytes a thread
// (plain loads where K % 8 ≠ 0 leaves them off 16 bytes), and written as
// fp32 into the score tile [32][keys + 4] they will be added to; the q tile
// comes by cp.async and k, then v, stream through one two-stage ring of
// 64-key blocks. QKᵀ runs on mma.sync.m16n8k16 (each warp a 16-row ×
// 16-key slab of a block) and its epilogue adds in `fwd_rel_rows`' order,
// s = (dot · scale) + eb, over the bias in place. The softmax is
// common.cuh's `tc_hb_softmax_rows` (#4's: one warp a row in registers, the
// Philox keep test, p rounded to bf16 over its own score row); PV reads P
// by ldmatrix and v by ldmatrix.trans, its fp32 accumulators in registers.
// Shared plan (`tc_smem_bytes`, ops/fused_attention.py::
// rel_hb_fwd_smem_bytes): scores [32][keys + 4] fp32, q [32][L] and the
// ring 2 × [64][L] bf16 (L = Dh rounded up to 16, + 8): 103 KB at K = 640,
// Dh = 64 (two blocks an SM), 123 KB at Dh = 128.
//
// What changes against #11: a row's softmax arithmetic is `fwd_rows`', so
// the probs differ from #11's only through the scores, whose dots the
// tensor cores sum in another order; bf16 #14 is held to #11 within the
// forward bound, no longer bit for bit. fp32 input keeps the CUDA-core
// kernel, which runs `fwd_rel_rows` (#11's row code) with 32-row tiles
// (shared plan `rel_fwd_smem_floats<32>`: 107 KB at K = 640, Dh = 64) and
// gives #11's bits. The entry dispatches on the dtype; a bf16 call always
// launches the tensor-core kernel or returns the launch's error
// (cudaErrorMisalignedAddress where q, k or v does not start on the 16
// bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 32;                 // query rows per block
constexpr int kMaxK = attn::kTcHbMaxLen;   // HB_MAX_SEQ_LEN

template <bool kDropout>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_rel_hb_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ ebias,
                           float* __restrict__ out, int Q, int K, int H,
                           int Dh, float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_rel_rows<float, kQTile, kDropout, false>(
      smem, q, k, v, ebias, out, nullptr, nullptr, Q, K, H, Dh, scale, drop);
}

template <bool kDropout>
int launch(const void* q, const void* k, const void* v, const void* ebias,
           void* out, int B, int Q, int K, int H, int Dh, float scale,
           DropoutArgs drop, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_fwd_rel_hb_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      attn::rel_fwd_smem_floats<kQTile>(K, Dh) * sizeof(float);
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_hb_kernel<kDropout><<<grid, attn::kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ebias),
      static_cast<float*>(out), Q, K, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kKBlock = 64;  // keys per staged k/v block

// Keys the block walks (whole 64-key blocks) and the score row's stride.
__host__ __device__ inline int tc_keys(int k_len) {
  return (k_len + kKBlock - 1) / kKBlock * kKBlock;
}
__host__ __device__ inline int tc_ss_ld(int k_len) {
  return tc_keys(k_len) + 4;
}

// Bytes of shared memory of one tensor-core block (see the note).
__host__ __device__ inline size_t tc_smem_bytes(int k_len, int dh) {
  return (size_t)kQTile * tc_ss_ld(k_len) * sizeof(float) +
         (size_t)(kQTile + 2 * kKBlock) * attn::tc_ld(dh) * sizeof(bf16);
}

template <bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_rel_hb_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ ebias,
                              bf16* __restrict__ out, int Q, int K, int H,
                              int Dh, float scale, int vec_eb,
                              DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int ssld = tc_ss_ld(K), keys = tc_keys(K);
  const int n_blocks = keys / kKBlock;
  const int stage = kKBlock * ld;

  float* ss = reinterpret_cast<float*>(smem_raw);  // [32][ssld]: eb, s, P
  bf16* qs = reinterpret_cast<bf16*>(ss + kQTile * ssld);  // [32][ld]
  bf16* ring = qs + kQTile * ld;          // 2 × [64][ld]: k blocks, then v

  const bf16* q_base = q + (size_t)b * Q * D + h * Dh;
  const bf16* k_base = k + (size_t)b * K * D + h * Dh;
  const bf16* v_base = v + (size_t)b * K * D + h * Dh;
  const bf16* eb = ebias + (((size_t)b * H + h) * Q + q0) * K;
  const int q_rows = min(kQTile, Q - q0);

  // Block i of the stream, into stage i & 1: k block i for i < n_blocks,
  // then v block i − n_blocks. Each its own cp.async group.
  auto load = [&](int i) {
    const bool is_k = i < n_blocks;
    const int k0 = (is_k ? i : i - n_blocks) * kKBlock;
    attn::tc_cp_rows(ring + (i & 1) * stage, ld, is_k ? k_base : v_base,
                     (size_t)D, k0, kKBlock, 0, min(kKBlock, K - k0), Dh);
  };
  attn::tc_cp_rows(qs, ld, q_base, (size_t)D, q0, kQTile, 0, q_rows, Dh);
  load(0);
  attn::cp_async_commit();  // q and k block 0
  // The tile's ebias rows, as fp32, where their scores will be.
  if (vec_eb) {
    const int chunks = K / 8;
#pragma unroll 4
    for (int x = tid; x < q_rows * chunks; x += attn::kTcThreads) {
      const int r = x / chunks, c = (x - r * chunks) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(eb + (size_t)r * K + c);
      const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(e2[0]);
      const float2 f1 = __bfloat1622float2(e2[1]);
      const float2 f2 = __bfloat1622float2(e2[2]);
      const float2 f3 = __bfloat1622float2(e2[3]);
      float4* dst = reinterpret_cast<float4*>(ss + r * ssld + c);
      dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  } else {
    for (int x = tid; x < q_rows * K; x += attn::kTcThreads) {
      const int r = x / K, c = x - r * K;
      ss[r * ssld + c] = __bfloat162float(eb[(size_t)r * K + c]);
    }
  }
  // The k-depth's pad columns of q and of both ring stages stay zero.
  attn::tc_zero_cols(qs, ld, kQTile + 2 * kKBlock, Dh, kd);

  // Scores: warp w takes rows m0 .. m0 + 15 and keys kq .. kq + 15 of each
  // block. PV: rows m0 .. m0 + 15 and n8 tiles c0 / 8 .. c0 / 8 + n − 1
  // (Dh split into four column groups).
  const int m0 = (warp & 1) * 16;
  const int kq = (warp >> 1) * 16;
  const int tiles = Dh / 8, per = (tiles + 3) / 4;
  const int c0 = (warp >> 1) * per * 8;
  const int n = max(0, min(per, tiles - (warp >> 1) * per));
  constexpr int kPvTiles = attn::kTcMaxDh / 32;
  float acc[kPvTiles][4];
#pragma unroll
  for (int t = 0; t < kPvTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  const bf16* ps = reinterpret_cast<const bf16*>(ss);  // P, rows of 2·ssld

  for (int i = 0; i < 2 * n_blocks; ++i) {
    attn::cp_async_wait<0>();  // block i
    __syncthreads();  // ... for every thread (and eb); block i − 1 is done
    if (i + 1 < 2 * n_blocks) load(i + 1);
    attn::cp_async_commit();
    const bf16* blk = ring + (i & 1) * stage;
    if (i < n_blocks) {
      // s = (q · k) · scale + eb, over eb in the fp32 score tile.
      const int k0 = i * kKBlock;
      float sc[2][4] = {};
      attn::tc_warp_abt<2>(sc, qs + m0 * ld, ld, blk + kq * ld, ld, kd);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + kq + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = m0 + (lane >> 2) + 8 * hi;
          float2* dst = reinterpret_cast<float2*>(ss + r * ssld + j);
          const float2 e = *dst;
          *dst = make_float2(__fadd_rn(__fmul_rn(sc[t][2 * hi], scale), e.x),
                             __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale),
                                       e.y));
        }
      }
      if (i == n_blocks - 1) {
        __syncthreads();  // every score is in
        attn::tc_hb_softmax_rows<kDropout>(ss, ssld, q_rows, K, q0, b, h,
                                           drop);
      }
    } else {
      // acc += P[:, k0 .. k0 + kmax) · v block
      const int k0 = (i - n_blocks) * kKBlock;
      const int kmax = min(kKBlock, (K - k0 + 15) / 16 * 16);
      const bf16* pa = attn::tc_lane_a(ps + m0 * 2 * ssld + k0, 2 * ssld);
      const bf16* vb = attn::tc_lane_bt(blk + c0, ld);
      for (int kk = 0; kk < kmax; kk += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + kk);
        attn::tc_mma_bt(acc, fa, vb + kk * ld, n);
      }
    }
  }
  bf16* out_tile = out + ((size_t)b * Q + q0) * D + h * Dh + c0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = m0 + (lane >> 2) + 8 * hi;
    if (r >= q_rows) continue;
#pragma unroll
    for (int t = 0; t < kPvTiles; ++t) {
      if (t < n)
        *reinterpret_cast<__nv_bfloat162*>(
            out_tile + (size_t)r * D + t * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[t][2 * hi], acc[t][2 * hi + 1]);
    }
  }
}

template <bool kDropout>
int launch_tc(const void* q, const void* k, const void* v, const void* ebias,
              void* out, int B, int Q, int K, int H, int Dh, float scale,
              DropoutArgs drop, cudaStream_t stream) {
  const int vec_eb = K % 8 == 0 && reinterpret_cast<uintptr_t>(ebias) % 16 == 0;
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      attn::allow_max_smem(attn_fwd_rel_hb_tc_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_rel_hb_tc_kernel<kDropout>
      <<<grid, attn::kTcThreads, tc_smem_bytes(K, Dh), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(ebias),
          static_cast<bf16*>(out), Q, K, H, Dh, scale, vec_eb, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, ebias and out. dropout = 0
// ignores seed/threshold/inv_keep. Returns the cudaError_t of the launch (0
// on success); a shape past the dtype's shared-memory plan returns
// cudaErrorInvalidValue.
int attn_fwd_rel_hb(const void* q, const void* k, const void* v,
                    const void* ebias, void* out, int B, int Q, int K, int H,
                    int Dh, float scale, int dropout, unsigned long long seed,
                    unsigned int threshold, float inv_keep, int dtype,
                    void* stream) {
  if (B < 1 || Q < 1 || K < 1 || K > kMaxK || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t plan =
      dtype == 1 ? tc_smem_bytes(K, Dh)
                 : attn::rel_fwd_smem_floats<kQTile>(K, Dh) * sizeof(float);
  if (plan > attn::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores (#11's row code), bf16 on the tensor cores.
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<false>(q, k, v, ebias, out, B, Q, K, H, Dh, scale, drop,
                           st);
    case 1:
      return launch<true>(q, k, v, ebias, out, B, Q, K, H, Dh, scale, drop,
                          st);
    case 2:
    case 3:
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dropout ? launch_tc<true>(q, k, v, ebias, out, B, Q, K, H, Dh,
                                       scale, drop, st)
                     : launch_tc<false>(q, k, v, ebias, out, B, Q, K, H, Dh,
                                        scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
