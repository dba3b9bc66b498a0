// Head-blocked packed attention forward for Hopper (sm_90a): the
// long-sequence forward past kernel #1's reach.
//
// Replaces the TPU kernel `_attn_fwd_packed_hb_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:1146), which the
// JAX entry takes where the full-H [H, S, S] scratch outgrows the TPU's
// scoped VMEM (S > ≈370 at bert-base bf16) and which reaches S = 640 there.
// On the TPU it splits the heads into blocks of hb; here heads are already
// one grid axis, so what carries over is its function and its reach.
//
// What it computes: #1's function without the saved probs. Per batch row
// b and head h, from qkv [B, S, 3D] (column packing i·D + h·Dh + c) and the
// fp32 mask: s = (Q_h · K_hᵀ in fp32) · scale + (1 − m) · −10000; an fp32
// max-subtracted softmax over the whole key row; at rate > 0 the keep mask
// of common.cuh's Philox stream, p ← keep ? p · inv_keep : 0 in fp32; the
// probs rounded to T; out [B, S, D] = T(p) · V_h accumulated in fp32.
//
// What bounds it on the card: at the driver's training shape (B=48,
// S=512, H=12, Dh=64, bf16) the two products are 4·B·H·S²·Dh ≈ 39 GFLOP
// over ~19 MB of projection and context: 0.04 ms at the bf16 tensor-core
// peak, 0.6 ms at the fp32 CUDA-core peak. Beside them the whole-row
// softmax touches 151 M scores, each written, read, exponentiated and
// divided once, in shared memory.
//
// What the design does about that (bf16, `attn_fwd_packed_hb_tc_kernel`):
// both products run on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix, with common.cuh's tensor-core pieces.
// One block of 8 warps per (32-row q tile, head, batch row), 9216 blocks at
// the training shape. The Q tile is staged as bf16 by cp.async; K, then V,
// stream through one two-stage ring of 64-key blocks, block i + 1 in flight
// while block i is computed (the first V block arrives during the
// softmax). QKᵀ (each warp a 16-row × 16-key slab of a block) goes to an
// fp32 [32][keys + 4] score tile as (dot · scale) + bias, the order of the
// fp32 kernel. The softmax is #1's whole-row softmax (common.cuh's
// `tc_hb_softmax_rows`, which #14 shares), one warp per row, its
// row's ≤ 20 values a lane held in registers: max, then e = exp(s − max)
// summed lane-strided then by the xor tree, then p = e / sum, in
// `fwd_rows`' order; at rate > 0 p goes back in place and each lane takes
// four consecutive keys for one Philox block, as `fwd_rows` does. The probs
// are written as bf16 over the first half of their own score row, so P
// costs no memory of its own; the row stride (keys + 4 floats, 16 bytes
// past a multiple of 128) keeps ldmatrix's eight rows on distinct banks.
// PV reads P by ldmatrix and V by ldmatrix.trans; its fp32 accumulators
// stay in registers (each warp 16 rows × a quarter of Dh) and are rounded
// once at the store. Ragged edges: Q and K/V rows past S are zero-filled by
// cp.async, P is zero from S to the next multiple of 16, and Dh % 16 ≠ 0
// pads the k-depth of Q and K with zero columns. Shared plan
// (`tc_smem_bytes`, ops/fused_attention.py::hb_fwd_smem_bytes): scores
// [32][keys + 4] fp32, Q [32][L] and the ring 2 × [64][L] bf16 (L = Dh
// rounded up to 16, + 8), the bias [keys]: 105.5 KB at S = 640, Dh = 64
// (two blocks an SM), 125.5 KB at Dh = 128.
//
// What changes against #1: a row's softmax arithmetic is `fwd_rows`', so
// the probs differ from #1's only through the scores, whose dots the
// tensor cores sum in another order; bf16 #4 is held to #1 within the
// forward bound, no longer bit for bit. fp32 input keeps the CUDA-core
// kernel, which runs `fwd_packed_rows` (#1's row code) with 32-row tiles
// (shared plan `fwd_smem_floats<32>`: 107 KB at S = 640, Dh = 64; 131 KB at
// Dh = 128) and gives #1's bits. The entry dispatches on the dtype; a bf16
// call always launches the tensor-core kernel or returns the launch's
// error (cudaErrorMisalignedAddress where qkv does not start on the 16
// bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kQTile = 32;     // query rows per block
constexpr int kMaxS = 640;     // ops/fused_attention.py::HB_MAX_SEQ_LEN

template <typename T, bool kDropout>
__global__ void __launch_bounds__(attn::kFwdThreads)
    attn_fwd_packed_hb_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ mask,
                              T* __restrict__ out, int S, int H, int Dh,
                              float scale, DropoutArgs drop) {
  extern __shared__ float smem[];
  attn::fwd_packed_rows<T, kQTile, kDropout, false>(
      smem, qkv, mask, out, nullptr, nullptr, S, H, Dh, scale, drop);
}

template <typename T, bool kDropout>
int launch(const void* qkv, const void* mask, void* out, int B, int S,
           int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_hb_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float);
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_hb_kernel<T, kDropout>
      <<<grid, attn::kFwdThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(mask),
          static_cast<T*>(out), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kKBlock = 64;             // keys per staged K/V block

// Keys the block walks (whole 64-key blocks) and the score row's stride.
__host__ __device__ inline int tc_keys(int s) {
  return (s + kKBlock - 1) / kKBlock * kKBlock;
}
__host__ __device__ inline int tc_ss_ld(int s) { return tc_keys(s) + 4; }

// Bytes of shared memory of one tensor-core block (see the note).
__host__ __device__ inline size_t tc_smem_bytes(int s, int dh) {
  return (size_t)kQTile * tc_ss_ld(s) * sizeof(float) +
         (size_t)(kQTile + 2 * kKBlock) * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)tc_keys(s) * sizeof(float);
}

template <bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_packed_hb_tc_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ mask,
                                 bf16* __restrict__ out, int S, int H,
                                 int Dh, float scale, DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int ssld = tc_ss_ld(S), keys = tc_keys(S);
  const int n_blocks = keys / kKBlock;
  const int stage = kKBlock * ld;

  float* ss = reinterpret_cast<float*>(smem_raw);  // [32][ssld]: s, then P
  bf16* qs = reinterpret_cast<bf16*>(ss + kQTile * ssld);  // [32][ld]
  bf16* ring = qs + kQTile * ld;          // 2 × [64][ld]: K blocks, then V
  float* bias = reinterpret_cast<float*>(ring + 2 * stage);  // [keys]

  const size_t row_stride = (size_t)3 * D;
  const bf16* q_base = qkv + (size_t)b * S * row_stride + h * Dh;
  const int q_rows = min(kQTile, S - q0);

  // Block i of the stream, into stage i & 1: K block i for i < n_blocks,
  // then V block i − n_blocks. Each its own cp.async group.
  auto load = [&](int i) {
    const bool is_k = i < n_blocks;
    const int k0 = (is_k ? i : i - n_blocks) * kKBlock;
    attn::tc_cp_rows(ring + (i & 1) * stage, ld, q_base + (is_k ? D : 2 * D),
                     row_stride, k0, kKBlock, 0, min(kKBlock, S - k0), Dh);
  };
  attn::tc_cp_rows(qs, ld, q_base, row_stride, q0, kQTile, 0, q_rows, Dh);
  load(0);
  attn::cp_async_commit();  // Q and K block 0
  for (int j = tid; j < keys; j += attn::kTcThreads)
    bias[j] = mask && j < S ? (1.0f - mask[(size_t)b * S + j]) * -10000.0f
                            : 0.0f;
  // The k-depth's pad columns of Q and of both ring stages stay zero.
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
    __syncthreads();  // ... for every thread; block i − 1 is done with
    if (i + 1 < 2 * n_blocks) load(i + 1);
    attn::cp_async_commit();
    const bf16* blk = ring + (i & 1) * stage;
    if (i < n_blocks) {
      // s = (q · k) · scale + bias into the fp32 score tile.
      const int k0 = i * kKBlock;
      float sc[2][4] = {};
      attn::tc_warp_abt<2>(sc, qs + m0 * ld, ld, blk + kq * ld, ld, kd);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + kq + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = m0 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<float2*>(ss + r * ssld + j) = make_float2(
              __fadd_rn(__fmul_rn(sc[t][2 * hi], scale), bias[j]),
              __fadd_rn(__fmul_rn(sc[t][2 * hi + 1], scale), bias[j + 1]));
        }
      }
      if (i == n_blocks - 1) {
        __syncthreads();  // every score is in
        attn::tc_hb_softmax_rows<kDropout>(ss, ssld, q_rows, S, q0, b, h,
                                            drop);
      }
    } else {
      // acc += P[:, k0 .. k0 + kmax) · V block
      const int k0 = (i - n_blocks) * kKBlock;
      const int kmax = min(kKBlock, (S - k0 + 15) / 16 * 16);
      const bf16* pa = attn::tc_lane_a(ps + m0 * 2 * ssld + k0, 2 * ssld);
      const bf16* vb = attn::tc_lane_bt(blk + c0, ld);
      for (int k = 0; k < kmax; k += 16) {
        uint32_t fa[4];
        attn::ldsm_x4(fa, pa + k);
        attn::tc_mma_bt(acc, fa, vb + k * ld, n);
      }
    }
  }
  bf16* out_tile = out + ((size_t)b * S + q0) * D + h * Dh + c0;
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
int launch_tc(const void* qkv, const void* mask, void* out, int B, int S,
              int H, int Dh, float scale, DropoutArgs drop,
              cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_packed_hb_tc_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attn_fwd_packed_hb_tc_kernel<kDropout>
      <<<grid, attn::kTcThreads, tc_smem_bytes(S, Dh), stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
          static_cast<bf16*>(out), S, H, Dh, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no padding). out is
// [B, S, D] in the input dtype. dropout = 0 ignores seed/threshold/
// inv_keep. Returns the cudaError_t of the launch (0 on success); a shape
// past the dtype's shared-memory plan returns cudaErrorInvalidValue.
int attn_fwd_packed_hb(const void* qkv, const void* mask, void* out, int B,
                       int S, int H, int Dh, float scale, int dropout,
                       unsigned long long seed, unsigned int threshold,
                       float inv_keep, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || Dh < 8 ||
      Dh > attn::kFwdMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t plan =
      dtype == 1 ? tc_smem_bytes(S, Dh)
                 : attn::fwd_smem_floats<kQTile>(S, Dh) * sizeof(float);
  if (plan > attn::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutArgs drop{seed, threshold, inv_keep};
  // fp32 on the CUDA cores (#1's row code), bf16 on the tensor cores.
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(qkv, mask, out, B, S, H, Dh, scale, drop,
                                  st);
    case 1:
      return launch<float, true>(qkv, mask, out, B, S, H, Dh, scale, drop,
                                 st);
    case 2:
    case 3:
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      return dropout ? launch_tc<true>(qkv, mask, out, B, S, H, Dh, scale,
                                       drop, st)
                     : launch_tc<false>(qkv, mask, out, B, S, H, Dh, scale,
                                        drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
