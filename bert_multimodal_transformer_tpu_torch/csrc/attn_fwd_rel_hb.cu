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
// What the design does about that (bf16): #4's tensor-core plan
// (attn_fwd_packed_hb.cu) with q and k/v from their own tensors (Q ≠ K)
// and the ebias in place of the [S] mask bias, the kernel bf16 #11 runs
// past K = 64 (attn_rel_full_tc.cuh's `attn_fwd_rel_tc_smem_kernel`,
// here without the saves, up to K = 640). One block of 8 warps per
// (32-row q tile, head, batch row), 9216 blocks at the training shape. The
// block's ebias rows are read first, 16 bytes a thread (plain loads where
// K % 8 ≠ 0 leaves them off 16 bytes), and written as fp32 into the score
// tile [32][keys + 4] they will be added to; the q tile comes by cp.async
// and k, then v, stream through one two-stage ring of 64-key blocks. QKᵀ
// runs on mma.sync.m16n8k16 (each warp a 16-row × 16-key slab of a block)
// and its epilogue adds in `fwd_rel_rows`' order, s = (dot · scale) + eb,
// over the bias in place. The softmax is common.cuh's `tc_hb_softmax_rows`
// (#4's: one warp a row in registers, the Philox keep test, p rounded to
// bf16 over its own score row); PV reads P by ldmatrix and v by
// ldmatrix.trans, its fp32 accumulators in registers. Shared plan
// (`rel_tc::fwd_smem_bytes`, ops/fused_attention.py::
// rel_hb_fwd_smem_bytes): scores [32][keys + 4] fp32, q [32][L] and the
// ring 2 × [64][L] bf16 (L = Dh rounded up to 16, + 8): 103 KB at K = 640,
// Dh = 64 (two blocks an SM), 123 KB at Dh = 128. Launched from here it
// ran as fast as #14's former copy of it, with the same bits (bf16 B=48
// Q=K=512: 1.1535-1.1634 ms against 1.1593-1.1644 at rate 0 on an NVIDIA
// H100 80GB HBM3 at 700 W, one call of chip_ab.py).
//
// What changes against #11: a row's softmax arithmetic is `fwd_rows`', so
// the probs differ from #11's CUDA-core kernel only through the scores,
// whose dots the tensor cores sum in another order; bf16 #14 is held to
// #11 within the forward bound (past K = 64 the two run one kernel). fp32
// input keeps the CUDA-core kernel, which runs `fwd_rel_rows` (#11's row
// code) with 32-row tiles (shared plan `rel_fwd_smem_floats<32>`: 107 KB
// at K = 640, Dh = 64) and gives #11's bits. The entry dispatches on the
// dtype; a bf16 call always launches the tensor-core kernel or returns the
// launch's error (cudaErrorMisalignedAddress where q, k or v does not
// start on the 16 bytes cp.async copies).

#include "attn_rel_full_tc.cuh"

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
      dtype == 1 ? rel_tc::fwd_smem_bytes(K, Dh)
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
    case 3: {
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
      using bf16 = __nv_bfloat16;
      const rel_tc::FwdArgs a{static_cast<const bf16*>(q),
                              static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v),
                              static_cast<const bf16*>(ebias),
                              static_cast<bf16*>(out),
                              nullptr,
                              nullptr,
                              B,
                              Q,
                              K,
                              H,
                              Dh,
                              scale};
      return dropout ? rel_tc::launch_fwd_smem<true, false>(a, drop, st)
                     : rel_tc::launch_fwd_smem<false, false>(a, drop, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
