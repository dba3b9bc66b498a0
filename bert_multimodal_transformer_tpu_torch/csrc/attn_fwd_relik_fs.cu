// Flash-streamed ingredients rel-attention forward for Hopper (sm_90a):
// the long-sequence MAG-XLNet forward.
//
// Replaces the TPU kernel `_attn_fwd_relik_fs_kernel`
// (bert_multimodal_transformer_tpu/ops/fused_attention.py:4272), which the
// JAX model takes past its full-H rel reach when the bias ingredients are
// eligible (bi attention, P ≥ Q + K).
//
// What it computes, per batch row b, head h and query row q, from rw, rr
// [B, Q, D] (the content query and the scaled position query, head-major
// columns h·Dh + c), the position keys r [P, D] (P ≥ Q + K), k, v [B, K, D],
// ed [B, H, Q], segd and maskb [B, Q, K], all in the input dtype, over key
// blocks of kKBlock in order: the score of common.cuh's `relik_score`
//   s = ((rw · k) · scale + rr · r[Q − q + k]) + ed · segd + maskb
// (rel_shift(rr · rᵀ) + the segment delta + the mask, assembled here), then
// #6's online softmax with a running max m, a denominator l and a rescaled
// fp32 accumulator:
//   m' = max(m, max_k s);  α = exp(m − m');  e = exp(s − m');
//   l  ← l · α + Σ_k e;  e ← keep ? e · inv_keep : 0 (common.cuh's Philox
//   stream at (k >> 2, q, h + h_off, b + b_off));
//   acc ← acc · α + T(e) · v_block
// and out [B, Q, D] = T(acc / l), lse [B, H, Q] = m + log l (fp32), the
// residual #24 rebuilds p from. Nothing [B, H, Q, P]- or [B, H, Q, K]-sized
// exists. The reference's ef₀ term, constant along k, is softmax-invariant
// and is left out, as the TPU kernel leaves it out.
//
// What bounds it on the card: at the driver's S = 1024 (B=48, H=12, Dh=64)
// the three products (rw·kᵀ, rr·r over the shifted window, PV) are ~232
// GFLOP; rw, rr, k, v and out (377 MB) and segd and maskb (201 MB) are
// read or written once: operations bound at the bf16 tensor-core peak
// (0.23 ms, against 0.17 ms for the bytes).
//
// What the design does about that (bf16, `attn_fwd_relik_fs_tc_kernel`):
// #6's tensor-core plan (common.cuh, "the flash-streamed forwards on the
// tensor cores"), one block of 8 warps per (64-row q tile, head, batch
// row), 9216 blocks at the driver's shape. The TPU kernel shifts each row
// of a [qb, qb + kb] bd block with masked lane rolls (`_row_shift_block`);
// here each key block computes the wide product BDʷ = rr_tile ·
// r_windowᵀ [64 × 128] on mma.m16n8k16 (each warp 16 rows × 64 window
// rows) into an fp32 tile, and score (qi, j) reads BDʷ[qi][63 − qi + j]:
// twice the bd products of the direct form, all on the tensor cores, the
// shift index arithmetic. The window, rows Q − q0 − 63 + k0 .. + 127 of r
// (`load_r_window`'s start; rows outside [0, P) zero), is two 64-row
// chunks, and the next block's window shares the second: a two-slot ring
// of chunks, chunk i + 2 loaded while block i's scores, softmax and PV run.
// ac = rw · kᵀ on the same mma; the score (relik_score's order, ((ac ·
// scale + bd) + ed · segd) + maskb) is assembled in the accumulators and
// then written over BDʷ into the fp32 score tile, where #6's online
// softmax and Philox mask run (`tc_softmax_step`), writing e as bf16 for PV
// (its fp32 accumulators in registers, rescaled by α). rw and rr stay
// staged; k, the segd and maskb tiles and the r chunks come by cp.async,
// one block ahead (k, segd and maskb while the block's softmax and PV run,
// v while its bd and scores run); segd and maskb by plain loads where K %
// 8 ≠ 0 leaves their rows off 16 bytes. Any Q and K are taken, the ragged
// last tiles zero-filled and bounds-checked (the TPU kernel needs Q and K
// % 128 == 0), and any Dh % 8 == 0 up to 128 (rw, rr, k and r zero-padded
// to a multiple of 16 for the mma's k-depth). Shared plan
// (`tc_smem_bytes`, ops/fused_attention.py::relik_fs_fwd_smem_bytes):
// rw, rr, k, v and two r chunks, bf16 [64][L] each (L = Dh rounded up to
// 16, + 8); BDʷ fp32 [64][136], its first [64][72] then the scores and the
// bf16 weights [64][72] behind them; segd and maskb bf16 [64][72]; m, l,
// α and ed: 107 KB at Dh = 64 (two blocks an SM), 155 KB at Dh = 128.
//
// fp32 input keeps the CUDA-core kernel (`attn_fwd_relik_fs_kernel<float>`:
// fp32 dots from fp32 shared memory; shared plan `smem_floats`, q tiles
// [64][Dh] ×2, a k/v block [64][Dh+1], the r window [127][Dh+1], scores
// [64][64]: 98 KB at Dh = 64, 177 KB at Dh = 128): a TF32 product would
// not hold the fp32 checks. The entry dispatches on the dtype; a bf16
// call always launches the tensor-core kernel or returns the launch's
// error (cudaErrorMisalignedAddress where rw, rr, r, k or v does not start
// on the 16 bytes cp.async copies).

#include "common.cuh"

namespace {

using attn::DropoutArgs;

constexpr int kThreads = 256;   // 8 warps
constexpr int kQTile = 64;      // query rows per block
constexpr int kKBlock = 64;     // ops/fused_attention.py::FS_KEY_BLOCK
constexpr int kWin = kQTile + kKBlock - 1;  // r rows a (tile, block) reads
constexpr int kMaxDh = 128;
constexpr int kAccPerThread = kQTile * kMaxDh / kThreads;

// rw, rr tiles [kQTile][dh] each, k/v block [kKBlock][dh + 1], r window
// [kWin][dh + 1], scores [kQTile][kKBlock], the rows' m, l, α and ed
// [kQTile] each.
__host__ __device__ inline size_t smem_floats(int dh) {
  return 2 * (size_t)kQTile * dh + (size_t)(kKBlock + kWin) * (dh + 1) +
         (size_t)kQTile * kKBlock + 4 * (size_t)kQTile;
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_relik_fs_kernel(const T* __restrict__ rw,
                             const T* __restrict__ rr,
                             const T* __restrict__ r, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ ed,
                             const T* __restrict__ segd,
                             const T* __restrict__ maskb,
                             T* __restrict__ out, float* __restrict__ lse,
                             int Q, int K, int P, int H, int Dh, float scale,
                             DropoutArgs drop) {
  extern __shared__ float smem[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ld = Dh + 1;

  float* rws = smem;                       // [kQTile][Dh]
  float* rrs = rws + kQTile * Dh;          // [kQTile][Dh]
  float* kvs = rrs + kQTile * Dh;          // [kKBlock][Dh + 1]
  float* rwin = kvs + kKBlock * ld;        // [kWin][Dh + 1]
  float* ss = rwin + kWin * ld;            // [kQTile][kKBlock]
  float* m_s = ss + kQTile * kKBlock;      // [kQTile] running max
  float* l_s = m_s + kQTile;               // [kQTile] running denominator
  float* alpha_s = l_s + kQTile;           // [kQTile] this block's rescale
  float* ed_s = alpha_s + kQTile;          // [kQTile]

  const size_t q_off = (size_t)b * Q * D + h * Dh;
  const T* k_src = k + (size_t)b * K * D + h * Dh;
  const T* v_src = v + (size_t)b * K * D + h * Dh;
  const T* r_head = r + h * Dh;
  const size_t row_bh = ((size_t)b * H + h) * Q;   // ed and lse rows
  const size_t qk_row = (size_t)b * Q;             // segd and maskb rows
  const int q_rows = min(kQTile, Q - q0);

  for (int i = tid; i < kQTile * Dh; i += kThreads) {
    const int rr_ = i / Dh, c = i - rr_ * Dh;
    const bool live = rr_ < q_rows;
    const size_t at = q_off + (size_t)(q0 + rr_) * D + c;
    rws[i] = live ? attn::to_float(rw[at]) : 0.0f;
    rrs[i] = live ? attn::to_float(rr[at]) : 0.0f;
  }
  for (int i = tid; i < kQTile; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
    ed_s[i] = i < q_rows ? attn::to_float(ed[row_bh + q0 + i]) : 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKBlock) {
    const int k_rows = min(kKBlock, K - k0);
    __syncthreads();  // the previous block's PV readers are done
    attn::load_tile(kvs, k_src + (size_t)k0 * D, (size_t)D, k_rows, Dh);
    attn::load_r_window(rwin, r_head, D, P, Q - q0 - (kQTile - 1) + k0, kWin,
                        Dh);
    __syncthreads();
    for (int i = tid; i < q_rows * k_rows; i += kThreads) {
      const int rq = i / k_rows, j = i - rq * k_rows;
      const size_t qk = (qk_row + q0 + rq) * K + k0 + j;
      ss[rq * kKBlock + j] = attn::relik_score(
          rws + rq * Dh, rrs + rq * Dh, kvs + j * ld,
          rwin + (kQTile - 1 - rq + j) * ld, Dh, scale, ed_s[rq],
          attn::to_float(segd[qk]), attn::to_float(maskb[qk]));
    }
    __syncthreads();
    // The online softmax step, one warp per row (#6's).
    for (int rq = warp; rq < q_rows; rq += kThreads / 32) {
      float* sr = ss + rq * kKBlock;
      float mx = -INFINITY;
      for (int j = lane; j < k_rows; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[rq];
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
        const int qg = q0 + rq;
        for (int j0 = 4 * lane; j0 < k_rows; j0 += 128) {
          const uint4 bits =
              attn::dropout_bits4(drop, b, h, qg, (k0 + j0) >> 2);
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
        alpha_s[rq] = alpha;
        l_s[rq] = __fadd_rn(__fmul_rn(l_s[rq], alpha), sum);
        m_s[rq] = m_new;
      }
    }
    __syncthreads();  // k no longer needed: stage v
    attn::load_tile(kvs, v_src + (size_t)k0 * D, (size_t)D, k_rows, Dh);
    __syncthreads();
    // acc ← acc · α + T(e) · v_block
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      const int rq = i / Dh, c = i - rq * Dh;
      if (i < kQTile * Dh && rq < q_rows) {
        const float* er = ss + rq * kKBlock;
        float pv = 0.0f;
        for (int j = 0; j < k_rows; ++j) pv = fmaf(er[j], kvs[j * ld + c], pv);
        acc[a] = __fadd_rn(__fmul_rn(acc[a], alpha_s[rq]), pv);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    const int rq = i / Dh, c = i - rq * Dh;
    if (i < kQTile * Dh && rq < q_rows)
      out[q_off + (size_t)(q0 + rq) * D + c] =
          attn::from_float<T>(acc[a] / l_s[rq]);
  }
  for (int rq = tid; rq < q_rows; rq += kThreads)
    lse[row_bh + q0 + rq] = __fadd_rn(m_s[rq], logf(l_s[rq]));
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBdLd = 2 * kKBlock + 8;  // BDʷ row stride (fp32)

// Bytes of shared memory of one tensor-core block at head width dh (see
// the note): rw, rr, k, v and two r chunks (bf16 [64][L] each), BDʷ (the
// scores and weights inside it), segd and maskb, m, l, α and ed.
__host__ __device__ inline size_t tc_smem_bytes(int dh) {
  return 6 * (size_t)kQTile * attn::tc_ld(dh) * sizeof(bf16) +
         (size_t)kQTile * kBdLd * sizeof(float) +
         2 * (size_t)kQTile * attn::kTcEsLd * sizeof(bf16) +
         4 * (size_t)kQTile * sizeof(float);
}

template <bool kDropout>
__global__ void __launch_bounds__(attn::kTcThreads, 2)
    attn_fwd_relik_fs_tc_kernel(const bf16* __restrict__ rw,
                                const bf16* __restrict__ rr,
                                const bf16* __restrict__ r,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ ed,
                                const bf16* __restrict__ segd,
                                const bf16* __restrict__ maskb,
                                bf16* __restrict__ out,
                                float* __restrict__ lse, int Q, int K, int P,
                                int H, int Dh, float scale, int vec_qk,
                                DropoutArgs drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * Dh;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld = attn::tc_ld(Dh), kd = attn::tc_depth(Dh);
  const int tile = kQTile * ld;
  constexpr int kEs = attn::kTcEsLd;

  bf16* rws = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* rrs = rws + tile;                         // [64][ld]
  bf16* ks = rrs + tile;                          // [64][ld]
  bf16* rwin = ks + tile;                         // 2 × [64][ld] r chunks
  bf16* vs = rwin + 2 * tile;                     // [64][ld]
  float* bdw = reinterpret_cast<float*>(vs + tile);  // [64][kBdLd]
  float* ss = bdw;                        // [64][kTcSsLd], over BDʷ
  bf16* es = reinterpret_cast<bf16*>(bdw + kQTile * attn::kTcSsLd);
  bf16* sgs = reinterpret_cast<bf16*>(bdw + kQTile * kBdLd);  // [64][kEs]
  bf16* mks = sgs + kQTile * kEs;                             // [64][kEs]
  float* m_s = reinterpret_cast<float*>(mks + kQTile * kEs);
  float* l_s = m_s + kQTile;
  float* alpha_s = l_s + kQTile;
  float* ed_s = alpha_s + kQTile;

  const size_t q_off = (size_t)b * Q * D + h * Dh;
  const bf16* k_src = k + (size_t)b * K * D + h * Dh;
  const bf16* v_src = v + (size_t)b * K * D + h * Dh;
  const bf16* r_head = r + h * Dh;
  const size_t row_bh = ((size_t)b * H + h) * Q;   // ed and lse rows
  const size_t qk_row = (size_t)b * Q + q0;        // segd and maskb rows
  const int q_rows = min(kQTile, Q - q0);
  const int n_blocks = (K + kKBlock - 1) / kKBlock;
  const long long p_base = (long long)Q - q0 - (kQTile - 1);
  const attn::TcWarp w = attn::tc_warp(Dh);

  // The segd and maskb tiles of key block i: cp.async where their rows
  // lie on 16 bytes (vec_qk), plain loads where they do not.
  auto load_qk = [&](int i) {
    const int k0 = i * kKBlock, k_rows = min(kKBlock, K - k0);
    const bf16* sg = segd + qk_row * K + k0;
    const bf16* mk = maskb + qk_row * K + k0;
    if (vec_qk) {
      for (int x = tid; x < kQTile * kKBlock / 8; x += attn::kTcThreads) {
        const int rq = x / (kKBlock / 8), c = (x % (kKBlock / 8)) * 8;
        const bool ok = rq < q_rows && c < k_rows;
        const size_t at = (size_t)rq * K + c;
        attn::cp_async16(sgs + rq * kEs + c, ok ? sg + at : segd, ok);
        attn::cp_async16(mks + rq * kEs + c, ok ? mk + at : maskb, ok);
      }
    } else {
      for (int x = tid; x < kQTile * kKBlock; x += attn::kTcThreads) {
        const int rq = x / kKBlock, c = x % kKBlock;
        const bool ok = rq < q_rows && c < k_rows;
        const size_t at = (size_t)rq * K + c;
        sgs[rq * kEs + c] = ok ? sg[at] : __float2bfloat16(0.0f);
        mks[rq * kEs + c] = ok ? mk[at] : __float2bfloat16(0.0f);
      }
    }
  };
  auto load_k = [&](int i) {
    const int k0 = i * kKBlock;
    attn::tc_cp_rows(ks, ld, k_src, (size_t)D, k0, kKBlock, 0,
                     min(kKBlock, K - k0), Dh);
    load_qk(i);
  };
  auto load_chunk = [&](int c) {
    attn::relik_tc_r_chunk(rwin + (c & 1) * tile, ld, r_head, D, P,
                           p_base + (long long)c * kKBlock, Dh);
  };

  attn::tc_cp_rows(rws, ld, rw + q_off, (size_t)D, q0, kQTile, 0, q_rows, Dh);
  attn::tc_cp_rows(rrs, ld, rr + q_off, (size_t)D, q0, kQTile, 0, q_rows, Dh);
  load_chunk(0);
  load_chunk(1);
  load_k(0);
  attn::cp_async_commit();
  // The k-depth's pad columns of rw, rr, k and the r chunks stay zero.
  attn::tc_zero_cols(rws, ld, 5 * kQTile, Dh, kd);
  for (int x = tid; x < kQTile; x += attn::kTcThreads) {
    m_s[x] = -INFINITY;
    l_s[x] = 0.0f;
    alpha_s[x] = 0.0f;
    ed_s[x] = x < q_rows ? __bfloat162float(ed[row_bh + q0 + x]) : 0.0f;
  }
  float acc[attn::kTcPvTiles][4];
#pragma unroll
  for (int t = 0; t < attn::kTcPvTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int i = 0; i < n_blocks; ++i) {
    const int k0 = i * kKBlock;
    const int k_rows = min(kKBlock, K - k0);
    attn::cp_async_wait<0>();  // k, segd, maskb of block i; its r chunks
    __syncthreads();           // ... for every thread; block i − 1's PV done
    attn::tc_cp_rows(vs, ld, v_src, (size_t)D, k0, kKBlock, 0, k_rows, Dh);
    attn::cp_async_commit();
    // BDʷ = rr · window(i)ᵀ: warp column half c takes window rows 64c ..
    // 64c + 63, chunk i + c.
    {
      const int half = warp >> 2;
      float bd[8][4] = {};
      attn::tc_warp_abt<8>(bd, rrs + w.m0 * ld, ld,
                           rwin + ((i + half) & 1) * tile, ld, kd);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = half * kKBlock + t * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int rq = w.m0 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<float2*>(bdw + rq * kBdLd + c) =
              make_float2(bd[t][2 * hi], bd[t][2 * hi + 1]);
        }
      }
    }
    __syncthreads();  // BDʷ whole; chunk i read for the last time
    if (i + 2 <= n_blocks) load_chunk(i + 2);
    attn::cp_async_commit();
    // The scores in the accumulators: relik_score's order.
    float sc[4][4] = {};
    attn::tc_warp_abt<4>(sc, rws + w.m0 * ld, ld, ks + w.k0 * ld, ld, kd);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int rq = w.m0 + (lane >> 2) + 8 * hi;
        const float* bd_row = bdw + rq * kBdLd + (kQTile - 1 - rq);
        const float2 sg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sgs + rq * kEs + j));
        const float2 mk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(mks + rq * kEs + j));
        sc[t][2 * hi] = attn::relik_combine(sc[t][2 * hi], bd_row[j], scale,
                                            ed_s[rq], sg.x, mk.x);
        sc[t][2 * hi + 1] = attn::relik_combine(
            sc[t][2 * hi + 1], bd_row[j + 1], scale, ed_s[rq], sg.y, mk.y);
      }
    }
    __syncthreads();  // BDʷ, k, segd and maskb read: free for what follows
    if (i + 1 < n_blocks) load_k(i + 1);
    attn::cp_async_commit();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = w.k0 + t * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int rq = w.m0 + (lane >> 2) + 8 * hi;
        *reinterpret_cast<float2*>(ss + rq * attn::kTcSsLd + j) =
            make_float2(sc[t][2 * hi], sc[t][2 * hi + 1]);
      }
    }
    __syncthreads();
    attn::tc_softmax_step<kDropout>(ss, es, m_s, l_s, alpha_s, q_rows,
                                    k_rows, q0, k0, b, h, drop);
    attn::cp_async_wait<2>();  // v of block i
    __syncthreads();
    attn::tc_pv(acc, w, es, vs, ld, alpha_s);
  }
  attn::tc_store_out(acc, w, out + q_off + (size_t)q0 * D, D,
                     lse + row_bh + q0, m_s, l_s, q_rows);
}

template <bool kDropout>
int launch_tc(const void* rw, const void* rr, const void* r, const void* k,
              const void* v, const void* ed, const void* segd,
              const void* maskb, void* out, void* lse, int B, int Q, int K,
              int P, int H, int Dh, float scale, DropoutArgs drop,
              cudaStream_t stream) {
  const uintptr_t rows = reinterpret_cast<uintptr_t>(rw) |
                         reinterpret_cast<uintptr_t>(rr) |
                         reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (rows % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int vec_qk = K % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(segd) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(maskb) % 16 == 0;
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_relik_fs_tc_kernel<kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_relik_fs_tc_kernel<kDropout>
      <<<grid, attn::kTcThreads, tc_smem_bytes(Dh), stream>>>(
          static_cast<const bf16*>(rw), static_cast<const bf16*>(rr),
          static_cast<const bf16*>(r), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(ed),
          static_cast<const bf16*>(segd), static_cast<const bf16*>(maskb),
          static_cast<bf16*>(out), static_cast<float*>(lse), Q, K, P, H, Dh,
          scale, vec_qk, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kDropout>
int launch(const void* rw, const void* rr, const void* r, const void* k,
           const void* v, const void* ed, const void* segd,
           const void* maskb, void* out, void* lse, int B, int Q, int K,
           int P, int H, int Dh, float scale, DropoutArgs drop,
           cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const cudaError_t err = attn::allow_max_smem(
      attn_fwd_relik_fs_kernel<T, kDropout>, &attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + kQTile - 1) / kQTile, H, B);
  attn_fwd_relik_fs_kernel<T, kDropout>
      <<<grid, kThreads, smem_floats(Dh) * sizeof(float), stream>>>(
          static_cast<const T*>(rw), static_cast<const T*>(rr),
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ed),
          static_cast<const T*>(segd), static_cast<const T*>(maskb),
          static_cast<T*>(out), static_cast<float*>(lse), Q, K, P, H, Dh,
          scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for rw, rr, r, k, v, ed, segd, maskb
// and out; lse is [B, H, Q] fp32. P ≥ Q + K. dropout = 0 ignores
// seed/threshold/inv_keep; b_off/h_off (≥ 0) are the global batch row and
// head of the tensors' first (b, h) in the Philox counter (a
// tensor-parallel rank's shard). Returns the cudaError_t of the launch (0 on
// success); a shape the kernel does not take returns cudaErrorInvalidValue.
int attn_fwd_relik_fs(const void* rw, const void* rr, const void* r,
                      const void* k, const void* v, const void* ed,
                      const void* segd, const void* maskb, void* out,
                      void* lse, int B, int Q, int K, int P, int H, int Dh,
                      float scale, int dropout, unsigned long long seed,
                      unsigned int threshold, float inv_keep, int b_off,
                      int h_off, int dtype, void* stream) {
  if (B < 1 || Q < 1 || K < 1 || P < Q + K || H < 1 || Dh < 8 ||
      Dh > kMaxDh || Dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_off < 0 || h_off < 0) return (int)cudaErrorInvalidValue;
  const DropoutArgs drop{seed, threshold, inv_keep, b_off, h_off};
  switch (dtype * 2 + (dropout != 0)) {
    case 0:
      return launch<float, false>(rw, rr, r, k, v, ed, segd, maskb, out, lse,
                                  B, Q, K, P, H, Dh, scale, drop, st);
    case 1:
      return launch<float, true>(rw, rr, r, k, v, ed, segd, maskb, out, lse,
                                 B, Q, K, P, H, Dh, scale, drop, st);
    case 2:  // bf16 on the tensor cores (see the note)
      return launch_tc<false>(rw, rr, r, k, v, ed, segd, maskb, out, lse, B,
                              Q, K, P, H, Dh, scale, drop, st);
    case 3:
      return launch_tc<true>(rw, rr, r, k, v, ed, segd, maskb, out, lse, B,
                             Q, K, P, H, Dh, scale, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
