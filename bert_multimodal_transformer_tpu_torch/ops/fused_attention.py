"""Packed, split and rel attention, forward and backward (port of
``ops/fused_attention.py``'s ``fused_attention_packed`` and
``fused_rel_attention`` in their full-H, head-blocked and flash-streamed
tiers, the split-tensor ``fused_attention`` and its tensor-parallel
``fused_attention_tp``, ``fused_attention_qkvproj`` with the QKV
projection inside, and ``fused_rel_attention_ingredients`` in its
full-H and flash-streamed tiers: prob dropout, saved probs, and the
backward kernels of each).

The packed kernels, each with its plain PyTorch version beside it:

* #1 ``attn_fwd_packed_cuda`` → ``csrc/attn_fwd_packed.cu``, plain version
  ``attn_fwd_packed_reference``: softmax(QKᵀ·scale + bias)·V with optional
  prob dropout and the probs p/pd saved for the backward;
* #3 ``attn_bwd_packed_saved_cuda`` → ``csrc/attn_bwd_packed_saved.cu``,
  plain version ``attn_bwd_packed_saved_reference``: dqkv from saved p/pd;
* #2 ``attn_bwd_packed_cuda`` → ``csrc/attn_bwd_packed.cu``, plain version
  ``attn_bwd_packed_reference``: dqkv with the probs recomputed and the
  keep mask replayed from the forward's seed.

The long-sequence packed tiers, taken past the full-H reach
(``packed_tier``), save nothing S²-sized:

* #4 ``attn_fwd_packed_hb_cuda`` → ``csrc/attn_fwd_packed_hb.cu`` and #5
  ``attn_bwd_packed_hb_cuda`` → ``csrc/attn_bwd_packed_hb.cu``, plain
  versions ``attn_{fwd,bwd}_packed_hb_reference``: #1's and #2's
  functions (whole-row softmax, recompute backward) up to
  ``HB_MAX_SEQ_LEN``;
* #6 ``attn_fwd_packed_fs_cuda`` → ``csrc/attn_fwd_packed_fs.cu`` and #7
  ``attn_bwd_packed_fs_cuda`` → ``csrc/attn_bwd_packed_fs.cu``, plain
  versions ``attn_{fwd,bwd}_packed_fs_reference``: the online softmax over
  key blocks with the lse residual, and the flash backward from it, at any
  S.

In bf16, #1-#11, #13-#17 and #20-#24 run their products on the tensor
cores (``mma.sync`` from ``ldmatrix``,
operands staged by ``cp.async``); fp32 keeps their CUDA-core kernels.
Their shared-memory plans are ``full_tc_fwd_smem_bytes`` (#1, #8: the
scores in registers up to ``FULL_TC_REG_MAX_SEQ_LEN``, #4's score tile
past it),
``full_tc_bwd_smem_bytes`` (#3, #10), ``full_tc_bwd_recompute_smem_bytes``
(#2, #9), ``rel_full_tc_fwd_smem_bytes`` (#11:
registers up to ``REL_TC_REG_MAX_K``, #14's score tile past it),
``rel_full_tc_bwd_smem_bytes`` with ``rel_full_tc_bwd_q_chunk`` (#13),
``relik_full_tc_fwd_smem_bytes`` (#20), ``relik_full_tc_bwd_smem_bytes``
with ``relik_full_tc_bwd_q_chunk`` (#21, and #22 from the saved probs),
``hb_fwd_smem_bytes``, ``hb_bwd_smem_bytes``, ``fs_fwd_smem_bytes``,
``fs_bwd_smem_bytes``, ``rel_hb_fwd_smem_bytes``,
``rel_hb_bwd_smem_bytes``, ``rel_fs_fwd_smem_bytes``,
``rel_fs_bwd_smem_bytes``, ``relik_fs_fwd_smem_bytes`` and
``relik_fs_bwd_smem_bytes``; each wrapper checks its plan before the
launch and raises past it.

The split-layout kernels #8, #10 and #9 (``attn_fwd_split_cuda``,
``attn_bwd_split_saved_cuda``, ``attn_bwd_split_cuda``) are #1-#3 on
separate q, k, v [B, H, S, Dh], the layout of a tensor-parallel rank's
heads (the section after the packed tiers). #18 and #19
(``attn_fwd_qkvproj_cuda``, ``attn_bwd_qkvproj_cuda``) are #1 and #3 with
the QKV projection inside: x·W + b computed in the forward kernel, dx =
dqkv·Wᵀ in the backward's (``fused_attention_qkvproj``, the section after
the split layout).

The rel kernels #11, #13 and #12 (``attn_fwd_rel_cuda``,
``attn_bwd_rel_saved_cuda``, ``attn_bwd_rel_cuda``), their head-blocked
tier #14/#15 and their flash-streamed tier #16/#17 are the packed tiers'
twins for separate q [B, Q, D] and k, v [B, K, D] under a full
differentiable score bias ebias [B, H, Q, K] in place of the [B, S] mask;
the ingredients kernels #20-#22 (full-H) and #23/#24 (flash-streamed)
build that bias themselves from its ingredients (the sections at the end
of this module).

Each CUDA wrapper launches on PyTorch's current stream and counts its
launches in ``<wrapper>.launches``; each packed and split plain version
counts its calls in ``<function>.calls``, which shows the path a CPU call
took.
``fused_attention_packed``, ``fused_attention``,
``fused_attention_qkvproj`` and ``fused_rel_attention`` dispatch on the
tensor's device: a CUDA tensor launches the kernels or raises, a CPU
tensor takes the plain versions. While ``torch.export`` traces a model
(``torch.compiler.is_exporting()``), their no-grad branches (and
``fused_rel_attention_ingredients``') call the kernel's ``magtorch``
custom op instead (``ops/export_ops.py``), which a serving artifact
holds. ``FusedAttentionPacked``,
``FusedAttention``, ``FusedAttentionQKVProj`` and ``FusedRelAttention`` are
the autograd functions (the JAX ``_fap_fwd``/``_fap_bwd``,
``_fa_fwd``/``_fa_bwd``, ``_faq_fwd``/``_faq_bwd``,
``_frel_fwd``/``_frel_bwd``).

The dropout stream: element (b, h, q, k) is kept iff its 32-bit draw is
``>= dropout_threshold(rate)``, with the draw taken from Philox4x32-10 at
counter ``(k >> 2, q, h, b)`` and key ``(seed & 0xffffffff, seed >> 32)``,
word ``k & 3`` (``philox4x32_10`` here; ``csrc/common.cuh`` on the card).
It is a pure function of (seed, b, h, q, k): the mask does not depend on
how a kernel tiles the work, and the recompute backward replays it
exactly. Every tier draws from the same stream, so for one seed the
full-H, head-blocked and flash-streamed tiers drop the same elements. The
seed is drawn on the host from an explicit CPU ``torch.Generator``, or
under threefry2x32 replayed from the site's JAX key as the JAX entries
draw it, ``randint(key, (1, 1), 0, 2**31 − 1)`` (a ``dropout_rng`` that
is an ``ops/dropout.py::SiteKey``; ``draw_seed``); nothing reads a device
tensor back.

``ops/kernels.py`` builds ``csrc/*.cu`` into one shared library with a
plain C interface at first use, binds it with ctypes and launches its
entries.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bert_multimodal_transformer_tpu_torch.ops.dropout import draw_seed
from bert_multimodal_transformer_tpu_torch.ops.kernels import (
    DTYPE_CODES as _DTYPE_CODES,
    MAX_SMEM_BYTES,
    check_sm90,
    launch as _launch,
    ptr as _ptr,
)

# Longest sequence the forward's shared-memory plan takes
# (max_position_embeddings of bert-base).
MAX_SEQ_LEN = 512
MAX_HEAD_DIM = 128
# Longest sequence of the head-blocked tier (#4, #5): the JAX package's
# head-blocked reach at bert-base bf16 (BENCHMARKS.md "Long-sequence
# scaling"), inside both kernels' shared-memory plans at Dh ≤ 128
# (``hb_fwd_smem_bytes``, ``hb_bwd_smem_bytes``). Past it the
# flash-streamed tier (#6, #7) takes any S.
HB_MAX_SEQ_LEN = 640
# The key-block width of #6's online softmax (``csrc/attn_fwd_packed_fs.cu``
# kKBlock), which its plain version repeats.
FS_KEY_BLOCK = 64
# Save the probs for the backward while they stay under this many bytes
# per call (the JAX package's auto policy).
SAVE_PROBS_CAP_BYTES = 256 * 1024 * 1024


# ---- the dropout stream ---------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """uint32 threshold t such that P(draw >= t) = 1 − rate (the JAX
    package's ``_dropout_threshold``)."""
    return min(int(round(rate * 4294967296.0)), 4294967295)


def inv_keep(rate: float) -> float:
    """The kept elements' scale 1 / (1 − rate), rounded to fp32 as the
    kernels use it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of m · x (m and x below 2^32) in int64
    arithmetic that never overflows: x is split into 16-bit halves."""
    a = m * (x & 0xFFFF)                   # < 2^48
    s = m * (x >> 16) + (a >> 16)          # < 2^49
    return s >> 16, ((s & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values.
    ``counter`` is four broadcastable tensors (x, y, z, w), ``key`` two
    ints or tensors; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: int, b: int, h: int, s_q: int, s_k: int,
                 device=None, k0: int = 0, b0: int = 0,
                 h0: int = 0) -> torch.Tensor:
    """The [B, H, Sq, Sk] 32-bit draws (int64) of the dropout stream, for
    keys k0 .. k0 + Sk − 1 of batch rows b0 .. b0 + B − 1 and heads
    h0 .. h0 + H − 1 (a shard's slice of a larger [B, H, Sq, Sk])."""
    first, n4 = k0 // 4, (k0 + s_k + 3) // 4 - k0 // 4
    shape = (b, h, s_q, n4)

    def axis(n, dim, start=0):
        view = [1, 1, 1, 1]
        view[dim] = n
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=device).view(view).expand(shape)

    words = philox4x32_10(
        (axis(n4, 3, first), axis(s_q, 2), axis(h, 1, h0), axis(b, 0, b0)),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    lead = k0 - 4 * first
    return torch.stack(words, dim=-1).reshape(b, h, s_q, 4 * n4)[
        ..., lead:lead + s_k]


def dropout_keep_mask(seed: int, b: int, h: int, s_q: int, s_k: int,
                      rate: float, device=None, k0: int = 0, b0: int = 0,
                      h0: int = 0) -> torch.Tensor:
    """Bool [B, H, Sq, Sk]: True where the element (keys from k0, batch
    rows from b0, heads from h0) is kept."""
    return dropout_bits(seed, b, h, s_q, s_k, device, k0, b0, h0) >= (
        dropout_threshold(rate))


# ---- plain PyTorch versions -----------------------------------------------


def _counted(fn):
    """``fn`` counting its calls in ``.calls``: the tier a CPU call took
    shows there."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        counted.calls += 1
        return fn(*args, **kwargs)

    counted.calls = 0
    return counted


def _heads(qkv: torch.Tensor, n_heads: int):
    b, s, d3 = qkv.shape
    return qkv.reshape(b, s, 3, n_heads, d3 // (3 * n_heads)).permute(
        2, 0, 3, 1, 4)


def _ctx_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).permute(0, 2, 1, 3)


def _pack(dq, dk, dv) -> torch.Tensor:
    """[B, H, S, Dh] ×3 → [B, S, 3·D] with the reshape(B, S, 3, H, Dh)
    column packing."""
    b, h, s, dh = dq.shape
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        b, s, 3 * h * dh)


def _split_probs(q, k, attention_mask, scale):
    """fp32 scores of q, k [B, H, S, Dh] (scale after the dot, then the
    (1−m)·−10000 bias) and their softmax, as the kernels compute them."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attention_mask is not None:
        bias = (1.0 - attention_mask.float()) * -10000.0
        scores = scores + bias[:, None, None, :]
    return torch.softmax(scores, dim=-1)


def _probs(qkv, attention_mask, n_heads, scale):
    q, k, _ = _heads(qkv, n_heads)
    return _split_probs(q, k, attention_mask, scale)


def _dropped(p, seed, rate, b_off=0, h_off=0):
    """p with the Philox keep mask applied (a kept element scaled by
    1/(1−rate) in fp32); ``b_off``/``h_off``: the global batch row and
    head of p's first (b, h)."""
    if rate <= 0.0:
        return p
    b, h, s_q, s_k = p.shape
    keep = dropout_keep_mask(seed, b, h, s_q, s_k, rate, p.device, b0=b_off,
                             h0=h_off)
    return torch.where(keep, p * inv_keep(rate), 0.0)


def _fwd_whole_rows(qkv, attention_mask, n_heads, scale, rate, seed):
    """(out, p, pd) of the whole-row forward (#1's and #4's function)."""
    dtype = qkv.dtype
    b, s, d3 = qkv.shape
    p = _probs(qkv, attention_mask, n_heads, scale)
    pd = _dropped(p, seed, rate)
    v = _heads(qkv, n_heads)[2]
    ctx = torch.matmul(pd.to(dtype).float(), v.float()).to(dtype)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, d3 // 3), p, pd


@_counted
def attn_fwd_packed_reference(
    qkv: torch.Tensor,                        # [B, S, 3·D]
    attention_mask: Optional[torch.Tensor],   # [B, S], 1 = real token
    *,
    n_heads: int,
    scale: float,
    rate: float = 0.0,
    seed: int = 0,
    save: bool = False,
):
    """Plain version of kernel #1: fp32 softmax; with ``save`` the probs p
    rounded to the input dtype; at ``rate > 0`` the keep mask of the
    Philox stream and the 1/(1−rate) scale applied in fp32 (and pd
    rounded, with ``save``); the dropped probs rounded to the input dtype
    for a PV product accumulated in fp32; the output in the input dtype.
    Returns out [B, S, D], or (out, p, pd) [B, H, S, S] with ``save`` (pd
    is p at rate 0)."""
    out, p, pd = _fwd_whole_rows(qkv, attention_mask, n_heads, scale, rate,
                                 seed)
    if not save:
        return out
    p_c = p.to(qkv.dtype)
    return out, p_c, (pd.to(qkv.dtype) if rate > 0.0 else p_c)


def _split_vjp(p, pd, pd_c, q, k, v, g, scale):
    """The backward kernels' shared math on q, k, v and the context
    gradient g [B, H, S, Dh]: dV = pd_cᵀ·g, d(pd) = g·Vᵀ, t = pd⊙d(pd),
    ds = (t − p·Σ_k t)·scale rounded to the input dtype, dQ = ds_c·K,
    dK = ds_cᵀ·Q; all products accumulated in fp32. Returns (dq, dk,
    dv)."""
    dtype = q.dtype
    q, k, v, g = (x.float() for x in (q, k, v, g))
    dv = torch.matmul(pd_c.float().transpose(-1, -2), g).to(dtype)
    t = pd * torch.matmul(g, v.transpose(-1, -2))
    ds = (t - p * t.sum(dim=-1, keepdim=True)) * scale
    ds_c = ds.to(dtype).float()
    dq = torch.matmul(ds_c, k).to(dtype)
    dk = torch.matmul(ds_c.transpose(-1, -2), q).to(dtype)
    return dq, dk, dv


def _vjp(p, pd, pd_c, qkv, g, n_heads, scale):
    """``_split_vjp`` on the packed layout; returns dqkv [B, S, 3·D]."""
    return _pack(*_split_vjp(p, pd, pd_c, *_heads(qkv, n_heads),
                             _ctx_heads(g, n_heads), scale))


def _bwd_recompute(qkv, attention_mask, seed, g, n_heads, scale, rate):
    """dqkv of the recompute backward (#2's and #5's function)."""
    p = _probs(qkv, attention_mask, n_heads, scale)
    pd = _dropped(p, seed, rate)
    return _vjp(p, pd, pd.to(qkv.dtype), qkv, g, n_heads, scale)


@_counted
def attn_bwd_packed_reference(
    qkv: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    seed: int,
    g: torch.Tensor,                          # [B, S, D]
    *,
    n_heads: int,
    scale: float,
    rate: float = 0.0,
) -> torch.Tensor:
    """Plain version of kernel #2: the probs recomputed in fp32, the keep
    mask replayed from ``seed``, pd kept in fp32 for the VJP and rounded
    (pd_c) for the dV product. Returns dqkv [B, S, 3·D]."""
    return _bwd_recompute(qkv, attention_mask, seed, g, n_heads, scale, rate)


@_counted
def attn_bwd_packed_saved_reference(
    p: torch.Tensor,                          # [B, H, S, S]
    pd: torch.Tensor,
    qkv: torch.Tensor,
    g: torch.Tensor,
    *,
    n_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of kernel #3: the VJP from the saved p and pd (input
    dtype, read as fp32). Returns dqkv [B, S, 3·D]."""
    return _vjp(p.float(), pd.float(), pd, qkv, g, n_heads, scale)


def dqkv_bf16_bound(ref, p, pd, qkv, g, *, n_heads, scale) -> torch.Tensor:
    """Elementwise bound on how far two bf16 dqkv of this math may lie
    apart when they come from the same inputs but sum in different orders
    (a kernel and its plain version, or kernels #2 and #3).

    Each side rounds pd_c, ds_c and its output to bf16 once; a rounding
    may land one ulp (≤ 2^-7 relative) the other way. A flip of one pd_c
    or ds_c element moves dqkv by that ulp times the other factor, so the
    sum of all flips is at most 2^-7 times the products taken over
    absolute values, A = pack(|ds|·|K|, |ds|ᵀ·|Q|, |pd|ᵀ·|g|), with |ds|
    bounded by the magnitude of its terms (|t| + |p|·Σ|t|)·scale (which
    also covers #3 reading p and pd rounded where #2 keeps them in fp32).
    Returns 2^-7·(|ref| + A) + 2^-17."""
    return _pack(*split_grads_bf16_bound(
        _heads(ref, n_heads), p, pd, *_heads(qkv, n_heads),
        _ctx_heads(g, n_heads), scale=scale))


def split_grads_bf16_bound(refs, p, pd, q, k, v, g, *, scale):
    """``dqkv_bf16_bound`` on the split layout: refs = (dq, dk, dv) and q,
    k, v, g [B, H, S, Dh]; returns the bounds of dq, dk and dv."""
    q, k, v, g = (x.float().abs() for x in (q, k, v, g))
    p, pd = p.float().abs(), pd.float().abs()
    t = pd * torch.matmul(g, v.transpose(-1, -2))
    ds = (t + p * t.sum(dim=-1, keepdim=True)) * scale
    a = (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
         torch.matmul(pd.transpose(-1, -2), g))
    return tuple(2.0 ** -7 * (r.float().abs() + x) + 2.0 ** -17
                 for r, x in zip(refs, a))


# ---- the long-sequence tiers: head-blocked (#4, #5), flash-streamed (#6, #7)


@_counted
def attn_fwd_packed_hb_reference(qkv, attention_mask, *, n_heads, scale,
                                 rate=0.0, seed=0):
    """Plain version of kernel #4: #1's function (whole-row fp32 softmax,
    the Philox mask, the dropped probs rounded for PV), nothing saved.
    Returns out [B, S, D]."""
    return _fwd_whole_rows(qkv, attention_mask, n_heads, scale, rate,
                           seed)[0]


@_counted
def attn_bwd_packed_hb_reference(qkv, attention_mask, seed, g, *, n_heads,
                                 scale, rate=0.0):
    """Plain version of kernel #5: #2's function, the probs recomputed and
    the keep mask replayed. Returns dqkv [B, S, 3·D]."""
    return _bwd_recompute(qkv, attention_mask, seed, g, n_heads, scale, rate)


def _bias(attention_mask, b, s, device):
    """The fp32 [B, S] score bias (1 − mask) · −10000 (zeros for None)."""
    if attention_mask is None:
        return torch.zeros(b, s, device=device)
    return (1.0 - attention_mask.float()) * -10000.0


@_counted
def attn_fwd_packed_fs_reference(qkv, attention_mask, *, n_heads, scale,
                                 rate=0.0, seed=0):
    """Plain version of kernel #6: the online softmax over key blocks of
    ``FS_KEY_BLOCK``, the kernel's recurrence and rounding points: per
    block m' = max(m, max s), α = exp(m − m'), e = exp(s − m'),
    l ← l·α + Σe (undropped), e dropped by the Philox mask and rounded to
    the input dtype, acc ← acc·α + e·V in fp32; then out = acc / l in the
    input dtype and lse = m + log l. Returns (out [B, S, D], lse [B, H, S]
    fp32)."""
    dtype = qkv.dtype
    b, s, d3 = qkv.shape
    q, k, v = (x.float() for x in _heads(qkv, n_heads))
    bias = _bias(attention_mask, b, s, qkv.device)
    m = torch.full(q.shape[:3], -float("inf"), device=qkv.device)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, s, FS_KEY_BLOCK):
        k1 = min(k0 + FS_KEY_BLOCK, s)
        sb = (torch.matmul(q, k[:, :, k0:k1].transpose(-1, -2)) * scale
              + bias[:, None, None, k0:k1])
        m_new = torch.maximum(m, sb.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sb - m_new[..., None])
        den = den * alpha + e.sum(dim=-1)
        if rate > 0.0:
            keep = dropout_keep_mask(seed, b, n_heads, s, k1 - k0, rate,
                                     qkv.device, k0)
            e = torch.where(keep, e * inv_keep(rate), 0.0)
        acc = acc * alpha[..., None] + torch.matmul(e.to(dtype).float(),
                                                    v[:, :, k0:k1])
        m = m_new
    out = (acc / den[..., None]).to(dtype)
    return (out.permute(0, 2, 1, 3).reshape(b, s, d3 // 3),
            m + torch.log(den))


@_counted
def attn_bwd_packed_fs_reference(qkv, attention_mask, seed, o, lse, g, *,
                                 n_heads, scale, rate=0.0):
    """Plain version of kernel #7: p = exp(s·scale + bias − lse) rebuilt
    from the forward's lse, δ = Σ g⊙o from the rounded output o, d(pd) =
    g·Vᵀ; with the replayed keep mask pd = keep·p/(1−rate) and dp =
    keep·d(pd)/(1−rate); ds = (p·(dp − δ))·scale; ds_c and pd_c rounded to
    the input dtype; dQ = ds_c·K, dK = ds_cᵀ·Q, dV = pd_cᵀ·g accumulated
    in fp32. Returns dqkv [B, S, 3·D]."""
    dtype = qkv.dtype
    b, s, _ = qkv.shape
    q, k, v = (x.float() for x in _heads(qkv, n_heads))
    gh, oh = (_ctx_heads(x, n_heads).float() for x in (g, o))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    bias = _bias(attention_mask, b, s, qkv.device)
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  + bias[:, None, None, :] - lse[..., None])
    dp = torch.matmul(gh, v.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, n_heads, s, s, rate, qkv.device)
        pd = torch.where(keep, p * inv_keep(rate), 0.0)
        dp = torch.where(keep, dp * inv_keep(rate), 0.0)
    ds_c = ((p * (dp - delta)) * scale).to(dtype).float()
    dq = torch.matmul(ds_c, k).to(dtype)
    dk = torch.matmul(ds_c.transpose(-1, -2), q).to(dtype)
    dv = torch.matmul(pd.to(dtype).float().transpose(-1, -2), gh).to(dtype)
    return _pack(dq, dk, dv)


# ---- CUDA wrappers ----------------------------------------------------------


def bwd_smem_bytes(s: int, dh: int) -> int:
    """Shared memory of one backward block (``csrc/common.cuh``'s
    ``bwd_smem_floats``): two [S][Dh+1] staging tiles, two [S][S] tiles
    and the [S] bias, in fp32."""
    return 4 * (2 * s * (dh + 1) + 2 * s * s + s)


def max_bwd_seq_len(dh: int) -> int:
    """Longest S the backward kernels take at head width ``dh`` (140 at
    Dh = 64, 117 at Dh = 128)."""
    s = 1
    while bwd_smem_bytes(s + 1, dh) <= MAX_SMEM_BYTES:
        s += 1
    return s


def _check_geometry(qkv: torch.Tensor, n_heads: int):
    if qkv.dim() != 3:
        raise ValueError(
            f"qkv must be [B, S, 3·D], got shape {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    if d3 % 3 != 0:
        raise ValueError(f"packed QKV last dim must be 3·D, got {d3}")
    d = d3 // 3
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    return b, s, d, d // n_heads


def _check_cuda(name: str, qkv: torch.Tensor, n_heads: int,
                max_s: Optional[int]):
    """The checks every CUDA wrapper makes on qkv (``max_s`` None: any S);
    returns (b, s, d, dh)."""
    if not qkv.is_cuda:
        raise ValueError(f"{name}: qkv must be a CUDA tensor, got "
                         f"{qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"{name}: qkv dtype {qkv.dtype} not supported (float32, "
            "bfloat16)")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(
            f"{name}: qkv must be a contiguous [B, S, 3·D] tensor, got "
            f"shape {tuple(qkv.shape)} contiguous={qkv.is_contiguous()}")
    b, s, d, dh = _check_geometry(qkv, n_heads)
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if max_s is not None and s > max_s:
        raise ValueError(f"{name}: S={s} exceeds the kernel's {max_s}")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"B={b} or H={n_heads} exceeds a grid dimension")
    check_sm90(qkv)
    return b, s, d, dh


def _mask_arg(attention_mask, qkv, b, s):
    """The fp32 [B, S] mask the kernels read (None for no padding)."""
    if attention_mask is None:
        return None
    if tuple(attention_mask.shape) != (b, s):
        raise ValueError(
            f"attention_mask shape {tuple(attention_mask.shape)} != {(b, s)}")
    if attention_mask.device != qkv.device:
        raise ValueError("attention_mask and qkv on different devices")
    return attention_mask.to(torch.float32).contiguous()


def _like(name, t, qkv, shape):
    if (t.device != qkv.device or t.dtype != qkv.dtype
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {qkv.dtype} tensor of shape "
            f"{shape} on {qkv.device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} contiguous={t.is_contiguous()}")


def _check_lse(lse, x, b, n_heads, q_len):
    """The checks on an fs tier's lse residual [B, H, Q] (fp32, on x's
    device, contiguous)."""
    if (lse.dtype != torch.float32 or lse.device != x.device
            or tuple(lse.shape) != (b, n_heads, q_len)
            or not lse.is_contiguous()):
        raise ValueError(
            f"lse must be a contiguous float32 tensor of shape "
            f"{(b, n_heads, q_len)} on {x.device}, got {lse.dtype} "
            f"{tuple(lse.shape)} on {lse.device}")


def _drop_args(rate: float, seed: int):
    if rate <= 0.0:
        return [0, 0, 0, 0.0]
    return [1, int(seed) & 0xFFFFFFFFFFFFFFFF, dropout_threshold(rate),
            inv_keep(rate)]


def attn_fwd_packed_cuda(
    qkv: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    *,
    n_heads: int,
    scale: float,
    rate: float = 0.0,
    seed: int = 0,
    save: bool = False,
):
    """Launch kernel #1 (``csrc/attn_fwd_packed.cu``) on ``qkv`` [B, S, 3·D]
    (CUDA, fp32 or bf16, contiguous): bf16 on the tensor cores (its plan,
    ``full_tc_fwd_smem_bytes``, fits every S ≤ ``MAX_SEQ_LEN``), fp32 on
    the CUDA cores. Returns out
    [B, S, D], or (out, p, pd) with ``save`` (pd is p at rate 0). Raises on
    anything the kernel does not take and on a failed launch; never falls
    back."""
    b, s, d, dh = _check_cuda("attn_fwd_packed", qkv, n_heads, MAX_SEQ_LEN)
    mask = _mask_arg(attention_mask, qkv, b, s)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    p = pd = None
    if save:
        p = torch.empty((b, n_heads, s, s), dtype=qkv.dtype,
                        device=qkv.device)
        pd = torch.empty_like(p) if rate > 0.0 else p
    _launch("attn_fwd_packed", qkv.data_ptr(), _ptr(mask), out.data_ptr(),
            _ptr(p), _ptr(pd) if rate > 0.0 else None, b, s, n_heads, dh,
            float(scale), *_drop_args(rate, seed),
            _DTYPE_CODES[qkv.dtype], device=qkv.device)
    attn_fwd_packed_cuda.launches += 1
    return (out, p, pd) if save else out


def attn_bwd_packed_cuda(
    qkv: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    seed: int,
    g: torch.Tensor,
    *,
    n_heads: int,
    scale: float,
    rate: float = 0.0,
) -> torch.Tensor:
    """Launch kernel #2 (``csrc/attn_bwd_packed.cu``): dqkv [B, S, 3·D]
    with the probs recomputed and the keep mask replayed from ``seed``;
    bf16 on the tensor cores, #9's kernel through the packed strides (its
    plan, ``full_tc_bwd_recompute_smem_bytes``, fits the whole reach),
    fp32 on the CUDA cores."""
    b, s, d, dh = _check_cuda("attn_bwd_packed", qkv, n_heads,
                              max_bwd_seq_len(qkv.shape[-1] // 3 // n_heads))
    mask = _mask_arg(attention_mask, qkv, b, s)
    _like("g", g, qkv, (b, s, d))
    dqkv = torch.empty_like(qkv)
    _launch("attn_bwd_packed", qkv.data_ptr(), _ptr(mask), g.data_ptr(),
            dqkv.data_ptr(), b, s, n_heads, dh, float(scale),
            *_drop_args(rate, seed), _DTYPE_CODES[qkv.dtype],
            device=qkv.device)
    attn_bwd_packed_cuda.launches += 1
    return dqkv


def attn_bwd_packed_saved_cuda(
    p: torch.Tensor,
    pd: torch.Tensor,
    qkv: torch.Tensor,
    g: torch.Tensor,
    *,
    n_heads: int,
    scale: float,
) -> torch.Tensor:
    """Launch kernel #3 (``csrc/attn_bwd_packed_saved.cu``): dqkv
    [B, S, 3·D] from the saved probs p and pd [B, H, S, S]; bf16 on the
    tensor cores (its plan, ``full_tc_bwd_smem_bytes``, fits the whole
    reach), fp32 on the CUDA cores."""
    b, s, d, dh = _check_cuda("attn_bwd_packed_saved", qkv, n_heads,
                              max_bwd_seq_len(qkv.shape[-1] // 3 // n_heads))
    _like("p", p, qkv, (b, n_heads, s, s))
    _like("pd", pd, qkv, (b, n_heads, s, s))
    _like("g", g, qkv, (b, s, d))
    dqkv = torch.empty_like(qkv)
    _launch("attn_bwd_packed_saved", p.data_ptr(), pd.data_ptr(),
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, s, n_heads, dh,
            float(scale), _DTYPE_CODES[qkv.dtype], device=qkv.device)
    attn_bwd_packed_saved_cuda.launches += 1
    return dqkv


def hb_bwd_smem_bytes(s: int, dh: int, itemsize: int = 2) -> int:
    """Shared memory of the larger of #5's blocks at sequence length ``s``
    and head width ``dh``. bf16 (itemsize 2, the tensor-core passes of
    ``csrc/attn_bwd_packed_tc.cuh`` with their own statistics, at any S):
    the dK/dV block's K and V and its two-stage Q and g rings, bf16
    [64][``_tc_ld``] each, the bf16 pd_c and ds_c tiles [64][72] and the
    [64] bias (72.3 KB at Dh = 64: two blocks an SM); the dQ block's Q, g
    and two-stage K and V rings, two [64] bias blocks and the statistics'
    [3][64] exchange. fp32 (the CUDA-core kernel's ``smem_floats``): P and
    Tt [32][S], the Q and g tiles and a K/V chunk [32][Dh+1] each, and the
    [S] bias, in fp32."""
    if itemsize == 2:
        return max(6 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 72 * 2 + 64 * 4,
                   6 * 64 * _tc_ld(dh) * 2 + 5 * 64 * 4)
    return 4 * (2 * 32 * s + 3 * 32 * (dh + 1) + s)


def _tc_ld(dh: int) -> int:
    """The staged row of the tensor-core flash-streamed forwards
    (``csrc/common.cuh``'s ``tc_ld``): Dh rounded up to 16 (the mma's
    k-depth) plus 8 bf16 elements."""
    return (dh + 15) // 16 * 16 + 8


def fs_fwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of one #6 block at head width ``dh``. bf16 (itemsize
    2, the tensor-core kernel's ``tc_smem_bytes``): Q and the two-stage K
    and V rings, bf16 [64][``_tc_ld``] each; the fp32 scores and the bf16
    weights [64][72]; the rows' m, l, α and two [64] bias blocks (73.3 KB
    at Dh = 64). fp32 (the CUDA-core kernel's ``smem_floats``): the Q tile
    [64][Dh], a K/V block [64][Dh+1], the scores [64][64], m, l, α and the
    bias, in fp32."""
    if itemsize == 2:
        return (5 * 64 * _tc_ld(dh) * 2 + 64 * 72 * 4 + 64 * 72 * 2
                + (3 * 64 + 2 * 64) * 4)
    return 4 * (64 * dh + 64 * (dh + 1) + 64 * 64 + 3 * 64 + 64)


def rel_fs_fwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of one #16 block at head width ``dh``. bf16 (the
    tensor-core kernel's ``tc_smem_bytes``): q and the two-stage k and v
    rings, bf16 [64][``_tc_ld``] each; the two-stage ebias ring bf16
    [64][72]; the fp32 scores and the bf16 weights [64][72]; the rows' m,
    l and α (90.8 KB at Dh = 64: two blocks an SM). fp32 (the CUDA-core
    kernel's ``smem_floats``): the q tile [64][Dh], a k/v block
    [64][Dh+1], the scores [64][64] and m, l, α, in fp32."""
    if itemsize == 2:
        return (5 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 72 * 2 + 64 * 72 * 4
                + 64 * 72 * 2 + 3 * 64 * 4)
    return 4 * (64 * dh + 64 * (dh + 1) + 64 * 64 + 3 * 64)


def hb_fwd_smem_bytes(s: int, dh: int, itemsize: int = 2) -> int:
    """Shared memory of one #4 block at sequence length ``s`` and head
    width ``dh``. bf16 (itemsize 2, the tensor-core kernel's
    ``tc_smem_bytes``, and the score-tile plan of ``csrc/attn_full_tc.cuh``
    that #1 and #8 run past ``FULL_TC_REG_MAX_SEQ_LEN``): the fp32 scores
    [32][keys + 4] (keys: S rounded up to 64), which the bf16 probs
    overwrite; the Q tile [32][``_tc_ld``]
    and the two-stage K/V ring [64][``_tc_ld``] each, bf16; the bias
    [keys] (105.5 KB at S = 640, Dh = 64: two blocks an SM). fp32
    (``csrc/common.cuh``'s ``fwd_smem_floats<32>``): the [32][Dh] Q tile, a
    [64][Dh+1] K/V chunk, the [32][S] scores and the [S] bias, in fp32."""
    if itemsize == 2:
        keys = -(-s // 64) * 64
        return (32 * (keys + 4) * 4 + (32 + 2 * 64) * _tc_ld(dh) * 2
                + keys * 4)
    return 4 * (32 * dh + 64 * (dh + 1) + 32 * s + s)


# The longest S of the bf16 full-H forwards' register plan (#1, #8;
# ``csrc/attn_full_tc.cuh``'s kRegMaxS): a block per (head, batch row), each
# warp's 16 query rows × every key of scores in its registers. Past it the
# bf16 forward takes #4's shared-memory score tile (``hb_fwd_smem_bytes``).
FULL_TC_REG_MAX_SEQ_LEN = 64


def full_tc_fwd_smem_bytes(s: int, dh: int) -> int:
    """Shared memory of one bf16 #1/#8 block at sequence length ``s`` and
    head width ``dh`` (``csrc/attn_full_tc.cuh``'s ``fwd_reg_smem_bytes``
    and ``fwd_smem_bytes``). Up to ``FULL_TC_REG_MAX_SEQ_LEN``: Q, K and V
    [S16][``_tc_ld``] bf16 and the [S16] fp32 bias (S16: S rounded up to
    16; 27.3 KB at S = 50, Dh = 64). Past it #4's plan,
    ``hb_fwd_smem_bytes`` (109 KB at S = 512, Dh = 128)."""
    if s <= FULL_TC_REG_MAX_SEQ_LEN:
        s16 = -(-s // 16) * 16
        return 3 * s16 * _tc_ld(dh) * 2 + s16 * 4
    return hb_fwd_smem_bytes(s, dh)


def full_tc_bwd_recompute_smem_bytes(s: int, dh: int) -> int:
    """Shared memory of one bf16 #2/#9 block at sequence length ``s`` and
    head width ``dh`` (``csrc/attn_full_tc.cuh``'s ``bwd_rc_smem_bytes``):
    the A and B tiles [S16][``_tc_ld``] bf16 (Q and K, then g and V, then
    K and Q), the probs [S16][S16 + 4] fp32 (pd_c over them), ds_c
    [S16][S16 + 8] bf16 and the [S16] fp32 bias (44.3 KB at S = 50, Dh =
    64; 167.1 KB at S = 140; 168.5 KB at S = 117, Dh = 128). It fits every
    S up to ``max_bwd_seq_len``, the fp32 plan's reach, which both dtypes
    keep."""
    s16 = -(-s // 16) * 16
    return (2 * s16 * _tc_ld(dh) * 2 + s16 * (s16 + 4) * 4
            + s16 * (s16 + 8) * 2 + s16 * 4)


def full_tc_bwd_smem_bytes(s: int, dh: int) -> int:
    """Shared memory of one bf16 #3/#10 block at sequence length ``s`` and
    head width ``dh`` (``csrc/attn_full_tc.cuh``'s ``bwd_smem_bytes``): Q,
    K, V and g [S16][``_tc_ld``] and the pd and ds_c tiles [S16][S16 + 8],
    bf16 (54 KB at S = 50, Dh = 64; 166.5 KB at S = 140; 204 KB at S = 117,
    Dh = 128). It fits every S up to ``max_bwd_seq_len``, the fp32 plan's
    reach, which both dtypes keep."""
    s16 = -(-s // 16) * 16
    return 2 * (4 * s16 * _tc_ld(dh) + 2 * s16 * (s16 + 8))


def rel_hb_fwd_smem_bytes(k_len: int, dh: int, itemsize: int = 2) -> int:
    """Shared memory of one #14 block at K = ``k_len`` and head width
    ``dh``. bf16 (the tensor-core kernel's ``tc_smem_bytes``): the fp32
    scores [32][keys + 4] (keys: K rounded up to 64), which hold the ebias
    rows first and the bf16 probs last; the q tile [32][``_tc_ld``] and the
    two-stage k/v ring [64][``_tc_ld``] each, bf16 (103 KB at K = 640, Dh
    = 64: two blocks an SM). fp32 (``csrc/common.cuh``'s
    ``rel_fwd_smem_floats<32>``): the [32][Dh] q tile, a [64][Dh+1] k/v
    chunk and the [32][K] scores, in fp32."""
    if itemsize == 2:
        keys = -(-k_len // 64) * 64
        return 32 * (keys + 4) * 4 + (32 + 2 * 64) * _tc_ld(dh) * 2
    return 4 * (32 * dh + 64 * (dh + 1) + 32 * k_len)


def fs_bwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of the larger of #7's two blocks at head width ``dh``.
    bf16 (the tensor-core kernels' ``tc_dkdv_smem_bytes`` and
    ``tc_dq_smem_bytes``): the dK/dV block's K and V, its two-stage Q, g
    and o rings, bf16 [64][``_tc_ld``] each, the bf16 pd_c and ds_c tiles
    [64][72] and the [64] bias (90.3 KB at Dh = 64: two blocks an SM); the
    dQ block's Q, g and two-stage K and V rings and two [64] bias blocks.
    fp32 (the CUDA-core kernels' ``dkdv_smem_floats`` and
    ``dq_smem_floats``): K and V [64][Dh+1] with Q and g [32][Dh+1], or
    all four [64][Dh+1]; the score and gradient tiles, lse, δ and bias."""
    if itemsize == 2:
        return max(8 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 72 * 2 + 64 * 4,
                   6 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 4)
    return 4 * max(
        2 * 64 * (dh + 1) + 2 * 32 * (dh + 1) + 2 * 32 * 64 + 2 * 32 + 64,
        4 * 64 * (dh + 1) + 2 * 64 * 64 + 2 * 64 + 64)


def rel_fs_bwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of the larger of #17's two blocks at head width
    ``dh``. bf16 (the passes of ``csrc/attn_bwd_rel_tc.cuh``): #7's
    dK/dV block, its K and V and two-stage Q, g and o rings, bf16
    [64][``_tc_ld``] each, the bf16 pd_c and ds_c tiles [64][72], with the
    two-stage ebias ring bf16 [64][72] for the bias (108 KB at Dh = 64: two
    blocks an SM); the dQ block's Q, g and two-stage K and V rings and the
    ebias ring, over which debias is staged. fp32 (the CUDA-core kernels'
    ``dkdv_smem_floats`` and ``dq_smem_floats``): K and V [64][Dh+1] with q
    and g [32][Dh+1], or all four [64][Dh+1]; the score and gradient tiles,
    lse and δ."""
    if itemsize == 2:
        return max(8 * 64 * _tc_ld(dh) * 2 + 4 * 64 * 72 * 2,
                   6 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 72 * 2)
    return 4 * max(
        2 * 64 * (dh + 1) + 2 * 32 * (dh + 1) + 2 * 32 * 64 + 2 * 32,
        4 * 64 * (dh + 1) + 2 * 64 * 64 + 2 * 64)


def rel_hb_bwd_smem_bytes(k_len: int, dh: int, itemsize: int = 2) -> int:
    """Shared memory of the larger of #15's blocks at K = ``k_len`` and head
    width ``dh``. bf16 (the passes of ``csrc/attn_bwd_rel_tc.cuh`` with
    their own statistics, at any K): the dK/dV block's K and V and its
    two-stage q and g rings, bf16 [64][``_tc_ld``] each, the bf16 pd_c and
    ds_c tiles [64][72] and the two-stage ebias ring bf16 [64][72] (90 KB at
    Dh = 64: two blocks an SM); the dQ block's q, g and two-stage K and V
    rings, the ebias ring and the statistics' [3][64] exchange. fp32 (the
    CUDA-core kernel's ``smem_floats``): P and Tt [32][K], the q and g
    tiles and a k/v chunk [32][Dh+1] each, in fp32."""
    if itemsize == 2:
        return max(6 * 64 * _tc_ld(dh) * 2 + 4 * 64 * 72 * 2,
                   6 * 64 * _tc_ld(dh) * 2 + 2 * 64 * 72 * 2 + 3 * 64 * 4)
    return 4 * (2 * 32 * k_len + 3 * 32 * (dh + 1))


def relik_fs_fwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of one #23 block at head width ``dh``. bf16 (the
    tensor-core kernel's ``tc_smem_bytes``): rw, rr, k, v and two 64-row r
    chunks, bf16 [64][``_tc_ld``] each; the wide bd product fp32
    [64][136], which the scores and the bf16 weights reuse; segd and maskb
    bf16 [64][72]; m, l, α and ed (107 KB at Dh = 64, two blocks an SM).
    fp32 (``smem_floats``): rw and rr [64][Dh], a k/v block and the r
    window [64 + 127][Dh+1], the scores [64][64] and four [64] rows."""
    if itemsize == 2:
        return (6 * 64 * _tc_ld(dh) * 2 + 64 * 136 * 4 + 2 * 64 * 72 * 2
                + 4 * 64 * 4)
    return 4 * (2 * 64 * dh + (64 + 127) * (dh + 1) + 64 * 64 + 4 * 64)


def relik_fs_bwd_smem_bytes(dh: int, itemsize: int = 2) -> int:
    """Shared memory of the larger of #24's two blocks at head width
    ``dh``. bf16 (the tensor-core kernels' ``tc_dkdv_smem_bytes`` and
    ``tc_dq_smem_bytes``): pass 1 holds k, v, rw, rr, g and two r chunks,
    bf16 [64][``_tc_ld``] each, the fp32 [64][72] bd tile (pd_c and ds_c
    over it) and the bf16 segd and maskb tiles [64][72] (99 KB at Dh = 64:
    two blocks an SM); pass 2 holds rw, rr, g, two k stages, v and three r
    chunks, the bd tile (S′ bf16 [64][136] over it), segd and maskb, the
    fp32 dr carry [64][Dh + 8] and ded's two halves [2][64] (135.5 KB at
    Dh = 64, 223.5 KB at Dh = 128: one block an SM). fp32 (the CUDA-core
    kernels' ``dkdv_smem_floats`` and ``dq_smem_floats``): k and v
    [64][Dh+1] with rw, rr and g [32][Dh+1] and the r window [95][Dh+1],
    the [32][64] tiles, lse, ed, δ (and ded)."""
    if itemsize == 2:
        ld, qk = _tc_ld(dh), 64 * 72 * 4 + 2 * 64 * 72 * 2
        return max(7 * 64 * ld * 2 + qk,
                   9 * 64 * ld * 2 + qk + 64 * (dh + 8) * 4 + 2 * 64 * 4)
    return 4 * max((2 * 64 + 3 * 32 + 95) * (dh + 1) + 2 * 32 * 64 + 3 * 32,
                   (3 * 32 + 2 * 64 + 95) * (dh + 1) + 3 * 32 * 64 + 4 * 32)


def _check_plan(name: str, plan_bytes: int, where: str) -> None:
    if plan_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: the shared-memory plan at {where} takes {plan_bytes} "
            f"bytes, past the {MAX_SMEM_BYTES} a block may hold")


def attn_fwd_packed_hb_cuda(qkv, attention_mask, *, n_heads, scale,
                            rate=0.0, seed=0):
    """Launch kernel #4 (``csrc/attn_fwd_packed_hb.cu``) on ``qkv``
    [B, S, 3·D], S ≤ ``HB_MAX_SEQ_LEN``: bf16 on the tensor cores, fp32 on
    the CUDA cores. Raises past the shared-memory plan
    (``hb_fwd_smem_bytes``). Returns out [B, S, D]."""
    _, s, _, dh = _check_geometry(qkv, n_heads)
    _check_plan("attn_fwd_packed_hb",
                hb_fwd_smem_bytes(s, dh, qkv.element_size()),
                f"S={s}, Dh={dh}")
    b, s, d, dh = _check_cuda("attn_fwd_packed_hb", qkv, n_heads,
                              HB_MAX_SEQ_LEN)
    mask = _mask_arg(attention_mask, qkv, b, s)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    _launch("attn_fwd_packed_hb", qkv.data_ptr(), _ptr(mask), out.data_ptr(),
            b, s, n_heads, dh, float(scale), *_drop_args(rate, seed),
            _DTYPE_CODES[qkv.dtype], device=qkv.device)
    attn_fwd_packed_hb_cuda.launches += 1
    return out


def attn_bwd_packed_hb_cuda(qkv, attention_mask, seed, g, *, n_heads, scale,
                            rate=0.0):
    """Launch kernel #5 (``csrc/attn_bwd_packed_hb.cu``): dqkv [B, S, 3·D]
    with the probs recomputed and the keep mask replayed from ``seed``,
    S ≤ ``HB_MAX_SEQ_LEN``. bf16: two tensor-core kernels on the current
    stream, each counted, the statistics and dQ pass and then the dK/dV
    pass, through the rows' max m, 1/l and δ in a [3, B, H, S] fp32
    workspace allocated here. fp32: one CUDA-core kernel, its dK/dV
    accumulators in a [B, H, 2, S, Dh] fp32 workspace. Raises past the
    shared-memory plan (``hb_bwd_smem_bytes``)."""
    _, s, _, dh = _check_geometry(qkv, n_heads)
    _check_plan("attn_bwd_packed_hb",
                hb_bwd_smem_bytes(s, dh, qkv.element_size()),
                f"S={s}, Dh={dh}")
    b, s, d, dh = _check_cuda("attn_bwd_packed_hb", qkv, n_heads,
                              HB_MAX_SEQ_LEN)
    mask = _mask_arg(attention_mask, qkv, b, s)
    _like("g", g, qkv, (b, s, d))
    dqkv = torch.empty_like(qkv)
    bf16 = qkv.dtype == torch.bfloat16
    ws = torch.empty((3, b, n_heads, s) if bf16 else (b, n_heads, 2, s, dh),
                     dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), _ptr(mask), g.data_ptr(), dqkv.data_ptr(),
            ws.data_ptr(), b, s, n_heads, dh, float(scale),
            *_drop_args(rate, seed), _DTYPE_CODES[qkv.dtype])
    _launch("attn_bwd_packed_hb", *args, device=qkv.device)
    attn_bwd_packed_hb_cuda.launches += 1
    if bf16:
        _launch("attn_bwd_packed_hb_dkdv", *args, device=qkv.device)
        attn_bwd_packed_hb_cuda.launches += 1
    return dqkv


def attn_fwd_packed_fs_cuda(qkv, attention_mask, *, n_heads, scale,
                            rate=0.0, seed=0):
    """Launch kernel #6 (``csrc/attn_fwd_packed_fs.cu``) on ``qkv``
    [B, S, 3·D], any S: bf16 on the tensor cores, fp32 on the CUDA cores.
    Raises past the shared-memory plan (``fs_fwd_smem_bytes``). Returns
    (out [B, S, D], lse [B, H, S] fp32)."""
    dh = _check_geometry(qkv, n_heads)[3]
    _check_plan("attn_fwd_packed_fs",
                fs_fwd_smem_bytes(dh, qkv.element_size()), f"Dh={dh}")
    b, s, d, dh = _check_cuda("attn_fwd_packed_fs", qkv, n_heads, None)
    mask = _mask_arg(attention_mask, qkv, b, s)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, n_heads, s), dtype=torch.float32,
                      device=qkv.device)
    _launch("attn_fwd_packed_fs", qkv.data_ptr(), _ptr(mask), out.data_ptr(),
            lse.data_ptr(), b, s, n_heads, dh, float(scale),
            *_drop_args(rate, seed), _DTYPE_CODES[qkv.dtype],
            device=qkv.device)
    attn_fwd_packed_fs_cuda.launches += 1
    return out, lse


def attn_bwd_packed_fs_cuda(qkv, attention_mask, seed, o, lse, g, *,
                            n_heads, scale, rate=0.0):
    """Launch kernel #7 (``csrc/attn_bwd_packed_fs.cu``), two kernels on
    the current stream, each counted: the dK/dV pass, then the dQ pass;
    bf16 on the tensor cores, fp32 on the CUDA cores. ``o`` and ``lse``
    are #6's outputs. Raises past the shared-memory plan
    (``fs_bwd_smem_bytes``). Returns dqkv [B, S, 3·D]."""
    dh = _check_geometry(qkv, n_heads)[3]
    _check_plan("attn_bwd_packed_fs",
                fs_bwd_smem_bytes(dh, qkv.element_size()), f"Dh={dh}")
    b, s, d, dh = _check_cuda("attn_bwd_packed_fs", qkv, n_heads, None)
    mask = _mask_arg(attention_mask, qkv, b, s)
    _like("o", o, qkv, (b, s, d))
    _like("g", g, qkv, (b, s, d))
    _check_lse(lse, qkv, b, n_heads, s)
    dqkv = torch.empty_like(qkv)
    args = (qkv.data_ptr(), _ptr(mask), o.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), b, s, n_heads, dh, float(scale),
            *_drop_args(rate, seed), _DTYPE_CODES[qkv.dtype])
    _launch("attn_bwd_packed_fs_dkdv", *args, device=qkv.device)
    attn_bwd_packed_fs_cuda.launches += 1
    _launch("attn_bwd_packed_fs_dq", *args, device=qkv.device)
    attn_bwd_packed_fs_cuda.launches += 1
    return dqkv


for _fn in (attn_fwd_packed_cuda, attn_bwd_packed_cuda,
            attn_bwd_packed_saved_cuda, attn_fwd_packed_hb_cuda,
            attn_bwd_packed_hb_cuda, attn_fwd_packed_fs_cuda,
            attn_bwd_packed_fs_cuda):
    _fn.launches = 0
del _fn


# ---- device dispatch and autograd -------------------------------------------


def _traced(name: str, rate: float):
    """The ``ops/export_ops.py`` custom op that stands for kernel entry
    ``name`` in a program ``torch.export`` traces (called in place of the
    kernel while ``torch.compiler.is_exporting()``)."""
    from bert_multimodal_transformer_tpu_torch.ops import export_ops

    return export_ops.traced_op(name, rate)


_TIER_SUFFIX = {"full": "", "hb": "_hb", "fs": "_fs"}


def _on(qkv: torch.Tensor) -> str:
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"fused_attention_packed runs on CUDA or CPU tensors, got "
            f"{qkv.device}")
    return qkv.device.type


def attn_fwd_packed(qkv, attention_mask, *, n_heads, scale, rate=0.0,
                    seed=0, save=False):
    """Kernel #1 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_packed_cuda if _on(qkv) == "cuda"
          else attn_fwd_packed_reference)
    return fn(qkv, attention_mask, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed, save=save)


def attn_bwd_packed(qkv, attention_mask, seed, g, *, n_heads, scale,
                    rate=0.0):
    """Kernel #2 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_packed_cuda if _on(qkv) == "cuda"
          else attn_bwd_packed_reference)
    return fn(qkv, attention_mask, seed, g, n_heads=n_heads, scale=scale,
              rate=rate)


def attn_bwd_packed_saved(p, pd, qkv, g, *, n_heads, scale):
    """Kernel #3 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_packed_saved_cuda if _on(qkv) == "cuda"
          else attn_bwd_packed_saved_reference)
    return fn(p, pd, qkv, g, n_heads=n_heads, scale=scale)


def attn_fwd_packed_hb(qkv, attention_mask, *, n_heads, scale, rate=0.0,
                       seed=0):
    """Kernel #4 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_packed_hb_cuda if _on(qkv) == "cuda"
          else attn_fwd_packed_hb_reference)
    return fn(qkv, attention_mask, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed)


def attn_bwd_packed_hb(qkv, attention_mask, seed, g, *, n_heads, scale,
                       rate=0.0):
    """Kernel #5 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_packed_hb_cuda if _on(qkv) == "cuda"
          else attn_bwd_packed_hb_reference)
    return fn(qkv, attention_mask, seed, g, n_heads=n_heads, scale=scale,
              rate=rate)


def attn_fwd_packed_fs(qkv, attention_mask, *, n_heads, scale, rate=0.0,
                       seed=0):
    """Kernel #6 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_packed_fs_cuda if _on(qkv) == "cuda"
          else attn_fwd_packed_fs_reference)
    return fn(qkv, attention_mask, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed)


def attn_bwd_packed_fs(qkv, attention_mask, seed, o, lse, g, *, n_heads,
                       scale, rate=0.0):
    """Kernel #7 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_packed_fs_cuda if _on(qkv) == "cuda"
          else attn_bwd_packed_fs_reference)
    return fn(qkv, attention_mask, seed, o, lse, g, n_heads=n_heads,
              scale=scale, rate=rate)


def packed_tier(s: int, dh: int, grad: bool) -> str:
    """The tier ``fused_attention_packed`` takes at sequence length ``s``
    and head width ``dh``: "full" (#1, and #3 or #2 with a gradient) up
    to ``MAX_SEQ_LEN`` without a gradient and ``max_bwd_seq_len(dh)``
    with one; "hb" (#4, and #5) up to ``HB_MAX_SEQ_LEN``; "fs" (#6, and
    #7) past it."""
    if s <= (max_bwd_seq_len(dh) if grad else MAX_SEQ_LEN):
        return "full"
    return "hb" if s <= HB_MAX_SEQ_LEN else "fs"


def resolve_save_probs(b: int, n_heads: int, s: int, rate: float,
                       itemsize: int,
                       save_probs: Optional[bool] = None,
                       k_len: Optional[int] = None) -> bool:
    """Whether the forward saves p (and pd) for the backward: as asked;
    else ``FUSED_ATTN_SAVE=0/1``; else while B·H·S·K·itemsize·n_prob
    ≤ 256 MB (K = ``k_len``, S when None), with n_prob = 2 at rate > 0 (p
    and pd) and 1 at rate 0. This is the JAX ``_resolve_knobs`` policy on
    the true [B, H, S, K] size: its sublane/lane rounding and its VMEM
    check are TPU layout and have no counterpart here."""
    if save_probs is None and "FUSED_ATTN_SAVE" in os.environ:
        save_probs = os.environ["FUSED_ATTN_SAVE"] == "1"
    if save_probs is None:
        n_prob = 2 if rate > 0.0 else 1
        k = s if k_len is None else k_len
        save_probs = (b * n_heads * s * k * itemsize * n_prob
                      <= SAVE_PROBS_CAP_BYTES)
    return bool(save_probs)


class FusedAttentionPacked(torch.autograd.Function):
    """Packed attention with its backward kernel (JAX ``_fap_fwd`` /
    ``_fap_bwd``). With ``save`` the forward keeps p and pd (the same
    tensor twice at rate 0) and the backward runs kernel #3; without, it
    keeps qkv, the mask and the seed, and kernel #2 recomputes the probs
    and replays the mask. The mask and the seed get no gradient."""

    @staticmethod
    def forward(ctx, qkv, attention_mask, n_heads: int, scale: float,
                rate: float, seed: int, save: bool):
        ctx.n_heads, ctx.scale, ctx.rate = n_heads, scale, rate
        ctx.seed, ctx.save = seed, save
        if save:
            out, p, pd = attn_fwd_packed(qkv, attention_mask,
                                         n_heads=n_heads, scale=scale,
                                         rate=rate, seed=seed, save=True)
            ctx.save_for_backward(qkv, p, pd)
        else:
            out = attn_fwd_packed(qkv, attention_mask, n_heads=n_heads,
                                  scale=scale, rate=rate, seed=seed)
            ctx.save_for_backward(qkv, attention_mask)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.save:
            qkv, p, pd = ctx.saved_tensors
            dqkv = attn_bwd_packed_saved(p, pd, qkv, g, n_heads=ctx.n_heads,
                                         scale=ctx.scale)
        else:
            qkv, mask = ctx.saved_tensors
            dqkv = attn_bwd_packed(qkv, mask, ctx.seed, g,
                                   n_heads=ctx.n_heads, scale=ctx.scale,
                                   rate=ctx.rate)
        return dqkv, None, None, None, None, None, None


class FusedAttentionPackedHB(torch.autograd.Function):
    """The head-blocked tier with its backward kernel (JAX ``_faph_fwd`` /
    ``_faph_bwd``): #4 forward keeps qkv, the mask and the seed; #5
    recomputes the probs and replays the mask. Nothing S²-sized is
    saved."""

    @staticmethod
    def forward(ctx, qkv, attention_mask, n_heads: int, scale: float,
                rate: float, seed: int):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        ctx.save_for_backward(qkv, attention_mask)
        return attn_fwd_packed_hb(qkv, attention_mask, n_heads=n_heads,
                                  scale=scale, rate=rate, seed=seed)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        dqkv = attn_bwd_packed_hb(qkv, mask, ctx.seed, g.contiguous(),
                                  n_heads=ctx.n_heads, scale=ctx.scale,
                                  rate=ctx.rate)
        return dqkv, None, None, None, None, None


class FusedAttentionPackedFS(torch.autograd.Function):
    """The flash-streamed tier with its backward kernel (JAX ``_faps_fwd``
    / ``_faps_bwd``): #6 forward keeps qkv, the mask, the seed and its
    residuals o and lse; #7 rebuilds the probs from lse."""

    @staticmethod
    def forward(ctx, qkv, attention_mask, n_heads: int, scale: float,
                rate: float, seed: int):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        out, lse = attn_fwd_packed_fs(qkv, attention_mask, n_heads=n_heads,
                                      scale=scale, rate=rate, seed=seed)
        ctx.save_for_backward(qkv, attention_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, mask, out, lse = ctx.saved_tensors
        dqkv = attn_bwd_packed_fs(qkv, mask, ctx.seed, out, lse,
                                  g.contiguous(), n_heads=ctx.n_heads,
                                  scale=ctx.scale, rate=ctx.rate)
        return dqkv, None, None, None, None, None


def fused_attention_packed(
    qkv: torch.Tensor,                        # [B, S, 3·D]
    attention_mask: Optional[torch.Tensor],   # [B, S] {0,1}, 1 = real token
    *,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    interpret: Optional[bool] = None,
    nb_fwd: Optional[int] = None,
    nb_bwd: Optional[int] = None,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """Attention on the packed QKV projection (column packing
    ``reshape(B, S, 3, H, Dh)``), returning the context as [B, S, D].

    Same signature and meaning as the JAX entry: ``dropout_rate`` applies
    only when ``deterministic`` is False, and then needs ``dropout_rng``,
    here a CPU ``torch.Generator`` from which the kernel seed is drawn.
    ``save_probs`` True/False/None picks the saved-probs or recompute
    backward (``resolve_save_probs``; ``FUSED_ATTN_SAVE=0/1`` overrides
    None). When no gradient is being taken (``torch.no_grad()``, or qkv
    not requiring grad) the forward saves nothing, as the JAX primal.

    ``interpret``/``nb_fwd``/``nb_bwd`` are TPU plan knobs with no meaning
    here and raise. The tier follows the JAX entry's order
    (``packed_tier``): the full-H kernels while they reach; then the
    head-blocked tier (#4, and #5 with a recompute backward) up to
    ``HB_MAX_SEQ_LEN``; then the flash-streamed tier (#6, and #7 from the
    saved o and lse) at any S. ``save_probs`` applies to the full-H tier
    only: the long tiers save nothing S²-sized, as in JAX.
    """
    if interpret is not None or nb_fwd is not None or nb_bwd is not None:
        raise ValueError(
            "interpret/nb_fwd/nb_bwd are TPU kernel-plan knobs; the CUDA "
            "kernels take none")
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    b, s, d, dh = _check_geometry(qkv, n_heads)
    if rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    _on(qkv)
    seed = draw_seed(dropout_rng) if rate > 0.0 else 0
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.float32)
    grad = torch.is_grad_enabled() and qkv.requires_grad
    tier = packed_tier(s, dh, grad)
    kw = dict(n_heads=n_heads, scale=scale, rate=rate, seed=seed)
    if not grad:
        if torch.compiler.is_exporting():
            return _traced("attn_fwd_packed" + _TIER_SUFFIX[tier], rate)(
                qkv, attention_mask, n_heads, float(scale))
        if tier == "full":
            return attn_fwd_packed(qkv, attention_mask, **kw)
        if tier == "hb":
            return attn_fwd_packed_hb(qkv, attention_mask, **kw)
        return attn_fwd_packed_fs(qkv, attention_mask, **kw)[0]
    if tier == "hb":
        return FusedAttentionPackedHB.apply(qkv, attention_mask, n_heads,
                                            float(scale), rate, seed)
    if tier == "fs":
        return FusedAttentionPackedFS.apply(qkv, attention_mask, n_heads,
                                            float(scale), rate, seed)
    save = resolve_save_probs(b, n_heads, s, rate, qkv.element_size(),
                              save_probs)
    return FusedAttentionPacked.apply(qkv, attention_mask, n_heads,
                                      float(scale), rate, seed, save)


# ---- split layout: separate q, k, v [B, H, S, Dh] (#8, #9, #10) -------------
#
# The port of the JAX split-tensor entry ``fused_attention`` (``_fused_
# attention`` / ``_fa_fwd`` / ``_fa_bwd``) and of ``fused_attention_tp``:
# #1-#3's function on separate q, k, v and out [B, H, S, Dh], the layout in
# which a tensor-parallel rank holds its local heads (the packed projection's
# q|k|v column blocks cannot be head-aligned by one contiguous chunk). Three
# kernels, each with its plain version:
#
# * #8 ``attn_fwd_split_cuda`` → ``csrc/attn_fwd_split.cu``: #1's forward,
#   prob dropout and saved p/pd included;
# * #10 ``attn_bwd_split_saved_cuda`` → ``csrc/attn_bwd_split_saved.cu``: dq,
#   dk, dv from the saved p/pd;
# * #9 ``attn_bwd_split_cuda`` → ``csrc/attn_bwd_split.cu``: the same with the
#   probs recomputed and the keep mask replayed.
#
# They run #1-#3's row code (``csrc/common.cuh``'s ``fwd_rows``,
# ``bwd_recompute_head``, ``bwd_saved_head``) at row stride Dh. The kernels
# take the global batch row and head of their tensors' first (b, h)
# (``b_off``, ``h_off``) into the Philox counter (k >> 2, q, h, b): a head
# shard draws the mask the single-card model draws for the same global
# element, and data shards draw different masks with no fold of the seed.


@_counted
def attn_fwd_split_reference(q, k, v, attention_mask, *, scale, rate=0.0,
                             seed=0, save=False, b_off=0, h_off=0):
    """Plain version of kernel #8: ``attn_fwd_packed_reference``'s
    function (fp32 softmax, the Philox keep mask at the global (b, h), the
    dropped probs rounded for a PV product accumulated in fp32) on q, k, v
    [B, H, S, Dh]. Returns out [B, H, S, Dh], or (out, p, pd) [B, H, S, S]
    with ``save`` (pd is p at rate 0)."""
    dtype = q.dtype
    p = _split_probs(q, k, attention_mask, scale)
    pd = _dropped(p, seed, rate, b_off, h_off)
    out = torch.matmul(pd.to(dtype).float(), v.float()).to(dtype)
    if not save:
        return out
    p_c = p.to(dtype)
    return out, p_c, (pd.to(dtype) if rate > 0.0 else p_c)


@_counted
def attn_bwd_split_reference(q, k, v, attention_mask, seed, g, *, scale,
                             rate=0.0, b_off=0, h_off=0):
    """Plain version of kernel #9: the probs recomputed in fp32, the keep
    mask replayed from ``seed`` at the global (b, h), pd kept in fp32 for
    the VJP and rounded for the dV product. Returns (dq, dk, dv)
    [B, H, S, Dh]."""
    p = _split_probs(q, k, attention_mask, scale)
    pd = _dropped(p, seed, rate, b_off, h_off)
    return _split_vjp(p, pd, pd.to(q.dtype), q, k, v, g, scale)


@_counted
def attn_bwd_split_saved_reference(p, pd, q, k, v, g, *, scale):
    """Plain version of kernel #10: the VJP from the saved p and pd (input
    dtype, read as fp32). Returns (dq, dk, dv) [B, H, S, Dh]."""
    return _split_vjp(p.float(), pd.float(), pd, q, k, v, g, scale)


def _check_split_cuda(name, q, k, v, max_s):
    """The checks every split CUDA wrapper makes on q, k, v; returns (b, h,
    s, dh)."""
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {t_name} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}: {t_name} dtype {t.dtype} not "
                             "supported (float32, bfloat16)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"{name}: {t_name} must be a contiguous [B, H, S, Dh] "
                f"tensor, got shape {tuple(t.shape)} "
                f"contiguous={t.is_contiguous()}")
    _like("k", k, q, tuple(q.shape))
    _like("v", v, q, tuple(q.shape))
    b, h, s, dh = q.shape
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if s > max_s:
        raise ValueError(f"{name}: S={s} exceeds the kernel's {max_s}")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} or H={h} exceeds a grid dimension")
    check_sm90(q)
    return b, h, s, dh


def attn_fwd_split_cuda(q, k, v, attention_mask, *, scale, rate=0.0, seed=0,
                        save=False, b_off=0, h_off=0):
    """Launch kernel #8 (``csrc/attn_fwd_split.cu``) on q, k, v
    [B, H, S, Dh] (CUDA, fp32 or bf16, contiguous), S ≤ ``MAX_SEQ_LEN``.
    Returns out [B, H, S, Dh], or (out, p, pd) with ``save``."""
    b, h, s, dh = _check_split_cuda("attn_fwd_split", q, k, v, MAX_SEQ_LEN)
    mask = _mask_arg(attention_mask, q, b, s)
    out = torch.empty_like(q)
    p = pd = None
    if save:
        p = torch.empty((b, h, s, s), dtype=q.dtype, device=q.device)
        pd = torch.empty_like(p) if rate > 0.0 else p
    _launch("attn_fwd_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(mask), out.data_ptr(), _ptr(p),
            _ptr(pd) if rate > 0.0 else None, b, s, h, dh, float(scale),
            *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[q.dtype], device=q.device)
    attn_fwd_split_cuda.launches += 1
    return (out, p, pd) if save else out


def attn_bwd_split_cuda(q, k, v, attention_mask, seed, g, *, scale, rate=0.0,
                        b_off=0, h_off=0):
    """Launch kernel #9 (``csrc/attn_bwd_split.cu``): (dq, dk, dv)
    [B, H, S, Dh] with the probs recomputed and the keep mask replayed from
    ``seed`` at the forward's offsets; bf16 on the tensor cores
    (``full_tc_bwd_recompute_smem_bytes``), fp32 on the CUDA cores."""
    b, h, s, dh = _check_split_cuda("attn_bwd_split", q, k, v,
                                    max_bwd_seq_len(q.shape[-1]))
    mask = _mask_arg(attention_mask, q, b, s)
    _like("g", g, q, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("attn_bwd_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(mask), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, h, dh, float(scale),
            *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[q.dtype], device=q.device)
    attn_bwd_split_cuda.launches += 1
    return dq, dk, dv


def attn_bwd_split_saved_cuda(p, pd, q, k, v, g, *, scale):
    """Launch kernel #10 (``csrc/attn_bwd_split_saved.cu``): (dq, dk, dv)
    [B, H, S, Dh] from the saved probs p and pd [B, H, S, S]."""
    b, h, s, dh = _check_split_cuda("attn_bwd_split_saved", q, k, v,
                                    max_bwd_seq_len(q.shape[-1]))
    _like("p", p, q, (b, h, s, s))
    _like("pd", pd, q, (b, h, s, s))
    _like("g", g, q, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("attn_bwd_split_saved", p.data_ptr(), pd.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, dh,
            float(scale), _DTYPE_CODES[q.dtype], device=q.device)
    attn_bwd_split_saved_cuda.launches += 1
    return dq, dk, dv


for _fn in (attn_fwd_split_cuda, attn_bwd_split_cuda,
            attn_bwd_split_saved_cuda):
    _fn.launches = 0
del _fn


def attn_fwd_split(q, k, v, attention_mask, *, scale, rate=0.0, seed=0,
                   save=False, b_off=0, h_off=0):
    """Kernel #8 on CUDA tensors, its plain version on CPU ones."""
    fn = (attn_fwd_split_cuda if _on(q) == "cuda"
          else attn_fwd_split_reference)
    return fn(q, k, v, attention_mask, scale=scale, rate=rate, seed=seed,
              save=save, b_off=b_off, h_off=h_off)


def attn_bwd_split(q, k, v, attention_mask, seed, g, *, scale, rate=0.0,
                   b_off=0, h_off=0):
    """Kernel #9 on CUDA tensors, its plain version on CPU ones."""
    fn = (attn_bwd_split_cuda if _on(q) == "cuda"
          else attn_bwd_split_reference)
    return fn(q, k, v, attention_mask, seed, g, scale=scale, rate=rate,
              b_off=b_off, h_off=h_off)


def attn_bwd_split_saved(p, pd, q, k, v, g, *, scale):
    """Kernel #10 on CUDA tensors, its plain version on CPU ones."""
    fn = (attn_bwd_split_saved_cuda if _on(q) == "cuda"
          else attn_bwd_split_saved_reference)
    return fn(p, pd, q, k, v, g, scale=scale)


def split_tier(s: int, dh: int, grad: bool) -> str:
    """"full" while the split kernels reach sequence length ``s`` at head
    width ``dh``: #8 up to ``MAX_SEQ_LEN`` without a gradient, #10/#9 up
    to ``max_bwd_seq_len(dh)`` with one; "einsum" past that, where the
    tensor-parallel model takes its head-sharded einsum branch (the JAX
    model's ``fused_fits`` test, ``models/bert.py:202-204``), decided
    before any launch."""
    return ("full" if s <= (max_bwd_seq_len(dh) if grad else MAX_SEQ_LEN)
            else "einsum")


class FusedAttention(torch.autograd.Function):
    """Split-layout attention with its backward kernel (JAX ``_fa_fwd`` /
    ``_fa_bwd``). With ``save`` the forward keeps p and pd and the backward
    runs kernel #10; without, it keeps q, k, v, the mask and the seed, and
    kernel #9 recomputes the probs and replays the mask. The mask and the
    seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, scale: float, rate: float,
                seed: int, save: bool, b_off: int, h_off: int):
        ctx.scale, ctx.rate, ctx.seed, ctx.save = scale, rate, seed, save
        ctx.b_off, ctx.h_off = b_off, h_off
        kw = dict(scale=scale, rate=rate, seed=seed, b_off=b_off,
                  h_off=h_off)
        if save:
            out, p, pd = attn_fwd_split(q, k, v, attention_mask, save=True,
                                        **kw)
            ctx.save_for_backward(q, k, v, p, pd)
        else:
            out = attn_fwd_split(q, k, v, attention_mask, **kw)
            ctx.save_for_backward(q, k, v, attention_mask)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.save:
            q, k, v, p, pd = ctx.saved_tensors
            grads = attn_bwd_split_saved(p, pd, q, k, v, g, scale=ctx.scale)
        else:
            q, k, v, mask = ctx.saved_tensors
            grads = attn_bwd_split(q, k, v, mask, ctx.seed, g,
                                   scale=ctx.scale, rate=ctx.rate,
                                   b_off=ctx.b_off, h_off=ctx.h_off)
        return (*grads,) + (None,) * 7


def _fused_split(q, k, v, attention_mask, scale, dropout_rate, dropout_rng,
                 deterministic, save_probs, b_off, h_off):
    """``fused_attention``'s body; ``b_off``/``h_off`` place the tensors'
    first (b, h) in the global batch and heads (the dropout stream)."""
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be [B, H, S, Dh] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    _on(q)
    b, h, s, dh = q.shape
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if split_tier(s, dh, grad) != "full":
        raise ValueError(
            f"fused_attention: S={s} at Dh={dh} is past the split kernels' "
            f"reach ({max_bwd_seq_len(dh) if grad else MAX_SEQ_LEN}"
            f"{' with a gradient' if grad else ''}); split_tier sends such "
            "lengths to the einsum branch")
    seed = draw_seed(dropout_rng) if rate > 0.0 else 0
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.float32)
    q, k, v = (x.contiguous() for x in (q, k, v))
    kw = dict(scale=float(scale), rate=rate, seed=seed, b_off=b_off,
              h_off=h_off)
    if not grad:
        return attn_fwd_split(q, k, v, attention_mask, **kw)
    save = resolve_save_probs(b, h, s, rate, q.element_size(), save_probs)
    return FusedAttention.apply(q, k, v, attention_mask, float(scale), rate,
                                seed, save, b_off, h_off)


def fused_attention(
    q: torch.Tensor,                          # [B, H, S, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor],   # [B, S] {0,1}, 1 = real token
    *,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """Attention on separate q, k, v [B, H, S, Dh], returning the context
    [B, H, S, Dh]: the JAX split-tensor ``fused_attention`` without its TPU
    plan knobs (``interpret``, ``nb_fwd``, ``nb_bwd``).

    ``dropout_rate`` applies only when ``deterministic`` is False, and then
    needs ``dropout_rng``, a CPU ``torch.Generator`` from which the kernel
    seed is drawn. ``save_probs`` True/False/None picks the saved-probs
    (#10) or recompute (#9) backward (``resolve_save_probs``;
    ``FUSED_ATTN_SAVE=0/1`` overrides None). With no gradient taken the
    forward (#8) saves nothing. A CUDA tensor launches the kernels or
    raises; a CPU one takes their plain versions. Raises past the kernels'
    reach (``split_tier``), which the model checks first."""
    return _fused_split(q, k, v, attention_mask, scale, dropout_rate,
                        dropout_rng, deterministic, save_probs, 0, 0)


def fused_attention_tp(
    q: torch.Tensor,                          # [B/dp, H/mp, S, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor],   # [B/dp, S]
    *,
    mesh,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """``fused_attention`` on one rank of a tensor-parallel mesh
    (``parallel/mesh.py``): q, k, v are this rank's batch rows (its data
    shard) and heads (its model shard), the JAX ``fused_attention_tp``'s
    per-device block. The kernels draw the dropout of the global (b, h):
    batch row offset ``mesh.data_rank`` · B_local, head offset
    ``mesh.model_rank`` · H_local, from the seed that every rank draws
    alike from ``dropout_rng``. The JAX wrapper instead folds the model and
    the data index into its rng (ROADMAP C, deliberate departures). Over
    more than one data rank the ``Trainer`` hands each data rank its own
    ``dropout_rng`` (the data rank folded into the seed), which then keeps
    the shards apart on its own."""
    b, h = q.shape[:2]
    return _fused_split(q, k, v, attention_mask, scale, dropout_rate,
                        dropout_rng, deterministic, None,
                        mesh.data_rank * b, mesh.model_rank * h)


# ---- the QKV projection inside the packed kernels (#18, #19) -----------------
#
# The port of the JAX ``fused_attention_qkvproj`` (``_fused_attention_
# qkvproj`` / ``_faq_fwd`` / ``_faq_bwd``): MAG-BERT's attention with the
# packed projection qkv = x·W + b computed inside the attention kernel
# (``BertConfig.qkv_fusion``). Two kernels, each with its plain version:
#
# * #18 ``attn_fwd_qkvproj_cuda`` → ``csrc/attn_fwd_qkvproj.cu``:
#   each (head, batch row) projects its q, k, v columns into shared memory
#   (fp32 sums, the bias added in fp32, one rounding: the TPU kernel's
#   ``(x·W + b).astype(dtype)``), then runs #1's attention on them, dropout,
#   saved p/pd and the emitted projection (``qkv_residual``) included. In
#   bf16 the projection runs on the tensor cores and, to S = 64, lands in
#   #1's register-plan tiles, on which #1's compute half runs (so #18 gives
#   #1's bits on its emitted qkv); past S = 64 the attention is #1's fp32
#   CUDA-core row code, as fp32 is throughout;
# * #19 ``attn_bwd_qkvproj_cuda`` → ``csrc/attn_bwd_qkvproj.cu``: #3's
#   saved-probs chain on the head re-projected from x by #18's projection
#   (or read from the emitted qkv), writing dqkv, then dx = dqkv·Wᵀ, two
#   launches a call. In bf16 both run on the tensor cores: the projection
#   lands in #3's tiles, on which #3's compute half runs (so dqkv from the
#   saved qkv is #3's, bit for bit), and dx is a tiled mma.sync product.
#
# dW = xᵀ·dqkv and db = Σ dqkv are plain products in ``FusedAttentionQKV
# Proj``, as the JAX package leaves them to XLA. The public entry takes W
# as [D, 3D], the JAX layout; the kernels read nn.Linear's [3D, D], where
# a head's rows are contiguous (the model hands its weight's transposed
# view, so no copy is made). Past the 256 MB save cap, under
# ``FUSED_ATTN_SAVE=0`` and past the kernels' shared-memory plan
# (``qkvproj_fits``) the entry takes the split structure (the dense
# projection, then ``fused_attention_packed``), decided before any launch.
# The dropout stream is the packed kernels', so #18 drops what #1 drops.

# Shared memory of the fp32 projection's staging (``csrc/common.cuh``'s
# ``gemm_smem_floats``: two [32][64 + 4] fp32 slices).
_GEMM_SMEM_FLOATS = 2 * 32 * 68
# The bf16 projection's cp.async ring (``csrc/attn_full_tc.cuh``'s
# ``proj_smem_bytes``): QKVPROJ_TC_STAGES stages of each batch row's 64 x
# rows and the head's weight rows (3·Dh, at most 192 a pass, rounded up to
# 16), a slice deep in rows of depth + 8 bf16. #18's register plan (S ≤ 64)
# takes QKVPROJ_TC_REG_ROWS batch rows a block and QKVPROJ_TC_REG_DEPTH-deep
# slices; the row plans (#18 past S = 64, #19) one batch row and
# QKVPROJ_TC_ROWS_DEPTH, which fits beside the head at #18's reach.
QKVPROJ_TC_STAGES, QKVPROJ_TC_ROWS, QKVPROJ_TC_COLS = 2, 64, 192
QKVPROJ_TC_REG_ROWS, QKVPROJ_TC_REG_DEPTH = 2, 64
QKVPROJ_TC_ROWS_DEPTH = 32
# bf16 #19's (head, batch row) pass re-projecting to S = 64: batch rows a
# block (``kBwdProjRows``), each weight slice QKVPROJ_TC_REG_DEPTH deep;
# past it one batch row and QKVPROJ_TC_ROWS_DEPTH.
QKVPROJ_TC_BWD_ROWS = 2


def qkvproj_tc_stage_bytes(dh: int, rows: int = 1,
                           depth: int = QKVPROJ_TC_ROWS_DEPTH) -> int:
    """The bf16 projection's staging ring at head width ``dh`` for ``rows``
    batch rows a block and ``depth``-deep slices (40 KB at Dh = 64, one
    row, 32 deep)."""
    w_rows = _rows16(min(3 * dh, QKVPROJ_TC_COLS))
    return (QKVPROJ_TC_STAGES * (rows * QKVPROJ_TC_ROWS + w_rows)
            * (depth + 8) * 2)


def _head_floats(s: int, dh: int, itemsize: int) -> int:
    """The projected head [S][3·Dh] in the input dtype, in whole float4s
    (``qkvproj_head_floats``)."""
    return (s * 3 * dh * itemsize + 15) // 16 * 4


def _proj_stage_bytes(dh: int, itemsize: int, depth: int) -> int:
    return (qkvproj_tc_stage_bytes(dh, 1, depth) if itemsize == 2
            else 4 * _GEMM_SMEM_FLOATS)


def qkvproj_fwd_smem_bytes(s: int, dh: int, itemsize: int) -> int:
    """Shared memory of one #18 block. bf16 to S = 64: #1's register-plan
    tiles and bias (``full_tc_fwd_smem_bytes``) for each of its
    ``QKVPROJ_TC_REG_ROWS`` batch rows, then the projection's ring
    (``qkvproj_tc_stage_bytes``; 144.5 KB at S = 50, Dh = 64). Past it,
    and in fp32: the projected head, then the larger of the projection's
    staging and #1's row plan (``fwd_smem_floats<16>``: the [16][Dh] Q
    tile, a [64][Dh+1] K/V chunk, [16][S] scores, the [S] bias)."""
    if itemsize == 2 and s <= FULL_TC_REG_MAX_SEQ_LEN:
        return (QKVPROJ_TC_REG_ROWS * full_tc_fwd_smem_bytes(s, dh)
                + qkvproj_tc_stage_bytes(dh, QKVPROJ_TC_REG_ROWS,
                                         QKVPROJ_TC_REG_DEPTH))
    rows = 16 * dh + 64 * (dh + 1) + 16 * s + s
    return (4 * _head_floats(s, dh, itemsize)
            + max(_proj_stage_bytes(dh, itemsize, QKVPROJ_TC_ROWS_DEPTH),
                  4 * rows))


def _qkvproj_bwd_row_plan_bytes(s: int, dh: int, itemsize: int,
                                recompute: bool) -> int:
    """Shared memory of one block of #19's fp32 (head, batch row) pass:
    #3's fp32 plan (``bwd_smem_bytes``), behind the projected head [S][3·Dh]
    when it re-projects from x (the projection's staging laid over the
    plan). ``qkvproj_fits`` holds both dtypes to its reach."""
    plan = bwd_smem_bytes(s, dh)
    if not recompute:
        return plan
    return (4 * _head_floats(s, dh, itemsize)
            + max(_proj_stage_bytes(dh, itemsize, QKVPROJ_TC_ROWS_DEPTH),
                  plan))


def qkvproj_tc_bwd_smem_bytes(s: int, dh: int, recompute: bool) -> int:
    """Shared memory of one block of bf16 #19's (head, batch row) pass
    (``csrc/attn_bwd_qkvproj.cu``'s ``heads_tc_smem_bytes``): for each of
    its batch rows (``QKVPROJ_TC_BWD_ROWS`` re-projecting to S = 64, else
    one) #3's Q, K, V and g tiles, then each row's pd and ds_c tiles, over
    which the projection's ring lies where it is the larger (162 KB at S =
    50, Dh = 64, re-projecting; #3's ``full_tc_bwd_smem_bytes`` from the
    saved qkv)."""
    s16 = _rows16(s)
    rows = (QKVPROJ_TC_BWD_ROWS
            if recompute and s <= FULL_TC_REG_MAX_SEQ_LEN else 1)
    qkvg = 4 * s16 * _tc_ld(dh) * 2
    tail = rows * 2 * s16 * (s16 + 8) * 2
    if recompute:
        depth = QKVPROJ_TC_REG_DEPTH if rows > 1 else QKVPROJ_TC_ROWS_DEPTH
        tail = max(tail, qkvproj_tc_stage_bytes(dh, rows, depth))
    return rows * qkvg + tail


def qkvproj_bwd_smem_bytes(s: int, dh: int, itemsize: int,
                           recompute: bool) -> int:
    """Shared memory of one block of #19's (head, batch row) launch: bf16
    the tensor-core plan (``qkvproj_tc_bwd_smem_bytes``), fp32 the
    CUDA-core row plan (``_qkvproj_bwd_row_plan_bytes``)."""
    if itemsize == 2:
        return qkvproj_tc_bwd_smem_bytes(s, dh, recompute)
    return _qkvproj_bwd_row_plan_bytes(s, dh, itemsize, recompute)


def qkvproj_fits(s: int, dh: int, itemsize: int, grad: bool) -> bool:
    """Whether #18 (and with a gradient #19 in its larger, re-projecting
    plan) takes sequence length ``s`` at head width ``dh`` and
    ``itemsize``-byte activations. D is streamed, so any width fits. At
    Dh = 64 the forward reaches S = 253 in fp32 and 468 in bf16, the
    backward S = 107 and 122; at Dh = 128, 119 / 228 and 73 / 91. The
    backward's reach is the CUDA-core row plan's in both dtypes (the head
    [S][3·Dh] beside #3's fp32 plan), which bf16 #19's tensor-core plan,
    smaller, also fits: the shapes that take the split structure did not
    move when bf16 #19 went to the tensor cores."""
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM or s > MAX_SEQ_LEN:
        return False
    if qkvproj_fwd_smem_bytes(s, dh, itemsize) > MAX_SMEM_BYTES:
        return False
    return not grad or (
        _qkvproj_bwd_row_plan_bytes(s, dh, itemsize, True) <= MAX_SMEM_BYTES
        and qkvproj_bwd_smem_bytes(s, dh, itemsize, True) <= MAX_SMEM_BYTES)


def _project(x, w, b3):
    """The packed projection as #18 rounds it: x·W summed in fp32, the bias
    added in fp32, one rounding to x's dtype. (The model's dense layer
    rounds the product, then adds the bias in the dtype: in bf16 the two
    differ by ulps.)"""
    return (torch.matmul(x.float(), w.float())
            + b3.float().reshape(-1)).to(x.dtype)


@_counted
def attn_fwd_qkvproj_reference(x, w, b3, attention_mask, *, n_heads, scale,
                               rate=0.0, seed=0, save=False, emit_qkv=False):
    """Plain version of kernel #18: ``_project``, then
    ``attn_fwd_packed_reference``'s function on it. x [B, S, D], w
    [D, 3D], b3 [3D]. Returns (out [B, S, D], qkv [B, S, 3D] with
    ``emit_qkv`` else None, p and pd [B, H, S, S] with ``save`` else None;
    pd is p at rate 0)."""
    qkv = _project(x, w, b3)
    out, p, pd = _fwd_whole_rows(qkv, attention_mask, n_heads, scale, rate,
                                 seed)
    if save:
        p = p.to(x.dtype)
        pd = pd.to(x.dtype) if rate > 0.0 else p
    else:
        p = pd = None
    return out, (qkv if emit_qkv else None), p, pd


@_counted
def attn_bwd_qkvproj_reference(p, pd, src, w, b3, g, *, n_heads, scale,
                               recompute):
    """Plain version of kernel #19: qkv = ``_project(src, w, b3)`` with
    ``recompute`` (src is x), else src itself (the saved qkv); then
    ``attn_bwd_packed_saved_reference``'s VJP, and dx = dqkv·Wᵀ summed in
    fp32, rounded once. Returns (dqkv [B, S, 3D], dx [B, S, D])."""
    qkv = _project(src, w, b3) if recompute else src
    dqkv = _vjp(p.float(), pd.float(), pd, qkv, g, n_heads, scale)
    return dqkv, torch.matmul(dqkv.float(), w.float().t()).to(dqkv.dtype)


def qkvproj_dx_bf16_bound(ref_dx, dqkv_bound, w) -> torch.Tensor:
    """Elementwise bound on two bf16 dx = T(dqkv·Wᵀ) whose dqkv lie within
    ``dqkv_bound`` of each other (``dqkv_bf16_bound``): the dqkv gap
    carried through |W| (Σ_k bound_k·|W_nk|), plus one bf16 rounding of
    the output that may land the other way (2^-7 relative) and 2^-17 for
    sums near zero."""
    return (torch.matmul(dqkv_bound.float(), w.float().abs().t())
            + 2.0 ** -7 * ref_dx.float().abs() + 2.0 ** -17)


def _check_qkvproj_cuda(name, x, w, b3, n_heads):
    """The checks both qkvproj CUDA wrappers make on x [B, S, D] (or g),
    w [D, 3D] and b3; returns (b, s, d, dh)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, "
                         "bfloat16)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(
            f"{name}: x must be a contiguous [B, S, D] tensor, got shape "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    b, s, d = x.shape
    for t_name, t, shape in (("w", w, (d, 3 * d)), ("b3", b3, (3 * d,))):
        if (t.device != x.device or t.dtype != x.dtype
                or t.numel() != int(np.prod(shape))
                or t.shape[-1] != shape[-1]):
            raise ValueError(
                f"{name}: {t_name} must be a {x.dtype} tensor of shape "
                f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    dh = d // n_heads
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"B={b} or H={n_heads} exceeds a grid dimension")
    check_sm90(x)
    return b, s, d, dh


def attn_fwd_qkvproj_cuda(x, w, b3, attention_mask, *, n_heads, scale,
                          rate=0.0, seed=0, save=False, emit_qkv=False):
    """Launch kernel #18 (``csrc/attn_fwd_qkvproj.cu``) on x [B, S, D], w
    [D, 3D] and b3 [3D] (CUDA, one dtype, fp32 or bf16; x contiguous; the
    kernel reads w as [3D, D], ``w.t()``, copied only if that is not
    contiguous). Returns (out, qkv or None, p or None, pd or None) as the
    plain version; ``emit_qkv`` needs ``save``."""
    b, s, d, dh = _check_qkvproj_cuda("attn_fwd_qkvproj", x, w, b3, n_heads)
    if s > MAX_SEQ_LEN or (qkvproj_fwd_smem_bytes(s, dh, x.element_size())
                           > MAX_SMEM_BYTES):
        raise ValueError(f"attn_fwd_qkvproj: S={s} at Dh={dh} is past the "
                         "kernel's shared-memory plan (qkvproj_fits)")
    if emit_qkv and not save:
        raise ValueError("attn_fwd_qkvproj: emit_qkv needs save")
    mask = _mask_arg(attention_mask, x, b, s)
    # held until the launch is queued: a copy freed earlier could be handed
    # to the next allocation before the kernel reads it
    w_rows, b3 = w.t().contiguous(), b3.reshape(-1).contiguous()
    out = torch.empty_like(x)
    qkv = (torch.empty((b, s, 3 * d), dtype=x.dtype, device=x.device)
           if emit_qkv else None)
    p = pd = None
    if save:
        p = torch.empty((b, n_heads, s, s), dtype=x.dtype, device=x.device)
        pd = torch.empty_like(p) if rate > 0.0 else p
    _launch("attn_fwd_qkvproj", x.data_ptr(), w_rows.data_ptr(),
            b3.data_ptr(), _ptr(mask), out.data_ptr(), _ptr(qkv), _ptr(p),
            _ptr(pd) if rate > 0.0 else None, b, s, n_heads, dh,
            float(scale), *_drop_args(rate, seed), _DTYPE_CODES[x.dtype],
            device=x.device)
    attn_fwd_qkvproj_cuda.launches += 1
    return out, qkv, p, pd


def attn_bwd_qkvproj_cuda(p, pd, src, w, b3, g, *, n_heads, scale,
                          recompute):
    """Launch kernel #19 (``csrc/attn_bwd_qkvproj.cu``), two kernels on the
    current stream, each counted: the (head, batch row) pass writing dqkv
    [B, S, 3D] from the saved probs p and pd [B, H, S, S] and the head
    re-projected from src = x [B, S, D] (``recompute``) or read from src =
    the saved qkv [B, S, 3D]; then dx = dqkv·Wᵀ [B, S, D]. Returns (dqkv,
    dx)."""
    b, s, d, dh = _check_qkvproj_cuda("attn_bwd_qkvproj", g, w, b3, n_heads)
    item = g.element_size()
    if max(_qkvproj_bwd_row_plan_bytes(s, dh, item, recompute),
           qkvproj_bwd_smem_bytes(s, dh, item, recompute)) > MAX_SMEM_BYTES:
        raise ValueError(f"attn_bwd_qkvproj: S={s} at Dh={dh} is past the "
                         "kernel's shared-memory plan (qkvproj_fits)")
    _like("src", src, g, (b, s, d if recompute else 3 * d))
    _like("p", p, g, (b, n_heads, s, s))
    _like("pd", pd, g, (b, n_heads, s, s))
    w_rows, b3 = w.t().contiguous(), b3.reshape(-1).contiguous()
    dqkv = torch.empty((b, s, 3 * d), dtype=g.dtype, device=g.device)
    dx = torch.empty_like(g)
    _launch("attn_bwd_qkvproj_heads", p.data_ptr(), pd.data_ptr(),
            src.data_ptr(), w_rows.data_ptr(), b3.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), b, s, n_heads, dh, float(scale), int(recompute),
            _DTYPE_CODES[g.dtype], device=g.device)
    attn_bwd_qkvproj_cuda.launches += 1
    _launch("attn_bwd_qkvproj_dx", dqkv.data_ptr(), w_rows.data_ptr(),
            dx.data_ptr(), b * s, d, _DTYPE_CODES[g.dtype], device=g.device)
    attn_bwd_qkvproj_cuda.launches += 1
    return dqkv, dx


for _fn in (attn_fwd_qkvproj_cuda, attn_bwd_qkvproj_cuda):
    _fn.launches = 0
del _fn


def attn_fwd_qkvproj(x, w, b3, attention_mask, *, n_heads, scale, rate=0.0,
                     seed=0, save=False, emit_qkv=False):
    """Kernel #18 on CUDA tensors, its plain version on CPU ones."""
    fn = (attn_fwd_qkvproj_cuda if _on(x) == "cuda"
          else attn_fwd_qkvproj_reference)
    return fn(x, w, b3, attention_mask, n_heads=n_heads, scale=scale,
              rate=rate, seed=seed, save=save, emit_qkv=emit_qkv)


def attn_bwd_qkvproj(p, pd, src, w, b3, g, *, n_heads, scale, recompute):
    """Kernel #19 on CUDA tensors, its plain version on CPU ones."""
    fn = (attn_bwd_qkvproj_cuda if _on(g) == "cuda"
          else attn_bwd_qkvproj_reference)
    return fn(p, pd, src, w, b3, g, n_heads=n_heads, scale=scale,
              recompute=recompute)


class FusedAttentionQKVProj(torch.autograd.Function):
    """Attention with the QKV projection inside and its backward kernel
    (JAX ``_faq_fwd`` / ``_faq_bwd``). The forward (#18) saves p and pd
    (the same tensor twice at rate 0) and, with ``qkv_residual``, the
    projection it emits; the backward (#19) re-projects from x or reads that
    projection, and returns dx from the kernel, dW = xᵀ·dqkv (in w's dtype)
    and db3 = Σ dqkv in fp32 (in b3's dtype) as plain products. The mask and
    the seed get no gradient."""

    @staticmethod
    def forward(ctx, x, w, b3, attention_mask, n_heads: int, scale: float,
                rate: float, seed: int, qkv_residual: bool):
        ctx.n_heads, ctx.scale, ctx.qkv_residual = n_heads, scale, qkv_residual
        out, qkv, p, pd = attn_fwd_qkvproj(
            x, w, b3, attention_mask, n_heads=n_heads, scale=scale, rate=rate,
            seed=seed, save=True, emit_qkv=qkv_residual)
        ctx.save_for_backward(x, w, b3, qkv, p, pd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b3, qkv, p, pd = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dqkv, dx = attn_bwd_qkvproj(
            p, pd, qkv if ctx.qkv_residual else x, w, b3, g,
            n_heads=ctx.n_heads, scale=ctx.scale,
            recompute=not ctx.qkv_residual)
        b, s, d = x.shape
        flat = dqkv.reshape(b * s, 3 * d)
        dw = torch.matmul(flat.t(), x.reshape(b * s, d)).t().to(w.dtype)
        db3 = flat.float().sum(dim=0).to(b3.dtype).reshape(b3.shape)
        return (dx, dw, db3) + (None,) * 6


def fused_attention_qkvproj(
    x: torch.Tensor,                          # [B, S, D] hidden states
    w: torch.Tensor,                          # [D, 3D] packed QKV kernel
    b3: torch.Tensor,                         # [3D] packed QKV bias
    attention_mask: Optional[torch.Tensor],   # [B, S] {0,1}, 1 = real token
    *,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    qkv_residual: bool = False,
    interpret: Optional[bool] = None,
    nb_fwd: Optional[int] = None,
    nb_bwd: Optional[int] = None,
) -> torch.Tensor:
    """``fused_attention_packed`` with the QKV projection inside the kernel
    (the JAX entry's signature and refusals), returning the context
    [B, S, D].

    With a gradient (x, w or b3 requiring one) the forward is #18 with
    saved probs and the backward #19; ``qkv_residual`` also keeps the
    projection, so #19 reads it instead of re-projecting. Without one, #18
    saves nothing, as the JAX primal. ``dropout_rate`` applies only when
    ``deterministic`` is False, and then needs ``dropout_rng``, a CPU
    ``torch.Generator`` from which the kernel seed is drawn. Where the JAX
    entry takes its split structure, this one does too: past the 256 MB
    save cap (``resolve_save_probs``, ``FUSED_ATTN_SAVE=0``), and where
    #18/#19 do not reach (``qkvproj_fits``): the dense projection (the
    product rounded, then the bias added in the dtype), then
    ``fused_attention_packed``. ``interpret``/``nb_fwd``/``nb_bwd`` are TPU
    plan knobs and raise."""
    if interpret is not None or nb_fwd is not None or nb_bwd is not None:
        raise ValueError(
            "interpret/nb_fwd/nb_bwd are TPU kernel-plan knobs; the CUDA "
            "kernels take none")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got shape {tuple(x.shape)}")
    b, s, d = x.shape
    d3 = 3 * d
    if tuple(w.shape) != (d, d3):
        raise ValueError(f"qkv kernel must be [{d}, {d3}], got "
                         f"{tuple(w.shape)}")
    if tuple(b3.shape) not in ((d3,), (1, d3)):
        raise ValueError(f"qkv bias must be [{d3}], got {tuple(b3.shape)}")
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    _on(x)
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                        or b3.requires_grad)
    if (not resolve_save_probs(b, n_heads, s, rate, x.element_size())
            or not qkvproj_fits(s, d // n_heads, x.element_size(), grad)):
        qkv = F.linear(x, w.t()) + b3.reshape(d3)
        return fused_attention_packed(
            qkv, attention_mask, n_heads=n_heads, scale=scale,
            dropout_rate=dropout_rate, dropout_rng=dropout_rng,
            deterministic=deterministic)
    seed = draw_seed(dropout_rng) if rate > 0.0 else 0
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.float32)
    x = x.contiguous()
    b3 = b3.reshape(d3)
    if not grad:
        if torch.compiler.is_exporting():
            return _traced("attn_fwd_qkvproj", rate)(
                x, w, b3, attention_mask, n_heads, float(scale))
        return attn_fwd_qkvproj(x, w, b3, attention_mask, n_heads=n_heads,
                                scale=float(scale), rate=rate, seed=seed)[0]
    return FusedAttentionQKVProj.apply(x, w, b3, attention_mask, n_heads,
                                       float(scale), rate, seed,
                                       bool(qkv_residual))


# ---- rel attention: a full differentiable score bias --------------------------
#
# The port of the JAX ``fused_rel_attention`` full-H tier (XLNet's content
# and query streams): q [B, Q, D] and k, v [B, K, D] head-major (column
# h·Dh + c), and ebias [B, H, Q, K], the score bias assembled outside the
# kernels (rel-shifted bd + segment ef − 1e30·mask in the model). Three
# kernels, each with its plain version:
#
# * #11 ``attn_fwd_rel_cuda`` → ``csrc/attn_fwd_rel.cu``:
#   softmax(q_h·k_hᵀ·scale + ebias) → dropout → ·v_h, optionally saving p/pd;
# * #13 ``attn_bwd_rel_saved_cuda`` → ``csrc/attn_bwd_rel_saved.cu``:
#   dq, dk, dv and debias from the saved p/pd;
# * #12 ``attn_bwd_rel_cuda`` → ``csrc/attn_bwd_rel.cu``: the same with the
#   probs recomputed and the keep mask replayed.
#
# In bf16 all three run on the tensor cores (``csrc/attn_rel_full_tc.cuh``):
# #12 rebuilds p with #11's bits (its register plan to K = 64, #14's score
# tile past it) and then runs #13's phases, in one kernel code with #13.
# fp32 keeps the CUDA-core kernels.
#
# Past the full-H reach the same function runs on the head-blocked tier
# (#14/#15, ``csrc/attn_{fwd,bwd}_rel_hb.cu``, to ``HB_MAX_SEQ_LEN``) and
# then on the flash-streamed tier (#16 ``attn_fwd_rel_fs_cuda`` →
# ``csrc/attn_fwd_rel_fs.cu``: the online softmax over key blocks with the
# lse residual; #17 ``attn_bwd_rel_fs_cuda`` → ``csrc/attn_bwd_rel_fs.cu``:
# the flash backward from it, debias written by the pass that owns the
# query rows), at any Q and K (``rel_tier``).
#
# debias is the score gradient before the scale (the TPU kernels' dscore);
# dq/dk come from ds·scale rounded to the input dtype. The dropout stream
# is the packed kernels' (counter (k >> 2, q, h, b)), over [B, H, Q, K].


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] → [B, L, H·Dh]."""
    b, h, n, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * dh)


def _rel_probs(q, k, ebias, n_heads, scale):
    """fp32 scores (scale after the dot, then + ebias) and their
    max-subtracted softmax; a row masked whole (every bias −1e30) comes out
    uniform, as the TPU kernel's."""
    scores = torch.matmul(_ctx_heads(q, n_heads).float(),
                          _ctx_heads(k, n_heads).float().transpose(-1, -2))
    return torch.softmax(scores * scale + ebias.float(), dim=-1)


@_counted
def attn_fwd_rel_reference(
    q: torch.Tensor,                          # [B, Q, D]
    k: torch.Tensor,                          # [B, K, D]
    v: torch.Tensor,                          # [B, K, D]
    ebias: torch.Tensor,                      # [B, H, Q, K]
    *,
    n_heads: int,
    scale: float,
    rate: float = 0.0,
    seed: int = 0,
    save: bool = False,
    b_off: int = 0,
    h_off: int = 0,
):
    """Plain version of kernel #11, with #1's rounding points: fp32
    softmax; p (and pd at rate > 0) rounded to the input dtype when saved;
    the dropped probs rounded for a PV product accumulated in fp32, the
    Philox mask at the global (b, h) (``b_off``/``h_off``: the tensors'
    first batch row and head). Returns out [B, Q, D], or (out, p, pd)
    [B, H, Q, K] with ``save`` (pd is p at rate 0)."""
    return _rel_forward(_rel_probs(q, k, ebias, n_heads, scale), v, n_heads,
                        rate, seed, save, b_off, h_off)


def _rel_forward(p, v, n_heads, rate, seed, save, b_off=0, h_off=0):
    """#11's and #20's forward from the fp32 probs p [B, H, Q, K]: the
    Philox mask at the global (b, h), the dropped probs rounded to v's
    dtype for a PV product accumulated in fp32; with ``save`` also p and
    pd rounded (pd is p at rate 0)."""
    dtype = v.dtype
    pd = _dropped(p, seed, rate, b_off, h_off)
    out = _merge_heads(torch.matmul(pd.to(dtype).float(),
                                    _ctx_heads(v, n_heads).float()).to(dtype))
    if not save:
        return out
    p_c = p.to(dtype)
    return out, p_c, (pd.to(dtype) if rate > 0.0 else p_c)


def _rel_vjp(p, pd, pd_c, q, k, v, g, n_heads, scale, eb_dtype):
    """The rel backward kernels' shared math: dV = pd_cᵀ·g, t = pd ⊙
    (g·Vᵀ), ds = t − p·Σ_k t (debias, in ``eb_dtype``), ds_c = T(ds·scale),
    dQ = ds_c·K, dK = ds_cᵀ·Q; products accumulated in fp32."""
    dtype = q.dtype
    qh, kh, vh = (_ctx_heads(x, n_heads).float() for x in (q, k, v))
    gh = _ctx_heads(g, n_heads).float()
    dv = torch.matmul(pd_c.float().transpose(-1, -2), gh).to(dtype)
    t = pd * torch.matmul(gh, vh.transpose(-1, -2))
    ds = t - p * t.sum(dim=-1, keepdim=True)
    ds_c = (ds * scale).to(dtype).float()
    dq = torch.matmul(ds_c, kh).to(dtype)
    dk = torch.matmul(ds_c.transpose(-1, -2), qh).to(dtype)
    return (_merge_heads(dq), _merge_heads(dk), _merge_heads(dv),
            ds.to(eb_dtype))


@_counted
def attn_bwd_rel_reference(q, k, v, ebias, seed, g, *, n_heads, scale,
                           rate=0.0, b_off=0, h_off=0):
    """Plain version of kernel #12: the probs recomputed in fp32, the keep
    mask replayed from ``seed`` at the forward's offsets. Returns (dq, dk,
    dv, debias), debias in ebias's dtype."""
    p = _rel_probs(q, k, ebias, n_heads, scale)
    pd = _dropped(p, seed, rate, b_off, h_off)
    return _rel_vjp(p, pd, pd.to(q.dtype), q, k, v, g, n_heads, scale,
                    ebias.dtype)


@_counted
def attn_bwd_rel_saved_reference(p, pd, q, k, v, g, *, n_heads, scale):
    """Plain version of kernel #13: the VJP from the saved p and pd (input
    dtype, read as fp32). Returns (dq, dk, dv, debias), debias in the input
    dtype (the autograd function casts it to ebias's, as the JAX
    ``_frel_bwd``)."""
    return _rel_vjp(p.float(), pd.float(), pd, q, k, v, g, n_heads, scale,
                    q.dtype)


@_counted
def attn_fwd_rel_hb_reference(q, k, v, ebias, *, n_heads, scale, rate=0.0,
                              seed=0):
    """Plain version of kernel #14: #11's function (whole-row fp32 softmax,
    the Philox mask, the dropped probs rounded for PV), nothing saved.
    Returns out [B, Q, D]."""
    p = _rel_probs(q, k, ebias, n_heads, scale)
    pd = _dropped(p, seed, rate)
    return _merge_heads(torch.matmul(
        pd.to(q.dtype).float(), _ctx_heads(v, n_heads).float()).to(q.dtype))


@_counted
def attn_bwd_rel_hb_reference(q, k, v, ebias, seed, g, *, n_heads, scale,
                              rate=0.0):
    """Plain version of kernel #15: #12's function, the probs recomputed
    and the keep mask replayed. Returns (dq, dk, dv, debias), debias in
    ebias's dtype."""
    p = _rel_probs(q, k, ebias, n_heads, scale)
    pd = _dropped(p, seed, rate)
    return _rel_vjp(p, pd, pd.to(q.dtype), q, k, v, g, n_heads, scale,
                    ebias.dtype)


@_counted
def attn_fwd_rel_fs_reference(q, k, v, ebias, *, n_heads, scale, rate=0.0,
                              seed=0):
    """Plain version of kernel #16: #6's online softmax over key blocks of
    ``FS_KEY_BLOCK`` on s = (q_h·k_hᵀ)·scale + ebias, with its rounding
    points (e dropped by the Philox mask a key block at a time, from the
    global key index, and rounded to the input dtype for PV; out = acc / l
    in the input dtype; lse = m + log l). Returns (out [B, Q, D], lse
    [B, H, Q] fp32)."""
    dtype = q.dtype
    b, q_len, _ = q.shape
    k_len = k.shape[1]
    qh, kh, vh = (_ctx_heads(x, n_heads).float() for x in (q, k, v))
    m = torch.full(qh.shape[:3], -float("inf"), device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, k_len, FS_KEY_BLOCK):
        k1 = min(k0 + FS_KEY_BLOCK, k_len)
        sb = (torch.matmul(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
              + ebias[..., k0:k1].float())
        m_new = torch.maximum(m, sb.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sb - m_new[..., None])
        den = den * alpha + e.sum(dim=-1)
        if rate > 0.0:
            keep = dropout_keep_mask(seed, b, n_heads, q_len, k1 - k0, rate,
                                     q.device, k0)
            e = torch.where(keep, e * inv_keep(rate), 0.0)
        acc = acc * alpha[..., None] + torch.matmul(e.to(dtype).float(),
                                                    vh[:, :, k0:k1])
        m = m_new
    return (_merge_heads((acc / den[..., None]).to(dtype)),
            m + torch.log(den))


def _rel_fs_probs(q, k, v, ebias, seed, o, lse, g, n_heads, scale, rate):
    """The flash backward's per-element pieces, rebuilt from the forward's
    lse: (p, pd, dp, δ) with p = exp(s·scale + ebias − lse), d(pd) = g·vᵀ,
    δ = Σ g⊙o from the rounded output, and the replayed keep mask."""
    b, q_len, _ = q.shape
    qh, kh, vh, gh, oh = (_ctx_heads(x, n_heads).float()
                          for x in (q, k, v, g, o))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale
                  + ebias.float() - lse[..., None])
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, n_heads, q_len, k.shape[1], rate,
                                 q.device)
        pd = torch.where(keep, p * inv_keep(rate), 0.0)
        dp = torch.where(keep, dp * inv_keep(rate), 0.0)
    return p, pd, dp, delta


@_counted
def attn_bwd_rel_fs_reference(q, k, v, ebias, seed, o, lse, g, *, n_heads,
                              scale, rate=0.0):
    """Plain version of kernel #17: p rebuilt from the forward's lse, δ =
    Σ g⊙o, the replayed keep mask (``_rel_fs_probs``); ds = p·(dp − δ) the
    unscaled score gradient, debias = T(ds) in ebias's dtype, ds_c =
    T(ds·scale), pd_c = T(pd); dQ = ds_c·K, dK = ds_cᵀ·Q, dV = pd_cᵀ·g
    accumulated in fp32. Returns (dq, dk, dv, debias)."""
    dtype = q.dtype
    p, pd, dp, delta = _rel_fs_probs(q, k, v, ebias, seed, o, lse, g,
                                     n_heads, scale, rate)
    ds = p * (dp - delta)
    ds_c = (ds * scale).to(dtype).float()
    qh, kh, gh = (_ctx_heads(x, n_heads).float() for x in (q, k, g))
    dq = torch.matmul(ds_c, kh).to(dtype)
    dk = torch.matmul(ds_c.transpose(-1, -2), qh).to(dtype)
    dv = torch.matmul(pd.to(dtype).float().transpose(-1, -2), gh).to(dtype)
    return (_merge_heads(dq), _merge_heads(dk), _merge_heads(dv),
            ds.to(ebias.dtype))


def rel_grads_bf16_bound(refs, p, pd, q, k, v, g, *, n_heads, scale):
    """Elementwise bounds on how far two bf16 (dq, dk, dv, debias) of this
    math may lie apart (``dqkv_bf16_bound``'s argument): 2^-7·(|ref| + A)
    + 2^-17 with A = (|ds|·|K|, |ds|ᵀ·|Q|, |pd|ᵀ·|g|, |ds|/scale), |ds|
    bounded by (|t| + |p|·Σ|t|)·scale."""
    qh, kh, vh = (_ctx_heads(x, n_heads).float().abs() for x in (q, k, v))
    gh = _ctx_heads(g, n_heads).float().abs()
    p, pd = p.float().abs(), pd.float().abs()
    t = pd * torch.matmul(gh, vh.transpose(-1, -2))
    ds = t + p * t.sum(dim=-1, keepdim=True)
    a = (_merge_heads(torch.matmul(ds * scale, kh)),
         _merge_heads(torch.matmul(ds.transpose(-1, -2) * scale, qh)),
         _merge_heads(torch.matmul(pd.transpose(-1, -2), gh)), ds)
    return tuple(2.0 ** -7 * (r.float().abs() + x) + 2.0 ** -17
                 for r, x in zip(refs, a))


def rel_fs_grads_bf16_bound(refs, q, k, v, ebias, seed, o, lse, g, *,
                            n_heads, scale, rate=0.0):
    """Elementwise bounds on how far two bf16 (dq, dk, dv, debias) of #17's
    math may lie apart (``dqkv_bf16_bound``'s argument): each side rounds
    ds_c, pd_c and its outputs once, a rounding one ulp (≤ 2^-7 relative)
    either way, so the two lie within 2^-7 times the products over absolute
    values, A = (|ds|·|K|·scale, |ds|ᵀ·|Q|·scale, |pd|ᵀ·|g|, |ds|), with
    |ds| bounded by p·(|dp| + |δ|) from the magnitudes of its terms.
    Returns 2^-7·(|ref| + A) + 2^-17 for each output."""
    p, pd, dp, delta = _rel_fs_probs(q, k, v, ebias, seed, o, lse, g,
                                     n_heads, scale, rate)
    ds = p * (dp.abs() + delta.abs())
    qh, kh, gh = (_ctx_heads(x, n_heads).float().abs() for x in (q, k, g))
    a = (_merge_heads(torch.matmul(ds, kh)) * scale,
         _merge_heads(torch.matmul(ds.transpose(-1, -2), qh)) * scale,
         _merge_heads(torch.matmul(pd.abs().transpose(-1, -2), gh)), ds)
    return tuple(2.0 ** -7 * (r.float().abs() + x) + 2.0 ** -17
                 for r, x in zip(refs, a))


def rel_bwd_smem_bytes(q_len: int, k_len: int, dh: int) -> int:
    """Shared memory of one rel backward block (``csrc/common.cuh``'s
    ``rel_bwd_smem_floats``): a [Q][Dh+1] and a [K][Dh+1] staging tile and
    two [Q][K] tiles, in fp32."""
    return 4 * ((q_len + k_len) * (dh + 1) + 2 * q_len * k_len)


def rel_bwd_fits(q_len: int, k_len: int, dh: int) -> bool:
    """Whether the rel backward kernels take this (Q, K, Dh): one (head,
    batch row)'s [Q, K] problem in 227 KB (Q = K ≤ 141 at Dh = 64)."""
    return rel_bwd_smem_bytes(q_len, k_len, dh) <= MAX_SMEM_BYTES


# The longest K of bf16 #11's register plan (``csrc/attn_rel_full_tc.cuh``'s
# kRegMaxK): a block per (64-row query tile, head, batch row), each warp's
# 16 query rows × every key of scores in its registers. Past it bf16 #11
# takes #14's shared-memory score tile (``rel_hb_fwd_smem_bytes``).
REL_TC_REG_MAX_K = 64


def _rows16(n: int) -> int:
    return -(-n // 16) * 16


def rel_full_tc_fwd_smem_bytes(q_len: int, k_len: int, dh: int) -> int:
    """Shared memory of one bf16 #11 block at (Q, K, Dh)
    (``csrc/attn_rel_full_tc.cuh``'s ``fwd_plan_bytes``). Up to
    ``REL_TC_REG_MAX_K``: the q tile [Q16][``_tc_ld``] (Q16: min(Q, 64)
    rounded up to 16) and k, v [K16][``_tc_ld``], bf16 (27.6 KB at Q = K =
    50, Dh = 64). Past it #14's plan, ``rel_hb_fwd_smem_bytes`` (109.6 KB at
    K = 512, Dh = 128)."""
    if k_len <= REL_TC_REG_MAX_K:
        return (_rows16(min(q_len, 64)) + 2 * _rows16(k_len)) * _tc_ld(dh) * 2
    return rel_hb_fwd_smem_bytes(k_len, dh)


def rel_full_tc_bwd_smem_bytes(qc: int, k_len: int, dh: int,
                               multi: bool = False,
                               recompute: bool = False) -> int:
    """Shared memory of one bf16 #13 (or, with ``recompute``, #12) block
    whose query chunk holds ``qc`` rows (a multiple of 16) at K =
    ``k_len``, head width ``dh`` (``csrc/attn_rel_full_tc.cuh``'s
    ``bwd_smem_bytes``): the staging tiles A [qc][``_tc_ld``] (#12: q,
    then g, then q; #13: g, then q) and B [K16][``_tc_ld``] (k, v, k), bf16;
    #13 the pd and ds_c tiles [qc][K16 + 8] bf16, #12 the fp32 probs tile
    [qc][K16 + 4] (pd_c over it) and the ds_c tile; with more than one
    chunk (``multi``) the fp32 dK and dV sums [K16][Dh]."""
    kp = _rows16(k_len)
    probs = (qc * (kp + 4) * 4 + qc * (kp + 8) * 2 if recompute
             else 2 * qc * (kp + 8) * 2)
    return (2 * (qc + kp) * _tc_ld(dh) + probs
            + (2 * kp * dh * 4 if multi else 0))


def rel_full_tc_bwd_q_chunk(q_len: int, k_len: int, dh: int,
                            recompute: bool = False) -> int:
    """The query rows bf16 #13's (``recompute``: #12's) block takes at a
    time (``csrc/attn_rel_full_tc.cuh``'s ``bwd_q_chunk``): all of them,
    rounded up to 16, where they fit (every shape of ``rel_bwd_fits`` but,
    for #13, Q > 944 at K ≤ 21 and, for #12, whose fp32 probs tile is
    larger, Q > 400 at K ≤ 67); else the most 16-row slabs that fit beside
    the fp32 dK/dV sums; 0 where not even 16 do (no shape of
    ``rel_bwd_fits``)."""
    qp = _rows16(q_len)
    if rel_full_tc_bwd_smem_bytes(qp, k_len, dh,
                                  recompute=recompute) <= MAX_SMEM_BYTES:
        return qp
    qc = 0
    while (qc + 16 < qp and rel_full_tc_bwd_smem_bytes(
            qc + 16, k_len, dh, multi=True,
            recompute=recompute) <= MAX_SMEM_BYTES):
        qc += 16
    return qc


def _check_rel_cuda(name, q, k, v, ebias, n_heads, bwd,
                    bias_label="ebias", max_k=MAX_SEQ_LEN):
    """The checks every rel CUDA wrapper makes (``ebias`` is whichever
    [B, H, Q, K] tensor the kernel reads, named ``bias_label``; ``bwd``:
    the full-H backward's shared-memory plan; ``max_k``: the kernel's
    longest K, None for any); returns (b, q_len, k_len, dh)."""
    for label, t in (("q", q), ("k", k), ("v", v), (bias_label, ebias)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name}: {label} must be {q.dtype} on {q.device} like q "
                f"(the kernels read ebias in q's dtype), got {t.dtype} on "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, "
                         "bfloat16)")
    b, q_len, k_len, dh = _check_rel_geometry(q, k, v, ebias, n_heads)
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if max_k is not None and k_len > max_k:
        raise ValueError(f"{name}: K={k_len} exceeds the kernel's {max_k}")
    if bwd and not rel_bwd_fits(q_len, k_len, dh):
        raise ValueError(f"{name}: Q={q_len} K={k_len} Dh={dh} exceeds the "
                         "backward's shared memory")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"B={b} or H={n_heads} exceeds a grid dimension")
    check_sm90(q)
    return b, q_len, k_len, dh


def _check_rel_geometry(q, k, v, ebias, n_heads):
    if q.dim() != 3 or k.dim() != 3 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"q must be [B, Q, D] and k, v [B, K, D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, q_len, d = q.shape
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    k_len = k.shape[1]
    if tuple(ebias.shape) != (b, n_heads, q_len, k_len):
        raise ValueError(f"ebias must be [B, H, Q, K] = "
                         f"{(b, n_heads, q_len, k_len)}, got "
                         f"{tuple(ebias.shape)}")
    return b, q_len, k_len, d // n_heads


def attn_fwd_rel_cuda(q, k, v, ebias, *, n_heads, scale, rate=0.0, seed=0,
                      save=False, b_off=0, h_off=0):
    """Launch kernel #11 (``csrc/attn_fwd_rel.cu``): out [B, Q, D], or (out,
    p, pd) [B, H, Q, K] with ``save`` (pd is p at rate 0). q, k, v and
    ebias are contiguous CUDA tensors of one dtype: bf16 on the tensor
    cores (its plan, ``rel_full_tc_fwd_smem_bytes``, fits every K ≤
    ``MAX_SEQ_LEN``), fp32 on the CUDA cores. Raises on anything the
    kernel does not take and on a failed launch."""
    b, q_len, k_len, dh = _check_rel_cuda("attn_fwd_rel", q, k, v, ebias,
                                          n_heads, bwd=False)
    out = torch.empty_like(q)
    p = pd = None
    if save:
        p = torch.empty_like(ebias)
        pd = torch.empty_like(p) if rate > 0.0 else p
    _launch("attn_fwd_rel", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ebias.data_ptr(), out.data_ptr(), _ptr(p),
            _ptr(pd) if rate > 0.0 else None, b, q_len, k_len, n_heads, dh,
            float(scale), *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[q.dtype], device=q.device)
    attn_fwd_rel_cuda.launches += 1
    return (out, p, pd) if save else out


def attn_bwd_rel_cuda(q, k, v, ebias, seed, g, *, n_heads, scale, rate=0.0,
                      b_off=0, h_off=0):
    """Launch kernel #12 (``csrc/attn_bwd_rel.cu``): (dq, dk, dv, debias)
    with the probs recomputed and the keep mask replayed from ``seed``;
    bf16 on the tensor cores (its plan, ``rel_full_tc_bwd_q_chunk`` with
    ``recompute``, takes the whole ``rel_bwd_fits`` reach), fp32 on the
    CUDA cores."""
    b, q_len, k_len, dh = _check_rel_cuda("attn_bwd_rel", q, k, v, ebias,
                                          n_heads, bwd=True)
    _like("g", g, q, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    debias = torch.empty_like(ebias)
    _launch("attn_bwd_rel", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ebias.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), debias.data_ptr(), b, q_len, k_len, n_heads, dh,
            float(scale), *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[q.dtype], device=q.device)
    attn_bwd_rel_cuda.launches += 1
    return dq, dk, dv, debias


def attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, *, n_heads, scale):
    """Launch kernel #13 (``csrc/attn_bwd_rel_saved.cu``): (dq, dk, dv,
    debias) from the saved probs p and pd [B, H, Q, K]; bf16 on the tensor
    cores (its plan, ``rel_full_tc_bwd_q_chunk``, takes the whole
    ``rel_bwd_fits`` reach), fp32 on the CUDA cores."""
    b, q_len, k_len, dh = _check_rel_cuda("attn_bwd_rel_saved", q, k, v, p,
                                          n_heads, bwd=True, bias_label="p")
    _like("pd", pd, q, tuple(p.shape))
    _like("g", g, q, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    debias = torch.empty_like(p)
    _launch("attn_bwd_rel_saved", p.data_ptr(), pd.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), debias.data_ptr(), b, q_len, k_len,
            n_heads, dh, float(scale), _DTYPE_CODES[q.dtype],
            device=q.device)
    attn_bwd_rel_saved_cuda.launches += 1
    return dq, dk, dv, debias


def attn_fwd_rel_hb_cuda(q, k, v, ebias, *, n_heads, scale, rate=0.0,
                         seed=0):
    """Launch kernel #14 (``csrc/attn_fwd_rel_hb.cu``), K ≤
    ``HB_MAX_SEQ_LEN``: bf16 on the tensor cores, fp32 on the CUDA cores.
    Raises past the shared-memory plan (``rel_hb_fwd_smem_bytes``).
    Returns out [B, Q, D]."""
    _, _, k_len, dh = _check_rel_geometry(q, k, v, ebias, n_heads)
    _check_plan("attn_fwd_rel_hb",
                rel_hb_fwd_smem_bytes(k_len, dh, q.element_size()),
                f"K={k_len}, Dh={dh}")
    b, q_len, k_len, dh = _check_rel_cuda("attn_fwd_rel_hb", q, k, v, ebias,
                                          n_heads, bwd=False,
                                          max_k=HB_MAX_SEQ_LEN)
    out = torch.empty_like(q)
    _launch("attn_fwd_rel_hb", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ebias.data_ptr(), out.data_ptr(), b, q_len, k_len, n_heads, dh,
            float(scale), *_drop_args(rate, seed), _DTYPE_CODES[q.dtype],
            device=q.device)
    attn_fwd_rel_hb_cuda.launches += 1
    return out


def attn_bwd_rel_hb_cuda(q, k, v, ebias, seed, g, *, n_heads, scale,
                         rate=0.0):
    """Launch kernel #15 (``csrc/attn_bwd_rel_hb.cu``): (dq, dk, dv,
    debias) with the probs recomputed and the keep mask replayed from
    ``seed``, K ≤ ``HB_MAX_SEQ_LEN``. bf16: two tensor-core kernels on the
    current stream, each counted, the statistics, dQ and debias pass and
    then the dK/dV pass, through the rows' max m, 1/l and δ in a
    [3, B, H, Q] fp32 workspace allocated here. fp32: one CUDA-core kernel,
    its dK/dV accumulators in a [B, H, 2, K, Dh] fp32 workspace. Raises past
    the shared-memory plan (``rel_hb_bwd_smem_bytes``)."""
    _, _, k_len, dh = _check_rel_geometry(q, k, v, ebias, n_heads)
    _check_plan("attn_bwd_rel_hb",
                rel_hb_bwd_smem_bytes(k_len, dh, q.element_size()),
                f"K={k_len}, Dh={dh}")
    b, q_len, k_len, dh = _check_rel_cuda("attn_bwd_rel_hb", q, k, v, ebias,
                                          n_heads, bwd=False,
                                          max_k=HB_MAX_SEQ_LEN)
    _like("g", g, q, tuple(q.shape))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    debias = torch.empty_like(ebias)
    bf16 = q.dtype == torch.bfloat16
    ws = torch.empty((3, b, n_heads, q_len) if bf16
                     else (b, n_heads, 2, k_len, dh),
                     dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ebias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            debias.data_ptr(), ws.data_ptr(), b, q_len, k_len, n_heads, dh,
            float(scale), *_drop_args(rate, seed), _DTYPE_CODES[q.dtype])
    _launch("attn_bwd_rel_hb", *args, device=q.device)
    attn_bwd_rel_hb_cuda.launches += 1
    if bf16:
        _launch("attn_bwd_rel_hb_dkdv", *args, device=q.device)
        attn_bwd_rel_hb_cuda.launches += 1
    return dq, dk, dv, debias


def attn_fwd_rel_fs_cuda(q, k, v, ebias, *, n_heads, scale, rate=0.0,
                         seed=0):
    """Launch kernel #16 (``csrc/attn_fwd_rel_fs.cu``): any Q and K; bf16
    on the tensor cores, fp32 on the CUDA cores. Raises past the
    shared-memory plan (``rel_fs_fwd_smem_bytes``). Returns (out
    [B, Q, D], lse [B, H, Q] fp32)."""
    dh = _check_rel_geometry(q, k, v, ebias, n_heads)[3]
    _check_plan("attn_fwd_rel_fs",
                rel_fs_fwd_smem_bytes(dh, q.element_size()), f"Dh={dh}")
    b, q_len, k_len, dh = _check_rel_cuda("attn_fwd_rel_fs", q, k, v, ebias,
                                          n_heads, bwd=False, max_k=None)
    out = torch.empty_like(q)
    lse = torch.empty((b, n_heads, q_len), dtype=torch.float32,
                      device=q.device)
    _launch("attn_fwd_rel_fs", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ebias.data_ptr(), out.data_ptr(), lse.data_ptr(), b, q_len,
            k_len, n_heads, dh, float(scale), *_drop_args(rate, seed),
            _DTYPE_CODES[q.dtype], device=q.device)
    attn_fwd_rel_fs_cuda.launches += 1
    return out, lse


def attn_bwd_rel_fs_cuda(q, k, v, ebias, seed, o, lse, g, *, n_heads, scale,
                         rate=0.0):
    """Launch kernel #17 (``csrc/attn_bwd_rel_fs.cu``), two kernels on the
    current stream, each counted: the dK/dV pass, then the dQ pass, which
    also writes debias; bf16 on the tensor cores, fp32 on the CUDA cores.
    ``o`` and ``lse`` are #16's outputs. Raises past the shared-memory plan
    (``rel_fs_bwd_smem_bytes``). Returns (dq, dk, dv, debias), debias in
    ebias's dtype (q's)."""
    dh = _check_rel_geometry(q, k, v, ebias, n_heads)[3]
    _check_plan("attn_bwd_rel_fs",
                rel_fs_bwd_smem_bytes(dh, q.element_size()), f"Dh={dh}")
    b, q_len, k_len, dh = _check_rel_cuda("attn_bwd_rel_fs", q, k, v, ebias,
                                          n_heads, bwd=False, max_k=None)
    _like("o", o, q, tuple(q.shape))
    _like("g", g, q, tuple(q.shape))
    _check_lse(lse, q, b, n_heads, q_len)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    debias = torch.empty_like(ebias)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ebias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), debias.data_ptr(), b, q_len, k_len,
            n_heads, dh, float(scale), *_drop_args(rate, seed),
            _DTYPE_CODES[q.dtype])
    _launch("attn_bwd_rel_fs_dkdv", *args, device=q.device)
    attn_bwd_rel_fs_cuda.launches += 1
    _launch("attn_bwd_rel_fs_dq", *args, device=q.device)
    attn_bwd_rel_fs_cuda.launches += 1
    return dq, dk, dv, debias


for _fn in (attn_fwd_rel_cuda, attn_bwd_rel_cuda, attn_bwd_rel_saved_cuda,
            attn_fwd_rel_hb_cuda, attn_bwd_rel_hb_cuda, attn_fwd_rel_fs_cuda,
            attn_bwd_rel_fs_cuda):
    _fn.launches = 0
del _fn


def attn_fwd_rel(q, k, v, ebias, *, n_heads, scale, rate=0.0, seed=0,
                 save=False, b_off=0, h_off=0):
    """Kernel #11 on a CUDA tensor, its plain version on a CPU one."""
    fn = attn_fwd_rel_cuda if _on(q) == "cuda" else attn_fwd_rel_reference
    return fn(q, k, v, ebias, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed, save=save, b_off=b_off, h_off=h_off)


def attn_bwd_rel(q, k, v, ebias, seed, g, *, n_heads, scale, rate=0.0,
                 b_off=0, h_off=0):
    """Kernel #12 on a CUDA tensor, its plain version on a CPU one."""
    fn = attn_bwd_rel_cuda if _on(q) == "cuda" else attn_bwd_rel_reference
    return fn(q, k, v, ebias, seed, g, n_heads=n_heads, scale=scale,
              rate=rate, b_off=b_off, h_off=h_off)


def attn_bwd_rel_saved(p, pd, q, k, v, g, *, n_heads, scale):
    """Kernel #13 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_rel_saved_cuda if _on(q) == "cuda"
          else attn_bwd_rel_saved_reference)
    return fn(p, pd, q, k, v, g, n_heads=n_heads, scale=scale)


def attn_fwd_rel_hb(q, k, v, ebias, *, n_heads, scale, rate=0.0, seed=0):
    """Kernel #14 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_rel_hb_cuda if _on(q) == "cuda"
          else attn_fwd_rel_hb_reference)
    return fn(q, k, v, ebias, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed)


def attn_bwd_rel_hb(q, k, v, ebias, seed, g, *, n_heads, scale, rate=0.0):
    """Kernel #15 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_rel_hb_cuda if _on(q) == "cuda"
          else attn_bwd_rel_hb_reference)
    return fn(q, k, v, ebias, seed, g, n_heads=n_heads, scale=scale,
              rate=rate)


def attn_fwd_rel_fs(q, k, v, ebias, *, n_heads, scale, rate=0.0, seed=0):
    """Kernel #16 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_rel_fs_cuda if _on(q) == "cuda"
          else attn_fwd_rel_fs_reference)
    return fn(q, k, v, ebias, n_heads=n_heads, scale=scale, rate=rate,
              seed=seed)


def attn_bwd_rel_fs(q, k, v, ebias, seed, o, lse, g, *, n_heads, scale,
                    rate=0.0):
    """Kernel #17 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_rel_fs_cuda if _on(q) == "cuda"
          else attn_bwd_rel_fs_reference)
    return fn(q, k, v, ebias, seed, o, lse, g, n_heads=n_heads, scale=scale,
              rate=rate)


class FusedRelAttention(torch.autograd.Function):
    """Rel attention with its backward kernel (JAX ``_frel_fwd`` /
    ``_frel_bwd``). With ``save`` the forward keeps p and pd and not ebias
    (the backward needs only its dtype) and the backward runs #13; without,
    it keeps q, k, v, ebias and the seed, and #12 recomputes the probs.
    ``b_off``/``h_off`` place the mask at the global (b, h) (a
    tensor-parallel rank's shard). Returns (dq, dk, dv, debias), debias in
    ebias's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, ebias, n_heads: int, scale: float,
                rate: float, seed: int, save: bool, b_off: int = 0,
                h_off: int = 0):
        ctx.n_heads, ctx.scale, ctx.rate = n_heads, scale, rate
        ctx.seed, ctx.save, ctx.eb_dtype = seed, save, ebias.dtype
        ctx.offs = dict(b_off=b_off, h_off=h_off)
        kw = dict(n_heads=n_heads, scale=scale, rate=rate, seed=seed,
                  **ctx.offs)
        if save:
            out, p, pd = attn_fwd_rel(q, k, v, ebias, save=True, **kw)
            ctx.save_for_backward(q, k, v, p, pd)
        else:
            out = attn_fwd_rel(q, k, v, ebias, **kw)
            ctx.save_for_backward(q, k, v, ebias)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        kw = dict(n_heads=ctx.n_heads, scale=ctx.scale)
        if ctx.save:
            q, k, v, p, pd = ctx.saved_tensors
            dq, dk, dv, debias = attn_bwd_rel_saved(p, pd, q, k, v, g, **kw)
        else:
            q, k, v, ebias = ctx.saved_tensors
            dq, dk, dv, debias = attn_bwd_rel(q, k, v, ebias, ctx.seed, g,
                                              rate=ctx.rate, **ctx.offs, **kw)
        return (dq, dk, dv, debias.to(ctx.eb_dtype),
                None, None, None, None, None, None, None)


class FusedRelAttentionHB(torch.autograd.Function):
    """The head-blocked rel tier with its backward kernel (JAX
    ``_frelhb_fwd`` / ``_frelhb_bwd``): #14 forward keeps q, k, v, ebias
    and the seed; #15 recomputes the probs and replays the mask. Nothing
    Q·K-sized is saved beyond ebias, the input itself."""

    @staticmethod
    def forward(ctx, q, k, v, ebias, n_heads: int, scale: float, rate: float,
                seed: int):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        ctx.eb_dtype = ebias.dtype
        ctx.save_for_backward(q, k, v, ebias)
        return attn_fwd_rel_hb(q, k, v, ebias, n_heads=n_heads, scale=scale,
                               rate=rate, seed=seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, ebias = ctx.saved_tensors
        dq, dk, dv, debias = attn_bwd_rel_hb(q, k, v, ebias, ctx.seed,
                                             g.contiguous(),
                                             n_heads=ctx.n_heads,
                                             scale=ctx.scale, rate=ctx.rate)
        return dq, dk, dv, debias.to(ctx.eb_dtype), None, None, None, None


class FusedRelAttentionFS(torch.autograd.Function):
    """The flash-streamed rel tier with its backward kernel (JAX
    ``_frelfs_fwd`` / ``_frelfs_bwd``): #16 forward keeps q, k, v, ebias,
    the seed and its residuals out and lse; #17 rebuilds the probs from
    lse. debias comes back in ebias's dtype, as ``_frelfs_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, ebias, n_heads: int, scale: float, rate: float,
                seed: int):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        ctx.eb_dtype = ebias.dtype
        out, lse = attn_fwd_rel_fs(q, k, v, ebias, n_heads=n_heads,
                                   scale=scale, rate=rate, seed=seed)
        ctx.save_for_backward(q, k, v, ebias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, ebias, out, lse = ctx.saved_tensors
        dq, dk, dv, debias = attn_bwd_rel_fs(q, k, v, ebias, ctx.seed, out,
                                             lse, g.contiguous(),
                                             n_heads=ctx.n_heads,
                                             scale=ctx.scale, rate=ctx.rate)
        return dq, dk, dv, debias.to(ctx.eb_dtype), None, None, None, None


def rel_tier(q_len: int, k_len: int, dh: int, grad: bool,
             ingredients_ok: bool, inkernel: bool = False) -> str:
    """The rel-attention tier at (Q, K, Dh), the twin of ``packed_tier``,
    keyed by the port's own kernels' reach. Where the bias ingredients are
    eligible (``ingredients_ok``: the model's ``rel_bias_impl`` "auto" or
    "inkernel", one [P, D] position stream with P ≥ Q + K, no ``head_mask``
    and no ``output_attentions``) under ``inkernel`` (the model's
    ``rel_bias_impl="inkernel"``):

    * "ik_full" (#20, and #22 or #21 with a gradient) while
      ``relik_full_fits``;
    * "ik_fs" (#23, and #24) past that, at any length.

    Otherwise:

    * "full" (#11, and #13 or #12 with a gradient) while K ≤
      ``MAX_SEQ_LEN`` and, with a gradient, ``rel_bwd_fits``;
    * "ik_fs" past that where the ingredients are eligible;
    * "hb" (#14, and #15) otherwise, while Q and K ≤ ``HB_MAX_SEQ_LEN``;
    * "fs" (#16, and #17) past that, at any Q and K: the JAX entry's last
      kernel tier (``_fused_rel_attention_fs``).

    Every geometry has a tier. The JAX model takes its ingredients tiers by
    its VMEM fits (the full-H one to Q = K = 224 at xlnet-base bf16); the
    port keys every tier by its kernels' reach instead, as ``packed_tier``
    does."""
    if ingredients_ok and inkernel:
        return ("ik_full" if relik_full_fits(q_len, k_len, dh, grad)
                else "ik_fs")
    if k_len <= MAX_SEQ_LEN and (not grad or rel_bwd_fits(q_len, k_len, dh)):
        return "full"
    if ingredients_ok:
        return "ik_fs"
    if q_len <= HB_MAX_SEQ_LEN and k_len <= HB_MAX_SEQ_LEN:
        return "hb"
    return "fs"


def fused_rel_attention(
    q: torch.Tensor,                          # [B, Q, D] head-major
    k: torch.Tensor,                          # [B, K, D]
    v: torch.Tensor,                          # [B, K, D]
    ebias: torch.Tensor,                      # [B, H, Q, K]
    *,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    interpret: Optional[bool] = None,
    nb_fwd: Optional[int] = None,
    nb_bwd: Optional[int] = None,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """softmax(q_h·k_hᵀ·scale + ebias[:, h]) with prob dropout, ·v_h, as
    [B, Q, D]; ebias is differentiable. Same signature and meaning as the
    JAX entry: ``dropout_rate`` applies only when ``deterministic`` is
    False and then needs ``dropout_rng`` (a CPU ``torch.Generator``, from
    which the kernel seed is drawn); ``save_probs`` picks the saved-probs
    or recompute backward of the full-H tier (``resolve_save_probs`` on
    [B, H, Q, K]). When no gradient is being taken the forward saves
    nothing.

    ``interpret``/``nb_fwd``/``nb_bwd`` are TPU plan knobs and raise. The
    tier is ``rel_tier``'s without the ingredients: the full-H kernels
    while they reach, then the head-blocked tier (#14, and #15 with a
    recompute backward) up to ``HB_MAX_SEQ_LEN``, then the flash-streamed
    tier (#16, and #17 from the saved out and lse) at any Q and K. It
    never degrades to einsum math."""
    if interpret is not None or nb_fwd is not None or nb_bwd is not None:
        raise ValueError(
            "interpret/nb_fwd/nb_bwd are TPU kernel-plan knobs; the CUDA "
            "kernels take none")
    return _fused_rel(q, k, v, ebias, n_heads, scale, dropout_rate,
                      dropout_rng, deterministic, save_probs, None)


def _fused_rel(q, k, v, ebias, n_heads, scale, dropout_rate, dropout_rng,
               deterministic, save_probs, offsets):
    """``fused_rel_attention``'s body. ``offsets`` (b_off, h_off), a
    tensor-parallel rank's: the tensors' first (b, h) in the global batch
    and heads (the dropout stream), on the full-H kernels alone; None for
    one card."""
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    b, q_len, k_len, dh = _check_rel_geometry(q, k, v, ebias, n_heads)
    if rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    _on(q)
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, ebias))
    tier = rel_tier(q_len, k_len, dh, grad, ingredients_ok=False)
    if offsets is not None and tier != "full":
        raise ValueError(
            f"Q={q_len} K={k_len} Dh={dh} is past the full-H rel kernels' "
            "reach: a head shard runs on them alone (rel_tier)")
    b_off, h_off = offsets or (0, 0)
    seed = draw_seed(dropout_rng) if rate > 0.0 else 0
    q, k, v, ebias = (x.contiguous() for x in (q, k, v, ebias))
    kw = dict(n_heads=n_heads, scale=scale, rate=rate, seed=seed)
    if not grad:
        if torch.compiler.is_exporting():
            return _traced("attn_fwd_rel" + _TIER_SUFFIX[tier], rate)(
                q, k, v, ebias, n_heads, float(scale))
        if tier == "full":
            return attn_fwd_rel(q, k, v, ebias, b_off=b_off, h_off=h_off,
                                **kw)
        if tier == "hb":
            return attn_fwd_rel_hb(q, k, v, ebias, **kw)
        return attn_fwd_rel_fs(q, k, v, ebias, **kw)[0]
    if tier == "hb":
        return FusedRelAttentionHB.apply(q, k, v, ebias, n_heads,
                                         float(scale), rate, seed)
    if tier == "fs":
        return FusedRelAttentionFS.apply(q, k, v, ebias, n_heads,
                                         float(scale), rate, seed)
    save = resolve_save_probs(b, n_heads, q_len, rate, q.element_size(),
                              save_probs, k_len=k_len)
    return FusedRelAttention.apply(q, k, v, ebias, n_heads, float(scale),
                                   rate, seed, save, b_off, h_off)


def fused_rel_attention_tp(
    q: torch.Tensor,                          # [B/dp, Q, D/mp] head-major
    k: torch.Tensor,                          # [B/dp, K, D/mp]
    v: torch.Tensor,                          # [B/dp, K, D/mp]
    ebias: torch.Tensor,                      # [B/dp, H/mp, Q, K]
    *,
    mesh,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """``fused_rel_attention`` on one rank of a tensor-parallel mesh
    (``parallel/mesh.py``): q, k, v and ebias are this rank's batch rows
    (its data shard) and its ``n_heads`` heads (its model shard), the JAX
    ``fused_rel_attention_tp``'s per-device block, on the full-H kernels
    #11-#13 (the model checks ``rel_tier`` first). The kernels draw the
    dropout of the global (b, h): batch row offset ``mesh.data_rank`` ·
    B_local, head offset ``mesh.model_rank`` · H_local, from the seed that
    every rank draws alike from ``dropout_rng``. The JAX wrapper instead
    folds the model and the data index into its rng (ROADMAP C, deliberate
    departures). Over more than one data rank the ``Trainer`` hands each
    data rank its own ``dropout_rng`` (the data rank folded into the
    seed), which then keeps the shards apart on its own."""
    return _fused_rel(q, k, v, ebias, n_heads, scale, dropout_rate,
                      dropout_rng, deterministic, None,
                      (mesh.data_rank * q.shape[0], mesh.model_rank * n_heads))


# ---- rel attention from its bias ingredients, flash-streamed (#23, #24) -----
#
# The port of the JAX ``fused_rel_attention_ingredients`` fs tier, the
# long-sequence MAG-XLNet path: in place of an assembled ebias the kernels
# take its ingredients and build each score themselves,
#
#   s[b,h,q,k] = (rw·k)·scale + rr·r[Q − q + k] + ed[b,h,q]·segd[b,q,k]
#                + maskb[b,q,k]
#
# with rw = q + r_w_bias and rr = (q + r_r_bias)·scale [B, Q, D], the
# position keys r [P, D] (P ≥ Q + K: the relative shift of XLNet's
# ``rel_shift`` is the index Q − q + k), the segment delta ed [B, H, Q]
# (scale·(q + r_s_bias)·(seg₁ − seg₀)) and the seg-diff and mask biases
# segd, maskb [B, Q, K]. The reference's ef₀ term, constant along k, is
# softmax-invariant with a zero gradient and is left out (JAX
# ``ops/fused_attention.py`` :3626-3632). Nothing [B, H, Q, P]- or
# [B, H, Q, K]-sized is built on the card:
#
# * #23 ``attn_fwd_relik_fs_cuda`` → ``csrc/attn_fwd_relik_fs.cu``: the
#   online softmax over key blocks of ``FS_KEY_BLOCK`` (#6's), dropout, PV;
#   out and lse;
# * #24 ``attn_bwd_relik_fs_cuda`` → ``csrc/attn_bwd_relik_fs.cu``: drw,
#   drr, dr, dk, dv and ded from lse, in three launches.
#
# The plain versions build the whole [B, H, Q, P] product rr·rᵀ and shift
# it with a gather; they run on the CPU and in the card's checks.


def _shift_index(q_len: int, k_len: int, device) -> torch.Tensor:
    """[1, 1, Q, K] int64: the position Q − q + k that score (q, k) reads."""
    return (q_len - torch.arange(q_len, device=device)[:, None]
            + torch.arange(k_len, device=device)[None, :])[None, None]


def _relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads, scale):
    """fp32 scores [B, H, Q, K] from the ingredients, in the kernels' order
    of additions: ((rw·kᵀ)·scale + rr·r[Q − q + k]) + ed·segd + maskb."""
    b, q_len, d = rw.shape
    k_len, p_len = k.shape[1], r.shape[0]
    ac = torch.matmul(_ctx_heads(rw, n_heads).float(),
                      _ctx_heads(k, n_heads).float().transpose(-1, -2))
    rh = r.float().reshape(p_len, n_heads, d // n_heads).permute(1, 0, 2)
    bd = torch.matmul(_ctx_heads(rr, n_heads).float(), rh.transpose(-1, -2))
    bd = torch.gather(bd, 3, _shift_index(q_len, k_len, rw.device).expand(
        b, n_heads, q_len, k_len))
    return ((ac * scale + bd) + ed.float()[..., None] * segd.float()[:, None]
            + maskb.float()[:, None])


@_counted
def attn_fwd_relik_fs_reference(rw, rr, r, k, v, ed, segd, maskb, *,
                                n_heads, scale, rate=0.0, seed=0, b_off=0,
                                h_off=0):
    """Plain version of kernel #23: the whole row's scores from the
    ingredients, then #6's online softmax over key blocks of
    ``FS_KEY_BLOCK`` with its rounding points (e dropped by the Philox
    mask, a key block at a time, and rounded to the input dtype for PV;
    out = acc / l in the input dtype; lse = m + log l). Returns (out
    [B, Q, D], lse [B, H, Q] fp32)."""
    dtype = rw.dtype
    b, q_len, _ = rw.shape
    k_len = k.shape[1]
    s = _relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads, scale)
    vh = _ctx_heads(v, n_heads).float()
    m = torch.full(s.shape[:3], -float("inf"), device=rw.device)
    den = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:3], vh.shape[-1], device=rw.device)
    for k0 in range(0, k_len, FS_KEY_BLOCK):
        k1 = min(k0 + FS_KEY_BLOCK, k_len)
        sb = s[..., k0:k1]
        m_new = torch.maximum(m, sb.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sb - m_new[..., None])
        den = den * alpha + e.sum(dim=-1)
        if rate > 0.0:
            keep = dropout_keep_mask(seed, b, n_heads, q_len, k1 - k0, rate,
                                     rw.device, k0, b_off, h_off)
            e = torch.where(keep, e * inv_keep(rate), 0.0)
        acc = acc * alpha[..., None] + torch.matmul(e.to(dtype).float(),
                                                    vh[:, :, k0:k1])
        m = m_new
    return (_merge_heads((acc / den[..., None]).to(dtype)),
            m + torch.log(den))


@_counted
def attn_bwd_relik_fs_reference(rw, rr, r, k, v, ed, segd, maskb, seed, o,
                                lse, g, *, n_heads, scale, rate=0.0, b_off=0,
                                h_off=0):
    """Plain version of kernel #24: p = exp(s − lse) from the forward's lse,
    δ = Σ g⊙o from the rounded output, d(pd) = g·vᵀ; with the replayed keep
    mask pd = keep·p/(1−rate) and dp = keep·d(pd)/(1−rate); ds = p·(dp − δ);
    ds_c = T(ds·scale), ds_u = T(ds), pd_c = T(pd); drw = ds_c·k, dk =
    ds_cᵀ·rw, dv = pd_cᵀ·g, drr[q] = Σ_k ds_u[q, k]·r[Q − q + k], dr[p] =
    Σ_{b, q} ds_u[b, q, p − Q + q]·rr[b, q], ded = Σ_k ds·segd, products in
    fp32, each output rounded once to the input dtype. Returns (drw, drr,
    dr, dk, dv, ded)."""
    dtype = rw.dtype
    b, q_len, _ = rw.shape
    k_len = k.shape[1]
    vh, gh, oh = (_ctx_heads(x, n_heads).float() for x in (v, g, o))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    p = torch.exp(_relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads,
                                scale) - lse[..., None])
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, n_heads, q_len, k_len, rate,
                                 rw.device, 0, b_off, h_off)
        pd = torch.where(keep, p * inv_keep(rate), 0.0)
        dp = torch.where(keep, dp * inv_keep(rate), 0.0)
    drw, drr, dr, dk, dv, ded = _relik_grads(
        p * (dp - delta), pd.to(dtype), rw, rr, r, k, g, segd, n_heads, scale)
    return drw, drr, dr.to(dtype), dk, dv, ded


def _relik_grads(ds, pd_c, rw, rr, r, k, g, segd, n_heads, scale):
    """The ingredients backward from the fp32 score gradient ds [B, H, Q,
    K] and the rounded dropped probs pd_c (the JAX ``_relik_grads`` with its
    callers' dv): ds_c = T(ds·scale), ds_u = T(ds); drw = ds_c·k, dk =
    ds_cᵀ·rw, dv = pd_cᵀ·g, drr[q] = Σ_k ds_u[q, k]·r[Q − q + k], dr[p] =
    Σ_{b, q} ds_u[b, q, p − Q + q]·rr[b, q], ded = Σ_k ds·segd, products in
    fp32. Returns (drw, drr, dr, dk, dv, ded): dr in fp32, the rest rounded
    once to rw's dtype."""
    dtype = rw.dtype
    b, q_len, d = rw.shape
    k_len, p_len = k.shape[1], r.shape[0]
    rwh, rrh, kh, gh = (_ctx_heads(x, n_heads).float() for x in (rw, rr, k, g))
    ds_c = (ds * scale).to(dtype).float()
    # ds_u placed at the positions it multiplies: z[q, Q − q + k] = ds_u[q, k]
    z = torch.zeros(b, n_heads, q_len, p_len, device=rw.device)
    z.scatter_(3, _shift_index(q_len, k_len, rw.device).expand(
        b, n_heads, q_len, k_len), ds.to(dtype).float())
    rh = r.float().reshape(p_len, n_heads, d // n_heads).permute(1, 0, 2)
    drw = _merge_heads(torch.matmul(ds_c, kh)).to(dtype)
    drr = _merge_heads(torch.matmul(z, rh)).to(dtype)
    dr = torch.einsum("bhqp,bhqf->phf", z, rrh).reshape(p_len, d)
    dk = _merge_heads(torch.matmul(ds_c.transpose(-1, -2), rwh)).to(dtype)
    dv = _merge_heads(torch.matmul(pd_c.float().transpose(-1, -2),
                                   gh)).to(dtype)
    ded = (ds * segd.float()[:, None]).sum(dim=-1).to(dtype)
    return drw, drr, dr, dk, dv, ded


def relik_grads_bf16_bound(refs, rw, rr, r, k, v, ed, segd, maskb, seed,
                           lse, g, o, *, n_heads, scale, rate=0.0):
    """Elementwise bounds on how far two bf16 (drw, drr, dr, dk, dv, ded)
    of #24's math may lie apart (``dqkv_bf16_bound``'s argument): each side
    rounds ds_c, ds_u and pd_c once and its outputs once; a rounding may
    land one ulp (≤ 2^-7 relative) the other way, so the two lie within
    2^-7 times the products taken over absolute values, A = (|ds|·|k|·
    scale, |ds|·|r shifted|, Σ_{b,q} |ds|·|rr| on the diagonals, |ds|ᵀ·|rw|·
    scale, |pd|ᵀ·|g|, Σ_k |ds|·|segd|), with |ds| bounded by p·(|dp| +
    |δ|) from the magnitudes of its terms. Returns 2^-7·(|ref| + A) +
    2^-17 for each output."""
    b, q_len, _ = rw.shape
    k_len = k.shape[1]
    vh, gh, oh = (_ctx_heads(x, n_heads).float().abs() for x in (v, g, o))
    p = torch.exp(_relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads,
                                scale) - lse[..., None])
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, n_heads, q_len, k_len, rate,
                                 rw.device)
        pd = torch.where(keep, p * inv_keep(rate), 0.0)
        dp = torch.where(keep, dp * inv_keep(rate), 0.0)
    return _relik_bound(refs, p * (dp + (gh * oh).sum(dim=-1, keepdim=True)),
                        pd, rw, rr, r, k, g, segd, n_heads, scale)


def relik_full_grads_bf16_bound(refs, p, pd, rw, rr, r, k, v, segd, g, *,
                                n_heads, scale):
    """Elementwise bounds on how far two bf16 (drw, drr, dr, dk, dv, ded)
    of #21's or #22's math may lie apart (``dqkv_bf16_bound``'s argument),
    as ``relik_grads_bf16_bound`` with |ds| bounded by |t| + |p|·Σ_k |t|,
    t = pd ⊙ (g·vᵀ), from the probs p and pd. Returns 2^-7·(|ref| + A) +
    2^-17 for each output."""
    vh, gh = (_ctx_heads(x, n_heads).float().abs() for x in (v, g))
    p, pd = p.float().abs(), pd.float().abs()
    t = pd * torch.matmul(gh, vh.transpose(-1, -2))
    return _relik_bound(refs, t + p * t.sum(dim=-1, keepdim=True), pd, rw, rr,
                        r, k, g, segd, n_heads, scale)


def _relik_bound(refs, ds, pd, rw, rr, r, k, g, segd, n_heads, scale):
    """2^-7·(|ref| + A) + 2^-17 for each of (drw, drr, dr, dk, dv, ded) from
    a bound |ds| on the score gradient and |pd|, A the products of
    ``_relik_grads`` over absolute values."""
    b, q_len, d = rw.shape
    k_len, p_len = k.shape[1], r.shape[0]
    rwh, rrh, kh, gh = (_ctx_heads(x, n_heads).float().abs()
                        for x in (rw, rr, k, g))
    z = torch.zeros(b, n_heads, q_len, p_len, device=rw.device)
    z.scatter_(3, _shift_index(q_len, k_len, rw.device).expand(
        b, n_heads, q_len, k_len), ds)
    rh = r.float().abs().reshape(p_len, n_heads, d // n_heads).permute(
        1, 0, 2)
    a = (_merge_heads(torch.matmul(ds, kh)) * scale,
         _merge_heads(torch.matmul(z, rh)),
         torch.einsum("bhqp,bhqf->phf", z, rrh).reshape(p_len, d),
         _merge_heads(torch.matmul(ds.transpose(-1, -2), rwh)) * scale,
         _merge_heads(torch.matmul(pd.transpose(-1, -2), gh)),
         (ds * segd.float().abs()[:, None]).sum(dim=-1))
    return tuple(2.0 ** -7 * (ref.float().abs() + x) + 2.0 ** -17
                 for ref, x in zip(refs, a))


def _check_relik_geometry(rw, rr, r, k, v, ed, segd, maskb, n_heads):
    """Shapes of the ingredients (ed, segd or maskb None: not checked);
    returns (b, q_len, k_len, p_len, dh)."""
    if rw.dim() != 3 or tuple(rr.shape) != tuple(rw.shape):
        raise ValueError(f"rw and rr must be [B, Q, D] alike, got "
                         f"{tuple(rw.shape)}, {tuple(rr.shape)}")
    b, q_len, d = rw.shape
    if k.dim() != 3 or tuple(v.shape) != tuple(k.shape) or (
            k.shape[0] != b or k.shape[2] != d):
        raise ValueError(f"k and v must be [B, K, D] with rw's B and D, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    k_len = k.shape[1]
    if r.dim() != 2 or r.shape[1] != d:
        raise ValueError(f"r must be [P, D] with D={d}, got {tuple(r.shape)}")
    p_len = r.shape[0]
    if p_len < q_len + k_len:
        raise ValueError(
            f"position stream P={p_len} < Q+K={q_len + k_len}: the relative "
            "shift reads r[Q − q + k], which needs P ≥ Q + K")
    if ed is not None and tuple(ed.shape) != (b, n_heads, q_len):
        raise ValueError(f"ed must be [B, H, Q] = {(b, n_heads, q_len)}, got "
                         f"{tuple(ed.shape)}")
    for label, t in (("segd", segd), ("maskb", maskb)):
        if t is not None and tuple(t.shape) != (b, q_len, k_len):
            raise ValueError(f"{label} must be [B, Q, K] = "
                             f"{(b, q_len, k_len)}, got {tuple(t.shape)}")
    return b, q_len, k_len, p_len, d // n_heads


def _check_relik_cuda(name, tensors, n_heads):
    """The checks the ingredients CUDA wrappers make: every tensor of
    ``tensors`` (label → tensor, rw first) a contiguous CUDA tensor of rw's
    dtype, the ingredients among them of matching shapes; returns (b,
    q_len, k_len, p_len, dh)."""
    rw = tensors["rw"]
    for label, t in tensors.items():
        if not t.is_cuda or t.dtype != rw.dtype or t.device != rw.device:
            raise ValueError(
                f"{name}: {label} must be a CUDA tensor of rw's dtype "
                f"{rw.dtype} on {rw.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if rw.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {rw.dtype} not supported (float32, "
                         "bfloat16)")
    geo = _check_relik_geometry(*(tensors.get(x) for x in (
        "rw", "rr", "r", "k", "v", "ed", "segd", "maskb")), n_heads)
    b, dh = geo[0], geo[-1]
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"B={b} or H={n_heads} exceeds a grid dimension")
    check_sm90(rw)
    return geo


def attn_fwd_relik_fs_cuda(rw, rr, r, k, v, ed, segd, maskb, *, n_heads,
                           scale, rate=0.0, seed=0, b_off=0, h_off=0):
    """Launch kernel #23 (``csrc/attn_fwd_relik_fs.cu``): every input a
    contiguous CUDA tensor of one dtype (fp32 or bf16; bf16 on the tensor
    cores, fp32 on the CUDA cores), any Q and K, P ≥ Q + K. Raises past
    the shared-memory plan (``relik_fs_fwd_smem_bytes``). Returns (out
    [B, Q, D], lse [B, H, Q] fp32)."""
    ins = dict(rw=rw, rr=rr, r=r, k=k, v=v, ed=ed, segd=segd, maskb=maskb)
    dh = _check_relik_geometry(rw, rr, r, k, v, ed, segd, maskb, n_heads)[-1]
    _check_plan("attn_fwd_relik_fs",
                relik_fs_fwd_smem_bytes(dh, rw.element_size()), f"Dh={dh}")
    b, q_len, k_len, p_len, dh = _check_relik_cuda("attn_fwd_relik_fs", ins,
                                                   n_heads)
    out = torch.empty_like(rw)
    lse = torch.empty((b, n_heads, q_len), dtype=torch.float32,
                      device=rw.device)
    _launch("attn_fwd_relik_fs", *(t.data_ptr() for t in ins.values()),
            out.data_ptr(), lse.data_ptr(), b, q_len, k_len, p_len, n_heads,
            dh, float(scale), *_drop_args(rate, seed), int(b_off),
            int(h_off), _DTYPE_CODES[rw.dtype], device=rw.device)
    attn_fwd_relik_fs_cuda.launches += 1
    return out, lse


def attn_bwd_relik_fs_cuda(rw, rr, r, k, v, ed, segd, maskb, seed, o, lse, g,
                           *, n_heads, scale, rate=0.0, b_off=0, h_off=0):
    """Launch kernel #24 (``csrc/attn_bwd_relik_fs.cu``), three kernels on
    the current stream, each counted: the dK/dV pass, the pass over each
    (batch row, head) that writes drw, drr, ded and its dr rows into an
    fp32 [B, P, D] workspace allocated here, and the sum of the workspace
    over B into dr; bf16 on the tensor cores, fp32 on the CUDA cores.
    ``o`` and ``lse`` are #23's outputs. Raises past the shared-memory plan
    (``relik_fs_bwd_smem_bytes``). Returns (drw, drr, dr, dk, dv, ded) in
    rw's dtype."""
    dh = _check_relik_geometry(rw, rr, r, k, v, ed, segd, maskb, n_heads)[-1]
    _check_plan("attn_bwd_relik_fs",
                relik_fs_bwd_smem_bytes(dh, rw.element_size()), f"Dh={dh}")
    ins = dict(rw=rw, rr=rr, r=r, k=k, v=v, ed=ed, segd=segd, maskb=maskb,
               o=o, g=g)
    b, q_len, k_len, p_len, dh = _check_relik_cuda("attn_bwd_relik_fs", ins,
                                                   n_heads)
    _like("o", o, rw, tuple(rw.shape))
    _like("g", g, rw, tuple(rw.shape))
    _check_lse(lse, rw, b, n_heads, q_len)
    drw, drr, dk, dv, ded, dr = (torch.empty_like(x)
                                 for x in (rw, rr, k, v, ed, r))
    d = rw.shape[-1]
    ws = torch.zeros((b, p_len, d), dtype=torch.float32, device=rw.device)
    args = (rw.data_ptr(), rr.data_ptr(), r.data_ptr(), k.data_ptr(),
            v.data_ptr(), ed.data_ptr(), segd.data_ptr(), maskb.data_ptr(),
            o.data_ptr(), lse.data_ptr(), g.data_ptr(), drw.data_ptr(),
            drr.data_ptr(), dk.data_ptr(), dv.data_ptr(), ded.data_ptr(),
            ws.data_ptr(), b, q_len, k_len, p_len, n_heads, dh, float(scale),
            *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[rw.dtype])
    _launch("attn_bwd_relik_fs_dkdv", *args, device=rw.device)
    attn_bwd_relik_fs_cuda.launches += 1
    _launch("attn_bwd_relik_fs_dq", *args, device=rw.device)
    attn_bwd_relik_fs_cuda.launches += 1
    _launch("attn_bwd_relik_fs_dr", ws.data_ptr(), dr.data_ptr(), b, p_len,
            d, _DTYPE_CODES[rw.dtype], device=rw.device)
    attn_bwd_relik_fs_cuda.launches += 1
    return drw, drr, dr, dk, dv, ded


attn_fwd_relik_fs_cuda.launches = 0
attn_bwd_relik_fs_cuda.launches = 0


def attn_fwd_relik_fs(rw, rr, r, k, v, ed, segd, maskb, *, n_heads, scale,
                      rate=0.0, seed=0, b_off=0, h_off=0):
    """Kernel #23 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_relik_fs_cuda if _on(rw) == "cuda"
          else attn_fwd_relik_fs_reference)
    return fn(rw, rr, r, k, v, ed, segd, maskb, n_heads=n_heads, scale=scale,
              rate=rate, seed=seed, b_off=b_off, h_off=h_off)


def attn_bwd_relik_fs(rw, rr, r, k, v, ed, segd, maskb, seed, o, lse, g, *,
                      n_heads, scale, rate=0.0, b_off=0, h_off=0):
    """Kernel #24 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_relik_fs_cuda if _on(rw) == "cuda"
          else attn_bwd_relik_fs_reference)
    return fn(rw, rr, r, k, v, ed, segd, maskb, seed, o, lse, g,
              n_heads=n_heads, scale=scale, rate=rate, b_off=b_off,
              h_off=h_off)


class FusedRelAttentionIKFS(torch.autograd.Function):
    """The ingredients flash-streamed tier with its backward kernel (JAX
    ``_frelikfs_fwd`` / ``_frelikfs_bwd``): #23 forward keeps the
    ingredients, the seed and its residuals o and lse; #24 rebuilds the
    probs from lse. segd and maskb get no gradient; ``b_off``/``h_off``
    place the mask at the global (b, h)."""

    @staticmethod
    def forward(ctx, rw, rr, r, k, v, ed, segd, maskb, n_heads: int,
                scale: float, rate: float, seed: int, b_off: int = 0,
                h_off: int = 0):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        ctx.offs = dict(b_off=b_off, h_off=h_off)
        out, lse = attn_fwd_relik_fs(rw, rr, r, k, v, ed, segd, maskb,
                                     n_heads=n_heads, scale=scale, rate=rate,
                                     seed=seed, **ctx.offs)
        ctx.save_for_backward(rw, rr, r, k, v, ed, segd, maskb, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        rw, rr, r, k, v, ed, segd, maskb, out, lse = ctx.saved_tensors
        drw, drr, dr, dk, dv, ded = attn_bwd_relik_fs(
            rw, rr, r, k, v, ed, segd, maskb, ctx.seed, out, lse,
            g.contiguous(), n_heads=ctx.n_heads, scale=ctx.scale,
            rate=ctx.rate, **ctx.offs)
        return (drw, drr, dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                ded.to(ed.dtype), None, None, None, None, None, None, None,
                None)


# ---- rel attention from its bias ingredients, full-H (#20, #21, #22) -------
#
# The port of the JAX ``fused_rel_attention_ingredients`` full tier, the
# MAG-XLNet path under ``rel_bias_impl="inkernel"`` while its kernels
# reach: the scores of the section above, a whole key row at a time (#11's
# plan), the probs saved for the backward or recomputed there:
#
# * #20 ``attn_fwd_relik_cuda`` → ``csrc/attn_fwd_relik.cu``: softmax,
#   dropout and PV (#11's), optionally p and pd; in bf16 on the tensor
#   cores (``csrc/attn_relik_full_tc.cuh``, as #21);
# * #22 ``attn_bwd_relik_saved_cuda`` → ``csrc/attn_bwd_relik_saved.cu``
#   (from p and pd) and #21 ``attn_bwd_relik_cuda`` →
#   ``csrc/attn_bwd_relik.cu`` (the probs recomputed, the mask replayed):
#   drw, drr, dk, dv, ded, and each (batch row, head)'s dr rows into an
#   fp32 [B, P, D] workspace that #24's third launch sums over B, so two
#   launches a call and no float atomics.
#
# dr comes back in fp32 from both the kernels and the plain versions, as
# the TPU kernels accumulate it; ``FusedRelAttentionIK`` casts it to r's
# dtype (the JAX ``_frelik_bwd``).


@_counted
def attn_fwd_relik_reference(rw, rr, r, k, v, ed, segd, maskb, *, n_heads,
                             scale, rate=0.0, seed=0, save=False, b_off=0,
                             h_off=0):
    """Plain version of kernel #20: the fp32 softmax of the scores the
    ingredients make (``_relik_scores``), then #11's plain forward (the
    Philox mask, T(pd)·v accumulated in fp32). Returns out [B, Q, D], or
    (out, p, pd) [B, H, Q, K] with ``save`` (pd is p at rate 0)."""
    p = torch.softmax(_relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads,
                                    scale), dim=-1)
    return _rel_forward(p, v, n_heads, rate, seed, save, b_off, h_off)


def _relik_vjp(p, pd, pd_c, rw, rr, r, k, v, segd, g, n_heads, scale):
    """#21's and #22's math: t = pd ⊙ (g·vᵀ), ds = t − p·Σ_k t (fp32), then
    ``_relik_grads``. Returns (drw, drr, dr fp32, dk, dv, ded)."""
    vh, gh = (_ctx_heads(x, n_heads).float() for x in (v, g))
    t = pd * torch.matmul(gh, vh.transpose(-1, -2))
    ds = t - p * t.sum(dim=-1, keepdim=True)
    return _relik_grads(ds, pd_c, rw, rr, r, k, g, segd, n_heads, scale)


@_counted
def attn_bwd_relik_reference(rw, rr, r, k, v, ed, segd, maskb, seed, g, *,
                             n_heads, scale, rate=0.0, b_off=0, h_off=0):
    """Plain version of kernel #21: the probs recomputed in fp32, the keep
    mask replayed from ``seed``, pd in fp32 for t and rounded for dv.
    Returns (drw, drr, dr, dk, dv, ded), dr in fp32."""
    p = torch.softmax(_relik_scores(rw, rr, r, k, ed, segd, maskb, n_heads,
                                    scale), dim=-1)
    pd = _dropped(p, seed, rate, b_off, h_off)
    return _relik_vjp(p, pd, pd.to(rw.dtype), rw, rr, r, k, v, segd, g,
                      n_heads, scale)


@_counted
def attn_bwd_relik_saved_reference(p, pd, rw, rr, r, k, v, segd, g, *,
                                   n_heads, scale):
    """Plain version of kernel #22: the VJP from the saved p and pd (input
    dtype, read as fp32). Returns (drw, drr, dr, dk, dv, ded), dr in
    fp32."""
    return _relik_vjp(p.float(), pd.float(), pd, rw, rr, r, k, v, segd, g,
                      n_heads, scale)


def relik_bwd_smem_bytes(q_len: int, k_len: int, dh: int) -> int:
    """Shared memory of one #21/#22 block (``csrc/common.cuh``'s
    ``relik_bwd_smem_floats``): the [Q][Dh+1] rw/g and rr tiles, the
    [K][Dh+1] k/v tile, the [Q+K−1][Dh+1] r window and three [Q][K] tiles,
    in fp32."""
    return 4 * ((3 * q_len + 2 * k_len - 1) * (dh + 1) + 3 * q_len * k_len)


def relik_bwd_fits(q_len: int, k_len: int, dh: int) -> bool:
    """Whether #21 and #22 take this (Q, K, Dh): one (head, batch row)'s
    problem in 227 KB (at Dh = 64: Q = 50 with K = 100, Q = K ≤ 95)."""
    return relik_bwd_smem_bytes(q_len, k_len, dh) <= MAX_SMEM_BYTES


def relik_fwd_smem_bytes(k_len: int, dh: int) -> int:
    """Shared memory of one #20 block (``csrc/attn_fwd_relik.cu``'s
    ``smem_floats``): the rw and rr tiles [16][Dh], a k/v chunk [64][Dh+1],
    the r window [79][Dh+1], the scores [16][K] and ed [16], in fp32 (123
    KB at K = 512, Dh = 128)."""
    return 4 * (2 * 16 * dh + (64 + 79) * (dh + 1) + 16 * k_len + 16)


def relik_full_fits(q_len: int, k_len: int, dh: int, grad: bool) -> bool:
    """Whether the full-H ingredients kernels reach (Q, K, Dh): #20 to K =
    ``MAX_SEQ_LEN`` within its plan (``relik_fwd_smem_bytes``), and with a
    gradient #21/#22's plan (``relik_bwd_fits``)."""
    return (k_len <= MAX_SEQ_LEN
            and relik_fwd_smem_bytes(k_len, dh) <= MAX_SMEM_BYTES
            and (not grad or relik_bwd_fits(q_len, k_len, dh)))


def relik_full_tc_fwd_smem_bytes(q_len: int, k_len: int, dh: int) -> int:
    """Shared memory of one bf16 #20 block at (Q, K, Dh)
    (``csrc/attn_relik_full_tc.cuh``'s ``fwd_plan_bytes``). Up to
    ``REL_TC_REG_MAX_K``: rw, rr [Q16][``_tc_ld``] (Q16: min(Q, 64) rounded
    up to 16), k, v [K16][``_tc_ld``] and the r window [Q16 + 64][``_tc_ld``],
    bf16, the warps' fp32 strips [Q16][72] over the window (55.3 KB at Q =
    K = 50, Dh = 64). Past it the score tile [32][keys + 4] fp32 (keys: K
    rounded up to 64), rw, rr [32][``_tc_ld``] and a two-stage ring of a
    64-key block with its 96 window rows [160][``_tc_ld``], bf16 (170.5 KB
    at K = 512, Dh = 128)."""
    ld = _tc_ld(dh)
    if k_len <= REL_TC_REG_MAX_K:
        qp = _rows16(min(q_len, 64))
        return ((2 * qp + 2 * _rows16(k_len)) * ld * 2
                + max((qp + 64) * ld * 2, qp * 72 * 4))
    keys = -(-k_len // 64) * 64
    return 32 * (keys + 4) * 4 + (2 * 32 + 2 * 160) * ld * 2


def relik_full_tc_bwd_smem_bytes(qc: int, k_len: int, dh: int,
                                 multi: bool = False) -> int:
    """Shared memory of one bf16 #21/#22 block whose query chunk holds ``qc``
    rows (a multiple of 16) at K = ``k_len``, head width ``dh``
    (``csrc/attn_relik_full_tc.cuh``'s ``bwd_smem_bytes``): rw/g, rr
    [qc][``_tc_ld``], k/v [K16][``_tc_ld``] and the r window [qc +
    K16][``_tc_ld``], bf16; the probs [qc][K16 + 4] fp32 (pd_c over them);
    ds_c [qc][K16 + 8] and the skewed ds_u [qc][K16 + 24], bf16; with more
    than one chunk (``multi``) the fp32 dK and dV sums [K16][Dh]."""
    kp = _rows16(k_len)
    return ((3 * qc + 2 * kp) * _tc_ld(dh) * 2 + qc * (kp + 4) * 4
            + qc * ((kp + 8) + (kp + 24)) * 2
            + (2 * kp * dh * 4 if multi else 0))


def relik_full_tc_bwd_q_chunk(q_len: int, k_len: int, dh: int) -> int:
    """The query rows bf16 #21's and #22's block takes at a time
    (``csrc/attn_relik_full_tc.cuh``'s ``bwd_q_chunk``): all of them,
    rounded up to 16, where they fit; else the most 16-row slabs that fit
    beside the fp32 dK/dV sums; 0 where not even 16 do (no shape of
    ``relik_bwd_fits`` with K ≤ ``MAX_SEQ_LEN``)."""
    qp = _rows16(q_len)
    if relik_full_tc_bwd_smem_bytes(qp, k_len, dh) <= MAX_SMEM_BYTES:
        return qp
    qc = 0
    while (qc + 16 < qp and relik_full_tc_bwd_smem_bytes(
            qc + 16, k_len, dh, multi=True) <= MAX_SMEM_BYTES):
        qc += 16
    return qc


def attn_fwd_relik_cuda(rw, rr, r, k, v, ed, segd, maskb, *, n_heads, scale,
                        rate=0.0, seed=0, save=False, b_off=0, h_off=0):
    """Launch kernel #20 (``csrc/attn_fwd_relik.cu``; bf16 on the tensor
    cores, ``relik_full_tc_fwd_smem_bytes``): every input a contiguous CUDA
    tensor of one dtype (fp32 or bf16), K ≤ ``MAX_SEQ_LEN``, P ≥ Q + K.
    Returns out [B, Q, D], or (out, p, pd) [B, H, Q, K] with ``save`` (pd
    is p at rate 0)."""
    ins = dict(rw=rw, rr=rr, r=r, k=k, v=v, ed=ed, segd=segd, maskb=maskb)
    b, q_len, k_len, p_len, dh = _check_relik_cuda("attn_fwd_relik", ins,
                                                   n_heads)
    if not relik_full_fits(q_len, k_len, dh, grad=False):
        raise ValueError(f"attn_fwd_relik: K={k_len} exceeds the kernel's "
                         f"{MAX_SEQ_LEN}")
    out = torch.empty_like(rw)
    p = pd = None
    if save:
        p = torch.empty((b, n_heads, q_len, k_len), dtype=rw.dtype,
                        device=rw.device)
        pd = torch.empty_like(p) if rate > 0.0 else p
    _launch("attn_fwd_relik", *(t.data_ptr() for t in ins.values()),
            out.data_ptr(), _ptr(p), _ptr(pd) if rate > 0.0 else None, b,
            q_len, k_len, p_len, n_heads, dh, float(scale),
            *_drop_args(rate, seed), int(b_off), int(h_off),
            _DTYPE_CODES[rw.dtype], device=rw.device)
    attn_fwd_relik_cuda.launches += 1
    return (out, p, pd) if save else out


def _relik_bwd_outputs(name, rw, r, q_len, k_len, n_heads, dh):
    """The backward's reach check, then its outputs drw, drr, dk, dv and
    ded (rw's dtype), the fp32 [B, P, D] workspace and the fp32 dr."""
    if not relik_bwd_fits(q_len, k_len, dh):
        raise ValueError(f"{name}: Q={q_len} K={k_len} Dh={dh} exceeds the "
                         "backward's shared memory")
    b, _, d = rw.shape
    k_shape = (b, k_len, d)
    new = functools.partial(torch.empty, device=rw.device)
    return (new(rw.shape, dtype=rw.dtype), new(rw.shape, dtype=rw.dtype),
            new(k_shape, dtype=rw.dtype), new(k_shape, dtype=rw.dtype),
            new((b, n_heads, q_len), dtype=rw.dtype),
            new((b, r.shape[0], d), dtype=torch.float32),
            new(tuple(r.shape), dtype=torch.float32))


def _relik_dr_sum(fn, ws, dr, device):
    """#24's third launch on ``ws``, counted on ``fn``: dr = Σ_b ws[b] in a
    fixed order, in fp32."""
    b, p_len, d = ws.shape
    _launch("attn_bwd_relik_fs_dr", ws.data_ptr(), dr.data_ptr(), b, p_len,
            d, _DTYPE_CODES[torch.float32], device=device)
    fn.launches += 1


def attn_bwd_relik_cuda(rw, rr, r, k, v, ed, segd, maskb, seed, g, *,
                        n_heads, scale, rate=0.0, b_off=0, h_off=0):
    """Launch kernel #21 (``csrc/attn_bwd_relik.cu``; bf16 on the tensor
    cores, ``relik_full_tc_bwd_q_chunk``), two kernels on the current
    stream, each counted: the (head, batch row) pass, with the probs
    recomputed and the keep mask replayed from ``seed``, that writes drw,
    drr, dk, dv, ded and its dr rows into an fp32 [B, P, D] workspace
    allocated here, then the workspace's sum over B. Returns (drw, drr, dr,
    dk, dv, ded), dr in fp32."""
    ins = dict(rw=rw, rr=rr, r=r, k=k, v=v, ed=ed, segd=segd, maskb=maskb,
               g=g)
    b, q_len, k_len, p_len, dh = _check_relik_cuda("attn_bwd_relik", ins,
                                                   n_heads)
    _like("g", g, rw, tuple(rw.shape))
    if (rw.dtype == torch.bfloat16
            and relik_full_tc_bwd_q_chunk(q_len, k_len, dh) == 0):
        raise ValueError(f"attn_bwd_relik: K={k_len} Dh={dh} exceeds the "
                         "bf16 plan's shared memory")
    drw, drr, dk, dv, ded, ws, dr = _relik_bwd_outputs(
        "attn_bwd_relik", rw, r, q_len, k_len, n_heads, dh)
    _launch("attn_bwd_relik", *(t.data_ptr() for t in ins.values()),
            *(t.data_ptr() for t in (drw, drr, dk, dv, ded, ws)), b, q_len,
            k_len, p_len, n_heads, dh, float(scale), *_drop_args(rate, seed),
            int(b_off), int(h_off), _DTYPE_CODES[rw.dtype], device=rw.device)
    attn_bwd_relik_cuda.launches += 1
    _relik_dr_sum(attn_bwd_relik_cuda, ws, dr, rw.device)
    return drw, drr, dr, dk, dv, ded


def attn_bwd_relik_saved_cuda(p, pd, rw, rr, r, k, v, segd, g, *, n_heads,
                              scale):
    """Launch kernel #22 (``csrc/attn_bwd_relik_saved.cu``; bf16 on the
    tensor cores, #21's kernel without its recompute,
    ``relik_full_tc_bwd_q_chunk``) from the saved probs p and pd [B, H, Q,
    K], two kernels on the current stream, each counted (as
    ``attn_bwd_relik_cuda``). Returns (drw, drr, dr, dk, dv, ded), dr in
    fp32."""
    ins = dict(rw=rw, rr=rr, r=r, k=k, v=v, segd=segd, g=g, p=p, pd=pd)
    b, q_len, k_len, p_len, dh = _check_relik_cuda("attn_bwd_relik_saved",
                                                   ins, n_heads)
    _like("g", g, rw, tuple(rw.shape))
    for label, t in (("p", p), ("pd", pd)):
        _like(label, t, rw, (b, n_heads, q_len, k_len))
    if (rw.dtype == torch.bfloat16
            and relik_full_tc_bwd_q_chunk(q_len, k_len, dh) == 0):
        raise ValueError(f"attn_bwd_relik_saved: K={k_len} Dh={dh} exceeds "
                         "the bf16 plan's shared memory")
    drw, drr, dk, dv, ded, ws, dr = _relik_bwd_outputs(
        "attn_bwd_relik_saved", rw, r, q_len, k_len, n_heads, dh)
    _launch("attn_bwd_relik_saved", *(t.data_ptr() for t in (
        p, pd, rw, rr, r, k, v, segd, g, drw, drr, dk, dv, ded, ws)), b,
        q_len, k_len, p_len, n_heads, dh, float(scale),
        _DTYPE_CODES[rw.dtype], device=rw.device)
    attn_bwd_relik_saved_cuda.launches += 1
    _relik_dr_sum(attn_bwd_relik_saved_cuda, ws, dr, rw.device)
    return drw, drr, dr, dk, dv, ded


for _fn in (attn_fwd_relik_cuda, attn_bwd_relik_cuda,
            attn_bwd_relik_saved_cuda):
    _fn.launches = 0
del _fn


def attn_fwd_relik(rw, rr, r, k, v, ed, segd, maskb, *, n_heads, scale,
                   rate=0.0, seed=0, save=False, b_off=0, h_off=0):
    """Kernel #20 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_fwd_relik_cuda if _on(rw) == "cuda"
          else attn_fwd_relik_reference)
    return fn(rw, rr, r, k, v, ed, segd, maskb, n_heads=n_heads, scale=scale,
              rate=rate, seed=seed, save=save, b_off=b_off, h_off=h_off)


def attn_bwd_relik(rw, rr, r, k, v, ed, segd, maskb, seed, g, *, n_heads,
                   scale, rate=0.0, b_off=0, h_off=0):
    """Kernel #21 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_relik_cuda if _on(rw) == "cuda"
          else attn_bwd_relik_reference)
    return fn(rw, rr, r, k, v, ed, segd, maskb, seed, g, n_heads=n_heads,
              scale=scale, rate=rate, b_off=b_off, h_off=h_off)


def attn_bwd_relik_saved(p, pd, rw, rr, r, k, v, segd, g, *, n_heads, scale):
    """Kernel #22 on a CUDA tensor, its plain version on a CPU one."""
    fn = (attn_bwd_relik_saved_cuda if _on(rw) == "cuda"
          else attn_bwd_relik_saved_reference)
    return fn(p, pd, rw, rr, r, k, v, segd, g, n_heads=n_heads, scale=scale)


class FusedRelAttentionIK(torch.autograd.Function):
    """The full-H ingredients tier with its backward kernel (JAX
    ``_frelik_fwd`` / ``_frelik_bwd``): with ``save`` #20 keeps p and pd
    and #22 runs from them; without, it keeps the ingredients and the seed
    and #21 recomputes the probs and replays the mask. segd and maskb get
    no gradient; dr comes back in r's dtype and ded in ed's;
    ``b_off``/``h_off`` place the mask at the global (b, h)."""

    @staticmethod
    def forward(ctx, rw, rr, r, k, v, ed, segd, maskb, n_heads: int,
                scale: float, rate: float, seed: int, save: bool,
                b_off: int = 0, h_off: int = 0):
        ctx.n_heads, ctx.scale, ctx.rate, ctx.seed = n_heads, scale, rate, seed
        ctx.save, ctx.ed_dtype = save, ed.dtype
        ctx.offs = dict(b_off=b_off, h_off=h_off)
        kw = dict(n_heads=n_heads, scale=scale, rate=rate, seed=seed,
                  **ctx.offs)
        if save:
            out, p, pd = attn_fwd_relik(rw, rr, r, k, v, ed, segd, maskb,
                                        save=True, **kw)
            ctx.save_for_backward(rw, rr, r, k, v, segd, p, pd)
        else:
            out = attn_fwd_relik(rw, rr, r, k, v, ed, segd, maskb, **kw)
            ctx.save_for_backward(rw, rr, r, k, v, ed, segd, maskb)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        kw = dict(n_heads=ctx.n_heads, scale=ctx.scale)
        if ctx.save:
            rw, rr, r, k, v, segd, p, pd = ctx.saved_tensors
            drw, drr, dr, dk, dv, ded = attn_bwd_relik_saved(
                p, pd, rw, rr, r, k, v, segd, g, **kw)
        else:
            rw, rr, r, k, v, ed, segd, maskb = ctx.saved_tensors
            drw, drr, dr, dk, dv, ded = attn_bwd_relik(
                rw, rr, r, k, v, ed, segd, maskb, ctx.seed, g, rate=ctx.rate,
                **ctx.offs, **kw)
        return (drw, drr, dr.to(r.dtype), dk, dv, ded.to(ctx.ed_dtype), None,
                None, None, None, None, None, None, None, None)


def fused_rel_attention_ingredients(
    rw: torch.Tensor,                         # [B, Q, D] q + r_w_bias
    rr: torch.Tensor,                         # [B, Q, D] (q + r_r_bias)·scale
    r: torch.Tensor,                          # [P, D] k_head_r, P ≥ Q + K
    k: torch.Tensor,                          # [B, K, D]
    v: torch.Tensor,                          # [B, K, D]
    ed: torch.Tensor,                         # [B, H, Q] segment delta
    segd: torch.Tensor,                       # [B, Q, K] seg-diff (0/1)
    maskb: torch.Tensor,                      # [B, Q, K] additive mask bias
    *,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    interpret: Optional[bool] = None,
    nb_fwd: Optional[int] = None,
    nb_bwd: Optional[int] = None,
    save_probs: Optional[bool] = None,
    tier: Optional[str] = None,
    fs_plan: Optional[tuple] = None,
) -> torch.Tensor:
    """XLNet relative attention from its score-bias ingredients, as
    [B, Q, D]: ``fused_rel_attention`` with ebias = rel_shift(rr·rᵀ) +
    ed·segd + maskb, less the reference's softmax-invariant ef₀ constant.
    rw, rr, r, k, v and ed are differentiable; segd and maskb are not.
    Same signature and argument checks as the JAX entry; the dropout
    arguments as ``fused_rel_attention``'s.

    Two tiers, as in JAX (``:4160-4185``): "full" (#20, and #22 or #21 with
    a gradient, ``FusedRelAttentionIK``; ``save_probs`` picks the backward
    as ``fused_rel_attention``'s) while ``relik_full_fits``, and "fs" (#23,
    and #24 from the saved o and lse; nothing S²-sized saved, so
    ``save_probs`` has no effect) at any Q and K. ``tier=None`` takes "full"
    while it reaches, else "fs"; ``tier="full"`` past the reach raises,
    naming it. ``interpret``/``nb_fwd``/``nb_bwd``/``fs_plan`` are TPU plan
    knobs and raise."""
    if (interpret is not None or nb_fwd is not None or nb_bwd is not None
            or fs_plan is not None):
        raise ValueError(
            "interpret/nb_fwd/nb_bwd/fs_plan are TPU kernel-plan knobs; the "
            "CUDA kernels take none")
    return _fused_relik(rw, rr, r, k, v, ed, segd, maskb, n_heads, scale,
                        dropout_rate, dropout_rng, deterministic, save_probs,
                        tier, 0, 0)


def _fused_relik(rw, rr, r, k, v, ed, segd, maskb, n_heads, scale,
                 dropout_rate, dropout_rng, deterministic, save_probs, tier,
                 b_off, h_off):
    """``fused_rel_attention_ingredients``'s body; ``b_off``/``h_off``
    place the tensors' first (b, h) in the global batch and heads (the
    dropout stream)."""
    if tier not in (None, "fs", "full"):
        raise ValueError(f"unknown tier {tier!r} (None | 'fs' | 'full')")
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    b, q_len, k_len, _, dh = _check_relik_geometry(rw, rr, r, k, v, ed, segd,
                                                   maskb, n_heads)
    if rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    _on(rw)
    xs = [x.contiguous() for x in (rw, rr, r, k, v, ed, segd, maskb)]
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs[:6])
    reach = relik_full_fits(q_len, k_len, dh, grad)
    if tier == "full" and not reach:
        raise ValueError(
            f"tier='full': Q={q_len} K={k_len} Dh={dh} is past the full-H "
            f"ingredients kernels' reach (K ≤ {MAX_SEQ_LEN}; with a "
            "gradient, relik_bwd_fits)")
    seed = draw_seed(dropout_rng) if rate > 0.0 else 0
    kw = dict(n_heads=n_heads, scale=scale, rate=rate, seed=seed,
              b_off=b_off, h_off=h_off)
    if not grad and torch.compiler.is_exporting():
        name = ("attn_fwd_relik_fs" if tier == "fs" or not reach
                else "attn_fwd_relik")
        return _traced(name, rate)(*xs, n_heads, float(scale))
    if tier == "fs" or not reach:
        if not grad:
            return attn_fwd_relik_fs(*xs, **kw)[0]
        return FusedRelAttentionIKFS.apply(*xs, n_heads, float(scale), rate,
                                           seed, b_off, h_off)
    if not grad:
        return attn_fwd_relik(*xs, **kw)
    save = resolve_save_probs(b, n_heads, q_len, rate, rw.element_size(),
                              save_probs, k_len=k_len)
    return FusedRelAttentionIK.apply(*xs, n_heads, float(scale), rate, seed,
                                     save, b_off, h_off)


def fused_rel_attention_ingredients_tp(
    rw: torch.Tensor,                         # [B/dp, Q, D/mp]
    rr: torch.Tensor,                         # [B/dp, Q, D/mp]
    r: torch.Tensor,                          # [P, D/mp]
    k: torch.Tensor,                          # [B/dp, K, D/mp]
    v: torch.Tensor,                          # [B/dp, K, D/mp]
    ed: torch.Tensor,                         # [B/dp, H/mp, Q]
    segd: torch.Tensor,                       # [B/dp, Q, K]
    maskb: torch.Tensor,                      # [B/dp, Q, K]
    *,
    mesh,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    tier: Optional[str] = None,
) -> torch.Tensor:
    """``fused_rel_attention_ingredients`` on one rank of a tensor-parallel
    mesh: rw, rr, k, v are this rank's batch rows and its ``n_heads``
    heads' columns, r its heads' columns of the position keys (the W_r
    chunk's product), ed its heads; segd and maskb are its rows whole. The
    JAX ``fused_rel_attention_ingredients_tp``'s per-device block, on the
    full-H (#20-#22) or flash-streamed (#23, #24) ingredients tier
    (``tier`` as the one-card entry's). dr and ded stay this rank's heads'.
    The kernels draw the dropout of the global (b, h): batch row offset
    ``mesh.data_rank`` · B_local, head offset ``mesh.model_rank`` ·
    H_local, from the seed that every rank draws alike from
    ``dropout_rng``. The JAX wrapper instead folds the model and the data
    index into its rng (ROADMAP C, deliberate departures). Over more than
    one data rank the ``Trainer`` hands each data rank its own
    ``dropout_rng`` (the data rank folded into the seed), which then keeps
    the shards apart on its own."""
    return _fused_relik(rw, rr, r, k, v, ed, segd, maskb, n_heads, scale,
                        dropout_rate, dropout_rng, deterministic, None, tier,
                        mesh.data_rank * rw.shape[0],
                        mesh.model_rank * n_heads)
