"""Attention primitives (port of ``ops/attention.py``).

Scores and softmax are fp32 whatever the compute dtype, as in the JAX
package's ``preferred_element_type=f32`` einsums. ``flash_attention`` runs
the flash-streamed kernels #6/#7 (``ops/fused_attention.py``), the port's
counterpart of the JAX package's library flash kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bert_multimodal_transformer_tpu_torch.ops.dropout import dropout


def dot_product_attention(
    q: torch.Tensor,               # [B, H, Sq, Dh]
    k: torch.Tensor,               # [B, H, Sk, Dh]
    v: torch.Tensor,               # [B, H, Sk, Dh]
    bias: Optional[torch.Tensor],  # additive, broadcastable to [B,H,Sq,Sk]
    *,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    deterministic: bool = True,
    head_mask: Optional[torch.Tensor] = None,  # [H] or broadcastable
    return_probs: bool = False,
    dropout_heads: Optional[Tuple[int, int]] = None,
):
    """Masked scaled-dot-product attention with fp32 softmax (HF
    BertSelfAttention semantics): scores = QKᵀ·scale + bias, softmax,
    dropout on the probs, optional multiplicative ``head_mask``, context =
    probs·V.

    Dropout applies when ``dropout_rate > 0`` and not ``deterministic``:
    each prob is kept with probability 1 − rate, the keep mask drawn from
    ``dropout_rng`` (a generator on the tensors' device, or a threefry
    ``SiteKey``: JAX's mask; required then), and a kept prob is scaled as
    ``p / (1 − rate)`` in fp32 (``ops/dropout.py``).

    The probs are rounded to the compute dtype before the PV product, and
    both products accumulate in fp32: a bf16 ``torch.matmul`` on the CPU
    would round its result, so the operands are upcast explicitly. With
    ``return_probs`` also returns the fp32 (post-dropout, post-head-mask)
    probs. ``dropout_heads`` (h0, H): q, k, v are heads h0 .. of H, and the
    keep mask is drawn for all H (``ops/dropout.py::dropout``'s ``shard``).
    """
    dtype = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires dropout_rng")
        probs = dropout(probs, dropout_rate, dropout_rng,
                        shard=(None if dropout_heads is None
                               else (1, dropout_heads[1], dropout_heads[0])))
    if head_mask is not None:
        probs = probs * head_mask.to(probs.dtype).reshape(1, -1, 1, 1)
    ctx = torch.matmul(probs.to(dtype).float(), v.float()).to(dtype)
    if return_probs:
        return ctx, probs
    return ctx


def flash_attention(
    qkv: torch.Tensor,                        # [B, S, 3·D] packed
    attention_mask: Optional[torch.Tensor],   # [B, S] {0,1}, 1 = real token
    *,
    n_heads: int,
    scale: float,
) -> torch.Tensor:
    """Blockwise flash attention on the packed projection, returning the
    context [B, S, D]: the JAX ``flash_attention`` (the library Pallas TPU
    kernel ``pallas.ops.tpu.flash_attention``: O(S) memory, no prob
    dropout) as kernel #6, the online softmax over key blocks, and #7 for
    its gradient from the saved o and lse, at any S (on CPU tensors their
    plain versions). No dropout is drawn: the model takes this branch only
    where dropout cannot apply.

    Departure: the JAX kernel keeps pads apart by segment ids, so a pad row
    attends only among the pads; #6/#7 add (1 − mask)·−10000 to the scores
    as the other kernels do, so a pad row attends to the real tokens. Real
    rows agree; pad rows may differ, as the JAX docstring allows, and
    reach neither a real row nor the pooled output."""
    from bert_multimodal_transformer_tpu_torch.ops import fused_attention as fa

    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.float32)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return fa.FusedAttentionPackedFS.apply(qkv, attention_mask, n_heads,
                                               float(scale), 0.0, 0)
    if torch.compiler.is_exporting():
        return fa._traced("attn_fwd_packed_fs", 0.0)(
            qkv, attention_mask, n_heads, float(scale))
    return fa.attn_fwd_packed_fs(qkv, attention_mask, n_heads=n_heads,
                                 scale=float(scale))[0]


def extended_attention_mask(attention_mask: torch.Tensor,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """[B, S] {0,1} mask → additive [B, 1, 1, S] with (1−m)·−10000 (HF
    ``get_extended_attention_mask``)."""
    m = attention_mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]
