"""Attention primitives (port of ``ops/attention.py``).

Scores and softmax are fp32 whatever the compute dtype, as in the JAX
package's ``preferred_element_type=f32`` einsums. ``flash_attention`` is
not ported yet (ROADMAP A.2).
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
    ``dropout_rng`` (a generator on the tensors' device, required then),
    and a kept prob is scaled as ``p / (1 − rate)`` in fp32
    (``ops/dropout.py``).

    The probs are rounded to the compute dtype before the PV product, and
    both products accumulate in fp32: a bf16 ``torch.matmul`` on the CPU
    would round its result, so the operands are upcast explicitly. With
    ``return_probs`` also returns the fp32 (post-dropout, post-head-mask)
    probs. ``dropout_heads`` (h0, H): q, k, v are heads h0 .. of H, and the
    keep mask is drawn for all H (``ops/dropout.py::dropout``'s ``heads``).
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
                        heads=dropout_heads)
    if head_mask is not None:
        probs = probs * head_mask.to(probs.dtype).reshape(1, -1, 1, 1)
    ctx = torch.matmul(probs.to(dtype).float(), v.float()).to(dtype)
    if return_probs:
        return ctx, probs
    return ctx


def extended_attention_mask(attention_mask: torch.Tensor,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """[B, S] {0,1} mask → additive [B, 1, 1, S] with (1−m)·−10000 (HF
    ``get_extended_attention_mask``)."""
    m = attention_mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]
