"""MAG-XLNet: XLNet with the Multimodal Adaptation Gate (port of
``models/xlnet.py``).

Batch-first as in the JAX package: the relative positions are one [P, D]
table per forward (P = K + Q for "bi" attention, K + 1 for "uni"; [B, P, D]
under ``bi_data``), masks are [B, 1, Q, K] floats with 1 = masked, and MAG
is injected before layer ``MultimodalConfig.injection_index`` (1 for
XLNet). The q/k/v/o/r projections are raw flat [D, H·Dh] params, as in the
JAX tree; the FFN, the sequence summary and the logits projection are
``nn.Linear`` (the JAX ``nn.Dense`` kernels transposed). Params are fp32
and compute runs in ``dtype`` with the JAX package's rounding points (see
``models/bert.py``).

Attention, per layer and stream (``XLNetRelativeAttention._rel_attn_core``):

* ``attention_impl="einsum"``: plain PyTorch, score = (ac + bd + ef)·scale
  − 1e30·mask in fp32, softmax, dropout;
* ``"fused"``: the tier is ``ops/fused_attention.py::rel_tier``'s. On the
  full-H tier (kernels #11-#13 on the card), the head-blocked one (#14,
  #15) and the flash-streamed one (#16, #17) the score bias ebias =
  rel_shift(bd) + ef + mask_bias is assembled here at the compute dtype
  with the scale folded into rr/rs, and ``fused_rel_attention`` runs the
  QK dot, softmax, dropout and PV. Where bi attention without ``bi_data``
  allows, the kernels take the bias ingredients instead
  (``fused_rel_attention_ingredients``) and nothing [B, H, Q, P]-sized is
  built: under ``rel_bias_impl="inkernel"`` at every length (the full-H
  ingredients kernels #20-#22 while they reach, then #23 and #24), under
  "auto" past the full-H reach (#23, #24: the JAX model's long-S path).
  ``head_mask`` and ``output_attentions`` take the einsum branch, as in
  the JAX package.

The memory (segment recurrence, JAX ``models/xlnet.py``): ``mems`` (one
[B, mlen, D] per layer) are prepended to each layer's keys and values, so
K = mlen + Q in the positions, the masks (memory columns unmasked) and the
segment matrix; with ``use_cache`` and ``config.mem_len`` the model also
returns each layer's new memory (``_cache_mem``: the layer's input, cut to
``reuse_len``, appended, the last ``mem_len`` rows kept, detached).

Tensor parallelism (``parallel/tp.py``): ``tp_mesh`` on the FFN splits it
Megatron-style (``ff.layer_1`` column-parallel, its dropout drawn for the
full width and sliced, ``ff.layer_2`` row-parallel); on the attention
(under ``shard_attention``) each rank projects q, k, v and the position
keys of its H/mp heads, runs them through
``fused_rel_attention_tp`` / ``fused_rel_attention_ingredients_tp`` (the
full-H tiers #11-#13, #20-#22, and the ingredients fs tier #23/#24, at the
offsets that give one card's dropout) or, past those (where one card takes
the head-blocked or flash-streamed ebias tiers), the einsum math with the
one-card keep mask sliced to its heads, and ``o`` is row-parallel, as the
JAX model's branches (``models/xlnet.py:212-240``).

The two branches differ by rounding only. Two-stream attention
(``perm_mask``, ``target_mapping``), ``head_mask``, ``inputs_embeds``,
``output_hidden_states``, ``output_attentions``, ``labels=``, the memory
and ``remat`` (each ``XLNetLayer`` rematerialized, ``models/remat.py``)
are ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert_multimodal_transformer_tpu_torch.config import (
    MultimodalConfig,
    XLNetConfig,
    resolve_device,
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    LayerNorm,
    _child,
    _dropout_rngs,
    _hidden_dropout,
    _linear,
    _normal_,
    dense,
    init_weights,
    load_threefry_params,
    row_parallel_dense,
)
from bert_multimodal_transformer_tpu_torch.models.mag import MAG
from bert_multimodal_transformer_tpu_torch.models.remat import (
    check_remat_outputs,
    remat_call,
)
from bert_multimodal_transformer_tpu_torch.ops.activations import ACT2FN
from bert_multimodal_transformer_tpu_torch.ops.dropout import (
    DropoutRngs,
    dropout,
)
from bert_multimodal_transformer_tpu_torch.ops.fused_attention import (
    fused_rel_attention,
    fused_rel_attention_ingredients,
    fused_rel_attention_ingredients_tp,
    fused_rel_attention_tp,
    rel_tier,
)
from bert_multimodal_transformer_tpu_torch.parallel.tp import (
    copy_to_model,
    local_heads,
    reduce_from_model,
)

MASK_VERY_NEG = 1e30  # score − 1e30·mask, as HF


def rel_shift(x: torch.Tensor, klen: int) -> torch.Tensor:
    """[B, H, Q, P] scores indexed by position distance → [B, H, Q, klen]
    aligned scores (the JAX ``rel_shift``: the same reshapes, row-major)."""
    b, h, q, p = x.shape
    x = x.reshape(b, h, p, q)[:, :, 1:, :]
    return x.reshape(b, h, q, p - 1)[:, :, :, :klen]


def relative_positional_encoding(qlen: int, klen: int, d_model: int,
                                 attn_type: str = "bi", clamp_len: int = -1,
                                 bi_data: bool = False,
                                 dtype: torch.dtype = torch.float32,
                                 device=None) -> torch.Tensor:
    """Sinusoidal relative position embeddings [P, D] (positions klen …
    −qlen+1 for "bi", klen … 0 for "uni"), computed in fp32; under
    ``bi_data`` the forward and backward tables stacked, [2, P, D]."""
    freq_seq = torch.arange(0, d_model, 2.0, dtype=torch.float32,
                            device=device)
    inv_freq = 1.0 / (10000.0 ** (freq_seq / d_model))
    if attn_type == "bi":
        beg, end = klen, -qlen
    elif attn_type == "uni":
        beg, end = klen, -1
    else:
        raise ValueError(f"Unknown attn_type {attn_type!r}")

    def sinusoid(pos_seq):
        inp = pos_seq[:, None] * inv_freq[None, :]
        return torch.cat([torch.sin(inp), torch.cos(inp)], dim=-1)

    def positions(start, stop, step):
        seq = torch.arange(start, stop, step, dtype=torch.float32,
                           device=device)
        return seq.clamp(-clamp_len, clamp_len) if clamp_len > 0 else seq

    pos_emb = sinusoid(positions(beg, end, -1.0))
    if bi_data:
        pos_emb = torch.stack([pos_emb,
                               sinusoid(positions(-beg, -end, 1.0))])
    return pos_emb.to(dtype)


def causal_attn_mask(qlen: int, mlen: int, same_length: bool = False,
                     device=None) -> torch.Tensor:
    """Float mask [Q, mlen + Q], 1 = masked (the JAX ``causal_attn_mask``)."""
    ones = torch.ones((qlen, qlen), dtype=torch.float32, device=device)
    ret = torch.cat([torch.zeros((qlen, mlen), dtype=torch.float32,
                                 device=device), torch.triu(ones, 1)], dim=1)
    if same_length:
        mask_lo = torch.tril(ones, -1)
        ret = torch.cat([ret[:, :qlen] + mask_lo, ret[:, qlen:]], dim=1)
    return ret


def _raw_param(*shape, device) -> nn.Parameter:
    # Drawn by init_xlnet_weights from an explicit generator.
    return nn.Parameter(torch.empty(shape, device=device))


def _f32_einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """An einsum accumulated in fp32 (``preferred_element_type=f32``)."""
    return torch.einsum(eq, *(x.float() for x in xs))


class XLNetRelativeAttention(nn.Module):
    """Two-stream relative multi-head attention with the post-LN residual
    (HF XLNetRelativeAttention), batch-first. ``tp_mesh`` (set by
    ``parallel/tp.py::shard_model_`` under ``shard_attention``) head-shards
    it over the mesh's model axis (module docstring)."""

    head_sharded = True  # tp_mesh is set only under shard_attention

    def __init__(self, config: XLNetConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.tp_mesh = None
        d, h, dh = config.d_model, config.n_head, config.d_head
        for name in ("q", "k", "v", "o", "r"):
            setattr(self, name, _raw_param(d, h * dh, device=device))
        for name in ("r_w_bias", "r_r_bias", "r_s_bias"):
            setattr(self, name, _raw_param(h, dh, device=device))
        self.seg_embed = _raw_param(2, h, dh, device=device)
        self.layer_norm = LayerNorm(d, config.layer_norm_eps, device=device)

    def _rel_attn_core(self, q_head, k_head, v_head, k_head_r, seg_mat,
                       attn_mask, deterministic, rngs, head_mask=None,
                       output_attentions=False, mask_bias=None,
                       seg_diff=None):
        """q_head [B,Q,H,Dh]; k/v_head [B,K,H,Dh]; k_head_r [P,H,Dh] ([B,P,H,
        Dh] under bi_data); seg_mat [B,Q,K,2] or None; attn_mask [B,1,Q,K]
        float 1 = masked. ``mask_bias``/``seg_diff`` are the fused path's
        forms hoisted out of the layer loop (−1e30·mask at the compute
        dtype; the bool behind seg_mat's one-hot). Under ``tp_mesh`` the
        heads are this rank's."""
        cfg = self.config
        dt = self.dtype
        mesh = self.tp_mesh
        scale = 1.0 / (cfg.d_head ** 0.5)
        klen = k_head.shape[1]
        train = not deterministic and cfg.dropout > 0
        bd_eq = ("bqhf,bphf->bhqp" if k_head_r.dim() == 4
                 else "bqhf,phf->bhqp")

        tier = None
        if (cfg.attention_impl == "fused" and head_mask is None
                and not output_attentions):
            bsz, qlen, h, dh = q_head.shape
            rw = (q_head.reshape(bsz, qlen, h * dh)
                  + self.r_w_bias.reshape(-1)).to(dt)
            # The ingredients tiers need the relative shift's P ≥ Q + K (bi
            # attention; uni's P = K + 1 does not reach) and one position
            # stream for the batch (not bi_data's [B, P, D]).
            ingredients_ok = (cfg.rel_bias_impl in ("auto", "inkernel")
                              and k_head_r.dim() == 3
                              and k_head_r.shape[0] >= qlen + klen)
            grad = torch.is_grad_enabled() and any(
                x.requires_grad for x in (
                    q_head, k_head, v_head, k_head_r, self.r_w_bias,
                    self.r_r_bias, self.r_s_bias, self.seg_embed))
            tier = rel_tier(qlen, klen, dh, grad, ingredients_ok,
                            inkernel=cfg.rel_bias_impl == "inkernel")
        # a head shard runs the full-H and the ingredients tiers; where one
        # card would take the head-blocked or flash-streamed ebias tiers it
        # runs the einsum math (the JAX model's TP gate)
        if tier is not None and (mesh is None or tier not in ("hb", "fs")):
            if tier in ("ik_full", "ik_fs"):
                return self._ingredients_core(
                    rw, q_head, k_head, v_head, k_head_r, seg_mat, attn_mask,
                    deterministic, rngs, mask_bias, seg_diff,
                    tier=tier.removeprefix("ik_"))
            rr = ((q_head + self.r_r_bias) * scale).to(dt)
            # Products in dt: fp32 accumulation rounded once to dt, as the
            # JAX preferred_element_type=f32 einsums cast to dt (bd at
            # once, ef after the select); fp32 products, and their
            # backward, would run off the tensor cores.
            bd = torch.einsum(bd_eq, rr, k_head_r.to(dt))
            ebias = rel_shift(bd, klen)
            if seg_mat is not None:
                rs = ((q_head + self.r_s_bias) * scale).to(dt)
                ef_raw = torch.einsum("bqhf,shf->bhqs", rs,
                                      self.seg_embed.to(dt))
                if seg_diff is not None:
                    # the one-hot contraction over {same, diff} is a select
                    ef = torch.where(seg_diff, ef_raw[..., 1:2],
                                     ef_raw[..., 0:1]).to(dt)
                else:
                    ef = _f32_einsum("bqks,bhqs->bhqk", seg_mat,
                                     ef_raw).to(dt)
                ebias = ebias + ef
            if mask_bias is not None:
                ebias = ebias + mask_bias
            elif attn_mask is not None:
                ebias = ebias - (MASK_VERY_NEG * attn_mask.float()).to(dt)
            attend, tp = ((fused_rel_attention, {}) if mesh is None
                          else (fused_rel_attention_tp, {"mesh": mesh}))
            ctx = attend(
                rw, k_head.to(dt).reshape(bsz, klen, h * dh),
                v_head.to(dt).reshape(bsz, klen, h * dh),
                ebias.expand(bsz, h, qlen, klen),
                n_heads=h, scale=scale, dropout_rate=cfg.dropout,
                dropout_rng=rngs.seed() if train else None,
                deterministic=deterministic, **tp)
            return ctx.reshape(bsz, qlen, h, dh)

        rw = (q_head + self.r_w_bias).to(dt)
        rr = (q_head + self.r_r_bias).to(dt)
        bd = rel_shift(_f32_einsum(bd_eq, rr, k_head_r.to(dt)), klen)
        ef = 0.0
        if seg_mat is not None:
            rs = (q_head + self.r_s_bias).to(dt)
            ef_raw = _f32_einsum("bqhf,shf->bhqs", rs, self.seg_embed.to(dt))
            ef = torch.einsum("bqks,bhqs->bhqk", seg_mat.float(), ef_raw)
        ac = _f32_einsum("bqhf,bkhf->bhqk", rw, k_head)
        score = (ac + bd + ef) * scale
        if attn_mask is not None:
            score = score - MASK_VERY_NEG * attn_mask.float()
        probs = torch.softmax(score, dim=-1)
        h0 = None
        if mesh is not None:
            # the one-card keep mask, sliced to this rank's heads
            h0 = local_heads(cfg.n_head, mesh)[0]
        probs = dropout(probs, cfg.dropout,
                        rngs.mask("attn_dropout") if train else None,
                        not train,
                        shard=None if h0 is None else (1, cfg.n_head, h0))
        if head_mask is not None:
            # HF applies the head mask after attention dropout.
            if h0 is not None:
                head_mask = head_mask[h0:h0 + probs.shape[1]]
            probs = probs * head_mask.to(probs.dtype).reshape(1, -1, 1, 1)
        attn_vec = _f32_einsum("bhqk,bkhf->bqhf", probs.to(dt),
                               v_head).to(dt)
        if output_attentions:
            probs = probs.float()
            if mesh is not None:
                probs = mesh.all_gather(probs, mesh.model_axis, dim=1)
            return attn_vec, probs
        return attn_vec

    def _ingredients_core(self, rw, q_head, k_head, v_head, k_head_r,
                          seg_mat, attn_mask, deterministic, rngs,
                          mask_bias, seg_diff, tier):
        """The fused branch's ingredients tiers (JAX ``models/xlnet.py``
        :254-318): the score-bias ingredients at the compute dtype, for
        ``fused_rel_attention_ingredients`` on ``tier`` ("full": #20-#22,
        "fs": #23, #24). rr carries the scale; ed = scale·(q + r_s_bias)·
        (seg₁ − seg₀) is the segment delta (the ef₀ term it leaves out is
        constant along the keys); zeros stand in for a missing seg_mat or
        mask, as in JAX."""
        cfg = self.config
        dt = self.dtype
        scale = 1.0 / (cfg.d_head ** 0.5)
        bsz, qlen, h, dh = q_head.shape
        klen = k_head.shape[1]
        rr = ((q_head.reshape(bsz, qlen, h * dh)
               + self.r_r_bias.reshape(-1)) * scale).to(dt)
        if seg_mat is not None:
            rs = ((q_head + self.r_s_bias) * scale).to(dt)
            sdelta = (self.seg_embed[1] - self.seg_embed[0]).to(dt)
            ed = _f32_einsum("bqhf,hf->bhq", rs, sdelta).to(dt)
            segd = (seg_diff[:, 0] if seg_diff is not None
                    else seg_mat[..., 1]).to(dt)
        else:
            ed = torch.zeros(bsz, h, qlen, dtype=dt, device=rw.device)
            segd = torch.zeros(bsz, qlen, klen, dtype=dt, device=rw.device)
        if mask_bias is not None:
            maskb = mask_bias[:, 0]
        elif attn_mask is not None:
            maskb = (-(MASK_VERY_NEG * attn_mask.float())).to(dt)[:, 0]
        else:
            maskb = torch.zeros(bsz, qlen, klen, dtype=dt, device=rw.device)
        train = not deterministic and cfg.dropout > 0
        mesh = self.tp_mesh
        attend, tp = ((fused_rel_attention_ingredients, {}) if mesh is None
                      else (fused_rel_attention_ingredients_tp,
                            {"mesh": mesh}))
        ctx = attend(
            rw, rr, k_head_r.to(dt).reshape(-1, h * dh),
            k_head.to(dt).reshape(bsz, klen, h * dh),
            v_head.to(dt).reshape(bsz, klen, h * dh), ed,
            segd.expand(bsz, qlen, klen), maskb.expand(bsz, qlen, klen),
            n_heads=h, scale=scale, dropout_rate=cfg.dropout,
            dropout_rng=rngs.seed() if train else None,
            deterministic=deterministic, tier=tier, **tp)
        return ctx.reshape(bsz, qlen, h, dh)

    def _post_attention(self, h, attn_vec, deterministic, rngs):
        b, q = attn_vec.shape[:2]
        out = torch.matmul(attn_vec.reshape(b, q, -1),
                           self.o.to(self.dtype).t())
        if self.tp_mesh is not None:
            # o is row-parallel over the heads: the partials summed
            out = reduce_from_model(out, self.tp_mesh)
        out = _hidden_dropout(out, self.config.dropout, rngs, deterministic,
                              "out_dropout")
        return self.layer_norm(out + h)

    def forward(self, h, g, attn_mask_h, attn_mask_g, r, seg_mat,
                target_mapping=None, head_mask=None, *, deterministic=True,
                rngs: Optional[DropoutRngs] = None, output_attentions=False,
                mask_bias_h=None, mask_bias_g=None, seg_diff=None,
                mems=None):
        cfg = self.config
        dt = self.dtype
        nh, dh = cfg.n_head, cfg.d_head
        bsz, qlen = h.shape[:2]
        mesh = self.tp_mesh
        h_in, g_in = h, g
        if mesh is not None:
            # this rank's heads: the replicated streams enter the split
            nh = local_heads(nh, mesh)[1]
            h_in = copy_to_model(h, mesh)
            if g is not None:
                g_in = copy_to_model(g, mesh)
        # the keys and values read the memory, then the segment
        cat = h_in if mems is None else torch.cat([mems.to(dt), h_in], dim=1)
        klen = cat.shape[1]
        if cfg.pack_qkv and mems is None:
            # one [D, 3·H·Dh] product in place of three: the same sums
            # (under memory k and v read another input than q)
            w_qkv = torch.cat([self.q, self.k, self.v], dim=1).to(dt)
            q_head_h, k_head, v_head = (
                x.reshape(bsz, qlen, nh, dh)
                for x in torch.matmul(h_in, w_qkv).chunk(3, dim=-1))
        else:
            q_head_h = torch.matmul(h_in, self.q.to(dt)).reshape(
                bsz, qlen, nh, dh)
            k_head, v_head = (
                torch.matmul(cat, w.to(dt)).reshape(bsz, klen, nh, dh)
                for w in (self.k, self.v))
        k_head_r = torch.matmul(r.to(dt), self.r.to(dt))
        k_head_r = (k_head_r.reshape(bsz, -1, nh, dh) if r.dim() == 3
                    else k_head_r.reshape(-1, nh, dh))
        core = dict(deterministic=deterministic, rngs=rngs,
                    head_mask=head_mask, output_attentions=output_attentions,
                    seg_diff=seg_diff)

        out_h = self._rel_attn_core(q_head_h, k_head, v_head, k_head_r,
                                    seg_mat, attn_mask_h,
                                    mask_bias=mask_bias_h, **core)
        attn_prob_h = attn_prob_g = None
        if output_attentions:
            out_h, attn_prob_h = out_h
        out_h = self._post_attention(h, out_h, deterministic, rngs)

        out_g = None
        if g is not None:
            q_head_g = torch.matmul(g_in, self.q.to(dt)).reshape(
                bsz, g.shape[1], nh, dh)
            if target_mapping is not None:
                # project the query positions onto the content positions
                tm = target_mapping.to(dt)
                q_head_g = _f32_einsum("bmhf,bmq->bqhf", q_head_g,
                                       tm).to(dt)
            vec_g = self._rel_attn_core(q_head_g, k_head, v_head, k_head_r,
                                        seg_mat, attn_mask_g,
                                        mask_bias=mask_bias_g, **core)
            if output_attentions:
                vec_g, attn_prob_g = vec_g
            if target_mapping is not None:
                vec_g = _f32_einsum("bqhf,bmq->bmhf", vec_g, tm).to(dt)
            out_g = self._post_attention(g, vec_g, deterministic, rngs)

        if output_attentions:
            attn_prob = (attn_prob_h if attn_prob_g is None
                         else (attn_prob_h, attn_prob_g))
            return out_h, out_g, attn_prob
        return out_h, out_g


class XLNetFeedForward(nn.Module):
    """Position-wise FFN with the post-LN residual (HF XLNetFeedForward).
    ``tp_mesh`` (set by ``parallel/tp.py::shard_model_``) splits it
    Megatron-style: ``layer_1`` column-parallel (its dropout drawn for the
    full width and sliced to the rank's columns), ``layer_2``
    row-parallel."""

    def __init__(self, config: XLNetConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.tp_mesh = None
        self.layer_1 = _linear(config.d_model, config.d_inner, device)
        self.layer_2 = _linear(config.d_inner, config.d_model, device)
        self.layer_norm = LayerNorm(config.d_model, config.layer_norm_eps,
                                    device=device)

    def forward(self, x, *, deterministic=True, rngs=None):
        cfg = self.config
        mesh = self.tp_mesh
        if mesh is None:
            out = ACT2FN[cfg.ff_activation](dense(self.layer_1, x,
                                                  self.dtype))
            out = _hidden_dropout(out, cfg.dropout, rngs, deterministic,
                                  "Dropout_0")
            out = dense(self.layer_2, out, self.dtype)
        else:
            out = ACT2FN[cfg.ff_activation](dense(
                self.layer_1, copy_to_model(x, mesh), self.dtype))
            if not deterministic and cfg.dropout > 0.0:
                cols = out.shape[-1]
                out = dropout(out, cfg.dropout, rngs.mask("Dropout_0"),
                              shard=(out.dim() - 1, cfg.d_inner,
                                     mesh.model_rank * cols))
            out = row_parallel_dense(self.layer_2, out, self.dtype, mesh)
        out = _hidden_dropout(out, cfg.dropout, rngs, deterministic,
                              "Dropout_1")
        return self.layer_norm(out + x)


class XLNetLayer(nn.Module):
    def __init__(self, config: XLNetConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.rel_attn = XLNetRelativeAttention(config, dtype, device=device)
        self.ff = XLNetFeedForward(config, dtype, device=device)

    def forward(self, h, g, attn_mask_h, attn_mask_g, r, seg_mat,
                target_mapping=None, head_mask=None, *, deterministic=True,
                rngs=None, output_attentions=False, mems=None, **hoisted):
        out = self.rel_attn(h, g, attn_mask_h, attn_mask_g, r, seg_mat,
                            target_mapping, head_mask,
                            deterministic=deterministic,
                            rngs=_child(rngs, "rel_attn"),
                            output_attentions=output_attentions, mems=mems,
                            **hoisted)
        out_h, out_g = out[:2]
        # one ff module for both streams: the second call draws its
        # dropouts with Flax's counter 2
        ff_rngs = _child(rngs, "ff")
        out_h = self.ff(out_h, deterministic=deterministic, rngs=ff_rngs)
        if out_g is not None:
            out_g = self.ff(out_g, deterministic=deterministic, rngs=ff_rngs)
        return (out_h, out_g) + tuple(out[2:])


def init_xlnet_weights(module: nn.Module, initializer_range: float,
                       generator: torch.Generator) -> None:
    """Normal(0, initializer_range) for the dense kernels, the embedding
    and the raw attention params (q, k, v, o, r, r_*_bias, seg_embed,
    mask_emb), zero dense biases, unit LayerNorms, as the JAX initializers;
    the MAG gate keeps its own init. Drawn from ``generator``."""
    init_weights(module, initializer_range, generator)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, XLNetRelativeAttention):
                raw = [sub.q, sub.k, sub.v, sub.o, sub.r, sub.r_w_bias,
                       sub.r_r_bias, sub.r_s_bias, sub.seg_embed]
            elif isinstance(sub, MagXLNetModel):
                raw = [sub.mask_emb]
            else:
                continue
            for p in raw:
                # a tensor-parallel chunk draws its full tensor
                _normal_(p, initializer_range, generator)


class MagXLNetModel(nn.Module):
    """XLNet backbone with MAG injected before layer ``injection_index``.
    ``device=None`` builds on the card (``config.resolve_device``: raises
    without one); pass ``device="cpu"`` for the CPU. ``remat``
    rematerializes each layer whole (JAX's XLNet takes no policy)."""

    def __init__(self, config: XLNetConfig,
                 multimodal_config: MultimodalConfig, visual_dim: int,
                 acoustic_dim: int, dtype: torch.dtype = torch.float32,
                 remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.multimodal_config = multimodal_config
        self.remat = remat
        self.dtype = dtype
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        mm = multimodal_config
        self.word_embedding = nn.utils.skip_init(
            nn.Embedding, config.vocab_size, config.d_model, device=device)
        # the query stream's input (two-stream attention only)
        self.mask_emb = _raw_param(1, 1, config.d_model, device=device)
        self.MAG = MAG(config.d_model, visual_dim, acoustic_dim,
                       beta_shift=mm.beta_shift, dropout_prob=mm.dropout_prob,
                       use_fused_kernel=mm.use_fused_kernel, device=device,
                       generator=generator)
        self.layer = nn.ModuleList(
            XLNetLayer(config, dtype, device=device)
            for _ in range(config.n_layer))
        init_xlnet_weights(self, config.initializer_range, generator)

    def _masks(self, b, qlen, mlen, attention_mask, input_mask, perm_mask,
               device):
        """(non_tgt_mask, attn_mask): [B or 1, 1, Q or 1, K] floats, 1 =
        masked, K = mlen + Q (the memory columns unmasked); the content
        stream's non-target mask lets every position see itself (the
        reference's −eye)."""
        cfg = self.config
        f32 = torch.float32
        if cfg.attn_type == "uni":
            attn_mask = causal_attn_mask(qlen, mlen, cfg.same_length,
                                         device)[None, None]
        elif cfg.attn_type == "bi":
            attn_mask = None
        else:
            raise ValueError(f"Unsupported attention type {cfg.attn_type}")
        if input_mask is not None and attention_mask is not None:
            raise ValueError("use only one of input_mask (1 = padding) or "
                             "attention_mask (0 = padding)")
        if input_mask is None and attention_mask is not None:
            input_mask = 1.0 - attention_mask.to(f32)
        data_mask = None
        if input_mask is not None:
            data_mask = input_mask.to(f32)[:, None, :]
        if perm_mask is not None:
            pm = perm_mask.to(f32)
            data_mask = pm if data_mask is None else data_mask + pm
        if data_mask is not None:
            if mlen > 0:
                data_mask = torch.cat([
                    torch.zeros((b, data_mask.shape[1], mlen), dtype=f32,
                                device=device), data_mask], dim=2)
            dm = data_mask[:, None]
            attn_mask = dm if attn_mask is None else attn_mask + dm
        if attn_mask is None:
            return None, None
        attn_mask = (attn_mask > 0).to(f32)
        eye = torch.eye(qlen, dtype=f32, device=device)
        if mlen > 0:
            eye = torch.cat([torch.zeros((qlen, mlen), dtype=f32,
                                         device=device), eye], dim=1)
        non_tgt_mask = ((attn_mask - eye[None, None]) > 0).to(f32)
        return non_tgt_mask, attn_mask

    def forward(
        self,
        input_ids: Optional[torch.Tensor],            # [B, Q]
        visual: torch.Tensor,                          # [B, Q, Dv]
        acoustic: torch.Tensor,                        # [B, Q, Da]
        attention_mask: Optional[torch.Tensor] = None,  # [B, Q], 1 = keep
        mems=None,
        perm_mask: Optional[torch.Tensor] = None,      # [B, Q, Q], 1 = hidden
        target_mapping: Optional[torch.Tensor] = None,  # [B, M, Q]
        token_type_ids: Optional[torch.Tensor] = None,  # [B, Q]
        input_mask: Optional[torch.Tensor] = None,     # [B, Q], 1 = padding
        head_mask: Optional[torch.Tensor] = None,      # [L, H] or [H]
        inputs_embeds: Optional[torch.Tensor] = None,  # [B, Q, D]
        use_cache: bool = False,
        *,
        deterministic: bool = True,
        dropout_rng=None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
    ):
        cfg = self.config
        dt = self.dtype
        if (input_ids is None) == (inputs_embeds is None):
            raise ValueError(
                "specify exactly one of input_ids or inputs_embeds")
        check_remat_outputs(self.remat, output_attentions)
        ref = input_ids if input_ids is not None else inputs_embeds
        rngs = _dropout_rngs(dropout_rng, deterministic, ref)
        device = ref.device
        b, qlen = ref.shape[:2]
        mlen = 0
        if mems is not None and mems[0] is not None:
            mlen = mems[0].shape[1]
        klen = mlen + qlen
        non_tgt_mask, attn_mask = self._masks(b, qlen, mlen, attention_mask,
                                              input_mask, perm_mask, device)

        if inputs_embeds is not None:
            word_emb_k = inputs_embeds.to(dt)
        else:
            word_emb_k = F.embedding(input_ids,
                                     self.word_embedding.weight).to(dt)
        # the JAX model's one Dropout module, called for each stream, the
        # positions and the output (Flax counters 1, 2, ...)
        output_h = _hidden_dropout(word_emb_k, cfg.dropout, rngs,
                                   deterministic, "Dropout_0")
        output_g = None
        if target_mapping is not None:
            word_emb_q = self.mask_emb.to(dt).expand(
                b, target_mapping.shape[1], cfg.d_model)
            output_g = _hidden_dropout(word_emb_q, cfg.dropout, rngs,
                                       deterministic, "Dropout_0")

        seg_mat = seg_diff = None
        if token_type_ids is not None:
            # the memory's positions take segment 0
            cat_ids = token_type_ids if mlen == 0 else torch.cat([
                token_type_ids.new_zeros((b, mlen)), token_type_ids], dim=1)
            diff = token_type_ids[:, :, None] != cat_ids[:, None, :]
            seg_mat = F.one_hot(diff.long(), 2).to(torch.float32)
            seg_diff = diff[:, None]

        pos_emb = relative_positional_encoding(
            qlen, klen, cfg.d_model, cfg.attn_type, cfg.clamp_len,
            bi_data=cfg.bi_data, dtype=dt, device=device)
        if cfg.bi_data:
            # forward positions for the first B/2 examples, backward for the
            # last B/2
            if b % 2 != 0:
                raise ValueError(
                    f"bi_data=True needs an even batch size, got {b}")
            pos_emb = torch.cat([pos_emb[0].expand(b // 2, -1, -1),
                                 pos_emb[1].expand(b // 2, -1, -1)])
        pos_emb = _hidden_dropout(pos_emb, cfg.dropout, rngs, deterministic,
                                  "Dropout_0", batch=cfg.bi_data)

        # The fused path's layer-independent ebias forms, once per forward.
        mask_bias_h = mask_bias_g = None
        if (cfg.attention_impl == "fused" and head_mask is None
                and not output_attentions):
            if non_tgt_mask is not None:
                mask_bias_h = (-(MASK_VERY_NEG * non_tgt_mask)).to(dt)
            if attn_mask is not None and target_mapping is not None:
                mask_bias_g = (-(MASK_VERY_NEG * attn_mask)).to(dt)
        else:
            seg_diff = None

        if mems is None:
            mems = [None] * cfg.n_layer
        keep_mems = bool(cfg.mem_len) and use_cache
        new_mems = []
        hidden_states = [] if output_hidden_states else None
        attentions = [] if output_attentions else None
        for i, layer in enumerate(self.layer):
            if keep_mems:
                # the layer's input, before MAG at the injection layer
                new_mems.append(self._cache_mem(output_h, mems[i]))
            if i == self.multimodal_config.injection_index:
                output_h = self.MAG(
                    output_h, visual.to(dt), acoustic.to(dt),
                    deterministic=deterministic,
                    dropout_rng=(rngs.child("MAG").mask("Dropout_0")
                                 if rngs else None))
            if output_hidden_states:
                # per-layer input states, (h, g) pairs under two-stream
                hidden_states.append(output_h if output_g is None
                                     else (output_h, output_g))
            hm = None
            if head_mask is not None:
                hm = head_mask[i] if head_mask.dim() == 2 else head_mask
            args = (output_h, output_g, non_tgt_mask, attn_mask, pos_emb,
                    seg_mat, target_mapping, hm)
            layer_rngs = _child(rngs, f"layer_{i}")
            kw = dict(deterministic=deterministic, rngs=layer_rngs,
                      output_attentions=output_attentions,
                      mask_bias_h=mask_bias_h, mask_bias_g=mask_bias_g,
                      seg_diff=seg_diff, mems=mems[i])
            out = (remat_call(layer, layer_rngs, "full", *args, **kw)
                   if self.remat else layer(*args, **kw))
            output_h, output_g = out[:2]
            if output_attentions:
                attentions.append(out[2])
        if output_hidden_states:
            hidden_states.append(output_h if output_g is None
                                 else (output_h, output_g))

        output = _hidden_dropout(output_g if output_g is not None
                                 else output_h, cfg.dropout, rngs,
                                 deterministic, "Dropout_0")
        outputs = (output, tuple(new_mems) if keep_mems else None)
        if output_hidden_states:
            outputs = outputs + (tuple(hidden_states),)
        if output_attentions:
            outputs = outputs + (tuple(attentions),)
        return outputs

    def _cache_mem(self, curr_out: torch.Tensor,
                   prev_mem: Optional[torch.Tensor]) -> torch.Tensor:
        """The layer's next memory (the JAX ``_cache_mem``, reference
        cache_mem): the current input cut to its first ``reuse_len`` rows
        when set, appended to the previous memory, the last ``mem_len``
        rows kept, with no gradient."""
        cfg = self.config
        if cfg.reuse_len is not None and cfg.reuse_len > 0:
            curr_out = curr_out[:, :cfg.reuse_len]
        if prev_mem is None:
            new_mem = curr_out[:, -cfg.mem_len:]
        else:
            new_mem = torch.cat([prev_mem, curr_out], dim=1)[:, -cfg.mem_len:]
        return new_mem.detach()


class SequenceSummary(nn.Module):
    """HF SequenceSummary with XLNet's settings: the LAST token (XLNet
    packs <cls> last, with left padding), a projection, tanh, dropout."""

    def __init__(self, config: XLNetConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.summary = _linear(config.d_model, config.d_model, device)

    def forward(self, hidden, *, deterministic=True, rngs=None):
        out = torch.tanh(dense(self.summary, hidden[:, -1], self.dtype))
        return _hidden_dropout(out, self.config.summary_last_dropout, rngs,
                               deterministic, "Dropout_0")


class MagXLNetForSequenceClassification(nn.Module):
    """SequenceSummary and the logits projection over MagXLNetModel, with
    the call signature ``Trainer`` and ``Predictor`` use. ``device=None``
    builds on the card and raises without one; pass ``device="cpu"`` for
    the CPU."""

    def __init__(self, config: XLNetConfig,
                 multimodal_config: MultimodalConfig, visual_dim: int,
                 acoustic_dim: int, dtype: torch.dtype = torch.float32,
                 remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.multimodal_config = multimodal_config
        self.dtype = dtype
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.transformer = MagXLNetModel(
            config, multimodal_config, visual_dim, acoustic_dim, dtype,
            remat, device=device, generator=generator)
        self.sequence_summary = SequenceSummary(config, dtype, device=device)
        self.logits_proj = _linear(config.d_model, config.num_labels, device)
        self._init_head(generator)

    def _init_head(self, generator):
        init_weights(self.sequence_summary, self.config.initializer_range,
                     generator)
        init_weights(self.logits_proj, self.config.initializer_range,
                     generator)

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every param again from ``generator`` (on the params'
        device), in the constructor's order."""
        self.transformer.MAG.reset_parameters(generator)
        init_xlnet_weights(self.transformer, self.config.initializer_range,
                           generator)
        self._init_head(generator)

    def flax_param_spec(self) -> dict:
        """The JAX ``MagXLNetForSequenceClassification``'s param tree as
        ``utils/flax_rng.py::init_params`` takes it, each scope's params
        in the JAX module's order; with ``mask_emb``, which the JAX model
        declares (first in the transformer's scope) when it is initialised
        with a ``target_mapping``."""
        cfg = self.config
        d, std = cfg.d_model, cfg.initializer_range
        hd = cfg.n_head * cfg.d_head

        def dense(n_in, n_out):
            return {"kernel": ("normal", (n_in, n_out), std),
                    "bias": ("zeros", (n_out,))}

        norm = {"scale": ("ones", (d,)), "bias": ("zeros", (d,))}
        bias = ("normal", (cfg.n_head, cfg.d_head), std)
        rel_attn = {**{name: ("normal", (d, hd), std)
                       for name in ("q", "k", "v", "o", "r")},
                    "r_w_bias": bias, "r_r_bias": bias, "r_s_bias": bias,
                    "seg_embed": ("normal", (2, cfg.n_head, cfg.d_head), std),
                    "layer_norm": norm}
        layer = {"rel_attn": rel_attn,
                 "ff": {"layer_1": dense(d, cfg.d_inner),
                        "layer_2": dense(cfg.d_inner, d),
                        "layer_norm": norm}}
        transformer = {
            "word_embedding": {"embedding": ("normal", (cfg.vocab_size, d),
                                             std)},
            "mask_emb": ("normal", (1, 1, d), std),
            "MAG": self.transformer.MAG.flax_param_spec(),
            **{f"layer_{i}": layer for i in range(cfg.n_layer)}}
        return {"transformer": transformer,
                "sequence_summary": {"summary": dense(d, d)},
                "logits_proj": dense(d, cfg.num_labels)}

    def init_params_threefry(self, key) -> None:
        """Every param as the JAX ``model.init(key)["params"]`` draws it
        under threefry2x32 (``utils/flax_rng.py``), on the params' device,
        converted to the port's layout (``utils/convert.py``) and copied
        in place (``load_threefry_params``)."""
        from bert_multimodal_transformer_tpu_torch.utils import convert
        from bert_multimodal_transformer_tpu_torch.utils.flax_rng import (
            init_params,
        )

        tree = init_params(key, self.flax_param_spec(),
                           self.logits_proj.weight.device)
        load_threefry_params(self, convert.xlnet_params_from_flax(tree))

    def forward(
        self,
        input_ids: Optional[torch.Tensor],
        visual: torch.Tensor,
        acoustic: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        mems=None,
        perm_mask: Optional[torch.Tensor] = None,
        target_mapping: Optional[torch.Tensor] = None,
        input_mask: Optional[torch.Tensor] = None,
        head_mask: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        use_cache: bool = False,
        *,
        deterministic: bool = True,
        dropout_rng=None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
    ):
        """``deterministic=False`` is the training forward and needs
        ``dropout_rng`` (an int seed or a CPU ``torch.Generator``)."""
        ref = input_ids if input_ids is not None else inputs_embeds
        rngs = _dropout_rngs(dropout_rng, deterministic, ref)
        outputs = self.transformer(
            input_ids, visual, acoustic, attention_mask=attention_mask,
            mems=mems, perm_mask=perm_mask, target_mapping=target_mapping,
            token_type_ids=token_type_ids, input_mask=input_mask,
            head_mask=head_mask, inputs_embeds=inputs_embeds,
            use_cache=use_cache, deterministic=deterministic,
            dropout_rng=_child(rngs, "transformer"),
            output_hidden_states=output_hidden_states,
            output_attentions=output_attentions)
        summary = self.sequence_summary(
            outputs[0], deterministic=deterministic,
            rngs=_child(rngs, "sequence_summary"))
        logits = dense(self.logits_proj, summary, self.dtype).float()
        # hidden_states/attentions when requested; under use_cache the new
        # memory first, so the recurrence runs through the classifier
        extras = outputs[1:] if use_cache else outputs[2:]
        if labels is not None:
            from bert_multimodal_transformer_tpu_torch.training.losses import (
                sequence_classification_loss,
            )

            loss = sequence_classification_loss(logits, labels,
                                                self.config.num_labels)
            return (loss, logits) + extras
        if extras:
            return (logits,) + extras
        return logits
