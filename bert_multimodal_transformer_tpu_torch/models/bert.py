"""MAG-BERT: BERT encoder with the Multimodal Adaptation Gate (port of
``models/bert.py``: the serving and the training forward).

As in the JAX package, the QKV projection is one packed [D, 3D] product per
layer, whose output the attention kernel reads unchanged; params are fp32
and compute runs in ``dtype`` with the JAX package's rounding points:

* a dense layer casts input and weight to ``dtype`` and adds the bias in
  ``dtype`` after the product (Flax ``Dense(dtype=...)``);
* the embedding sum is fp32, then cast;
* LayerNorm computes in fp32 and casts back;
* the MAG gate runs in fp32 on modality features cast to ``dtype``, as
  plain PyTorch or, with ``MultimodalConfig.use_fused_kernel``, through
  the fused gate kernels behind ``ops/mag_fused.py``;
* logits are returned in fp32.

The large products (QKV, output, FFN, pooler, classifier) are plain
``torch.nn.functional.linear``. Attention is ``ops/attention.py`` under
``attention_impl="einsum"`` and the CUDA kernels behind
``ops/fused_attention.py`` under ``"fused"``; ``head_mask`` and
``output_attentions`` take the einsum branch, as in the JAX package. With
``BertConfig.qkv_fusion`` the fused branch hands the ``qkv`` layer's
weight and bias to ``fused_attention_qkvproj``, whose kernels compute the
projection themselves (the same parameters, so ``state_dict`` and the
converters see no difference) where they reach.

Under tensor parallelism (``parallel/tp.py::shard_model_``) each encoder
layer splits its FFN over the mesh's model axis, and with
``shard_attention`` head-shards its attention (the JAX model's TP
branches, ``models/bert.py:202-300``).

``deterministic=False`` is the training forward, with the JAX package's
dropout sites: the embeddings after their LayerNorm, the MAG output, the
attention probs (in the kernel, or on the einsum branch), the attention
output and the FFN output before their residual LayerNorms, and the pooled
output before the classifier. It needs ``dropout_rng`` (an int seed or a
CPU ``torch.Generator``; see ``ops/dropout.py::DropoutRngs``) in place of
Flax's ``rngs={"dropout": key}``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    resolve_device,
)
from bert_multimodal_transformer_tpu_torch.models.mag import MAG
from bert_multimodal_transformer_tpu_torch.ops.activations import ACT2FN
from bert_multimodal_transformer_tpu_torch.ops.attention import (
    dot_product_attention,
    extended_attention_mask,
)
from bert_multimodal_transformer_tpu_torch.ops.dropout import (
    DropoutRngs,
    dropout,
)
from bert_multimodal_transformer_tpu_torch.ops.fused_attention import (
    fused_attention_packed,
    fused_attention_qkvproj,
    fused_attention_tp,
    split_tier,
)
from bert_multimodal_transformer_tpu_torch.parallel.tp import (
    copy_to_model,
    local_heads,
    reduce_from_model,
)


def _uninitialized(module_cls, *args, device) -> nn.Module:
    # Weights are set by init_weights from an explicit generator.
    return nn.utils.skip_init(module_cls, *args,
                              device=resolve_device(device))


def _linear(in_features: int, out_features: int, device) -> nn.Linear:
    return _uninitialized(nn.Linear, in_features, out_features, device=device)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Flax ``Dense(dtype=...)`` rounding: the product in ``dtype``, then
    the bias added in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def row_parallel_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                       mesh) -> torch.Tensor:
    """``dense`` with the weight's input columns split over the model axis
    (``parallel/tp.py``): this rank's partial product in ``dtype``, summed
    over the axis, then the replicated bias added in ``dtype``."""
    partial = F.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce_from_model(partial, mesh) + layer.bias.to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype; eps
    1e-12 as HF BertLayerNorm."""

    def __init__(self, dim: int, eps: float = 1e-12, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class BertEmbeddings(nn.Module):
    """word + learned-position + token-type embeddings → LayerNorm."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.dtype = dtype
        self.hidden_dropout_prob = config.hidden_dropout_prob
        d = config.hidden_size
        self.word_embeddings = _uninitialized(
            nn.Embedding, config.vocab_size, d, device=device)
        self.position_embeddings = _uninitialized(
            nn.Embedding, config.max_position_embeddings, d, device=device)
        self.token_type_embeddings = _uninitialized(
            nn.Embedding, config.type_vocab_size, d, device=device)
        self.LayerNorm = LayerNorm(d, config.layer_norm_eps, device=device)

    def forward(self, input_ids: Optional[torch.Tensor],
                token_type_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                *, deterministic: bool = True,
                rngs: Optional[DropoutRngs] = None) -> torch.Tensor:
        if inputs_embeds is None:
            seq_len = input_ids.shape[-1]
            word = F.embedding(input_ids, self.word_embeddings.weight)
        else:
            seq_len = inputs_embeds.shape[-2]
            word = inputs_embeds
        if position_ids is None:
            position_ids = torch.arange(seq_len, device=word.device)[None, :]
        x = (word
             + F.embedding(position_ids, self.position_embeddings.weight)
             + F.embedding(token_type_ids, self.token_type_embeddings.weight)
             ).to(self.dtype)
        return _hidden_dropout(self.LayerNorm(x), self.hidden_dropout_prob,
                               rngs, deterministic)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention with packed QKV, output projection and the
    post-LN residual (HF BertAttention math).

    ``tp_mesh`` (set by ``parallel/tp.py::shard_model_`` under
    ``shard_attention``) head-shards it over the mesh's model axis, the JAX
    model's TP branches: this rank's q, k, v of its heads from the
    replicated packed weight, the split-layout kernels through
    ``fused_attention_tp`` while ``split_tier`` says they reach (else the
    einsum math on the local heads), and ``output_dense`` row-parallel.
    Without it, ``qkv_fusion`` on the fused branch (no head_mask, no
    output_attentions) takes the JAX model's ``use_qkvproj`` branch,
    FFN-only tensor parallelism (``tp_mesh`` None) too; where the kernels
    do not reach (``qkvproj_fits``, in place of the TPU's full-H fit)
    ``fused_attention_qkvproj`` itself takes the dense projection and the
    packed tiers, as the JAX model's other branch."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.tp_mesh = None
        d = config.hidden_size
        self.qkv = _linear(d, 3 * d, device)
        self.output_dense = _linear(d, d, device)
        self.output_LayerNorm = LayerNorm(d, config.layer_norm_eps,
                                          device=device)

    def forward(self, hidden: torch.Tensor,
                attn_bias: Optional[torch.Tensor],
                head_mask: Optional[torch.Tensor] = None,
                attention_mask_2d: Optional[torch.Tensor] = None,
                *, deterministic: bool = True,
                output_attentions: bool = False,
                rngs: Optional[DropoutRngs] = None):
        cfg = self.config
        rate = cfg.attention_probs_dropout_prob
        train = not deterministic and rate > 0.0
        d = cfg.hidden_size
        h = cfg.num_attention_heads
        dh = d // h
        b, s, _ = hidden.shape
        scale = 1.0 / (dh ** 0.5)
        probs = None
        fused = (cfg.attention_impl == "fused" and head_mask is None
                 and not output_attentions)
        mesh = self.tp_mesh
        if mesh is not None:
            h0, hl = local_heads(h, mesh)
            # this rank's heads' q|k|v rows of the replicated packed weight
            w = self.qkv.weight.view(3, h, dh, d)[:, h0:h0 + hl]
            bias = self.qkv.bias.view(3, h, dh)[:, h0:h0 + hl]
            qkv = (F.linear(copy_to_model(hidden, mesh).to(self.dtype),
                            w.reshape(3 * hl * dh, d).to(self.dtype))
                   + bias.reshape(-1).to(self.dtype))
            q, k, v = qkv.reshape(b, s, 3, hl, dh).permute(2, 0, 3, 1, 4)
            grad = torch.is_grad_enabled() and qkv.requires_grad
            if fused and split_tier(s, dh, grad) == "full":
                ctx = fused_attention_tp(
                    q, k, v, attention_mask_2d, mesh=mesh, scale=scale,
                    dropout_rate=rate,
                    dropout_rng=rngs.host if train else None,
                    deterministic=deterministic)
            else:
                ctx = dot_product_attention(
                    q, k, v, attn_bias, scale=scale, dropout_rate=rate,
                    dropout_rng=rngs.device if train else None,
                    deterministic=deterministic,
                    head_mask=(None if head_mask is None
                               else head_mask[h0:h0 + hl]),
                    return_probs=output_attentions, dropout_heads=(h0, h))
                if output_attentions:
                    ctx, probs = ctx
                    probs = mesh.all_gather(probs, mesh.model_axis, dim=1)
            ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, hl * dh)
            out = row_parallel_dense(self.output_dense, ctx, self.dtype,
                                     mesh)
        elif fused and cfg.qkv_fusion:
            # the projection inside the attention kernel (#18/#19) from the
            # same qkv parameters, handed over as the JAX [D, 3D] kernel;
            # past the kernels' reach the entry takes this dense layer and
            # fused_attention_packed, as the branch below
            ctx = fused_attention_qkvproj(
                hidden.to(self.dtype), self.qkv.weight.to(self.dtype).t(),
                self.qkv.bias.to(self.dtype), attention_mask_2d, n_heads=h,
                scale=scale, dropout_rate=rate,
                dropout_rng=rngs.host if train else None,
                deterministic=deterministic, qkv_residual=cfg.qkv_residual)
            out = dense(self.output_dense, ctx, self.dtype)
        else:
            qkv = dense(self.qkv, hidden, self.dtype)
            if fused:
                ctx = fused_attention_packed(
                    qkv, attention_mask_2d, n_heads=h, scale=scale,
                    dropout_rate=rate,
                    dropout_rng=rngs.host if train else None,
                    deterministic=deterministic)
            else:
                q, k, v = qkv.reshape(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
                ctx = dot_product_attention(
                    q, k, v, attn_bias, scale=scale, dropout_rate=rate,
                    dropout_rng=rngs.device if train else None,
                    deterministic=deterministic, head_mask=head_mask,
                    return_probs=output_attentions)
                if output_attentions:
                    ctx, probs = ctx
                ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, d)
            out = dense(self.output_dense, ctx, self.dtype)
        out = _hidden_dropout(out, cfg.hidden_dropout_prob, rngs,
                              deterministic)
        out = self.output_LayerNorm(out + hidden)
        if output_attentions:
            return out, probs
        return out


class BertLayer(nn.Module):
    """Self-attention block + GELU FFN block with post-LN residuals.

    ``tp_mesh`` (set by ``parallel/tp.py::shard_model_``) splits the FFN
    Megatron-style over the mesh's model axis: ``intermediate_dense``
    column-parallel, ``output_dense`` row-parallel."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.tp_mesh = None
        self.attention = BertSelfAttention(config, dtype, device=device)
        self.intermediate_dense = _linear(config.hidden_size,
                                          config.intermediate_size, device)
        self.output_dense = _linear(config.intermediate_size,
                                    config.hidden_size, device)
        self.output_LayerNorm = LayerNorm(config.hidden_size,
                                          config.layer_norm_eps,
                                          device=device)

    def forward(self, hidden: torch.Tensor,
                attn_bias: Optional[torch.Tensor],
                head_mask: Optional[torch.Tensor] = None,
                attention_mask_2d: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                output_attentions: bool = False,
                rngs: Optional[DropoutRngs] = None):
        attn_out = self.attention(hidden, attn_bias, head_mask,
                                  attention_mask_2d,
                                  deterministic=deterministic,
                                  output_attentions=output_attentions,
                                  rngs=rngs)
        probs = None
        if output_attentions:
            attn_out, probs = attn_out
        mesh = self.tp_mesh
        x = attn_out if mesh is None else copy_to_model(attn_out, mesh)
        x = dense(self.intermediate_dense, x, self.dtype)
        x = ACT2FN[self.config.hidden_act](x)
        if mesh is None:
            x = dense(self.output_dense, x, self.dtype)
        else:
            x = row_parallel_dense(self.output_dense, x, self.dtype, mesh)
        x = _hidden_dropout(x, self.config.hidden_dropout_prob, rngs,
                            deterministic)
        x = self.output_LayerNorm(x + attn_out)
        if output_attentions:
            return x, probs
        return x


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.config = config
        self.layer = nn.ModuleList(
            BertLayer(config, dtype, device=device)
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden: torch.Tensor,
                attn_bias: Optional[torch.Tensor],
                head_mask: Optional[torch.Tensor] = None,
                attention_mask_2d: Optional[torch.Tensor] = None,
                *, deterministic: bool = True,
                output_hidden_states: bool = False,
                output_attentions: bool = False,
                rngs: Optional[DropoutRngs] = None):
        all_hidden = [] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        for i, layer in enumerate(self.layer):
            if output_hidden_states:
                # per-layer INPUT states + the final output (HF semantics)
                all_hidden.append(hidden)
            # head_mask: [L, H] per-layer rows or [H] shared
            hm = None
            if head_mask is not None:
                hm = head_mask[i] if head_mask.dim() == 2 else head_mask
            out = layer(hidden, attn_bias, hm, attention_mask_2d,
                        deterministic, output_attentions, rngs)
            if output_attentions:
                hidden, probs = out
                all_attn.append(probs)
            else:
                hidden = out
        if output_hidden_states:
            all_hidden.append(hidden)
        if output_hidden_states or output_attentions:
            return (hidden,
                    tuple(all_hidden) if output_hidden_states else None,
                    tuple(all_attn) if output_attentions else None)
        return hidden


class BertPooler(nn.Module):
    """tanh(Linear(hidden[:, 0]))."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = _linear(config.hidden_size, config.hidden_size, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(dense(self.dense, hidden[:, 0], self.dtype))


def _hidden_dropout(x: torch.Tensor, rate: float,
                    rngs: Optional[DropoutRngs],
                    deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    return dropout(x, rate, rngs.device)


def _dropout_rngs(dropout_rng, deterministic: bool,
                  ref: torch.Tensor) -> Optional[DropoutRngs]:
    if deterministic:
        return None
    if dropout_rng is None:
        raise ValueError(
            "deterministic=False needs dropout_rng (an int seed or a CPU "
            "torch.Generator)")
    return DropoutRngs.make(dropout_rng, ref.device)


def _normal_(p: torch.Tensor, std: float,
             generator: torch.Generator) -> None:
    """Normal(0, std) into ``p`` from ``generator``. A tensor-parallel
    chunk (``parallel/tp.py::shard_model_``: its ``tp_shard`` is (dim, full
    size, start)) draws the full tensor and keeps its chunk, so every rank
    holds the chunk one device would, and the generator advances as one
    device's does."""
    shard = getattr(p, "tp_shard", None)
    if shard is None:
        p.normal_(0.0, std, generator=generator)
        return
    dim, full, start = shard
    shape = list(p.shape)
    shape[dim] = full
    whole = torch.empty(shape, dtype=p.dtype, device=p.device)
    whole.normal_(0.0, std, generator=generator)
    p.copy_(whole.narrow(dim, start, p.shape[dim]))


def init_weights(module: nn.Module, initializer_range: float,
                 generator: torch.Generator) -> None:
    """Normal(0, initializer_range) dense kernels and embeddings, zero
    biases, unit LayerNorms, torch-default MAG; drawn in module order from
    ``generator``, which must live on the params' device."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                _normal_(sub.weight, initializer_range, generator)
                sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                sub.weight.normal_(0.0, initializer_range,
                                   generator=generator)
            elif isinstance(sub, LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()


class MagBertModel(nn.Module):
    """BERT backbone with early-fusion MAG: embeddings → MAG(emb, visual,
    acoustic) → encoder → pooler. ``device=None`` builds on the card
    (``config.resolve_device``: raises without one); pass ``device="cpu"``
    for the CPU."""

    def __init__(self, config: BertConfig,
                 multimodal_config: MultimodalConfig, visual_dim: int,
                 acoustic_dim: int, dtype: torch.dtype = torch.float32,
                 *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        mm = multimodal_config
        self.embeddings = BertEmbeddings(config, dtype, device=device)
        self.MAG = MAG(config.hidden_size, visual_dim, acoustic_dim,
                       beta_shift=mm.beta_shift,
                       dropout_prob=mm.dropout_prob,
                       use_fused_kernel=mm.use_fused_kernel, device=device,
                       generator=generator)
        self.encoder = BertEncoder(config, dtype, device=device)
        self.pooler = BertPooler(config, dtype, device=device)
        init_weights(self, config.initializer_range, generator)

    def forward(
        self,
        input_ids: Optional[torch.Tensor],
        visual: torch.Tensor,
        acoustic: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        head_mask: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        *,
        deterministic: bool = True,
        dropout_rng=None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
    ):
        if (input_ids is None) == (inputs_embeds is None):
            raise ValueError(
                "specify exactly one of input_ids or inputs_embeds")
        ref = input_ids if input_ids is not None else inputs_embeds
        rngs = _dropout_rngs(dropout_rng, deterministic, ref)
        input_shape = (input_ids.shape if input_ids is not None
                       else inputs_embeds.shape[:-1])
        if attention_mask is None:
            attention_mask = torch.ones(input_shape, dtype=torch.int32,
                                        device=ref.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros(input_shape, dtype=torch.int32,
                                         device=ref.device)
        # Both attention branches read the mask as fp32; cast it once.
        mask_f32 = attention_mask.to(torch.float32)
        attn_bias = extended_attention_mask(mask_f32)

        emb = self.embeddings(input_ids, token_type_ids, position_ids,
                              inputs_embeds=inputs_embeds,
                              deterministic=deterministic, rngs=rngs)
        fused = self.MAG(emb, visual.to(self.dtype), acoustic.to(self.dtype),
                         deterministic=deterministic,
                         dropout_rng=rngs.device if rngs else None)
        enc_out = self.encoder(fused, attn_bias, head_mask, mask_f32,
                               deterministic=deterministic,
                               output_hidden_states=output_hidden_states,
                               output_attentions=output_attentions,
                               rngs=rngs)
        if output_hidden_states or output_attentions:
            seq_out, all_hidden, all_attn = enc_out
        else:
            seq_out, all_hidden, all_attn = enc_out, None, None
        pooled = self.pooler(seq_out)
        outputs = (seq_out, pooled)
        if output_hidden_states:
            outputs = outputs + (all_hidden,)
        if output_attentions:
            outputs = outputs + (all_attn,)
        return outputs


class MagBertForSequenceClassification(nn.Module):
    """Pooled-output classifier head over MagBertModel."""

    def __init__(self, config: BertConfig,
                 multimodal_config: MultimodalConfig, visual_dim: int,
                 acoustic_dim: int, dtype: torch.dtype = torch.float32,
                 *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.bert = MagBertModel(config, multimodal_config, visual_dim,
                                 acoustic_dim, dtype, device=device,
                                 generator=generator)
        self.classifier = _linear(config.hidden_size, config.num_labels,
                                  device)
        init_weights(self.classifier, config.initializer_range, generator)

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every param again from ``generator`` (on the params'
        device), in the constructor's order: the same generator state
        gives the same weights as constructing the model with it."""
        self.bert.MAG.reset_parameters(generator)
        init_weights(self.bert, self.config.initializer_range, generator)
        init_weights(self.classifier, self.config.initializer_range,
                     generator)

    def forward(
        self,
        input_ids: Optional[torch.Tensor],
        visual: torch.Tensor,
        acoustic: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        head_mask: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        *,
        deterministic: bool = True,
        dropout_rng=None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
    ):
        """``deterministic=False`` is the training forward and needs
        ``dropout_rng``: an int seed or a CPU ``torch.Generator``, from
        which every dropout site of the call draws (module docstring)."""
        ref = input_ids if input_ids is not None else inputs_embeds
        rngs = _dropout_rngs(dropout_rng, deterministic, ref)
        bert_out = self.bert(
            input_ids, visual, acoustic, attention_mask, token_type_ids,
            position_ids, head_mask, inputs_embeds,
            deterministic=deterministic, dropout_rng=rngs,
            output_hidden_states=output_hidden_states,
            output_attentions=output_attentions)
        pooled = _hidden_dropout(bert_out[1], self.config.hidden_dropout_prob,
                                 rngs, deterministic)
        extras = bert_out[2:]  # hidden_states/attentions when requested
        logits = dense(self.classifier, pooled, self.dtype).float()
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
