"""GPipe pipeline parallelism for MAG-XLNet (port of ``parallel/pp_xlnet.py``).

The XLNet twin of ``parallel/pp.py``: the schedule, the collectives, the
optimizer, the epoch drivers and resume are ``PipelineTrainer``'s; this
module supplies the XLNet stage and its parameter layout:

* PROLOGUE (replicated over the pipe axis): the word embedding and its
  dropout, with MAG's parameters and the query stream's ``mask_emb``
  (unused on the fine-tuning path, kept so the layout round-trips). The
  mask algebra, the segment matrix and the relative position encoding are
  functions of the microbatch alone, so every stage computes them for
  itself; only the [mb, S, D] activation crosses between stages;
* MAG mid-stack: the model injects MAG before layer
  ``injection_index`` (1 for XLNet). With k layers a stage and
  injection_index = r0·k + p, stage r0 applies it before its local layer
  p, and no other stage runs it (the fused gate's #25/#26 launch on r0
  only); k = 1 puts it on stage 1;
* EPILOGUE (replicated like the prologue): the model-level dropout, the
  last-token ``SequenceSummary`` and the logits projection;
* PP×TP: the FFN is split over the model axis as on one stage of the
  tensor-parallel model (the JAX ``_TPXLNetLayer`` / ``_TPXLNetFF``: the
  inner dropout drawn at full width and sliced, as ``parallel/tp.py``
  does); relative attention stays full-headed.

Scope, as in JAX: bi attention, the content stream, no memory; ``bi_data``
and other attention types are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bert_multimodal_transformer_tpu_torch.models.bert import (
    _hidden_dropout,
    dense,
)
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MASK_VERY_NEG,
    relative_positional_encoding,
)
from bert_multimodal_transformer_tpu_torch.ops.dropout import DropoutRngs
from bert_multimodal_transformer_tpu_torch.parallel.pp import (
    PipelineStage,
    PipelineTrainer,
    model_params_from_pp_params,
    pp_params_from_model_params,
)

# The XLNet names of the layout functions (JAX
# ``pp_params_from_xlnet_params`` / ``xlnet_params_from_pp_params``); the
# functions read the family off the names.
pp_params_from_xlnet_params = pp_params_from_model_params
xlnet_params_from_pp_params = model_params_from_pp_params


@dataclasses.dataclass
class XLNetPipelineTrainer(PipelineTrainer):
    """The pipelined drop-in Trainer for MAG-XLNet regression (module
    docstring); everything but the stage is ``PipelineTrainer``'s."""

    def __post_init__(self):
        cfg = self.model.config
        self._pp_common_setup(cfg.n_layer, cfg.d_model)
        if self._mp > 1 and cfg.d_inner % self._mp != 0:
            raise ValueError(
                f"d_inner ({cfg.d_inner}) must divide by the model "
                f"axis ({self._mp}) for the Megatron FFN split")
        if cfg.attn_type != "bi":
            raise ValueError(
                "the pipelined XLNet stage implements bi attention (the "
                "fine-tuning config, xlnet-base-cased); attn_type="
                f"{cfg.attn_type!r} is not pipelined")
        if cfg.bi_data:
            raise ValueError(
                "bi_data position streams are not pipelined (training "
                "never uses them — reference xlnet.py:126-141)")
        inj = self.model.multimodal_config.injection_index
        if not (0 <= inj < cfg.n_layer):
            raise ValueError(
                f"injection_index {inj} outside [0, {cfg.n_layer})")
        # injection_index = r0·k + p: MAG before local layer p on stage r0
        self._inj_rank, self._inj_local = divmod(inj, self._k)
        self._tp_split()

    def _model_parts(self):
        tr = self.model.transformer
        return ({"word_embedding": tr.word_embedding, "MAG": tr.MAG,
                 "mask_emb": tr.mask_emb},
                list(tr.layer),
                {"sequence_summary": self.model.sequence_summary,
                 "logits_proj": self.model.logits_proj})

    def _stage_forward(self, stage: PipelineStage, mb: Tuple,
                       x_in: Optional[torch.Tensor],
                       rngs: Optional[DropoutRngs], deterministic: bool):
        ids, vis, ac, mask, seg = mb[:5]
        cfg, dt = self.model.config, self._dtype
        b, s = ids.shape
        device = ids.device
        pro = stage.prologue
        if x_in is None:
            h = _hidden_dropout(
                F.embedding(ids, pro.word_embedding.weight).to(dt),
                cfg.dropout, rngs, deterministic, "Dropout_0")
        else:
            h = x_in
        # the layer-independent tensors of the fine-tuning forward (the
        # model's own, models/xlnet.py::MagXLNetModel.forward, at mlen 0)
        non_tgt_mask, attn_mask = self.model.transformer._masks(
            b, s, 0, mask, None, None, device)
        diff = seg[:, :, None] != seg[:, None, :]
        seg_mat = F.one_hot(diff.long(), 2).to(torch.float32)
        seg_diff = diff[:, None]
        pos_emb = relative_positional_encoding(
            s, s, cfg.d_model, cfg.attn_type, cfg.clamp_len, bi_data=False,
            dtype=dt, device=device)
        pos_emb = _hidden_dropout(pos_emb, cfg.dropout, rngs, deterministic,
                                  "Dropout_0", batch=False)
        mask_bias_h = None
        if cfg.attention_impl == "fused":
            if non_tgt_mask is not None:
                mask_bias_h = (-(MASK_VERY_NEG * non_tgt_mask)).to(dt)
        else:
            seg_diff = None
        on_inj = self.mesh.pipe_rank == self._inj_rank
        for j, layer in enumerate(stage.layers):
            if on_inj and j == self._inj_local:
                h = pro.MAG(h, vis.to(dt), ac.to(dt),
                            deterministic=deterministic,
                            dropout_rng=rngs.device if rngs else None)
            h = layer(h, None, non_tgt_mask, attn_mask, pos_emb, seg_mat,
                      None, None, deterministic=deterministic, rngs=rngs,
                      mask_bias_h=mask_bias_h, seg_diff=seg_diff)[0]
        if not self._last:
            return h
        epi = stage.epilogue
        out = _hidden_dropout(h, cfg.dropout, rngs, deterministic,
                              "Dropout_0")
        summary = epi.sequence_summary(out, deterministic=deterministic,
                                       rngs=rngs)
        return dense(epi.logits_proj, summary, dt).float().reshape(-1)
