"""Typed configuration, with torch dtypes.

Port of ``bert_multimodal_transformer_tpu/config.py`` (dataset presets, the
MAG hyperparameters, the rank mesh, the BERT and XLNet configs). Options
whose port has not landed yet raise ``NotImplementedError`` naming their
ROADMAP item instead of being silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Modality dimensions and identity of one dataset (MOSI: acoustic 74,
    visual 47, text 768; MOSEI: visual 35)."""

    name: str
    acoustic_dim: int
    visual_dim: int
    text_dim: int = 768
    # Split sizes (train, dev, test); informational only.
    split_sizes: Tuple[int, int, int] = (0, 0, 0)

    @staticmethod
    def mosi() -> "DatasetConfig":
        return DatasetConfig(
            name="mosi", acoustic_dim=74, visual_dim=47, text_dim=768,
            split_sizes=(1281, 229, 685),
        )

    @staticmethod
    def mosei() -> "DatasetConfig":
        return DatasetConfig(
            name="mosei", acoustic_dim=74, visual_dim=35, text_dim=768,
            split_sizes=(16265, 1869, 4643),
        )

    @staticmethod
    def from_name(name: str) -> "DatasetConfig":
        presets = {"mosi": DatasetConfig.mosi, "mosei": DatasetConfig.mosei}
        if name not in presets:
            raise ValueError(
                f"Unknown dataset {name!r}; expected one of {sorted(presets)}"
            )
        return presets[name]()


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    """MAG gate hyperparameters."""

    beta_shift: float = 1.0
    dropout_prob: float = 0.5
    # Encoder layer the gate is injected before: 0 for BERT (the embedding
    # output), 1 for XLNet.
    injection_index: int = 0
    # Route the gate through the fused kernels (ops/mag_fused.py).
    use_fused_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The rank mesh's layout (parallel/mesh.py::make_mesh): data_parallel
    × model_parallel ranks, -1 for every rank on that axis."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT encoder hyperparameters (HF transformers==3.0.2 defaults for
    bert-base-uncased)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_labels: int = 1
    # "einsum" (plain PyTorch attention, exact HF semantics) or "fused"
    # (the hand-written packed attention kernel, ops/fused_attention.py).
    # "flash" waits for ROADMAP A.2.
    attention_impl: str = "einsum"
    # With attention_impl="fused": also fuse the QKV projection gemm into
    # the attention kernel (qkv = x·W + b computed in the forward kernel #18;
    # the backward #19 emits dqkv once and does dx = dqkv·Wᵀ in-kernel —
    # ops/fused_attention.py::fused_attention_qkvproj). Opt-in, as in the
    # JAX package. Ignored under TP attention sharding / head_mask /
    # output_attentions (those fall back to the split projection).
    qkv_fusion: bool = False
    # With qkv_fusion: save the kernel-computed qkv to device memory as a
    # backward residual (True) or recompute the projection in the backward
    # kernel (False — drops the B·S·3D residual entirely).
    qkv_residual: bool = False
    # The mesh whose model axis head-shards attention (tensor parallelism,
    # parallel/tp.py): set with Trainer(tp_shard_attention=True), and read
    # by Predictor(mesh=...). None: attention over all heads on every rank.
    tp_attention_mesh: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.attention_impl == "flash":
            raise NotImplementedError(
                "attention_impl='flash' is not ported yet (ROADMAP A.2)")
        if self.attention_impl not in ("einsum", "fused"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} "
                "(einsum | fused)")
        if self.tp_attention_mesh is not None:
            from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
                Mesh,
            )

            if not isinstance(self.tp_attention_mesh, Mesh):
                raise TypeError(
                    "tp_attention_mesh must be a parallel.mesh.Mesh, got "
                    f"{type(self.tp_attention_mesh).__name__}")

    @staticmethod
    def bert_base_uncased() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def bert_large_uncased() -> "BertConfig":
        return BertConfig(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096,
        )

    @staticmethod
    def tiny(vocab_size: int = 128) -> "BertConfig":
        """Small config for tests."""
        return BertConfig(
            vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64,
        )


@dataclasses.dataclass(frozen=True)
class XLNetConfig:
    """XLNet hyperparameters (HF transformers==3.0.2 defaults for
    xlnet-base-cased), the fields and defaults of the JAX package's
    ``XLNetConfig``."""

    vocab_size: int = 32000
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    d_inner: int = 3072
    ff_activation: str = "gelu"
    # Hidden and attention-prob dropout alike.
    dropout: float = 0.1
    # Segment recurrence (Transformer-XL memory): under use_cache each layer
    # keeps its last mem_len input rows (of the first reuse_len of the
    # current segment, when set) for the next segment's keys.
    mem_len: Optional[int] = None
    reuse_len: Optional[int] = None
    attn_type: str = "bi"
    same_length: bool = False
    bi_data: bool = False
    clamp_len: int = -1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # SequenceSummary: the last token, a projection, tanh, this dropout.
    summary_last_dropout: float = 0.1
    num_labels: int = 1
    # "einsum" (plain PyTorch attention) or "fused" (the rel-attention
    # kernels, ops/fused_attention.py, tier by rel_tier).
    attention_impl: str = "einsum"
    # Score-bias assembly on the fused path. "stream" assembles the
    # [B,H,Q,K] ebias outside the kernels at every length (the full-H
    # kernels, then the head-blocked ones to Q = K = 640, then the
    # flash-streamed ones at any length). "auto" does the same while the
    # full-H kernels reach and past them hands the kernels the bias
    # ingredients (the flash-streamed ingredients kernels, any length),
    # where bi attention without bi_data allows; else as "stream".
    # "inkernel" hands the kernels the ingredients at every length where
    # they are eligible (the full-H ingredients kernels while they reach,
    # then the flash-streamed ones); else as "stream" (rel_tier).
    rel_bias_impl: str = "auto"
    # One [D, 3·H·Dh] projection for q/k/v in place of three (same math).
    pack_qkv: bool = False
    tp_attention_mesh: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.attention_impl not in ("einsum", "fused"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} "
                "(XLNet: einsum | fused)")
        if self.rel_bias_impl not in ("auto", "stream", "inkernel"):
            raise ValueError(
                f"unknown rel_bias_impl {self.rel_bias_impl!r} "
                "(auto | stream | inkernel)")
        if self.tp_attention_mesh is not None:
            raise NotImplementedError(
                "tp_attention_mesh: tensor-parallel attention is not ported "
                "yet (ROADMAP A.10)")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def xlnet_base_cased() -> "XLNetConfig":
        return XLNetConfig()

    @staticmethod
    def tiny(vocab_size: int = 128) -> "XLNetConfig":
        return XLNetConfig(
            vocab_size=vocab_size, d_model=32, n_layer=2, n_head=2, d_inner=64,
        )


def resolve_device(device) -> torch.device:
    """The device a model is built on: the card unless the caller asks for
    another. ``None`` means ``cuda``, and raises when no card is visible
    rather than building on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: pass device=\"cpu\" to build the "
                "model on the CPU (the kernels' plain versions)")
        device = "cuda"
    return torch.device(device)


def dtype_from_str(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]
