"""from_pretrained-style constructors (port of ``utils/pretrained.py``).

One-call mirror of the reference's model creation
(``MAG_BertForSequenceClassification.from_pretrained(name,
multimodal_config=..., num_labels=1)``, multimodal_driver.py:316-323):
build the model with every param drawn from ``seed``, then overwrite every
encoder weight from a local HF checkpoint with missing-key tolerance
(``utils/convert.py::load_pretrained_into_model``): MAG and the classifier
head keep their fresh initialization (bert.py:90,249).

No network: ``path`` is a local ``pytorch_model.bin`` or
``model.safetensors``, or a directory holding one, where a ``config.json``
beside it overrides the geometry. The model is built on the card unless
the caller passes ``device="cpu"``; the port's model holds its params, so
these return the model alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
    resolve_device,
)
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    load_pretrained_into_model,
)


def _load_config_json(path: str) -> Optional[dict]:
    if os.path.isdir(path):
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                return json.load(f)
    return None


def _apply_config_overrides(cfg, raw: Optional[dict]):
    if not raw:
        return cfg
    fields = {f.name for f in dataclasses.fields(cfg)}
    overrides = {k: v for k, v in raw.items()
                 if k in fields and v is not None}
    return dataclasses.replace(cfg, **overrides)


def _from_pretrained(model_cls, default_cfg, family: str, path: str,
                     multimodal_config: MultimodalConfig, *,
                     visual_dim: int, acoustic_dim: int, config=None,
                     num_labels: int = 1, dtype: torch.dtype = torch.float32,
                     seed: int = 0, device=None):
    """Shared loading recipe for both families: config.json overrides →
    the model built with its params drawn from ``seed`` on ``device`` →
    the checkpoint overlay."""
    cfg = config or default_cfg
    cfg = _apply_config_overrides(cfg, _load_config_json(path))
    cfg = dataclasses.replace(cfg, num_labels=num_labels)
    device = resolve_device(device)
    model = model_cls(cfg, multimodal_config, visual_dim, acoustic_dim,
                      dtype, device=device,
                      generator=torch.Generator(device=device).manual_seed(
                          seed))
    return load_pretrained_into_model(model, path, family=family)


def bert_from_pretrained(path: str, multimodal_config: MultimodalConfig,
                         **kw):
    """A MAG-BERT classifier with its encoder weights loaded from
    ``path``."""
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    return _from_pretrained(MagBertForSequenceClassification,
                            BertConfig.bert_base_uncased(), "bert", path,
                            multimodal_config, **kw)


def xlnet_from_pretrained(path: str, multimodal_config: MultimodalConfig,
                          **kw):
    """A MAG-XLNet classifier with its transformer weights loaded from
    ``path`` (``sequence_summary``/``logits_proj`` load too when the
    checkpoint has them)."""
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    return _from_pretrained(MagXLNetForSequenceClassification,
                            XLNetConfig.xlnet_base_cased(), "xlnet", path,
                            multimodal_config, **kw)


def from_pretrained(path: str, model_name: str,
                    multimodal_config: MultimodalConfig, **kw):
    """Name-dispatched variant mirroring prep_for_training
    (multimodal_driver.py:316-323)."""
    if model_name.startswith("bert"):
        kw.setdefault(
            "config",
            BertConfig.bert_large_uncased() if "large" in model_name
            else BertConfig.bert_base_uncased())
        return bert_from_pretrained(path, multimodal_config, **kw)
    if model_name.startswith("xlnet"):
        return xlnet_from_pretrained(path, multimodal_config, **kw)
    raise ValueError(f"unknown model family for {model_name!r}")
