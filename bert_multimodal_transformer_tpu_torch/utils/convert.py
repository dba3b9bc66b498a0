"""Param conversion into the port.

``params_from_flax`` and ``xlnet_params_from_flax`` take the JAX package's
MAG-BERT and MAG-XLNet param trees (nested dicts of arrays, as
``model.init(...)["params"]`` or a restored checkpoint gives them, with
every leaf converted by ``np.asarray``; or torch tensors, which stay on
their device, as ``utils/flax_rng.py::init_params`` draws them) and return
the port's ``state_dict``. For MAG-BERT:

* dense ``kernel`` [in, out] → ``nn.Linear.weight`` [out, in];
* LayerNorm ``scale``/``bias`` → ``weight``/``bias``;
* embedding tables → ``<table>.weight``;
* ``layer_{i}`` → ``layer.{i}``;
* MAG params pass through unchanged (the port keeps their layout).

Both also take the JAX pipeline layout (``parallel/pp.py::
pp_params_from_model_params``, ``pp_xlnet.py::pp_params_from_xlnet_params``:
``prologue`` / ``layers`` stacked on a leading [L] axis / ``epilogue``),
as a pipelined run's checkpoint holds it, and give the model's state dict.

HF checkpoints (the reference warm-starts from them through
``from_pretrained`` with missing-key tolerance, multimodal_driver.py:316-323)
map straight onto the port's state dict: ``load_torch_state_dict`` reads a
local ``pytorch_model.bin`` or ``model.safetensors``,
``convert_bert_params`` / ``convert_xlnet_params`` rename and reshape the
HF tensors, and ``load_pretrained_into_model`` overlays them on a built
model, whose MAG and classifier keep their fresh init.
``export_bert_state_dict`` / ``export_xlnet_state_dict`` go back to HF
names, and ``save_hf_state_dict`` writes the file. No network and no
``transformers``: the HF names are spelled out here.
"""

from __future__ import annotations

import errno
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib
from bert_multimodal_transformer_tpu_torch.utils.safetensors_io import (
    load_safetensors,
    save_safetensors,
)

_LAYER = re.compile(r"layer_(\d+)")


def _walk(tree: Mapping[str, Any],
          leaf: Callable[[List[str], str, np.ndarray],
                         Tuple[List[str], np.ndarray]],
          stack: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Flatten a Flax param tree into ``state_dict`` names, ``layer_{i}`` →
    ``layer.{i}`` (only directly under ``stack`` when given: XLNet's FFN
    has Dense children named layer_1/layer_2); ``leaf(path, key, array)``
    gives each leaf's trailing names and array."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: List[str]) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = (_LAYER.fullmatch(key)
                     if stack is None or path[-1:] == [stack] else None)
                walk(val, path + [f"layer.{m.group(1)}" if m else key])
                continue
            if not isinstance(val, torch.Tensor):
                val = np.asarray(val)
            names, arr = leaf(path, key, val)
            out[".".join(path + names)] = (
                arr.contiguous() if isinstance(arr, torch.Tensor)
                else torch.tensor(np.ascontiguousarray(arr)))

    walk(tree, [])
    return out


def _dense_or_norm(key: str, arr: np.ndarray):
    """Dense ``kernel`` [in, out] → ``weight`` [out, in]; LayerNorm
    ``scale`` → ``weight``; ``bias`` stays; None for any other leaf."""
    if key == "kernel":
        return ["weight"], arr.T
    if key == "scale":
        return ["weight"], arr
    if key == "bias":
        return ["bias"], arr
    return None


def _model_tree_from_pp(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX pipeline-layout tree → the model tree it came from (JAX
    ``model_params_from_pp_params`` / ``xlnet_params_from_pp_params``,
    on numpy leaves)."""

    def unstack(node, i):
        return {k: unstack(v, i) if isinstance(v, Mapping)
                else np.asarray(v)[i] for k, v in node.items()}

    def first_leaf(node):
        v = next(iter(node.values()))
        return first_leaf(v) if isinstance(v, Mapping) else np.asarray(v)

    pro, epi = tree["prologue"], tree["epilogue"]
    layers = {f"layer_{i}": unstack(tree["layers"], i)
              for i in range(first_leaf(tree["layers"]).shape[0])}
    if "word_embedding" in pro:
        return {"transformer": {"word_embedding": pro["word_embedding"],
                                "MAG": pro["MAG"], **layers},
                "sequence_summary": epi["sequence_summary"],
                "logits_proj": epi["logits_proj"]}
    return {"bert": {"embeddings": pro["embeddings"], "MAG": pro["MAG"],
                     "encoder": layers, "pooler": epi["pooler"]},
            "classifier": epi["classifier"]}


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX MAG-BERT tree (or its pipeline layout) → the port's
    ``MagBert*`` state_dict. A MAG-XLNet pipeline layout goes to
    ``xlnet_params_from_flax``."""
    if "prologue" in tree:
        tree = _model_tree_from_pp(tree)
        if "transformer" in tree:
            return xlnet_params_from_flax(tree)

    def leaf(path, key, arr):
        if "MAG" in path:
            return [key], arr
        return _dense_or_norm(key, arr) or ([key, "weight"], arr)

    return _walk(tree, leaf)


def xlnet_params_from_flax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX MAG-XLNet tree → the port's ``MagXLNet*`` state_dict: the
    FFN, summary and logits ``nn.Dense`` kernels transpose into
    ``nn.Linear``; the embedding table ``word_embedding/embedding`` becomes
    ``word_embedding.weight``; the raw attention params (q, k, v, o, r
    [D, H·Dh], r_{w,r,s}_bias, seg_embed), ``mask_emb`` and the MAG params
    pass through as they are. A tree initialised without
    ``target_mapping`` has no ``mask_emb``: load it with ``strict=False``
    and the port keeps its own. The pipeline layout is taken too."""
    if "prologue" in tree:
        tree = _model_tree_from_pp(tree)

    def leaf(path, key, arr):
        if "MAG" in path:
            return [key], arr
        if key == "embedding":
            return ["weight"], arr
        return _dense_or_norm(key, arr) or ([key], arr)

    return _walk(tree, leaf, stack="transformer")


# ---- HF checkpoints --------------------------------------------------------

HF_FILES = ("pytorch_model.bin", "model.safetensors")


def checkpoint_file(path: str) -> str:
    """The weights file of ``path``: the file itself, or in a directory
    ``pytorch_model.bin`` before ``model.safetensors``. Raises
    FileNotFoundError (with the message ``open`` gives a missing file)."""
    if os.path.isdir(path):
        for candidate in HF_FILES:
            p = os.path.join(path, candidate)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"{path}: no pytorch_model.bin or model.safetensors")
    if not os.path.exists(path):
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT),
                                path)
    return path


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An HF checkpoint as CPU tensors: a torch-pickle
    ``pytorch_model.bin`` (``torch.load(weights_only=True)``: tensors
    only, no code runs) or a ``model.safetensors`` (parsed in numpy, BF16
    widened exactly). A directory is searched for either, .bin first."""
    path = checkpoint_file(path)
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v)
                for k, v in load_safetensors(path).items()}
    return torch.load(path, map_location="cpu", weights_only=True)


def _strip_prefix(sd: Dict[str, torch.Tensor],
                  prefixes=("bert.", "transformer.")
                  ) -> Dict[str, torch.Tensor]:
    """Drop the head model's ``bert.`` / ``transformer.`` prefix (an HF
    ``*ForSequenceClassification`` checkpoint) from every name."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _getter(sd: Mapping[str, torch.Tensor]):
    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"checkpoint missing {name}")
        return sd[name]

    return get


# HF BERT layer names → the port's, after the layer prefix: (HF, port).
_BERT_LAYER = (
    ("attention.output.dense", "attention.output_dense"),
    ("attention.output.LayerNorm", "attention.output_LayerNorm"),
    ("intermediate.dense", "intermediate_dense"),
    ("output.dense", "output_dense"),
    ("output.LayerNorm", "output_LayerNorm"),
)


def convert_bert_params(hf_sd: Dict[str, torch.Tensor], num_layers: int,
                        prefix: str = "bert.") -> Dict[str, torch.Tensor]:
    """An HF BERT state dict (prefix stripped) → the port's MAG-BERT
    names under ``prefix``. Both sides store ``nn.Linear`` weights as
    [out, in], so nothing transposes; each layer's q/k/v pack into the one
    ``qkv`` Linear, query rows first, then key, then value
    (``models/bert.py``'s split of the packed projection). The pooler
    loads when the checkpoint has one."""
    get = _getter(hf_sd)
    out = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = get(
            f"embeddings.{name}.weight")
    for leaf in ("weight", "bias"):
        out[f"{prefix}embeddings.LayerNorm.{leaf}"] = get(
            f"embeddings.LayerNorm.{leaf}")
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}.", f"{prefix}encoder.layer.{i}."
        for leaf in ("weight", "bias"):
            out[f"{dst}attention.qkv.{leaf}"] = torch.cat([
                get(f"{src}attention.self.{qkv}.{leaf}")
                for qkv in ("query", "key", "value")])
            for hf, port in _BERT_LAYER:
                out[f"{dst}{port}.{leaf}"] = get(f"{src}{hf}.{leaf}")
    if "pooler.dense.weight" in hf_sd:
        for leaf in ("weight", "bias"):
            out[f"{prefix}pooler.dense.{leaf}"] = get(
                f"pooler.dense.{leaf}")
    return out


_XLNET_ATTN = ("r_w_bias", "r_r_bias", "r_s_bias", "seg_embed",
               "layer_norm.weight", "layer_norm.bias")
_XLNET_FF = tuple(f"{m}.{leaf}" for m in ("layer_1", "layer_2", "layer_norm")
                  for leaf in ("weight", "bias"))
_XLNET_HEAD = ("sequence_summary.summary.weight",
               "sequence_summary.summary.bias", "logits_proj.weight",
               "logits_proj.bias")


def convert_xlnet_params(hf_sd: Dict[str, torch.Tensor], num_layers: int,
                         prefix: str = "transformer."
                         ) -> Dict[str, torch.Tensor]:
    """An HF XLNet state dict (prefix stripped) → the port's MAG-XLNet
    names. HF stores q/k/v/o/r as [d_model, n_head, d_head] einsum
    weights; the port stores them flat, [d_model, n_head·d_head]. The
    biases [n_head, d_head], seg_embed [2, n_head, d_head] and the FFN's
    ``nn.Linear`` weights carry over as they are. ``mask_emb`` and the
    head (``sequence_summary``, ``logits_proj``, outside ``prefix``) come
    along when the checkpoint has them."""
    get = _getter(hf_sd)
    out = {f"{prefix}word_embedding.weight": get("word_embedding.weight")}
    if "mask_emb" in hf_sd:
        out[f"{prefix}mask_emb"] = hf_sd["mask_emb"]
    for i in range(num_layers):
        src, dst = f"layer.{i}.", f"{prefix}layer.{i}."
        for name in ("q", "k", "v", "o", "r"):
            w = get(f"{src}rel_attn.{name}")
            out[f"{dst}rel_attn.{name}"] = w.reshape(w.shape[0], -1)
        for name in _XLNET_ATTN:
            out[f"{dst}rel_attn.{name}"] = get(f"{src}rel_attn.{name}")
        for name in _XLNET_FF:
            out[f"{dst}ff.{name}"] = get(f"{src}ff.{name}")
    for name in _XLNET_HEAD:
        if name in hf_sd:
            out[name] = hf_sd[name]
    return out


def _count_layers(sd: Dict[str, torch.Tensor], prefix_fmt: str) -> int:
    i = 0
    while any(k.startswith(prefix_fmt.format(i)) for k in sd):
        i += 1
    return i


def _optional(name: str) -> bool:
    """Names a model may lack and the overlay then skips: the pooler, the
    query stream's ``mask_emb`` and the XLNet head."""
    return (".pooler." in f".{name}" or name.endswith("mask_emb")
            or name in _XLNET_HEAD)


def _full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Each state-dict entry's shape at full size (a tensor-parallel
    chunk records its full extent in ``tp_shard``, an FSDP slice in
    ``fsdp_shard``)."""
    shapes = {}
    for name, t in model.state_dict(keep_vars=True).items():
        shape = list(t.shape)
        for attr in ("tp_shard", "fsdp_shard"):
            shard = getattr(t, attr, None)
            if shard is not None:
                shape[shard[0]] = shard[1]
        shapes[name] = tuple(shape)
    return shapes


def load_pretrained_into_model(model: nn.Module, checkpoint_path: str,
                               family: str = "bert") -> nn.Module:
    """``from_pretrained``'s overlay, in place: every encoder weight of the
    local HF checkpoint replaces the model's (the layer count read off the
    checkpoint's names), cast to the param's dtype on its device; MAG and
    the classifier keep their fresh init, as do the optional pieces the
    checkpoint lacks. A model sharded by ``parallel/tp.py::shard_model_``
    takes its chunks, one split by ``parallel/fsdp.py`` its slices. A
    tensor whose shape differs from the model's (a [512, D] position table
    under ``--max_seq_length`` > 512) raises ValueError naming it, before
    anything is loaded."""
    sd = _strip_prefix(load_torch_state_dict(checkpoint_path))
    if family == "bert":
        prefix = "bert." if hasattr(model, "bert") else ""
        mapped = convert_bert_params(
            sd, _count_layers(sd, "encoder.layer.{}."), prefix)
    elif family == "xlnet":
        prefix = "transformer." if hasattr(model, "transformer") else ""
        mapped = convert_xlnet_params(sd, _count_layers(sd, "layer.{}."),
                                      prefix)
    else:
        raise ValueError(f"unknown model family {family!r}")
    shapes = _full_shapes(model)
    mapped = {k: v for k, v in mapped.items()
              if k in shapes or not _optional(k)}
    for name, t in mapped.items():
        if name not in shapes:
            raise ValueError(f"{checkpoint_path}: the model has no "
                             f"parameter {name}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{checkpoint_path}: {name} has shape {tuple(t.shape)} in "
                f"the checkpoint, the model's is {shapes[name]}")
    model.load_state_dict(tp_lib.local_state_dict(model, mapped),
                          strict=False)
    return model


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy with a storage of its own (slices of the packed qkv
    would otherwise save their whole parent)."""
    return t.detach().to("cpu").clone(memory_format=torch.contiguous_format)


def export_bert_state_dict(state_dict: Mapping[str, torch.Tensor],
                           num_layers: int, prefix: str = "bert."
                           ) -> Dict[str, torch.Tensor]:
    """The reverse of ``convert_bert_params``: the port's full-size
    MAG-BERT state dict → HF ``BertModel`` names, each a CPU tensor of its
    own. MAG and the classifier are the port's and are not exported."""
    sd = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = state_dict[
            f"{prefix}embeddings.{name}.weight"]
    for leaf in ("weight", "bias"):
        sd[f"embeddings.LayerNorm.{leaf}"] = state_dict[
            f"{prefix}embeddings.LayerNorm.{leaf}"]
    for i in range(num_layers):
        src, dst = f"{prefix}encoder.layer.{i}.", f"encoder.layer.{i}."
        for leaf in ("weight", "bias"):
            qkv = state_dict[f"{src}attention.qkv.{leaf}"]
            for name, part in zip(("query", "key", "value"),
                                  qkv.chunk(3)):
                sd[f"{dst}attention.self.{name}.{leaf}"] = part
        for hf, port in _BERT_LAYER:
            for leaf in ("weight", "bias"):
                sd[f"{dst}{hf}.{leaf}"] = state_dict[f"{src}{port}.{leaf}"]
    for leaf in ("weight", "bias"):
        name = f"{prefix}pooler.dense.{leaf}"
        if name in state_dict:
            sd[f"pooler.dense.{leaf}"] = state_dict[name]
    return {k: _host(v) for k, v in sd.items()}


def export_xlnet_state_dict(state_dict: Mapping[str, torch.Tensor],
                            num_layers: int, prefix: str = "transformer."
                            ) -> Dict[str, torch.Tensor]:
    """The reverse of ``convert_xlnet_params``: the port's full-size
    MAG-XLNet state dict → HF ``XLNetModel`` names, q/k/v/o/r back to
    [d_model, n_head, d_head] (n_head read off ``r_w_bias``). MAG and the
    head are not exported."""
    sd = {"word_embedding.weight": state_dict[
        f"{prefix}word_embedding.weight"]}
    if f"{prefix}mask_emb" in state_dict:
        sd["mask_emb"] = state_dict[f"{prefix}mask_emb"].reshape(1, 1, -1)
    for i in range(num_layers):
        src, dst = f"{prefix}layer.{i}.", f"layer.{i}."
        nh, dh = state_dict[f"{src}rel_attn.r_w_bias"].shape
        for name in ("q", "k", "v", "o", "r"):
            w = state_dict[f"{src}rel_attn.{name}"]
            sd[f"{dst}rel_attn.{name}"] = w.reshape(w.shape[0], nh, dh)
        for name in _XLNET_ATTN:
            sd[f"{dst}rel_attn.{name}"] = state_dict[f"{src}rel_attn.{name}"]
        for name in _XLNET_FF:
            sd[f"{dst}ff.{name}"] = state_dict[f"{src}ff.{name}"]
    return {k: _host(v) for k, v in sd.items()}


def save_hf_state_dict(sd: Dict[str, torch.Tensor], path: str) -> None:
    """Write an exported state dict: ``model.safetensors``-format when
    ``path`` ends in ``.safetensors``, else a torch ``.bin``
    (``torch.save``), the two files ``load_torch_state_dict`` reads."""
    if path.endswith(".safetensors"):
        save_safetensors(path, {k: v.numpy() for k, v in sd.items()},
                         metadata={"format": "pt"})
    else:
        torch.save(sd, path)
