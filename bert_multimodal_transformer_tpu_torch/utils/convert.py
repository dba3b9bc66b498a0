"""Param conversion into the port.

``params_from_flax`` and ``xlnet_params_from_flax`` take the JAX package's
MAG-BERT and MAG-XLNet param trees (nested dicts of arrays, as
``model.init(...)["params"]`` or a restored checkpoint gives them, with
every leaf converted by ``np.asarray``) and return the port's
``state_dict``. For MAG-BERT:

* dense ``kernel`` [in, out] → ``nn.Linear.weight`` [out, in];
* LayerNorm ``scale``/``bias`` → ``weight``/``bias``;
* embedding tables → ``<table>.weight``;
* ``layer_{i}`` → ``layer.{i}``;
* MAG params pass through unchanged (the port keeps their layout).

Loading an HF ``pytorch_model.bin`` or safetensors file waits for a
checkpoint in the repository (ROADMAP A.6).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

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
            names, arr = leaf(path, key, np.asarray(val))
            out[".".join(path + names)] = torch.tensor(
                np.ascontiguousarray(arr))

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


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX MAG-BERT tree → the port's ``MagBert*`` state_dict."""

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
    and the port keeps its own."""

    def leaf(path, key, arr):
        if "MAG" in path:
            return [key], arr
        if key == "embedding":
            return ["weight"], arr
        return _dense_or_norm(key, arr) or ([key], arr)

    return _walk(tree, leaf, stack="transformer")
