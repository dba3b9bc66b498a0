"""Param conversion into the port.

``params_from_flax`` takes the JAX package's MAG-BERT param tree (nested
dicts of arrays, as ``model.init(...)["params"]`` or a restored checkpoint
gives it, with every leaf converted by ``np.asarray``) and returns the
port's ``state_dict``:

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
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)")


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: List[str]) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER.fullmatch(key)
                walk(val, path + [f"layer.{m.group(1)}" if m else key])
                continue
            arr = np.asarray(val)
            if "MAG" in path:
                names = [key]
            elif key == "kernel":
                names, arr = ["weight"], arr.T
            elif key == "scale":
                names = ["weight"]
            elif key == "bias":
                names = ["bias"]
            else:  # an embedding table
                names = [key, "weight"]
            out[".".join(path + names)] = torch.tensor(
                np.ascontiguousarray(arr))

    walk(tree, [])
    return out
