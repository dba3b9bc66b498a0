"""Activation registry (port of ``ops/activations.py``): the HF ACT2FN
table. BERT-base uses the exact erf GELU."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-based GELU (HF transformers.activations.gelu)."""
    return F.gelu(x, approximate="none")


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (HF transformers.activations.gelu_new)."""
    return F.gelu(x, approximate="tanh")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


ACT2FN = {
    "gelu": gelu,
    "relu": torch.relu,
    "swish": swish,
    "gelu_new": gelu_new,
    "mish": mish,
}
