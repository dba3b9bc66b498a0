"""MAG as an ``nn.Module`` (port of ``models/mag.py``).

The params keep the JAX package's names and ``x @ W`` ([in, out]) layout,
so ``ops.mag.mag_gate`` and ``ops.mag_fused.mag_gate_fused`` take the
module's params as they are and ``utils/convert.params_from_flax`` passes
them through unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.config import resolve_device
from bert_multimodal_transformer_tpu_torch.ops import mag as mag_ops
from bert_multimodal_transformer_tpu_torch.ops.dropout import dropout
from bert_multimodal_transformer_tpu_torch.ops.mag_fused import (
    mag_gate_fused,
)


class MAG(nn.Module):
    """Multimodal Adaptation Gate: ``forward(text, visual, acoustic)``,
    then output dropout at ``dropout_prob`` (the JAX module's last step).
    ``use_fused_kernel`` routes the gate through the fused kernels
    (``ops/mag_fused.py``); the dropout stays outside them. ``device=None``
    builds on the card and raises without one; pass ``device="cpu"`` for
    the CPU."""

    PARAM_NAMES = ("w_hv_v", "w_hv_t", "b_hv", "w_ha_a", "w_ha_t", "b_ha",
                   "w_v", "b_v", "w_a", "b_a", "ln_gamma", "ln_beta")

    def __init__(self, hidden_size: int, visual_dim: int, acoustic_dim: int,
                 beta_shift: float = 1.0, dropout_prob: float = 0.5,
                 use_fused_kernel: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.visual_dim = visual_dim
        self.acoustic_dim = acoustic_dim
        self.beta_shift = beta_shift
        self.dropout_prob = dropout_prob
        self.use_fused_kernel = use_fused_kernel
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init = mag_ops.init_mag_params(generator, hidden_size, visual_dim,
                                       acoustic_dim, device=device)
        for name in self.PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(init[name].clone()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the params again from ``generator`` (on their device), as
        the constructor does."""
        init = mag_ops.init_mag_params(generator, self.hidden_size,
                                       self.visual_dim, self.acoustic_dim,
                                       device=self.w_v.device)
        with torch.no_grad():
            for name in self.PARAM_NAMES:
                getattr(self, name).copy_(init[name])

    def flax_param_spec(self) -> Dict[str, tuple]:
        """The JAX MAG's params as ``utils/flax_rng.py::init_params``
        takes them, in its declaration order: torch ``nn.Linear``'s
        Kaiming-uniform, bound 1/√fan_in (JAX ``models/mag.py:20-26``),
        and a unit LayerNorm."""
        d, dv, da = self.hidden_size, self.visual_dim, self.acoustic_dim
        hv, ha, bv, ba = (1.0 / (fan_in ** 0.5)
                          for fan_in in (dv + d, da + d, dv, da))
        return {"w_hv_v": ("uniform", (dv, d), hv),
                "w_hv_t": ("uniform", (d, d), hv),
                "b_hv": ("uniform", (d,), hv),
                "w_ha_a": ("uniform", (da, d), ha),
                "w_ha_t": ("uniform", (d, d), ha),
                "b_ha": ("uniform", (d,), ha),
                "w_v": ("uniform", (dv, d), bv), "b_v": ("uniform", (d,), bv),
                "w_a": ("uniform", (da, d), ba), "b_a": ("uniform", (d,), ba),
                "ln_gamma": ("ones", (d,)), "ln_beta": ("zeros", (d,))}

    def params_dict(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self.PARAM_NAMES}

    def forward(self, text_embedding: torch.Tensor, visual: torch.Tensor,
                acoustic: torch.Tensor, *, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``dropout_rng``: a generator on the activations' device, or a
        threefry ``ops/dropout.py::SiteKey``, needed when not
        ``deterministic``."""
        gate = mag_gate_fused if self.use_fused_kernel else mag_ops.mag_gate
        fused = gate(self.params_dict(), text_embedding, visual, acoustic,
                     beta_shift=self.beta_shift)
        return dropout(fused, self.dropout_prob, dropout_rng, deterministic)
