"""Multimodal Adaptation Gate, functional core (port of ``ops/mag.py``):

    g_v = ReLU([visual; text] W_hv + b_hv)
    g_a = ReLU([acoustic; text] W_ha + b_ha)
    H_m = g_v ⊙ (visual W_v + b_v) + g_a ⊙ (acoustic W_a + b_a)
    α   = min(‖text‖₂ / (‖H_m‖₂ + 1e-6) · β, 1)   with ‖H_m‖₂ = 0 → 1
    out = LayerNorm(α · H_m + text)

The concat-matmuls are split into partial matmuls, with the JAX package's
param names and ``x @ W`` ([in, out]) layout. All math runs in fp32
whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

EPS = 1e-6


def mag_norms(text_f32: torch.Tensor, h_m: torch.Tensor,
              beta_shift: float) -> torch.Tensor:
    """The α scale of the gate. ``text_f32``/``h_m``: [..., D] fp32.
    Returns α of shape [..., 1]."""
    em_norm = torch.linalg.vector_norm(text_f32, dim=-1)
    hm_norm = torch.linalg.vector_norm(h_m, dim=-1)
    # ‖H_m‖ == 0 → use 1.0
    hm_norm = torch.where(hm_norm == 0.0, torch.ones_like(hm_norm), hm_norm)
    thresh = (em_norm / (hm_norm + EPS)) * beta_shift
    alpha = torch.clamp(thresh, max=1.0)
    return alpha[..., None]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with torch-default eps 1e-5 (the gate's nn.LayerNorm,
    unlike BERT's 1e-12)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def mag_gate(
    params: Mapping[str, torch.Tensor],
    text: torch.Tensor,
    visual: torch.Tensor,
    acoustic: torch.Tensor,
    *,
    beta_shift: float = 1.0,
) -> torch.Tensor:
    """Plain MAG gate (pre-dropout). Shapes: text [..., D], visual
    [..., Dv], acoustic [..., Da]; returns [..., D] in ``text.dtype``.

    ``params`` keys (``x @ W`` layout): w_hv_v [Dv, D], w_hv_t [D, D],
    b_hv [D], w_ha_a [Da, D], w_ha_t [D, D], b_ha [D], w_v [Dv, D], b_v
    [D], w_a [Da, D], b_a [D], ln_gamma [D], ln_beta [D].
    """
    f32 = torch.float32
    t = text.to(f32)
    v = visual.to(f32)
    a = acoustic.to(f32)

    def p(name):
        return params[name].to(f32)

    gate_v = torch.relu(v @ p("w_hv_v") + t @ p("w_hv_t") + p("b_hv"))
    gate_a = torch.relu(a @ p("w_ha_a") + t @ p("w_ha_t") + p("b_ha"))
    h_m = (gate_v * (v @ p("w_v") + p("b_v"))
           + gate_a * (a @ p("w_a") + p("b_a")))
    alpha = mag_norms(t, h_m, beta_shift)
    out = layer_norm(alpha * h_m + t, p("ln_gamma"), p("ln_beta"))
    return out.to(text.dtype)


def init_mag_params(generator: torch.Generator, text_dim: int,
                    visual_dim: int, acoustic_dim: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Kaiming-uniform linear init matching torch nn.Linear defaults; the
    gate is never loaded from a pretrained checkpoint. ``generator`` must
    live on ``device``."""

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.uniform_(-bound, bound, generator=generator)

    # W_hv acts on [visual; text]: its rows split into the visual part then
    # the text part.
    w_hv = uniform((visual_dim + text_dim, text_dim), visual_dim + text_dim)
    b_hv = uniform((text_dim,), visual_dim + text_dim)
    w_ha = uniform((acoustic_dim + text_dim, text_dim),
                   acoustic_dim + text_dim)
    b_ha = uniform((text_dim,), acoustic_dim + text_dim)
    w_v = uniform((visual_dim, text_dim), visual_dim)
    b_v = uniform((text_dim,), visual_dim)
    w_a = uniform((acoustic_dim, text_dim), acoustic_dim)
    b_a = uniform((text_dim,), acoustic_dim)
    return {
        "w_hv_v": w_hv[:visual_dim], "w_hv_t": w_hv[visual_dim:],
        "b_hv": b_hv,
        "w_ha_a": w_ha[:acoustic_dim], "w_ha_t": w_ha[acoustic_dim:],
        "b_ha": b_ha,
        "w_v": w_v, "b_v": b_v,
        "w_a": w_a, "b_a": b_a,
        "ln_gamma": torch.ones((text_dim,), dtype=dtype, device=device),
        "ln_beta": torch.zeros((text_dim,), dtype=dtype, device=device),
    }
