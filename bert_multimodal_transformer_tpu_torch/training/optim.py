"""Optimizer and LR schedule (port of ``training/optim.py``).

AdamW with the exact update rule of ``transformers.AdamW`` 3.0.2 (what the
reference trains with), weight decay 0.01 on every parameter except biases
and LayerNorm params, and the linear warmup→decay-to-zero schedule (HF
``get_linear_schedule_with_warmup``). The JAX package builds it as an optax
chain; here it is one ``torch.optim.Optimizer`` that computes the same
scalars on the host in fp32 and updates every tensor with ``torch._foreach``
ops (one multi-tensor launch per op on the card).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]

_f32 = np.float32


def linear_warmup_decay_schedule(learning_rate: float, warmup_steps: int,
                                 total_steps: int) -> Schedule:
    """LR = lr · step/warmup for step < warmup, then linear decay to 0 at
    total_steps, computed in fp32 as the JAX schedule."""
    warmup_steps = max(int(warmup_steps), 0)
    total_steps = max(int(total_steps), 1)

    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_steps:
            frac = step / _f32(max(1.0, float(warmup_steps)))
        else:
            frac = (_f32(total_steps) - step) / _f32(
                max(1.0, float(total_steps - warmup_steps)))
        return float(_f32(learning_rate) * np.clip(frac, _f32(0.0),
                                                   _f32(1.0)))

    return schedule


def no_decay(name: str) -> bool:
    """True for params excluded from weight decay, on the port's names.
    The reference excludes names containing 'bias', 'LayerNorm.bias' and
    'LayerNorm.weight'; the JAX ``_no_decay`` adds the MAG gate's b_* and
    ln_* leaves. The two rules give the same partition of the model."""
    parts = name.split(".")
    leaf = parts[-1]
    if "bias" in leaf or leaf.startswith(("b_", "ln_")):
        return True
    return any("LayerNorm" in p or "layer_norm" in p for p in parts)


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]
               ) -> Dict[str, bool]:
    """{name: True where weight decay applies}."""
    return {name: not no_decay(name) for name, _ in named_params}


class AdamWHF(torch.optim.Optimizer):
    """``transformers.AdamW`` 3.0.2, in the JAX ``adamw_hf`` association:

        m ← b1·m + (1−b1)·g;   v ← b2·v + (1−b2)·g²
        u = s0 · (m / (√v + eps)),  s0 = √(1−b2ᵗ)/(1−b1ᵗ)   (one scalar)
        u ← u·(1 − lr·wd) + wd·p      (decay on the post-update param)
        p ← p − lr·u

    with t the count of this update and lr = schedule(t − 1): update k
    uses the schedule at the number of updates completed before it, as
    optax counts. ``max_grad_norm > 0`` first scales the gradients by
    max_norm/‖g‖ when ‖g‖ ≥ max_norm (``optax.clip_by_global_norm``: no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), without a host
    sync. The two param groups carry weight_decay and 0.
    """

    def __init__(self, param_groups, schedule: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 max_grad_norm: float = 0.0):
        super().__init__(param_groups, dict(weight_decay=0.0))
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.count = 0

    def _state(self, p):
        st = self.state[p]
        if not st:
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def _clip(self, grads):
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm),
                            self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWHF takes no closure")
        groups = [[p for p in g["params"] if p.grad is not None]
                  for g in self.param_groups]
        if self.max_grad_norm > 0:
            self._clip([p.grad for ps in groups for p in ps])
        lr = self.schedule(self.count)
        self.count += 1
        t = _f32(self.count)
        b1, b2 = _f32(self.b1), _f32(self.b2)
        s0 = float(np.sqrt(_f32(1.0) - b2 ** t) / (_f32(1.0) - b1 ** t))
        for group, params in zip(self.param_groups, groups):
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self._state(p) for p in params]
            m = [s["exp_avg"] for s in states]
            v = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(m, denom)
            torch._foreach_mul_(u, s0)
            wd = group["weight_decay"]
            if wd > 0.0:
                keep = float(_f32(1.0) - _f32(lr) * _f32(wd))
                torch._foreach_mul_(u, keep)
                torch._foreach_add_(u, params, alpha=wd)
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(params, u)

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)


def adamw_hf(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
             schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-6, weight_decay: float = 0.01,
             max_grad_norm: float = 0.0) -> AdamWHF:
    """AdamWHF over ``named_params`` (``model.named_parameters()``), with
    weight decay where ``decay_mask`` says so."""
    named_params = list(named_params)
    on = decay_mask(named_params)
    groups = [
        {"params": [p for n, p in named_params if on[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named_params if not on[n]],
         "weight_decay": 0.0},
    ]
    return AdamWHF([g for g in groups if g["params"]], schedule, b1=b1,
                   b2=b2, eps=eps, max_grad_norm=max_grad_norm)


def make_optimizer(
    learning_rate: float,
    num_train_steps: int,
    warmup_proportion: float = 0.1,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    max_grad_norm: float = 0.0,
) -> Callable[[Iterable[Tuple[str, torch.nn.Parameter]]], AdamWHF]:
    """The reference's optimizer: ``adamw_hf`` with HF defaults (betas
    0.9/0.999, eps 1e-6), the warmup schedule, optional clipping (off at
    0). Returns a factory to call on ``model.named_parameters()``; the
    ``Trainer`` does that when it creates its state."""
    schedule = linear_warmup_decay_schedule(
        learning_rate, int(warmup_proportion * num_train_steps),
        num_train_steps)
    return functools.partial(adamw_hf, schedule=schedule, b1=b1, b2=b2,
                             eps=eps, weight_decay=weight_decay,
                             max_grad_norm=max_grad_norm)
