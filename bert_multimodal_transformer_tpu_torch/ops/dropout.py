"""Dropout for the training forward: Flax ``nn.Dropout`` semantics, and
the explicit generators a training forward draws from.

The JAX package threads one ``dropout`` PRNG key through the model
(``rngs={"dropout": key}``). The port threads ``DropoutRngs``:

* ``host``, a CPU ``torch.Generator``: the attention kernel's seed is drawn
  from it on the host, once per layer (``ops/fused_attention.py``);
* ``device``, a generator on the activations' device: the hidden, MAG and
  einsum-attention keep masks are drawn from it on the device, with no
  host sync per site.

Neither touches the global torch RNG.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit kernel seed drawn on the host from an explicit CPU
    generator (a device generator would need a host sync to read)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(
            f"dropout_rng must be a torch.Generator, got {type(generator)}")
    if generator.device.type != "cpu":
        raise ValueError(
            "dropout_rng must be a CPU generator: the kernel seed is drawn "
            f"on the host, got a generator on {generator.device}")
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator))


@dataclasses.dataclass
class DropoutRngs:
    host: torch.Generator
    device: torch.Generator

    @staticmethod
    def make(dropout_rng: Union["DropoutRngs", torch.Generator, int],
             device) -> "DropoutRngs":
        """From an int seed or a CPU generator (the host stream); the
        device stream is seeded with one draw of the host stream."""
        if isinstance(dropout_rng, DropoutRngs):
            return dropout_rng
        if isinstance(dropout_rng, int):
            host = torch.Generator().manual_seed(dropout_rng)
        elif (isinstance(dropout_rng, torch.Generator)
              and dropout_rng.device.type == "cpu"):
            host = dropout_rng
        else:
            raise TypeError(
                "dropout_rng must be an int seed, a CPU torch.Generator or "
                f"DropoutRngs, got {dropout_rng!r}")
        dev = torch.Generator(device=device).manual_seed(draw_seed(host))
        return DropoutRngs(host, dev)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool = False,
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: each element kept with probability 1 − rate,
    its keep mask drawn from ``generator`` (on x's device; required, so
    the global RNG is never used), and scaled as ``x / (1 − rate)`` in
    x's dtype, zeros elsewhere. Identity when ``deterministic`` or at rate
    0; zeros at rate 1.

    Flax divides by 1 − rate as a weak-typed scalar, which JAX first
    rounds to x's dtype: a bf16 activation is divided by bf16(0.9) =
    0.8984375, not by 0.9. The divisor is rounded the same way here.

    ``shard`` (dim, full size, start): x holds elements start .. of the
    full size's along ``dim``, as a tensor-parallel rank holds its heads'
    probs or its columns of a column-parallel activation; the keep mask is
    drawn at the full size and sliced, so the rank drops what one device
    drops and its generator advances as one device's does."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    divisor = float(torch.tensor(keep_prob, dtype=x.dtype))
    shape = list(x.shape)
    if shard is not None:
        shape[shard[0]] = shard[1]
    keep = torch.rand(shape, generator=generator,
                      device=x.device) < keep_prob
    if shard is not None:
        keep = keep.narrow(shard[0], shard[2], x.shape[shard[0]])
    return torch.where(keep, x / divisor, 0.0)
