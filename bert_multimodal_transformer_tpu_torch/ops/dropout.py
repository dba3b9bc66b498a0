"""Dropout for the training forward: Flax ``nn.Dropout`` semantics, and
the explicit streams a training forward draws from.

The JAX package threads one ``dropout`` PRNG key through the model
(``rngs={"dropout": key}``); each dropout site and each fused-attention
entry draws its own key from it with Flax's ``make_rng``. The port has two
streams, chosen by ``--rng_impl``:

* ``DropoutRngs`` (rbg, the default): ``host``, a CPU ``torch.Generator``
  from which the attention kernel's seed is drawn on the host, once per
  layer (``ops/fused_attention.py``), and ``device``, a generator on the
  activations' device from which the hidden, MAG and einsum-attention keep
  masks are drawn on the device, with no host sync per site;
* ``ThreefryRngs`` (threefry2x32): JAX's own key with the Flax scope path
  (``utils/flax_rng.py``), so that every site draws the key its JAX
  counterpart draws (a ``SiteKey``): a mask site draws
  ``bernoulli(site_key, 1 − rate, full_shape)``, JAX's mask bit for bit,
  through kernel T (``csrc/threefry_dropout.cu``) on the card; a fused
  attention entry gets ``randint(site_key, (1, 1), 0, 2**31 − 1)`` as its
  kernel seed, the seed the JAX entries hand their Pallas kernel.

The model modules speak to both alike: ``rngs.child(name)`` enters a
submodule's scope, ``rngs.mask(name)`` is a mask site's stream and
``rngs.seed()`` a kernel seed site's. Neither stream touches the global
torch RNG.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from bert_multimodal_transformer_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    check_sm90,
    launch,
)
from bert_multimodal_transformer_tpu_torch.utils import jax_random
from bert_multimodal_transformer_tpu_torch.utils.flax_rng import KeyScope

# The JAX fused entries' seed range: randint(key, (1, 1), 0, 2**31 - 1).
SEED_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SiteKey:
    """One threefry draw site's key: JAX's ``make_rng("dropout")`` there.
    ``rows`` (full batch rows, first row): dim 0 of the site's tensor is a
    data rank's rows of the global batch, whose mask is the global mask's
    rows. ``seed_fold``: XORed into a fused kernel's seed (the data rank's
    fold, so that data shards draw different in-kernel masks). ``local``:
    the mask is drawn for the tensor's own shape, a ``shard`` ignored, as
    JAX draws every site under ``shard_map`` (the pipeline's)."""

    key: jax_random.Key
    rows: Optional[Tuple[int, int]] = None
    seed_fold: int = 0
    local: bool = False


def draw_seed(rng: Union[torch.Generator, SiteKey]) -> int:
    """A fused kernel's seed. From a CPU generator: 63 bits drawn on the
    host (a device generator would need a host sync to read). From a
    threefry ``SiteKey``: the JAX entries' ``randint(key, (1, 1), 0,
    2**31 − 1)``, replayed on the host."""
    if isinstance(rng, SiteKey):
        seed = int(jax_random.randint(rng.key, (1, 1), 0, SEED_MAX)[0, 0])
        return seed ^ rng.seed_fold
    if not isinstance(rng, torch.Generator):
        raise TypeError(
            f"dropout_rng must be a torch.Generator, got {type(rng)}")
    if rng.device.type != "cpu":
        raise ValueError(
            "dropout_rng must be a CPU generator: the kernel seed is drawn "
            f"on the host, got a generator on {rng.device}")
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=rng))


@dataclasses.dataclass
class DropoutRngs:
    host: torch.Generator
    device: torch.Generator

    @staticmethod
    def make(dropout_rng, device):
        """From an int seed or a CPU generator (the host stream); the
        device stream is seeded with one draw of the host stream. A
        ``DropoutRngs`` or ``ThreefryRngs`` is taken as it is."""
        if isinstance(dropout_rng, (DropoutRngs, ThreefryRngs)):
            return dropout_rng
        if isinstance(dropout_rng, int):
            host = torch.Generator().manual_seed(dropout_rng)
        elif (isinstance(dropout_rng, torch.Generator)
              and dropout_rng.device.type == "cpu"):
            host = dropout_rng
        else:
            raise TypeError(
                "dropout_rng must be an int seed, a CPU torch.Generator, "
                f"DropoutRngs or ThreefryRngs, got {dropout_rng!r}")
        dev = torch.Generator(device=device).manual_seed(draw_seed(host))
        return DropoutRngs(host, dev)

    def child(self, name: str) -> "DropoutRngs":
        return self

    def mask(self, name: Optional[str] = None,
             batch: bool = True) -> torch.Generator:
        return self.device

    def seed(self, name: Optional[str] = None) -> torch.Generator:
        return self.host

    def get_state(self):
        return self.host.get_state(), self.device.get_state()

    def set_state(self, state) -> None:
        self.host.set_state(state[0])
        self.device.set_state(state[1])


@dataclasses.dataclass
class ThreefryRngs:
    """The threefry stream of one forward: the "dropout" ``KeyScope`` at
    the module's Flax path, (over data ranks) this rank's rows of the
    global batch and the fused seed's fold, and whether its masks are
    drawn for the local shape (``SiteKey.local``)."""

    scope: KeyScope
    rows: Optional[Tuple[int, int]] = None
    seed_fold: int = 0
    local: bool = False

    @staticmethod
    def from_key(key, rows: Optional[Tuple[int, int]] = None,
                 seed_fold: int = 0, local: bool = False) -> "ThreefryRngs":
        """The root stream of ``model.apply(..., rngs={"dropout": key})``."""
        return ThreefryRngs(KeyScope(key), rows, seed_fold, local)

    def child(self, name: str) -> "ThreefryRngs":
        return ThreefryRngs(self.scope.child(name), self.rows,
                            self.seed_fold, self.local)

    def mask(self, name: Optional[str] = None, batch: bool = True
             ) -> SiteKey:
        """A mask site's key: ``make_rng`` in child scope ``name`` (an
        ``nn.Dropout``'s) or in this scope. ``batch``: dim 0 of the site's
        tensor is the batch."""
        return SiteKey(self.scope.next(name), self.rows if batch else None,
                       local=self.local)

    def seed(self, name: Optional[str] = None) -> SiteKey:
        return SiteKey(self.scope.next(name), seed_fold=self.seed_fold)

    def get_state(self) -> Dict[Tuple[str, ...], int]:
        return self.scope.get_state()

    def set_state(self, state) -> None:
        self.scope.set_state(state)


class ThreefryStream:
    """The train state's threefry key, the JAX ``TrainState.rng``: each
    step splits it into the step's dropout key and the next state key
    (``rng, new_rng = split(state.rng)``). ``get_state``/``set_state``
    read and write the key as an int64 tensor of its two words, as a
    checkpoint holds it in place of a generator's state."""

    def __init__(self, key):
        self.key = jax_random.as_key(key)

    def step_key(self) -> jax_random.Key:
        rng, self.key = jax_random.split(self.key)
        return rng

    def get_state(self) -> torch.Tensor:
        return torch.tensor(self.key, dtype=torch.int64)

    def set_state(self, state: torch.Tensor) -> None:
        self.key = jax_random.as_key(state.tolist())


def rng_impl_of(stream) -> str:
    """"threefry2x32" for a ``ThreefryStream``, "rbg" for a generator."""
    return "threefry2x32" if isinstance(stream, ThreefryStream) else "rbg"


def _keep_and_divisor(rate: float, dtype: torch.dtype) -> Tuple[float, float]:
    """1 − rate, and its rounding to ``dtype``: Flax divides by 1 − rate as
    a weak-typed scalar, which JAX first rounds to x's dtype (a bf16
    activation is divided by bf16(0.9) = 0.8984375, not by 0.9)."""
    keep_prob = 1.0 - rate
    return keep_prob, float(torch.tensor(keep_prob, dtype=dtype))


def dropout(x: torch.Tensor, rate: float,
            generator: Union[torch.Generator, SiteKey, None],
            deterministic: bool = False,
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: each element kept with probability 1 − rate,
    and scaled as ``x / (1 − rate)`` in x's dtype (the divisor rounded to
    it as Flax's is), zeros elsewhere. Identity when ``deterministic`` or
    at rate 0; zeros at rate 1. The keep mask comes from ``generator``: a
    torch generator on x's device, or a threefry ``SiteKey``
    (``threefry_dropout``). It is required, so the global RNG is never
    used.

    ``shard`` (dim, full size, start): x holds elements start .. of the
    full size's along ``dim``, as a tensor-parallel rank holds its heads'
    probs or its columns of a column-parallel activation; the keep mask is
    the full size's, sliced, so the rank drops what one device drops (a
    torch generator also advances as one device's does)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    if isinstance(generator, SiteKey):
        return threefry_dropout(x, rate, generator, shard)
    keep_prob, divisor = _keep_and_divisor(rate, x.dtype)
    shape = list(x.shape)
    if shard is not None:
        shape[shard[0]] = shard[1]
    keep = torch.rand(shape, generator=generator,
                      device=x.device) < keep_prob
    if shard is not None:
        keep = keep.narrow(shard[0], shard[2], x.shape[shard[0]])
    return torch.where(keep, x / divisor, 0.0)


# ---- threefry dropout (kernel T) --------------------------------------------

# (n, n1, n2, n3, base, (f0, f1, f2, f3)): x as [n / (n1·n2·n3), n1, n2, n3]
# and the flat index of its element (i0..i3) in the full shape, base +
# Σ i_d·f_d (csrc/threefry_dropout.cu's Layout).
Layout = Tuple[int, int, int, int, int, Tuple[int, int, int, int]]


def threefry_layout(shape: Sequence[int],
                    slices: Dict[int, Tuple[int, int]]) -> Layout:
    """The kernel's layout of a contiguous tensor of ``shape`` that holds,
    along each dim d of ``slices``, elements start .. of a full size
    (``slices[d] = (full, start)``): its full-shape strides, the flat index
    of its first element, and its dims merged where the full index stays
    affine (at most four remain)."""
    shape = [int(s) for s in shape]
    full = list(shape)
    starts = [0] * len(shape)
    for d, (size, start) in slices.items():
        d %= len(shape)
        if not 0 <= start <= size - shape[d]:
            raise ValueError(
                f"slice {start}..{start + shape[d]} of dim {d} lies outside "
                f"its full size {size}")
        full[d], starts[d] = int(size), int(start)
    strides = [math.prod(full[d + 1:]) for d in range(len(full))]
    base = sum(s * f for s, f in zip(starts, strides))
    dims = []  # (local size, full stride), merged from the last dim
    for size, stride in reversed(list(zip(shape, strides))):
        if size == 1:
            continue
        if dims and stride == dims[-1][0] * dims[-1][1]:
            dims[-1] = (dims[-1][0] * size, dims[-1][1])
        else:
            dims.append((size, stride))
    if len(dims) > 4:
        raise ValueError(f"threefry dropout takes at most four unmergeable "
                         f"dims, got shape {shape} with slices {slices}")
    dims += [(1, 0)] * (4 - len(dims))
    (n3, f3), (n2, f2), (n1, f1), (n0, f0) = dims
    return (n0 * n1 * n2 * n3, n1, n2, n3, base, (f0, f1, f2, f3))


def _flat_index(layout: Layout, device) -> torch.Tensor:
    n, n1, n2, n3, base, (f0, f1, f2, f3) = layout
    i = torch.arange(n, dtype=torch.int64, device=device)
    i3, r = i % n3, i // n3
    i2, r = r % n2, r // n2
    i1, i0 = r % n1, r // n1
    return base + i0 * f0 + i1 * f1 + i2 * f2 + i3 * f3


def threefry_dropout_plain(x: torch.Tensor, key: jax_random.Key,
                           keep_prob: float, divisor: float,
                           layout: Layout) -> torch.Tensor:
    """Kernel T's function in plain PyTorch: ``x / divisor`` where the
    element's uniform, JAX's ``bernoulli(key, keep_prob, full_shape)`` at
    its full-shape index, is below ``keep_prob``, else 0. The divisor is a
    tensor on x's device: a CUDA tensor divided by a Python scalar is
    multiplied by its reciprocal, one rounding off a true division (JAX's
    and the kernel's)."""
    flat = _flat_index(layout, x.device)
    b0, b1 = jax_random.threefry2x32(key, flat >> 32,
                                     flat & jax_random.MASK32)
    keep = jax_random.bits_to_unit_float(b0 ^ b1) < torch.tensor(
        keep_prob, dtype=torch.float32, device=x.device)
    div = torch.tensor(divisor, dtype=x.dtype, device=x.device)
    return torch.where(keep.reshape(x.shape), x / div, 0.0)


def threefry_dropout_cuda(x: torch.Tensor, key: jax_random.Key,
                          keep_prob: float, divisor: float,
                          layout: Layout) -> torch.Tensor:
    """Launch kernel T (``csrc/threefry_dropout.cu``) on a contiguous CUDA
    tensor of fp32 or bf16. Raises on anything the kernel does not take
    and on a failed launch; never falls back."""
    if x.dtype not in DTYPE_CODES or not x.is_contiguous():
        raise ValueError(
            "threefry_dropout: x must be a contiguous float32 or bfloat16 "
            f"tensor, got {x.dtype} (contiguous: {x.is_contiguous()})")
    check_sm90(x)
    n, n1, n2, n3, base, f = layout
    if n != x.numel():
        raise ValueError(f"threefry_dropout: layout of {n} elements for a "
                         f"tensor of {x.numel()}")
    out = torch.empty_like(x)
    launch("threefry_dropout", x.data_ptr(), out.data_ptr(), n, n1, n2, n3,
           base, *f, key[0], key[1], float(keep_prob), float(divisor),
           DTYPE_CODES[x.dtype], device=x.device)
    threefry_dropout_cuda.launches += 1
    return out


threefry_dropout_cuda.launches = 0


def _threefry_apply(x, key, keep_prob, divisor, layout):
    if x.is_cuda:
        return threefry_dropout_cuda(x.contiguous(), key, keep_prob, divisor,
                                     layout)
    return threefry_dropout_plain(x, key, keep_prob, divisor, layout)


class ThreefryDropout(torch.autograd.Function):
    """Kernel T with its gradient: the backward applies the same keep mask
    and divisor to the cotangent, regenerated from the key (nothing is
    saved)."""

    @staticmethod
    def forward(ctx, x, key, keep_prob, divisor, layout):
        ctx.args = (key, keep_prob, divisor, layout)
        return _threefry_apply(x, key, keep_prob, divisor, layout)

    @staticmethod
    def backward(ctx, g):
        return (_threefry_apply(g, *ctx.args), None, None, None, None)


def threefry_dropout(x: torch.Tensor, rate: float, site: SiteKey,
                     shard: Optional[Tuple[int, int, int]] = None
                     ) -> torch.Tensor:
    """Flax ``nn.Dropout`` at a threefry site: JAX's keep mask
    ``bernoulli(site.key, 1 − rate, full_shape)`` at x's elements, where
    the full shape widens dim 0 to the global batch (``site.rows``) and
    ``shard``'s dim to its full size (not for a ``site.local``). On a CUDA
    tensor kernel T, on a CPU tensor its plain version."""
    slices = {}
    if site.rows is not None:
        slices[0] = site.rows
    if shard is not None and not site.local:
        slices[shard[0] % x.dim()] = (shard[1], shard[2])
    keep_prob, divisor = _keep_and_divisor(rate, x.dtype)
    layout = threefry_layout(x.shape, slices)
    return ThreefryDropout.apply(x, site.key, keep_prob, divisor, layout)
