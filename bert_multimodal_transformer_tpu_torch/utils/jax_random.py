"""JAX's ``threefry2x32`` random API on Python integers and torch tensors.

The JAX package draws its init params and, on the einsum path, every
dropout mask from ``jax.random`` with the threefry2x32 implementation
(``--rng_impl threefry2x32``). This module replays that stream, following
``jax/_src/prng.py`` and ``jax/_src/random.py`` (jax 0.9.0) with
``jax_threefry_partitionable`` on, the default there:

* a key is two uint32 words ``(k0, k1)``, held on the host as Python
  integers: deriving one (``PRNGKey``, ``split``, ``fold_in``) costs a few
  Threefry blocks and never waits for a device;
* the bits of a draw of shape ``shape`` are, for the element at flat index
  ``n`` of that shape, ``x0 ^ x1`` of ``threefry2x32(key, (n >> 32, n &
  0xFFFFFFFF))``: each element's bits depend on its index in the full
  shape alone, so a slice of a draw is the draw of that slice's indices;
* ``uniform``, ``bernoulli``, ``randint`` and ``normal`` turn the bits into
  values as ``jax.random`` does.

The bulk functions run on int64 tensors masked to 32 bits, on any device
(``device=``); they are the plain version of the dropout kernel
(``csrc/threefry_dropout.cu``). ``normal`` reproduces XLA's float32
``erf_inv`` polynomial (Giles' approximation, as ``chlo.erf_inv`` lowers)
in float32 torch arithmetic; its ``log1p`` is torch's, so a value may
differ from JAX's in its last bits (the tests hold it within 2e-6
relative).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
MASK32 = 0xFFFFFFFF
# The key schedule's parity constant and the two rotation sets of
# Threefry-2x32 (20 rounds: five groups of four, a key injection after
# each group).
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
INT32_MAX = 2 ** 31 - 1

Word = Union[int, torch.Tensor]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds on the counter words ``(x0, x1)``:
    Python integers, or int64 tensors holding values in [0, 2³²)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def as_key(key) -> Key:
    """A key from any pair of integers (a tuple, a list, a numpy array of
    two uint32 words)."""
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 <= MASK32 and 0 <= k1 <= MASK32):
        raise ValueError(f"a threefry key is two uint32 words, got {key!r}")
    return (k0, k1)


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2³¹): the seed's high
    and low 32 bits, so (0, seed)."""
    seed = int(seed)
    if not 0 <= seed <= INT32_MAX:
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: Threefry of the counter
    (0, uint32(data))."""
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` in partitionable mode: key i is the
    Threefry of the counter (0, i), the same as ``fold_in(key, i)``."""
    return tuple(threefry2x32(key, i >> 32, i & MASK32) for i in range(num))


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def random_bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of values
    in [0, 2³²) on ``device``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(math.prod(shape), device)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in float32 with one rounding, as XLA's CPU code contracts
    it: the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 from 32-bit words, as ``jax.random.uniform``:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    u = bits_to_unit_float(random_bits(key, shape, device))
    return torch.maximum(lo, _fma(u, hi - lo, lo))


def bernoulli(key: Key, p: float, shape: Sequence[int],
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform float32 < p."""
    keep = torch.tensor(p, dtype=torch.float32, device=device)
    return bits_to_unit_float(random_bits(key, shape, device)) < keep


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    draws of 32 bits from ``split(key)``, combined modulo the span with
    uint32 wraparound, as JAX does."""
    oor = maxval > INT32_MAX
    minval = min(max(int(minval), -2 ** 31), INT32_MAX)
    maxval = min(max(int(maxval), -2 ** 31), INT32_MAX)
    span = (maxval - minval) & MASK32
    if maxval <= minval:
        span = 1
    elif oor:
        span = (span + 1) & MASK32
    if span == 0:
        raise ValueError("randint span of 2^32 is not supported")
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    off = (((higher % span) * mult) & MASK32) + lower % span
    off = (off & MASK32) % span
    out = (off + minval) & MASK32
    return torch.where(out > INT32_MAX, out - 2 ** 32, out).to(torch.int32)


# XLA's float32 erf_inv (Giles), the chlo lowering's constants.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], **f32),
                    torch.tensor(_ERFINV_GE5[0], **f32))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, torch.tensor(a, **f32),
                                   torch.tensor(b, **f32)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erf_inv of a uniform
    draw on (nextafter(−1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, lo, 1.0, device)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=device)
    return sqrt2 * erf_inv_f32(u)
