"""Flax's key derivation (flax 0.12.3, ``flax/core/scope.py``), on the keys
of ``utils/jax_random.py``.

A Flax module draws a key with ``make_rng(collection)``: its scope's
counter for that collection goes up by one, and the key is the root key
(``rngs={"dropout": key}`` at ``apply``, the ``init`` key for "params")
with the scope's path and the counter folded in at once
(``LazyRng.as_jax_rng`` → ``_fold_in_static``): the SHA-1 of the path's
names and the counter's big-endian bytes, its first four bytes as a
big-endian uint32, one ``fold_in``. Flax's ``flax_fix_rng_separator`` is
off by default, so the items are hashed back to back with no separator.

Every ``self.param`` draws once from its scope's "params" counter, in the
order the module declares them; every call of an ``nn.Dropout`` draws once
from the Dropout's own scope (``Dropout_0``, ``Dropout_1``, … by the order
of creation in a compact method, or the attribute name under ``setup``),
and a module called twice (XLNet's shared ``ff`` and the model's one
``dropout``) draws with counter 2 the second time. ``KeyScope`` keeps
those counters, so a port module can name the key its JAX counterpart
draws.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from bert_multimodal_transformer_tpu_torch.utils import jax_random

Foldable = Union[str, int]


def fold_in_static(key: jax_random.Key,
                   data: Tuple[Foldable, ...]) -> jax_random.Key:
    """Flax's ``_fold_in_static`` with ``flax_fix_rng_separator`` off (its
    default): ``data`` (names and ints) hashed back to back with SHA-1,
    folded into ``key`` as one uint32; ``key`` as it is for empty data."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return jax_random.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def scope_key(key: jax_random.Key, path: Tuple[str, ...],
              counter: int) -> jax_random.Key:
    """The key ``make_rng`` gives at scope ``path`` on its ``counter``-th
    draw (from 1) from root key ``key``."""
    return fold_in_static(key, (*path, counter))


class KeyScope:
    """A Flax scope's view of one rng collection: the root key, the path,
    and the draw counters of every scope under the root (shared by the
    views ``child`` makes). ``next(name)`` is ``make_rng`` in child scope
    ``name`` (in this scope when None)."""

    def __init__(self, key, path: Tuple[str, ...] = (),
                 counters: Optional[Dict[Tuple[str, ...], int]] = None):
        self.key = jax_random.as_key(key)
        self.path = tuple(path)
        self.counters = {} if counters is None else counters

    def child(self, name: str) -> "KeyScope":
        return KeyScope(self.key, self.path + (name,), self.counters)

    def next(self, name: Optional[str] = None) -> jax_random.Key:
        path = self.path if name is None else self.path + (name,)
        n = self.counters.get(path, 0) + 1
        self.counters[path] = n
        return scope_key(self.key, path, n)

    def get_state(self) -> Dict[Tuple[str, ...], int]:
        return dict(self.counters)

    def set_state(self, state: Dict[Tuple[str, ...], int]) -> None:
        self.counters.clear()
        self.counters.update(state)


def _draw(key: jax_random.Key, leaf: Tuple, device) -> torch.Tensor:
    kind, shape = leaf[0], tuple(leaf[1])
    if kind == "normal":  # jax.nn.initializers.normal(stddev)
        std = torch.tensor(leaf[2], dtype=torch.float32, device=device)
        return jax_random.normal(key, shape, device) * std
    if kind == "uniform":  # jax.random.uniform(key, shape, f32, -b, b)
        return jax_random.uniform(key, shape, -leaf[2], leaf[2], device)
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    raise ValueError(f"unknown initializer {kind!r}")


def init_params(key, spec: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """``model.init(key)["params"]`` of a Flax model whose param tree is
    ``spec``: nested dicts by scope name, each leaf an initializer
    ("normal", shape, stddev), ("uniform", shape, bound), ("ones", shape)
    or ("zeros", shape), in the order its scope declares them (each leaf
    draws its scope's next "params" key). Float32 tensors on ``device``,
    in the JAX tree's names and layout."""
    key = jax_random.as_key(key)

    def walk(node, path):
        out, counter = {}, 0
        for name, val in node.items():
            if isinstance(val, Mapping):
                out[name] = walk(val, path + (name,))
            else:
                counter += 1
                out[name] = _draw(scope_key(key, path, counter), val, device)
        return out

    return walk(spec, ())
