"""Fully-sharded data parallelism (ZeRO-3) over the ``data`` mesh axis (port
of ``parallel/fsdp.py``).

With ``Trainer(..., fsdp=True)`` every parameter and both AdamW moments are
stored sharded over the data axis, the axis the batch is already split
over:

* the per-leaf rule is the JAX one (``fsdp_pspec_for_leaf``): shard the
  largest dimension divisible by the data-axis size that the base spec
  leaves free, a tie keeping the leading dimension; a leaf with no such
  dimension keeps its base spec (replicated over data). The rule reads the
  JAX layout of each leaf: an ``nn.Linear`` weight is the transposed JAX
  ``Dense`` kernel, so its shape and spec are read reversed, and every
  leaf shards on the dimension its JAX counterpart shards on;
* on a mesh with a model axis > 1 the tensor-parallel rules
  (``parallel/tp.py::tp_pspec_for_path``) claim their dimension first and
  FSDP shards the largest remaining free one (``make_fsdp_state_specs``);
* the step counter and the dropout generator stay whole on every rank (the
  JAX ``.step`` and ``.rng`` leaves): the port's ``TrainState`` keeps them
  as a host int and a CPU generator that every rank advances alike.

Between steps each rank holds only its shard (``shard_model_``: the
parameter's data is its slice, and the optimizer, built over the same
parameters, creates its moments at the slice's shape). A step gathers the
whole model's weights over the data axis in one collective before the
forward (``gather_params_``), runs the forward and backward on the full
weights, sums the gradients over the data axis and keeps the rank's slice
of each (``keep_grad_shards_``), which frees the full weights, and AdamW
updates the shard. Gloo has no reduce-scatter, so the sum is an
all-reduce of the full gradients followed by taking the rank's slice: the
same numbers a reduce-scatter gives. The gather is whole-model, not per
module: a step's peak holds the full weights and gradients once, with the
moments at 1/n. Evaluation and prediction gather the same way for the
length of a split (``full_params``).

Checkpoints gather full size (``gather``, called by
``parallel/tp.py::full_state_dict``) and a restore takes the rank's slice
(``shard``, by ``local_state_dict``), so an FSDP checkpoint is the same
file as a plain or tensor-parallel one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
)
from bert_multimodal_transformer_tpu_torch.parallel.tp import (
    PartitionSpec,
    tp_pspec_for_path,
)


def fsdp_pspec_for_leaf(shape: Sequence[int], n_data: int,
                        base: Optional[Tuple] = None) -> PartitionSpec:
    """The spec sharding the largest ``base``-free dimension of ``shape``
    over the data axis (ties keep the leading dimension, so position
    embeddings [S, D] with S == D shard on S). ``base`` is an existing spec
    (a TP rule) whose claimed dimensions are left untouched; a leaf with no
    dimension divisible by ``n_data`` keeps ``base`` (replicated over
    data). Trailing unsharded dimensions are dropped, as the JAX
    ``PartitionSpec``."""
    spec = list(base or ())
    spec += [None] * (len(shape) - len(spec))
    best = None
    for i, dim in enumerate(shape):
        if spec[i] is not None:
            continue
        if dim % n_data == 0 and dim >= n_data and (
                best is None or dim > shape[best]):
            best = i
    if best is not None:
        spec[best] = DATA_AXIS
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_transposed(model: nn.Module) -> set:
    """The parameter names the port stores transposed from the JAX tree:
    every ``nn.Linear`` weight (a ``Dense`` kernel [in, out] there)."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def _padded(spec: PartitionSpec, ndim: int) -> List:
    return list(spec) + [None] * (ndim - len(spec))


def fsdp_spec(shape: Sequence[int], n_data: int, base: PartitionSpec,
              transposed: bool) -> PartitionSpec:
    """``fsdp_pspec_for_leaf`` on the leaf's JAX layout, as a spec of the
    port's layout (a transposed leaf's shape and base read reversed)."""
    if not transposed:
        return fsdp_pspec_for_leaf(shape, n_data, base)
    jax_base = tuple(_padded(base, len(shape))[::-1])
    spec = _padded(fsdp_pspec_for_leaf(tuple(shape)[::-1], n_data,
                                       jax_base), len(shape))[::-1]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def make_fsdp_state_specs(model: nn.Module, mesh: Mesh, *,
                          shard_attention: bool = False
                          ) -> Dict[str, PartitionSpec]:
    """{parameter name: spec} under FSDP (JAX
    ``make_fsdp_state_shardings``): the TP rules first on a mesh with a
    model axis > 1, then FSDP on the largest remaining free dimension. The
    moments mirror their parameter's spec. ``model`` holds the shapes the
    rule reads (its tensor-parallel chunks when sharded over the model
    axis, whose split dimension the TP base claims)."""
    n_data = mesh.data_size
    tp_active = mesh.model_size > 1
    transposed = _jax_transposed(model)
    specs = {}
    for name, p in model.named_parameters():
        base = (tp_pspec_for_path(name, shard_attention=shard_attention)
                if tp_active else ())
        if n_data <= 1 or len(base) > p.dim():
            specs[name] = base
            continue
        specs[name] = fsdp_spec(tuple(p.shape), n_data, base,
                                name in transposed)
    return specs


def _data_dim(spec: PartitionSpec) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == DATA_AXIS), None)


@dataclasses.dataclass(eq=False)
class FsdpSharding:
    """What a model sharded by ``shard_model_`` remembers: the mesh, and
    for each parameter split over the data axis its dimension (``dims``),
    with the rank's slices of those parameters while the full weights are
    out (``_shards``)."""

    mesh: Mesh
    dims: Dict[str, int]
    _shards: Optional[Dict[str, torch.Tensor]] = None

    def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.mesh.data_size
        return t.narrow(dim, self.mesh.data_rank * n, n)

    def shard(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """A dict keyed by parameter names at the model's pre-FSDP size →
        this rank's slices (copies)."""
        return {name: (self._slice(t, self.dims[name]).clone()
                       if name in self.dims else t)
                for name, t in full.items()}

    def gather(self, local: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The inverse of ``shard``: every data rank's slices joined (a
        collective over the data axis that every rank calls)."""
        return {name: (self.mesh.all_gather(t, self.mesh.data_axis,
                                            self.dims[name])
                       if name in self.dims else t)
                for name, t in local.items()}


def shard_model_(model: nn.Module, mesh: Mesh,
                 shard_attention: bool = False) -> nn.Module:
    """Keep only this data rank's slice of every parameter the FSDP specs
    split (``make_fsdp_state_specs``), in place; the model remembers the
    split as ``model.fsdp_sharding``. Call it before the optimizer is
    built, so the moments take the slices' shapes. A model already
    sharded is returned as it is."""
    if getattr(model, "fsdp_sharding", None) is not None:
        return model
    specs = make_fsdp_state_specs(model, mesh,
                                  shard_attention=shard_attention)
    dims = {name: _data_dim(spec) for name, spec in specs.items()
            if _data_dim(spec) is not None}
    sharding = FsdpSharding(mesh, dims)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in dims:
                full = p.shape[dims[name]]
                p.data = sharding._slice(p.data, dims[name]).clone()
                # (dim, full size), as tp_shard records its split
                p.fsdp_shard = (dims[name], full)
    model.fsdp_sharding = sharding
    return model


def _params(model: nn.Module, sharding: FsdpSharding):
    return [(name, p) for name, p in model.named_parameters()
            if name in sharding.dims]


def gather_params_(model: nn.Module) -> None:
    """Put the full weights in every sharded parameter (one all-gather over
    the data axis for all of them), keeping the rank's slices aside. The
    parameters must hold no gradient."""
    sharding = getattr(model, "fsdp_sharding", None)
    if sharding is None or sharding._shards is not None:
        return
    params = _params(model, sharding)
    if not params:
        sharding._shards = {}
        return
    mesh = sharding.mesh
    shards = {name: p.data for name, p in params}
    flat = torch.cat([s.reshape(-1) for s in shards.values()])
    parts = mesh.all_gather(flat, mesh.data_axis).chunk(mesh.data_size)
    sizes = [s.numel() for s in shards.values()]
    pieces = [part.split(sizes) for part in parts]
    with torch.no_grad():
        for i, (name, p) in enumerate(params):
            dim = sharding.dims[name]
            p.data = torch.cat([piece[i].view_as(shards[name])
                                for piece in pieces], dim=dim)
    sharding._shards = shards


def release_params_(model: nn.Module) -> None:
    """Back to the rank's slices after ``gather_params_`` (the full weights
    are freed once nothing else holds them)."""
    sharding = getattr(model, "fsdp_sharding", None)
    if sharding is None or sharding._shards is None:
        return
    for name, p in _params(model, sharding):
        p.data = sharding._shards[name]
    sharding._shards = None


def reshard_(model: nn.Module) -> None:
    """After ``gather_params_``, when the full weights were rewritten alike
    on every rank (drawn from one seed): keep the rank's slices of them."""
    sharding = getattr(model, "fsdp_sharding", None)
    if sharding is None or sharding._shards is None:
        return
    with torch.no_grad():
        for name, p in _params(model, sharding):
            p.data = sharding._slice(p.data, sharding.dims[name]).clone()
    sharding._shards = None


def keep_grad_shards_(model: nn.Module) -> None:
    """After the gradients were summed over the data axis: every sharded
    parameter keeps its slice of the gradient and of the weights."""
    sharding = getattr(model, "fsdp_sharding", None)
    if sharding is None or sharding._shards is None:
        return
    for name, p in _params(model, sharding):
        g = p.grad
        p.grad = None
        p.data = sharding._shards[name]
        if g is not None:
            p.grad = sharding._slice(g, sharding.dims[name]).clone()
    sharding._shards = None


@contextlib.contextmanager
def full_params(model: nn.Module):
    """Inside: the full weights in every sharded parameter (evaluation,
    prediction, drawing the init); the slices come back on exit."""
    sharding = getattr(model, "fsdp_sharding", None)
    if sharding is None or sharding._shards is not None:
        yield
        return
    gather_params_(model)
    try:
        yield
    finally:
        release_params_(model)


def global_grad_norm(params: List[torch.Tensor], mesh: Mesh
                     ) -> torch.Tensor:
    """‖g‖₂ over the whole model's gradients, from ``params``' gradients
    on this rank: the squares of a slice split over the data axis
    (``fsdp_shard``) summed over it, of a chunk split over the model axis
    (``tp_shard``) over that one, of a pipeline stage's own layers
    (``pp_stage_local``) over the pipe axis, a replicated gradient counted
    once (JAX ``optax.clip_by_global_norm`` on the sharded tree)."""
    buckets: Dict[Tuple[bool, bool, bool], List[torch.Tensor]] = {}
    for p in params:
        key = (hasattr(p, "fsdp_shard"), hasattr(p, "tp_shard"),
               hasattr(p, "pp_stage_local"))
        buckets.setdefault(key, []).append(p.grad)
    if set(buckets) == {(False, False, False)}:
        # nothing split: the one-device norm, to its bits
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(buckets[False, False, False])))
    total = None
    for key in sorted(buckets):
        sq = torch.stack(torch._foreach_norm(buckets[key])).float()
        sq = sq.square().sum()
        for on, axis in zip(key, (mesh.data_axis, MODEL_AXIS, mesh.pipe_axis)):
            if on:
                sq = mesh.all_reduce_(sq, axis)
        total = sq if total is None else total + sq
    return total.sqrt()
