"""Tensor (model-axis) parallelism for MAG-BERT and MAG-XLNet (port of
``parallel/tp.py``).

The FFN is split Megatron-style over the mesh's ``model`` axis:

* the first FFN product is column-parallel: ``intermediate_dense`` (XLNet:
  ``ff.layer_1``) keeps its weight rows (output features) and bias of this
  rank's chunk; the activation stays local;
* the second is row-parallel: the layer-level ``output_dense`` (XLNet:
  ``ff.layer_2``) keeps the weight columns (input features) of the chunk;
  the partial products are summed over the model axis and the bias,
  replicated, is added after the sum.

With ``shard_attention`` attention is head-sharded too: each rank computes
q, k and v of its H/mp heads from the replicated packed ``qkv`` weight (its
q|k|v column blocks cannot be head-aligned by one contiguous chunk, so it
stays whole, as in JAX), runs attention on them (the split-layout kernels
#8-#10 through ``ops/fused_attention.py::fused_attention_tp``, or the
einsum math), and ``attention.output_dense`` is row-parallel over the
heads. Each rank's gradient of ``qkv`` then covers only its heads' rows, so
it is summed over the model axis before the optimizer step
(``sync_grads``). XLNet's raw [D, H·Dh] projections are head-major, so a
contiguous chunk of their columns is whole heads: ``q``, ``k``, ``v`` and
``r`` are column-parallel on that axis, ``o`` row-parallel on it, and the
[H, Dh] biases ``r_w_bias``/``r_r_bias``/``r_s_bias`` and ``seg_embed``
[2, H, Dh] are split on H; each rank then runs the rel kernels on its
heads (``ops/fused_attention.py::fused_rel_attention_tp`` and
``fused_rel_attention_ingredients_tp``) or the einsum math, and no
gradient is partial. Everything else (embeddings, MAG, LayerNorms, pooler,
classifier) stays replicated, and the two autograd functions keep its
gradients whole: ``copy_to_model`` (identity forward, sum backward) where a
replicated activation enters a sharded region, ``reduce_from_model`` (sum
forward, identity backward) where a sharded region's partial output
leaves it.

The rules key on the port's state-dict names (``tp_pspec_for_path``); a
spec is a tuple over the tensor's dims naming the axis each is split on
(``()`` replicated). ``shard_state_dict`` / ``gather_state_dict`` carry a
full state dict (as ``utils/convert.py::params_from_flax`` gives it) to a
rank's shards and back; ``shard_model_`` turns a model built at full size
into this rank's shard. ``full_state_dict`` / ``local_state_dict`` do the
same for whatever sharding a model carries (none included), which is how
checkpoints and HF files stay full-size whatever the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
)

PartitionSpec = Tuple[Optional[str], ...]


_XLNET_HEAD_COLUMNS = tuple(f".rel_attn.{n}" for n in ("q", "k", "v", "r",
                                                        "o"))
_XLNET_HEAD_ROWS = tuple(f".rel_attn.{n}" for n in ("r_w_bias", "r_r_bias",
                                                    "r_s_bias"))


def tp_pspec_for_path(path: str, *,
                      shard_attention: bool = False) -> PartitionSpec:
    """The spec of one parameter by its state-dict name (torch layout:
    ``Linear.weight`` is [out, in]; XLNet's raw projections keep the JAX
    [D, H·Dh])."""
    ffn_in = ".intermediate_dense." in path or ".ff.layer_1." in path
    ffn_out = ((".output_dense." in path and ".attention." not in path)
               or ".ff.layer_2." in path)
    attn_out = ".attention.output_dense." in path
    if ffn_in and path.endswith(".weight"):
        return (MODEL_AXIS, None)
    if ffn_in and path.endswith(".bias"):
        return (MODEL_AXIS,)
    if (ffn_out or (shard_attention and attn_out)) and path.endswith(
            ".weight"):
        return (None, MODEL_AXIS)
    if shard_attention:
        # q/k/v/r column-parallel on the flat head axis, o row-parallel on
        # it (its contraction axis, also dim 1)
        if path.endswith(_XLNET_HEAD_COLUMNS):
            return (None, MODEL_AXIS)
        if path.endswith(_XLNET_HEAD_ROWS):
            return (MODEL_AXIS, None)
        if path.endswith(".rel_attn.seg_embed"):
            return (None, MODEL_AXIS, None)
    # the row-parallel biases are added after the sum: replicated, as the
    # packed qkv (whose gradient sync_grads sums under shard_attention)
    return ()


def _split_dim(spec: PartitionSpec) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == MODEL_AXIS), None)


def shard_tensor(t: torch.Tensor, spec: PartitionSpec,
                 mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of ``t`` under ``spec`` (a view)."""
    dim = _split_dim(spec)
    if dim is None or mesh.model_size == 1:
        return t
    n = t.shape[dim]
    if n % mesh.model_size:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{mesh.model_size} model ranks")
    size = n // mesh.model_size
    return t.narrow(dim, mesh.model_rank * size, size)


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh,
                     shard_attention: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict → this rank's (copies of its chunks)."""
    return {name: shard_tensor(t, tp_pspec_for_path(
        name, shard_attention=shard_attention), mesh).clone()
        for name, t in full.items()}


def gather_state_dict(local: Dict[str, torch.Tensor], mesh: Mesh,
                      shard_attention: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's chunks (a collective
    over the model axis: every rank of a model group calls it)."""
    out = {}
    for name, t in local.items():
        dim = _split_dim(tp_pspec_for_path(name,
                                           shard_attention=shard_attention))
        out[name] = (t if dim is None
                     else mesh.all_gather(t, mesh.model_axis, dim))
    return out


def full_state_dict(model: nn.Module,
                    tensors: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """``tensors`` (default the model's state dict), keyed by the model's
    parameter names, at full size: gathered over the model axis when
    ``shard_model_`` sharded the model (a collective that every rank of a
    model group calls), else as they are."""
    tensors = model.state_dict() if tensors is None else tensors
    sharding = getattr(model, "tp_sharding", None)
    if sharding is None:
        return dict(tensors)
    return gather_state_dict(tensors, *sharding)


def local_state_dict(model: nn.Module, full: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full-size dict keyed by the model's parameter names → what this
    rank holds of it: its chunks when the model is sharded, else ``full``
    as it is."""
    sharding = getattr(model, "tp_sharding", None)
    if sharding is None:
        return full
    return shard_state_dict(full, *sharding)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone(), MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated activation entering a model-sharded region: identity
    forward; its gradient (partial on each rank) summed over the model
    axis."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A model-sharded region's partial output summed over the model axis;
    the gradient passes through."""
    return _ReduceFromModel.apply(x, mesh)


def local_heads(n_heads: int, mesh: Mesh) -> Tuple[int, int]:
    """(first global head, number of heads) of this model rank."""
    if n_heads % mesh.model_size:
        raise ValueError(f"n_heads={n_heads} not divisible by model axis "
                         f"size {mesh.model_size}")
    n = n_heads // mesh.model_size
    return mesh.model_rank * n, n


def _n_heads_and_ffn(cfg) -> Tuple[int, int]:
    """(heads, FFN width) of a MAG-BERT or MAG-XLNet config."""
    if hasattr(cfg, "num_attention_heads"):
        return cfg.num_attention_heads, cfg.intermediate_size
    return cfg.n_head, cfg.d_inner


def shard_model_(model: nn.Module, mesh: Mesh,
                 shard_attention: bool = False) -> nn.Module:
    """Turn a MAG-BERT or MAG-XLNet classifier built at full size into this
    rank's shard, in place: each split parameter becomes its chunk
    (remembering where in the full tensor it sits, so
    ``models/bert.py::init_weights`` draws the full tensor and keeps the
    chunk, as one device would), the layers run the FFN split, and with
    ``shard_attention`` the attention head-sharded (BERT's packed ``qkv``
    marked for ``sync_grads``). A model already sharded over this mesh the
    same way is returned as it is."""
    if getattr(model, "tp_sharding", None) is not None:
        if model.tp_sharding != (mesh, shard_attention):
            raise ValueError("the model is already sharded over another "
                             "mesh or attention split")
        return model
    if mesh.model_size == 1:
        return model
    n_heads, ffn = _n_heads_and_ffn(getattr(model, "config", None))
    local_heads(n_heads, mesh)
    if ffn % mesh.model_size:
        raise ValueError(f"FFN width {ffn} not divisible by model axis "
                         f"size {mesh.model_size}")
    modules = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        spec = tp_pspec_for_path(name, shard_attention=shard_attention)
        dim = _split_dim(spec)
        owner, attr = name.rsplit(".", 1)
        if dim is not None:
            chunk = nn.Parameter(shard_tensor(p.detach(), spec, mesh).clone())
            chunk.tp_shard = (dim, p.shape[dim],
                              mesh.model_rank * chunk.shape[dim])
            setattr(modules[owner], attr, chunk)
        elif shard_attention and ".attention.qkv." in name:
            p.tp_partial = True
    for mod in model.modules():
        # the attention modules take the mesh only when their heads split
        if hasattr(mod, "tp_mesh") and (
                shard_attention or not getattr(mod, "head_sharded", False)):
            mod.tp_mesh = mesh
    model.tp_sharding = (mesh, shard_attention)
    return model


def sync_grads(model: nn.Module, mesh: Mesh) -> None:
    """Sum over the model axis the gradients each rank holds only a part
    of (the packed ``qkv`` under ``shard_attention``), one collective for
    all of them."""
    mesh.all_reduce_list_(
        [p.grad for p in model.parameters()
         if getattr(p, "tp_partial", False) and p.grad is not None],
        MODEL_AXIS)
