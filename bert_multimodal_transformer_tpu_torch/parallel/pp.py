"""GPipe pipeline parallelism for MAG-BERT (port of ``parallel/pp.py``).

The model is split into a PROLOGUE (embeddings and MAG, the reference's
early fusion), a stack of ``BertLayer``s laid out over the mesh's ``pipe``
axis, k = L / n_stages consecutive layers a stage, and an EPILOGUE (pooler,
dropout and classifier). Each rank (``parallel/mesh.py::make_pp_mesh``)
holds its stage's layers and a replica of the prologue and epilogue:

* the stage is a module of its own (``PipelineStage``) over the model's own
  submodules, its parameters named in the pipeline layout (``prologue.*``,
  ``layers.<j>.*`` for its j-th local layer, ``epilogue.*``); the other
  stages' layers are released from the rank's model at its first step;
* a step runs the GPipe schedule: every microbatch's forward in order (the
  first stage runs the prologue, each stage receives its input from the
  one before and sends its output on, the last runs the epilogue and the
  loss), then every microbatch's backward in reverse order, each stage
  receiving the cotangent of its output from the next stage and sending
  that of its input back. Each microbatch's graph stays alive from its
  forward to its backward, so the step's peak grows with ``n_micro``. The
  JAX package writes the same schedule as one ``lax.scan`` over
  T = n_micro + n_stages − 1 ticks; here each rank runs its own part of
  it, and the bubble, (n_stages − 1)/T of the ticks, is the time a stage
  waits on its neighbour;
* only the last stage's loss contributes: the mean MSE of each microbatch
  summed over microbatches and divided by n_micro, or the masked sum of
  squared errors under ``valid`` divided by the global valid count;
* ``_cross_stage_grads``: only one stage's prologue (the first) and one
  stage's epilogue (the last) reach the loss, so their gradients are
  summed over the pipe axis and every replica applies the same update;
  layer gradients stay with their stage. Then every gradient, and the
  loss, is reduced over the data axis;
* dropout, under ``rng_impl`` "rbg": each (step, microbatch, stage)
  draws from its own generators (``ops/dropout.py::DropoutRngs``, seeded
  from one draw of the state's generator, the microbatch and the stage),
  so the kernels' Philox seed comes from them and the saved-probs backward
  replays the forward's mask. That stream is the port's own; with dropout
  off the step equals the plain ``Trainer(grad_accum=n_micro)`` step;
* dropout, under "threefry2x32": the JAX ``PipelineTrainer``'s keys
  (``parallel/pp.py:480-511``, ``:600-601``, ``:643-646``). The step's
  key is ``split(state.rng)[0]``, over data ranks ``fold_in``-ed with the
  data index (each rank draws its local rows' masks); microbatch m's key
  is ``fold_in(key, m)``; each part is a Flax module applied at the root
  under ``fold_in(key_m, tag)``: the prologue (``embeddings``, ``MAG``)
  under tag 1 << 20, layer i under its global id i, the epilogue under
  2 << 20 (``PartRngs``). Every hidden, MAG and einsum-probs mask and
  every fused kernel's seed is then JAX's;
* PP×TP: on a (data, pipe, model) mesh each stage's layers split the FFN
  Megatron-style over the model axis with the port's f/g operators
  (``parallel/tp.py::copy_to_model`` / ``reduce_from_model``, set by
  ``shard_model_``), the JAX ``_TPBertLayer``; attention stays full-headed
  on every model rank.

``PipelineTrainer`` subclasses ``Trainer`` and swaps only the train,
masked-train, eval and predict steps, so the epoch driver, resume and
scoring run unchanged. Its state's model is the stage: a checkpoint holds
the whole model in the pipeline layout (the layers stacked on a leading
[L] axis, gathered over the stages; ``PipelineStage.pp_layout``), which
``model_params_from_pp_params`` turns back into the model's state dict
(``serving.py::Predictor.from_checkpoint`` and the driver's
``--predict_only`` do).

Ranks that share a card talk over gloo, whose point-to-point calls take
host tensors: the [mb, S, D] activation and its cotangent go through host
memory (``Mesh.pipe_send`` / ``pipe_recv``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.models.bert import (
    _child,
    _hidden_dropout,
    dense,
)
from bert_multimodal_transformer_tpu_torch.ops.attention import (
    extended_attention_mask,
)
from bert_multimodal_transformer_tpu_torch.ops.dropout import (
    DropoutRngs,
    SiteKey,
    ThreefryRngs,
    ThreefryStream,
    draw_seed,
)
from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    Mesh,
)
from bert_multimodal_transformer_tpu_torch.training.losses import mse_loss
from bert_multimodal_transformer_tpu_torch.training.trainer import (
    COMPILER_OPTIONS_REFUSAL,
    Trainer,
    TrainState,
    _data_fold,
    attach_grad_norm,
)
from bert_multimodal_transformer_tpu_torch.utils import jax_random

# Each family's model-layout names: the backbone prefix, the layer stack's
# prefix, and the prologue's and epilogue's entries (an entry under the
# backbone keeps its name after it).
_LAYOUTS = {
    "bert": dict(backbone="bert.", layers="bert.encoder.layer.",
                 prologue=("embeddings", "MAG"),
                 epilogue=("pooler", "classifier")),
    "xlnet": dict(backbone="transformer.", layers="transformer.layer.",
                  prologue=("word_embedding", "MAG", "mask_emb"),
                  epilogue=("sequence_summary", "logits_proj")),
}


def _family(names) -> str:
    names = list(names)
    if any(n.startswith(("transformer.", "prologue.word_embedding."))
           for n in names):
        return "xlnet"
    return "bert"


def _entry(rest: str) -> str:
    return rest.split(".", 1)[0]


def pp_params_from_model_params(params: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A MAG-BERT or MAG-XLNet state dict → the pipeline layout (JAX
    ``pp_params_from_model_params`` / ``pp_params_from_xlnet_params``):
    ``prologue.<name>`` (BERT: embeddings, MAG; XLNet: word_embedding,
    MAG, mask_emb), ``layers.<name>`` stacked over the L layers on a
    leading axis, ``epilogue.<name>`` (BERT: pooler, classifier; XLNet:
    sequence_summary, logits_proj). Inner names are kept, so the
    optimizer's no-decay rule sorts every entry as before."""
    lay = _LAYOUTS[_family(params)]
    layer_re = re.compile(re.escape(lay["layers"]) + r"(\d+)\.(.*)")
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        m = layer_re.fullmatch(name)
        if m:
            stacked.setdefault(m.group(2), {})[int(m.group(1))] = t
            continue
        rest = (name[len(lay["backbone"]):]
                if name.startswith(lay["backbone"]) else name)
        section = ("prologue" if _entry(rest) in lay["prologue"]
                   else "epilogue" if _entry(rest) in lay["epilogue"]
                   else None)
        if section is None:
            raise KeyError(f"{name} has no place in the pipeline layout")
        out[f"{section}.{rest}"] = t
    for rest, by_layer in stacked.items():
        out[f"layers.{rest}"] = torch.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return out


def _model_name(name: str, lay: dict) -> str:
    """A prologue or epilogue entry's name in the model layout."""
    section, rest = name.split(".", 1)
    if section == "prologue" or (section == "epilogue"
                                 and _entry(rest) == "pooler"):
        return lay["backbone"] + rest
    if section == "epilogue":
        return rest
    raise KeyError(f"{name} is not a pipeline-layout name")


def model_params_from_pp_params(pp_params: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``pp_params_from_model_params``: the model's state
    dict (for checkpoint export, serving and the HF converters)."""
    lay = _LAYOUTS[_family(pp_params)]
    out: Dict[str, torch.Tensor] = {}
    for name, t in pp_params.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(t.shape[0]):
                out[f"{lay['layers']}{i}.{rest}"] = t[i]
        else:
            out[_model_name(name, lay)] = t
    return out


def is_pp_layout(params) -> bool:
    """True when ``params`` are in the pipeline layout (a checkpoint a
    pipelined run wrote)."""
    return any(n.startswith("prologue.") for n in params)


def _holder(entries: Dict[str, object]) -> nn.Module:
    """A module whose attributes are ``entries`` (submodules, or a bare
    parameter such as XLNet's ``mask_emb``), so their names read
    ``<entry>.<inner name>``."""
    holder = nn.Module()
    for name, obj in entries.items():
        setattr(holder, name, obj)
    return holder


class PipelineStage(nn.Module):
    """One stage of the pipeline: the model's prologue and epilogue
    modules (replicated on every stage) and its k layers, under
    pipeline-layout names. ``pp_layout`` carries its checkpoints to and
    from the whole model's pipeline layout."""

    def __init__(self, config, dtype, prologue: Dict[str, object],
                 layers: List[nn.Module], epilogue: Dict[str, object],
                 mesh: Mesh, first_layer: int, n_layers: int):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.prologue = _holder(prologue)
        self.layers = nn.ModuleList(layers)
        self.epilogue = _holder(epilogue)
        self.pp_layout = _StageLayout(self, mesh, first_layer, n_layers)

    def model_names(self) -> Dict[str, str]:
        """{this stage's parameter name: the model's name of it}."""
        names = [n for n, _ in self.named_parameters()]
        lay = _LAYOUTS[_family(names)]
        first = self.pp_layout.first_layer
        out = {}
        for name in names:
            m = _LOCAL.fullmatch(name)
            out[name] = (f"{lay['layers']}{first + int(m.group(1))}."
                         f"{m.group(2)}" if m else _model_name(name, lay))
        return out


_LOCAL = re.compile(r"layers\.(\d+)\.(.*)")


@dataclasses.dataclass(eq=False)
class _StageLayout:
    """A stage's dicts (state dict or moments, by stage name) to and from
    the whole model's pipeline layout: the layers gathered over the pipe
    axis (and first over the model axis, under PP×TP) in stage order."""

    stage: PipelineStage
    mesh: Mesh
    first_layer: int
    n_layers: int

    def full(self, tensors: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """The stage's ``tensors`` → the pipeline layout of the whole model
        (collectives over the model and pipe axes: every rank calls it)."""
        mesh = self.mesh
        if getattr(self.stage, "tp_sharding", None) is not None:
            tensors = tp_lib.gather_state_dict(tensors, mesh)
        out, stacked = {}, {}
        for name in sorted(tensors):
            m = _LOCAL.fullmatch(name)
            if m is None:
                out[name] = tensors[name]
            else:
                stacked.setdefault(m.group(2), {})[int(m.group(1))] = (
                    tensors[name])
        for rest in sorted(stacked):
            by_j = stacked[rest]
            local = torch.stack([by_j[j] for j in range(len(by_j))])
            out[f"layers.{rest}"] = mesh.all_gather(local, PIPE_AXIS, 0)
        return out

    def local(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """The whole model's pipeline layout (or its model layout) → this
        stage's entries, its chunks under PP×TP."""
        if not is_pp_layout(full):
            full = pp_params_from_model_params(full)
        k = len(self.stage.layers)
        out = {}
        for name, t in full.items():
            if name.startswith("layers."):
                rest = name[len("layers."):]
                for j in range(k):
                    out[f"layers.{j}.{rest}"] = t[self.first_layer + j]
            else:
                out[name] = t
        if getattr(self.stage, "tp_sharding", None) is not None:
            out = tp_lib.shard_state_dict(out, self.mesh)
        return out


def _stage_seed(seed: int, micro: int, stage: int) -> int:
    """The seed of one (step, microbatch, stage) dropout stream."""
    x = (seed ^ (micro + 1) * 0xD1B54A32D192ED03
         ^ (stage + 1) * 0x94D049BB133111EB)
    return x & (2 ** 63 - 1)


# What the JAX pipeline folds into a microbatch's key for each part of a
# stage (parallel/pp.py:480-511, pp_xlnet.py:244-331); layer i takes its
# global id i.
PROLOGUE_TAG = 1 << 20
EPILOGUE_TAG = 2 << 20
MAG_TAG = 3 << 20          # XLNet's MAG, applied as a module of its own
POS_EMB_TAG = 4 << 20      # XLNet's position-encoding mask


@dataclasses.dataclass
class PartRngs:
    """One microbatch's dropout streams on a stage, by part. rbg: ``rbg``,
    the (step, microbatch, stage) streams, the same for every part.
    threefry2x32: ``key``, the microbatch's key; part ``tag`` draws from
    the root stream of ``fold_in(key, tag)``, as the JAX pipeline applies
    each part as a Flax module of its own, and every mask for the local
    shape, as JAX draws under its ``shard_map`` (``ThreefryRngs.local``:
    a PP×TP rank's FFN columns)."""

    rbg: Optional[DropoutRngs] = None
    key: Optional[jax_random.Key] = None

    def part(self, tag: int):
        """The stream of the part folded with ``tag``."""
        if self.key is None:
            return self.rbg
        return ThreefryRngs.from_key(jax_random.fold_in(self.key, tag),
                                     local=True)

    def site(self, tag: int):
        """A mask drawn straight from ``fold_in(key, tag)``, outside any
        Flax scope (``jax.random.bernoulli`` of that key)."""
        if self.key is None:
            return self.rbg.mask()
        return SiteKey(jax_random.fold_in(self.key, tag))


def _part(rngs: Optional[PartRngs], tag: int):
    return None if rngs is None else rngs.part(tag)


@dataclasses.dataclass
class PipelineTrainer(Trainer):
    """The pipelined drop-in for ``Trainer`` (MAG-BERT regression).

    ``model`` is the full model, built (or loaded) on every rank: the
    trainer takes its stage's modules from it when the state is created,
    and releases the other stages' layers at the first step. ``mesh`` is
    this rank's place in ``make_pp_mesh``'s mesh. ``n_micro`` microbatches
    a step; each data rank's share of the batch must divide by it. A step
    is the plain Trainer's ``grad_accum=n_micro`` step (module docstring);
    the epoch drivers, resume and scoring are Trainer's."""

    n_micro: int = 4

    def _pp_common_setup(self, n_layers: int, hidden_size: int) -> None:
        """The family-independent guards of the JAX ``_pp_common_setup``
        and the stage geometry."""
        if self.mesh is None or not getattr(self.mesh, "pipelined", False):
            raise ValueError("the pipeline trainer needs a mesh with a "
                             f"'{PIPE_AXIS}' axis (make_pp_mesh)")
        if self.grad_accum != 1:
            raise ValueError(
                "PipelineTrainer accumulates over n_micro microbatches; "
                "grad_accum must stay 1")
        if self.tp_shard_attention:
            raise ValueError(
                "tp_shard_attention does not compose with the pipeline "
                "trainer (no 'model' axis on a pp mesh)")
        if self.mem_len is not None:
            raise ValueError(
                "mem_len (segment recurrence) does not compose with the "
                "pipeline trainer — the pipelined step never threads "
                "mems, so accepting it would silently train without "
                "memory; use the data-parallel Trainer")
        if self.fsdp:
            raise ValueError(
                "fsdp does not compose with the pipeline trainer (the "
                "pipeline owns its stage-sharded state layout)")
        if self.compiler_options:
            raise ValueError(COMPILER_OPTIONS_REFUSAL)
        if self.multiprocess:
            # the JAX driver refuses --pipeline_parallel under
            # --num_processes > 1
            raise ValueError(
                "multiprocess composes with the data-parallel trainer, fsdp "
                "and the model axis; not with the pipeline trainer")
        self._n_stages = self.mesh.pipe_size
        self._dp = self.mesh.data_size
        self._mp = self.mesh.model_size
        if n_layers % self._n_stages != 0:
            raise ValueError(
                f"layer count ({n_layers}) must divide "
                f"evenly over {self._n_stages} pipeline stages")
        if self.model.config.num_labels != 1:
            raise ValueError(
                "PipelineTrainer implements the reference's regression "
                "training loop (MSE, multimodal_driver.py:371-373); "
                "num_labels must be 1")
        if self.n_micro < 1:
            raise ValueError("n_micro must be >= 1")
        self._k = n_layers // self._n_stages
        self._n_layers = n_layers
        self._hidden_size = hidden_size
        self._dtype = getattr(self.model, "dtype", torch.float32)
        self.device = next(self.model.parameters()).device
        self.stage: Optional[PipelineStage] = None
        self._released = False

    def __post_init__(self):
        cfg = self.model.config
        self._pp_common_setup(cfg.num_hidden_layers, cfg.hidden_size)
        if getattr(self.model.multimodal_config, "injection_index", 0) != 0:
            raise ValueError(
                "PipelineTrainer's prologue applies MAG before layer 0 "
                "(BERT semantics, reference bert.py:219); "
                "injection_index != 0 is not pipelined")
        if self._mp > 1 and cfg.intermediate_size % self._mp != 0:
            raise ValueError(
                f"intermediate_size ({cfg.intermediate_size}) must "
                f"divide by the model axis ({self._mp}) for the "
                "Megatron FFN split")
        self._tp_split()

    def _tp_split(self) -> None:
        """PP×TP: the FFN of every layer Megatron-split over the model
        axis (attention stays full-headed)."""
        if self._mp > 1:
            tp_lib.shard_model_(self.model, self.mesh, False)

    # ---- family hooks: the stage's modules and its forward -------------

    def _model_parts(self):
        """(prologue entries, the L layers, epilogue entries) of the
        model."""
        bert = self.model.bert
        return ({"embeddings": bert.embeddings, "MAG": bert.MAG},
                list(bert.encoder.layer),
                {"pooler": bert.pooler, "classifier": self.model.classifier})

    def _layer_rngs(self, rngs: Optional[PartRngs], j: int):
        """Local layer j's stream: the part of its global id."""
        return _part(rngs, self.mesh.pipe_rank * self._k + j)

    def _stage_forward(self, stage: PipelineStage, mb: Tuple,
                       x_in: Optional[torch.Tensor],
                       rngs: Optional[PartRngs], deterministic: bool):
        """One stage's work on one microbatch: the prologue on the first
        stage (``x_in`` None) or the received activation, the stage's
        layers, then on the last stage the epilogue's [mb] fp32 logits;
        else the [mb, S, D] activation to send on."""
        ids, vis, ac, mask, seg = mb[:5]
        cfg, dt = self.model.config, self._dtype
        mask_f32 = mask.to(torch.float32)
        attn_bias = extended_attention_mask(mask_f32)
        if x_in is None:
            pro, pro_rngs = stage.prologue, _part(rngs, PROLOGUE_TAG)
            emb = pro.embeddings(ids, seg, deterministic=deterministic,
                                 rngs=_child(pro_rngs, "embeddings"))
            h = pro.MAG(emb, vis.to(dt), ac.to(dt),
                        deterministic=deterministic,
                        dropout_rng=(pro_rngs.child("MAG").mask("Dropout_0")
                                     if pro_rngs else None))
        else:
            h = x_in
        for j, layer in enumerate(stage.layers):
            h = layer(h, attn_bias, None, mask_f32, deterministic, False,
                      self._layer_rngs(rngs, j))
        if not self._last:
            return h
        epi = stage.epilogue
        pooled = _hidden_dropout(epi.pooler(h), cfg.hidden_dropout_prob,
                                 _part(rngs, EPILOGUE_TAG), deterministic,
                                 "Dropout_0")
        return dense(epi.classifier, pooled, dt).float().reshape(-1)

    # ---- state ---------------------------------------------------------

    @property
    def _first(self) -> bool:
        return self.mesh.pipe_rank == 0

    @property
    def _last(self) -> bool:
        return self.mesh.pipe_rank == self._n_stages - 1

    def _build_stage(self) -> PipelineStage:
        if self.stage is None:
            prologue, layers, epilogue = self._model_parts()
            first = self.mesh.pipe_rank * self._k
            stage = PipelineStage(self.model.config, self._dtype, prologue,
                                  layers[first:first + self._k], epilogue,
                                  self.mesh, first, self._n_layers)
            if self._mp > 1:
                stage.tp_sharding = (self.mesh, False)
            for p in stage.layers.parameters():
                # the stage's own: summed over the pipe axis in the
                # clipping norm
                p.pp_stage_local = True
            self.stage = stage
        return self.stage

    def _release_others(self) -> None:
        """Free the other stages' layers from this rank's model (kept
        until the first step, so an HF overlay can still load the whole
        model)."""
        if self._released:
            return
        own = {id(p) for p in self.stage.parameters()}
        with torch.no_grad():
            for layer in self._model_parts()[1]:
                for p in layer.parameters():
                    if id(p) not in own:
                        p.data = p.data.new_empty(0)
        self._released = True

    def init_state(self, seed: int) -> TrainState:
        """Draw the whole model's params from ``seed`` on every rank (the
        one-device draw: under threefry2x32 the JAX pipeline's
        ``model.init(PRNGKey(seed))`` and state key ``fold_in(PRNGKey(seed),
        1)``, as ``Trainer.init_state``), then create the state of this
        rank's stage."""
        if self._released:
            raise ValueError("init_state draws the whole model, whose other "
                             "stages were released at the first step")
        if self.rng_impl == "threefry2x32":
            key = jax_random.PRNGKey(seed)
            self.model.init_params_threefry(key)
            return self.create_state_from_params(
                None, ThreefryStream(jax_random.fold_in(key, 1)))
        self.model.init_params(
            torch.Generator(device=self.device).manual_seed(seed))
        return self.create_state_from_params(None, seed + 1)

    def create_state_from_params(self, params, rng) -> TrainState:
        """``params`` in the model layout (as ``utils/convert.py`` or a
        plain checkpoint gives them) or the pipeline layout, None keeping
        the model's weights; ``rng`` as ``Trainer.create_state_from_params``
        takes it."""
        stage = self._build_stage()
        if params is not None:
            stage.load_state_dict(stage.pp_layout.local(params))
        rng = self._stream(rng)
        optimizer = attach_grad_norm(self.tx(stage.named_parameters()),
                                     self.mesh)
        return TrainState(step=0, model=stage, optimizer=optimizer,
                          generator=rng)

    def model_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The whole model's state dict, full size (a collective: every
        rank calls it), for the HF export and serving paths."""
        return model_params_from_pp_params(
            tp_lib.full_state_dict(state.model))

    # ---- the pipeline --------------------------------------------------

    def _micro(self, batch: Tuple) -> List[Tuple]:
        b = batch[0].shape[0]
        if b % self.n_micro:
            raise ValueError(
                f"local batch {b} not divisible by n_micro {self.n_micro} "
                "(global batch must divide by n_micro x data_parallel)")
        return list(zip(*(t.chunk(self.n_micro) for t in batch)))

    def _micro_rngs(self, step, m: int) -> PartRngs:
        """Microbatch m's streams from the step's: an rbg seed, or a
        threefry key (``fold_in(key, m)``, JAX ``pp.py:600-601``)."""
        if isinstance(step, tuple):
            return PartRngs(key=jax_random.fold_in(step, m))
        return PartRngs(rbg=DropoutRngs.make(torch.Generator().manual_seed(
            _stage_seed(step, m, self.mesh.pipe_rank)), self.device))

    def _pipeline_forward(self, stage: PipelineStage, micro: List[Tuple],
                          step):
        """Every microbatch's forward through this stage, in order:
        receive (all but the first stage), compute, send (all but the
        last). ``step``: the step's dropout stream (``_pp_step``), None
        for the deterministic forward. Returns [(input, output)] per
        microbatch, the output the last stage's [mb] logits."""
        mesh = self.mesh
        out = []
        for m, mb in enumerate(micro):
            rngs = None if step is None else self._micro_rngs(step, m)
            x_in = None
            if not self._first:
                b, s = mb[0].shape
                x_in = mesh.pipe_recv((b, s, self._hidden_size),
                                      self._dtype, -1)
                if step is not None:
                    x_in.requires_grad_()
            y = self._stage_forward(stage, mb, x_in, rngs, step is None)
            if not self._last:
                mesh.pipe_send(y, +1)
            out.append((x_in, y))
        return out

    def _cross_stage_grads(self, stage: PipelineStage) -> None:
        """Sum the prologue's and epilogue's gradients over the pipe axis
        (JAX ``_cross_stage_grads``): a stage whose replica did not reach
        the loss holds none, and the sum gives every replica the one
        gradient. A parameter no stage reached (XLNet's ``mask_emb``)
        stays without one, as on one device."""
        mesh = self.mesh
        shared = [p for part in (stage.prologue, stage.epilogue)
                  for p in part.parameters()]
        used = torch.tensor([p.grad is not None for p in shared],
                            dtype=torch.float32, device=self.device)
        mesh.all_reduce_(used, PIPE_AXIS)
        grads = []
        for p, u in zip(shared, used.tolist()):
            if u > 0:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        mesh.all_reduce_list_(grads, PIPE_AXIS)

    def _pp_step(self, state: TrainState, batch: Tuple,
                 valid: Optional[np.ndarray] = None):
        mesh, stage = self.mesh, state.model
        self._release_others()
        micro = self._micro(batch)
        if valid is not None:
            valid = np.asarray(valid, bool)
            weights = torch.from_numpy(
                mesh.local_rows(valid).astype(np.float32)).to(
                    self.device).chunk(self.n_micro)
        if isinstance(state.generator, ThreefryStream):
            # JAX pp.py:643-646: the explicit step's fold of the data index
            step = state.generator.step_key()
            if self._dp > 1:
                step = jax_random.fold_in(step, mesh.data_rank)
        else:
            step = draw_seed(state.generator) ^ _data_fold(mesh.data_rank)
        state.optimizer.zero_grad(set_to_none=True)
        ran = self._pipeline_forward(stage, micro, step)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for m in reversed(range(self.n_micro)):
            x_in, y = ran[m]
            ran[m] = None
            if self._last:
                labels = micro[m][5]
                if valid is None:
                    loss = mse_loss(y, labels)
                else:
                    err = torch.square(y - labels.reshape(-1).float())
                    loss = torch.sum(err * weights[m])
                total = total + loss.detach()
                loss.backward()
            else:
                y.backward(mesh.pipe_recv(y.shape, y.dtype, +1))
            if not self._first:
                mesh.pipe_send(x_in.grad, -1)
        del ran
        self._cross_stage_grads(stage)
        total = mesh.all_reduce_(total, PIPE_AXIS)
        if self._dp > 1:
            mesh.all_reduce_list_(
                [p.grad for p in stage.parameters() if p.grad is not None],
                mesh.data_axis)
            total = mesh.all_reduce_(total, mesh.data_axis)
        div = (max(float(valid.sum()), 1.0) if valid is not None
               else float(self.n_micro * self._dp))
        grads = [p.grad for p in stage.parameters() if p.grad is not None]
        torch._foreach_div_(grads, div)
        total = total / div
        state.optimizer.step()
        state.step += 1
        return total

    def _train_step(self, state: TrainState, batch: Tuple):
        return self._pp_step(state, batch)

    def _train_step_masked(self, state: TrainState, batch: Tuple, valid):
        return self._pp_step(state, batch, valid)

    @torch.inference_mode()
    def _pp_logits(self, stage: PipelineStage, batch: Tuple
                   ) -> torch.Tensor:
        """The deterministic pipelined forward: this data rank's [b]
        logits on every stage (the last stage's, summed over the pipe
        axis)."""
        self._release_others()
        ran = self._pipeline_forward(stage, self._micro(batch), None)
        b = batch[0].shape[0]
        logits = (torch.cat([y for _, y in ran]) if self._last
                  else torch.zeros(b, dtype=torch.float32,
                                   device=self.device))
        return self.mesh.all_reduce_(logits.clone(), PIPE_AXIS)

    def _eval_step(self, state: TrainState, batch: Tuple, valid):
        logits = self._pp_logits(state.model, batch)
        labels = batch[-1].reshape(-1).float()
        v = valid.to(torch.float32)
        return torch.sum(torch.square(logits - labels) * v), torch.sum(v)

    def _predict_step(self, state: TrainState, batch: Tuple):
        return (self._pp_logits(state.model, batch),
                batch[-1].reshape(-1).float())

    # ---- direct use ----------------------------------------------------

    def train_step(self, state: TrainState, batch: Tuple):
        """One pipelined optimizer step on a host batch (the global
        batch: each data rank takes its rows)."""
        return self._train_step(state, self._put_batch(batch))

    def predict(self, state: TrainState, batch: Tuple) -> torch.Tensor:
        """The deterministic pipelined forward of a host batch: [B] fp32
        logits, gathered over the data axis."""
        logits = self._pp_logits(state.model, self._put_batch(batch))
        return self.mesh.all_gather(logits, self.mesh.data_axis)
