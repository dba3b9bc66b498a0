"""Training / evaluation engine (port of ``training/trainer.py``, one
device).

* ``make_train_step`` — forward with dropout, MSE on the logits computed
  outside the model (as the reference does), backward, AdamW update;
  gradient accumulation splits the batch into ``grad_accum`` micro-batches,
  each with its own dropout draws, and averages their gradients;
* ``make_masked_train_step`` — the same for the ragged last batch, padded
  to shape with a validity mask: the loss is the masked mean;
* ``eval_step`` / ``predict_step`` — the deterministic forward, with
  validity masks so padded eval batches score every example once;
* ``make_mems_train_step`` / ``mems_eval_step`` / ``mems_predict_step`` —
  the same with XLNet's memory (segment recurrence) carried in and out of
  every step, chained through the micro-batches under grad accumulation;
* ``Trainer`` — the epoch loops (train_epoch / eval_epoch / test_epoch /
  test_score_model / train) with the JAX trainer's records; with
  ``mem_len`` the memory starts as zeros each epoch and each eval/test
  split and threads through the batch stream in order.

Losses stay on the device until an epoch ends; the dropout seeds come from
the state's CPU generator, or under ``rng_impl="threefry2x32"`` the keys
from the state's JAX key (``ops/dropout.py``), so a step never waits for
the card.

With a ``mesh`` (``parallel/mesh.py``; one Trainer per rank, each fed the
same global batches) each rank takes its data shard's rows, the gradients
are summed over the ``data`` axis and divided once (the ragged tail by its
global valid count), and eval sums and test predictions are gathered over
it; a model axis > 1 splits MAG-BERT Megatron-style (``parallel/tp.py``,
with ``tp_shard_attention`` the attention heads too). With ``fsdp`` the
params and AdamW's moments are stored sharded over the data axis and
gathered for each step, evaluation and prediction (``parallel/fsdp.py``).
The GPipe pipeline trainers subclass ``Trainer`` (``parallel/pp.py``,
``parallel/pp_xlnet.py``). With ``multiprocess`` the loader yields only
this process's rows (``parallel/multiprocess.py``), each rank takes its
own from them, the ragged tail's divisor is the valid count summed over
the data axis, and test predictions, labels and masks are gathered over
it. XLA compile options have no torch counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from bert_multimodal_transformer_tpu_torch.ops.dropout import (
    ThreefryRngs,
    ThreefryStream,
    draw_seed,
)
from bert_multimodal_transformer_tpu_torch.parallel import fsdp as fsdp_lib
from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib
from bert_multimodal_transformer_tpu_torch.parallel.mesh import Mesh
from bert_multimodal_transformer_tpu_torch.training import (
    metrics as metrics_lib,
)
from bert_multimodal_transformer_tpu_torch.training.losses import mse_loss
from bert_multimodal_transformer_tpu_torch.training.optim import AdamWHF
from bert_multimodal_transformer_tpu_torch.utils import jax_random

RNG_IMPLS = ("rbg", "threefry2x32")


@dataclasses.dataclass
class TrainState:
    """What a step reads and advances: the step count, the model (which
    holds the params), its optimizer (which holds the moments and the
    update count) and the stream every step's dropout draws from: a CPU
    generator (rbg) or the JAX key (threefry2x32, ``ThreefryStream``)."""

    step: int
    model: nn.Module
    optimizer: AdamWHF
    generator: Union[torch.Generator, ThreefryStream]


def _forward(model, batch, generator, deterministic: bool, mems=None):
    """(logits, labels), or (logits, labels, new memory) when ``mems`` is
    given: under use_cache the XLNet classifier returns (logits, new_mems,
    ...)."""
    input_ids, visual, acoustic, input_mask, segment_ids, label_ids = batch
    kw = dict(attention_mask=input_mask, token_type_ids=segment_ids,
              deterministic=deterministic,
              dropout_rng=None if deterministic else generator)
    if mems is not None:
        out = model(input_ids, visual, acoustic, mems=mems, use_cache=True,
                    **kw)
        return out[0], label_ids, out[1]
    return model(input_ids, visual, acoustic, **kw), label_ids


def _data_fold(data_rank: int) -> int:
    """What a data rank XORs into its step's dropout seed (0 for rank 0)."""
    return (data_rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1)


def _micro_rngs(generator, grad_accum: int, local_rows: int,
                mesh: Optional[Mesh], explicit: bool) -> list:
    """Each micro-batch's dropout stream. rbg: the state's generator (over
    data ranks a generator seeded from it with the data rank folded in).
    threefry2x32: the JAX step's keys, ``split(state.rng)`` and under
    accumulation ``split(rng, grad_accum)``; over data ranks each rank
    draws its rows of the global micro-batch's masks (the JAX GSPMD step's
    masks), its fused kernels' seeds folded with the data rank, or with
    ``explicit`` (the JAX shard_map step) ``fold_in(key, data_index)`` on
    its local rows."""
    n_data = mesh.data_size if mesh is not None else 1
    if not isinstance(generator, ThreefryStream):
        rng = generator
        if n_data > 1:
            rng = torch.Generator().manual_seed(
                draw_seed(rng) ^ _data_fold(mesh.data_rank))
        return [rng] * grad_accum
    key = generator.step_key()
    keys = [key] if grad_accum == 1 else jax_random.split(key, grad_accum)
    rows, fold = None, 0
    if n_data > 1 and explicit:
        keys = [jax_random.fold_in(k, mesh.data_rank) for k in keys]
    elif n_data > 1:
        per = local_rows // grad_accum
        rows, fold = (per * n_data, mesh.data_rank * per), _data_fold(
            mesh.data_rank)
    return [ThreefryRngs.from_key(k, rows, fold) for k in keys]


def _make_step(grad_accum: int, masked: bool, with_mems: bool = False,
               mesh: Optional[Mesh] = None, explicit: bool = False):
    """Shared train-step factory (see make_train_step /
    make_masked_train_step / make_mems_train_step for the semantics).
    Gradients of the micro-batches add up in ``.grad`` and are divided
    once, by ``grad_accum`` or by the valid count, as the JAX step divides
    its summed gradients. ``with_mems``: the step takes the memory after
    the batch (``valid`` after it) and returns (loss, new memory), the
    memory chained through the micro-batches.

    With ``mesh`` the batch is this rank's rows (``Mesh.local_rows`` with
    ``grad_accum``) and ``valid`` the global batch's mask (when the ranks
    run in several processes, this process's rows of it, and the divisor
    the valid count summed over the data axis): the model axis's
    partial gradients are summed (``parallel/tp.py::sync_grads``), then
    every gradient and the loss over the data axis, divided by
    grad_accum × data ranks, or by the global valid count. Over more than
    one data rank the step's dropout streams come from one seed drawn from
    the state's generator with the data rank folded in, so data shards draw
    different masks and the model ranks of a shard the same ones (the
    hidden dropout and the packed kernels draw on local rows; the split
    kernels' batch-row offset then changes nothing); under threefry each
    rank draws its rows of JAX's global masks (``_micro_rngs``;
    ``explicit``: the JAX shard_map step's folded keys). A model split by
    ``parallel/fsdp.py::shard_model_`` gathers its full weights before the
    forward and keeps its slice of each summed gradient (and of the
    weights) before the optimizer step."""
    n_data = mesh.data_size if mesh is not None else 1

    def train_step(state: TrainState, batch: Tuple, *rest):
        mems = rest[0] if with_mems else None
        valid = rest[-1] if masked else None
        b = batch[0].shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum={grad_accum}")
        micro = list(zip(*(t.chunk(grad_accum) for t in batch)))
        if masked:
            valid = np.asarray(valid, bool)
            local = (valid if mesh is None
                     else mesh.local_rows(valid, grad_accum))
            weights = torch.from_numpy(local.astype(np.float32)).to(
                batch[0].device).chunk(grad_accum)
            n_valid = float(valid.sum())
            if mesh is not None and mesh.num_processes > 1:
                # the other processes' rows are not here: sum the counts
                n_valid = float(mesh.all_reduce_(
                    torch.tensor(float(local.sum()), device=batch[0].device),
                    mesh.data_axis))
        rngs = _micro_rngs(state.generator, grad_accum, b, mesh, explicit)
        state.optimizer.zero_grad(set_to_none=True)
        fsdp_lib.gather_params_(state.model)
        total = None
        for i, mb in enumerate(micro):
            if with_mems:
                logits, labels, mems = _forward(state.model, mb, rngs[i],
                                                False, mems)
            else:
                logits, labels = _forward(state.model, mb, rngs[i],
                                          deterministic=False)
            if masked:
                err = torch.square(logits.reshape(-1).float()
                                   - labels.reshape(-1).float())
                loss = torch.sum(err * weights[i])
            else:
                loss = mse_loss(logits, labels)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        div = (max(n_valid, 1.0) if masked
               else float(grad_accum * n_data))
        if mesh is not None:
            tp_lib.sync_grads(state.model, mesh)
            if n_data > 1:
                mesh.all_reduce_list_(
                    [p.grad for p in state.model.parameters()
                     if p.grad is not None], mesh.data_axis)
                total = mesh.all_reduce_(total.clone(), mesh.data_axis)
        fsdp_lib.keep_grad_shards_(state.model)
        if div != 1.0:
            grads = [p.grad for p in state.model.parameters()
                     if p.grad is not None]
            torch._foreach_div_(grads, div)
            total = total / div
        state.optimizer.step()
        state.step += 1
        return (total, mems) if with_mems else total

    return train_step


def make_train_step(grad_accum: int = 1, mesh: Optional[Mesh] = None,
                    explicit: bool = False):
    """The train step: ``step(state, batch) -> loss`` (a device scalar).

    With grad_accum > 1 the batch splits into grad_accum micro-batches of
    B/grad_accum rows and the gradients are averaged — the reference's
    loss/accum scaling. ``mesh``, ``explicit``: see ``_make_step``."""
    return _make_step(grad_accum, masked=False, mesh=mesh, explicit=explicit)


def make_masked_train_step(grad_accum: int = 1,
                           mesh: Optional[Mesh] = None):
    """Train step for the final RAGGED batch: ``step(state, batch, valid)``
    with the batch zero-padded to shape and ``valid`` its host bool mask;
    loss = masked mean. The reference trains on the ragged tail as a
    smaller batch; the masked mean over the padded batch is the same
    math. ``mesh``: see ``_make_step``."""
    return _make_step(grad_accum, masked=True, mesh=mesh)


def make_mems_train_step(masked: bool, grad_accum: int = 1,
                         mesh: Optional[Mesh] = None):
    """The train step with XLNet's memory (JAX ``make_mems_train_step``):
    ``step(state, batch, mems[, valid]) -> (loss, new_mems)``, ``mems`` one
    [B/grad_accum, mem_len, D] tensor per layer. With grad_accum > 1 the
    batch's A·B rows run as A sequential micro-batches of B rows and the
    memory chains through them (micro-batch i reads micro-batch i−1's
    cache) while the gradients accumulate against the step's params; the
    memory returned is the last micro-batch's. ``masked``: the ragged tail
    batch's masked mean, its memory carried as any other's. ``mesh``: over
    data ranks each rank carries its rows' memory, [B/(grad_accum·D),
    mem_len, D] a layer, and the gradients and the loss are summed over
    the data axis as ``_make_step`` does (the JAX step shards the memory
    over the batch axis)."""
    return _make_step(grad_accum, masked=masked, with_mems=True, mesh=mesh)


def attach_grad_norm(optimizer: AdamWHF, mesh: Optional[Mesh]) -> AdamWHF:
    """Over a mesh, clipping reads the whole model's gradient norm
    (``parallel/fsdp.py::global_grad_norm``), not this rank's shards'."""
    if mesh is not None:
        optimizer.grad_norm_fn = functools.partial(fsdp_lib.global_grad_norm,
                                                   mesh=mesh)
    return optimizer


@torch.inference_mode()
def eval_step(state: TrainState, batch: Tuple, valid: torch.Tensor):
    """Masked dev-set MSE: returns (sum_sq_err, n_valid) so ragged final
    batches contribute exactly their real examples."""
    logits, labels = _forward(state.model, batch, None, deterministic=True)
    err = torch.square(logits.reshape(-1) - labels.reshape(-1))
    v = valid.to(torch.float32)
    return torch.sum(err * v), torch.sum(v)


@torch.inference_mode()
def predict_step(state: TrainState, batch: Tuple):
    logits, labels = _forward(state.model, batch, None, deterministic=True)
    return logits.reshape(-1), labels.reshape(-1)


@torch.inference_mode()
def mems_eval_step(state: TrainState, batch: Tuple, valid: torch.Tensor,
                   mems):
    """``eval_step`` with the memory: (sum_sq_err, n_valid, new_mems)."""
    logits, labels, new_mems = _forward(state.model, batch, None, True, mems)
    err = torch.square(logits.reshape(-1) - labels.reshape(-1))
    v = valid.to(torch.float32)
    return torch.sum(err * v), torch.sum(v), new_mems


@torch.inference_mode()
def mems_predict_step(state: TrainState, batch: Tuple, mems):
    """``predict_step`` with the memory: (preds, labels, new_mems)."""
    logits, labels, new_mems = _forward(state.model, batch, None, True, mems)
    return logits.reshape(-1), labels.reshape(-1), new_mems


# The JAX trainer's ``compiler_options`` are XLA compiler flags; no torch
# call takes them.
COMPILER_OPTIONS_REFUSAL = (
    "compiler_options are XLA compiler options (the JAX package's jit); the "
    "PyTorch port compiles no XLA program and has no counterpart for them")


@dataclasses.dataclass
class Trainer:
    """Epoch-level trainer on the device that holds the model's params.

    ``model`` is any module with the MAG-classifier call signature
    (input_ids, visual, acoustic, attention_mask=, token_type_ids=,
    deterministic=, dropout_rng=) → logits; ``tx`` the optimizer factory
    of ``optim.make_optimizer``. The step updates the params in place.

    ``mesh`` (``parallel/mesh.py::make_mesh``): this rank's place in a
    (data, model) mesh; every rank builds its Trainer over the full-size
    model and is fed the same global batches. A model axis > 1 shards the
    model in place (``parallel/tp.py::shard_model_``: MAG-BERT or
    MAG-XLNet);
    ``tp_shard_attention`` head-shards its attention too, with the JAX
    trainer's guards. ``create_state_from_params`` then takes the full
    state dict and keeps this rank's chunks.

    ``mem_len`` (XLNet segment recurrence) must equal the model config's:
    a fixed-shape zero memory, n_layer × [B, mem_len, D] at the model
    dtype, starts each epoch and each eval/test split and is carried from
    batch to batch in order (B = the micro-batch rows under grad
    accumulation, a data rank's share of them over a mesh). As in the JAX
    trainer the zero positions are attended until real segments flush
    them.

    ``rng_impl``: "rbg" (the default) draws every step's dropout from a
    CPU generator; "threefry2x32" from the state's JAX key, as the JAX
    trainer under ``jax_default_prng_impl = "threefry2x32"``: the params
    of ``init_state(seed)`` are ``model.init(PRNGKey(seed))``'s, the state
    key ``fold_in(PRNGKey(seed), 1)``, and each step draws JAX's masks
    (``ops/dropout.py``).

    ``multiprocess``: the loaders yield this process's rows of each global
    batch (``parallel/multiprocess.py::ShardedBatchIterator``), and every
    process scores the whole test split (the predictions gathered over the
    data axis). Not with ``mem_len``, as in the JAX trainer. The mesh
    records the processes (``make_mesh(num_processes=)``) and the rows
    follow it; a mesh over several processes without ``multiprocess``
    raises. In one process ``multiprocess`` changes nothing, as in JAX.
    """

    model: nn.Module
    tx: Callable
    mesh: Optional[object] = None
    grad_accum: int = 1
    tp_shard_attention: bool = False
    fsdp: bool = False
    mem_len: Optional[int] = None
    compiler_options: Optional[dict] = None
    multiprocess: bool = False
    rng_impl: str = "rbg"

    def __post_init__(self):
        if self.rng_impl not in RNG_IMPLS:
            raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got "
                             f"{self.rng_impl!r}")
        if self.multiprocess and self.mem_len is not None:
            # the JAX trainer's refusal
            raise ValueError(
                "multiprocess does not compose with mem_len (the memory "
                "init builds [B, mlen, D] zeros from the local batch "
                "shape; global assembly for mems is not implemented)")
        if self.compiler_options:
            raise ValueError(COMPILER_OPTIONS_REFUSAL)
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(
                "Trainer(mesh=...) takes a parallel.mesh.Mesh "
                f"(parallel.mesh.make_mesh), got {type(self.mesh).__name__}")
        if (self.mesh is not None and self.mesh.num_processes > 1
                and not self.multiprocess):
            raise ValueError(
                f"the mesh's ranks run in {self.mesh.num_processes} "
                "processes, each loading only its own rows: build the "
                "Trainer with multiprocess=True")
        mp = self.mesh.model_size if self.mesh is not None else 1
        cfg = getattr(self.model, "config", None)
        if self.tp_shard_attention:
            # the JAX trainer's guards of the CLI's preconditions
            impl = getattr(cfg, "attention_impl", "einsum")
            if mp <= 1:
                raise ValueError(
                    "tp_shard_attention requires a mesh model axis > 1")
            if impl == "flash":
                raise ValueError(
                    "tp_shard_attention supports einsum and fused "
                    "attention, not flash")
            if (impl == "fused"
                    and getattr(cfg, "tp_attention_mesh", None) is None):
                raise ValueError(
                    "tp_shard_attention with the fused kernels needs the "
                    "model built with tp_attention_mesh=<mesh> (the split "
                    "kernels run on each rank's heads; ops/fused_attention.py"
                    "::fused_attention_tp)")
            n_head = getattr(cfg, "n_head",
                             getattr(cfg, "num_attention_heads", 0))
            if n_head % mp != 0:
                raise ValueError(
                    f"tp_shard_attention needs n_head ({n_head}) divisible "
                    f"by the model-axis size ({mp})")
        tp_mesh = getattr(cfg, "tp_attention_mesh", None)
        if tp_mesh is not None and (tp_mesh is not self.mesh
                                    or not self.tp_shard_attention):
            raise ValueError(
                "a model built with tp_attention_mesh trains with "
                "Trainer(mesh=<that mesh>, tp_shard_attention=True)")
        if self.mem_len is not None and (mp > 1 or self.fsdp):
            # the JAX trainer's refusal
            raise ValueError("mem_len supports the data-parallel trainer "
                             "(mems shard over the batch axis)")
        if mp > 1:
            tp_lib.shard_model_(self.model, self.mesh,
                                self.tp_shard_attention)
        self.device = next(self.model.parameters()).device
        self._train_step = make_train_step(self.grad_accum, self.mesh)
        self._train_step_masked = make_masked_train_step(
            self.grad_accum, self.mesh)
        if self.mem_len is not None:
            cfg = getattr(self.model, "config", None)
            if getattr(cfg, "mem_len", None) != self.mem_len:
                raise ValueError(
                    f"Trainer(mem_len={self.mem_len}) needs the model "
                    f"built with config.mem_len={self.mem_len} (got "
                    f"{getattr(cfg, 'mem_len', None)}): the model's "
                    "memory update reads its own config")
            self._train_step_mems = make_mems_train_step(
                masked=False, grad_accum=self.grad_accum, mesh=self.mesh)
            self._train_step_mems_masked = make_mems_train_step(
                masked=True, grad_accum=self.grad_accum, mesh=self.mesh)

    def _init_mems(self, batch, *, for_train: bool = False):
        """A fresh zero memory for a new epoch or split: n_layer ×
        [B, mem_len, d_model] at the model dtype on the params' device.
        With grad accumulation a train batch holds A·B rows that run as A
        sequential B-row segments, so the memory is B rows; over a mesh, a
        data rank's share of them."""
        cfg = self.model.config
        b = np.asarray(batch[0]).shape[0]
        if for_train:
            b //= self.grad_accum
        if self.mesh is not None:
            b //= self.mesh.data_size
        dt = getattr(self.model, "dtype", torch.float32)
        return tuple(torch.zeros((b, self.mem_len, cfg.d_model), dtype=dt,
                                 device=self.device)
                     for _ in range(cfg.n_layer))

    def init_state(self, seed: int) -> TrainState:
        """Draw the params from ``seed`` (on the params' device; at full
        size under FSDP, every rank alike) and start the dropout stream.
        rbg: ``model.init_params`` from a generator seeded with ``seed``,
        the stream at ``seed + 1``. threefry2x32: the JAX trainer's
        ``model.init(PRNGKey(seed))`` (``model.init_params_threefry``) and
        state key ``fold_in(PRNGKey(seed), 1)``."""
        fsdp_lib.gather_params_(self.model)
        if self.rng_impl == "threefry2x32":
            key = jax_random.PRNGKey(seed)
            self.model.init_params_threefry(key)
            rng = ThreefryStream(jax_random.fold_in(key, 1))
        else:
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(seed))
            rng = seed + 1
        fsdp_lib.reshard_(self.model)
        return self.create_state_from_params(None, rng)

    def create_state_from_params(
            self, params: Optional[Dict[str, torch.Tensor]],
            rng: Union[int, torch.Generator, tuple, ThreefryStream]
    ) -> TrainState:
        """A fresh state over ``params`` (a full-size state_dict, of which
        a sharded rank keeps its chunks and slices; None keeps the model's
        weights) with the dropout stream ``rng``: under rbg an int seed or
        a CPU generator; under threefry2x32 a key (two uint32 words), an
        int seed (``PRNGKey(rng)``, as the JAX tests pass
        ``PRNGKey(1)``) or a ``ThreefryStream``. Under ``fsdp`` the model
        is split over the data axis here, before the optimizer is
        built."""
        if params is not None:
            self.model.load_state_dict(
                tp_lib.local_state_dict(self.model, params))
        if self.fsdp and self.mesh is not None:
            fsdp_lib.shard_model_(self.model, self.mesh,
                                  self.tp_shard_attention)
        if self.rng_impl == "threefry2x32":
            if not isinstance(rng, ThreefryStream):
                rng = ThreefryStream(jax_random.PRNGKey(rng)
                                     if isinstance(rng, int) else rng)
        elif not isinstance(rng, torch.Generator):
            rng = torch.Generator().manual_seed(int(rng))
        optimizer = attach_grad_norm(self.tx(self.model.named_parameters()),
                                     self.mesh)
        return TrainState(step=0, model=self.model, optimizer=optimizer,
                          generator=rng)

    def _put(self, a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _put_batch(self, batch, micro: int = 1):
        """The batch on the device: with a mesh, this rank's rows of it
        (``Mesh.local_rows`` over ``micro`` micro-batches; of this
        process's rows under ``multiprocess``)."""
        if self.mesh is not None:
            batch = tuple(self.mesh.local_rows(np.asarray(a), micro)
                          for a in batch)
        return tuple(self._put(a) for a in batch)

    def _put_valid(self, valid) -> torch.Tensor:
        if self.mesh is not None:
            valid = self.mesh.local_rows(np.asarray(valid))
        return self._put(valid)

    def train_epoch(self, state: TrainState, loader
                    ) -> Tuple[TrainState, float]:
        """Mean loss over one epoch. A ragged final batch (loader with
        drop_remainder=False) trains through the masked step."""
        state, loss, _ = self._train_epoch(state, loader)
        return state, loss

    def _train_epoch(self, state: TrainState, loader, *,
                     start_batch: int = 0, step_callback=None,
                     max_steps: Optional[int] = None):
        """train_epoch plus resume: skip the first ``start_batch`` batches
        (the loader replays the same shuffle, see
        BatchIterator.restore_position), call ``step_callback(state,
        batch_idx)`` after each optimizer step, and stop mid-epoch after
        ``max_steps`` steps. Returns (state, mean_loss, {"steps": n,
        "stopped_at_batch": next batch to train, or None})."""
        losses = []
        stopped_at = None
        n_batches = len(loader) if hasattr(loader, "__len__") else None
        if start_batch and hasattr(loader, "iter_from"):
            it = enumerate(loader.iter_from(start_batch), start=start_batch)
        else:
            it = enumerate(loader)
        mems = None  # a fresh memory each epoch (and after a resume)
        for bi, (batch, valid) in it:
            if bi < start_batch:
                continue
            if self.mem_len is not None:
                if mems is None:
                    mems = self._init_mems(batch, for_train=True)
                if valid.all():
                    loss, mems = self._train_step_mems(
                        state, self._put_batch(batch, self.grad_accum), mems)
                else:
                    loss, mems = self._train_step_mems_masked(
                        state, self._put_batch(batch, self.grad_accum), mems,
                        valid)
            elif valid.all():
                loss = self._train_step(
                    state, self._put_batch(batch, self.grad_accum))
            else:
                loss = self._train_step_masked(
                    state, self._put_batch(batch, self.grad_accum), valid)
            losses.append(loss)
            if step_callback is not None:
                step_callback(state, bi)
            if (max_steps is not None and len(losses) >= max_steps
                    and (n_batches is None or bi + 1 < n_batches)):
                stopped_at = bi + 1
                break
        mean = (float(np.mean(torch.stack(losses).cpu().numpy()))
                if losses else 0.0)
        return state, mean, {"steps": len(losses),
                             "stopped_at_batch": stopped_at}

    def _eval_step(self, state: TrainState, batch: Tuple,
                   valid: torch.Tensor):
        return eval_step(state, batch, valid)

    def _predict_step(self, state: TrainState, batch: Tuple):
        return predict_step(state, batch)

    def eval_epoch(self, state: TrainState, loader) -> float:
        """Mean dev MSE over every real example; partial sums stay on the
        device, one host sync at the end. With ``mem_len`` the memory
        threads through the split from zeros. Under FSDP the full weights
        are gathered for the split."""
        with fsdp_lib.full_params(state.model):
            return self._eval_epoch(state, loader)

    def _eval_epoch(self, state: TrainState, loader) -> float:
        sums, mems = [], None
        for batch, valid in loader:
            if self.mem_len is None:
                sums.append(self._eval_step(state, self._put_batch(batch),
                                            self._put_valid(valid)))
                continue
            if mems is None:
                mems = self._init_mems(batch)
            s, c, mems = mems_eval_step(
                state, self._put_batch(batch), self._put_valid(valid), mems)
            sums.append((s, c))
        if not sums:
            return 0.0
        tot_cnt = torch.stack([torch.stack([s for s, _ in sums]).sum(),
                               torch.stack([c for _, c in sums]).sum()])
        if self.mesh is not None:
            self.mesh.all_reduce_(tot_cnt, self.mesh.data_axis)
        tot, cnt = (float(x) for x in tot_cnt)
        return tot / max(cnt, 1.0)

    def test_epoch(self, state: TrainState, loader):
        with fsdp_lib.full_params(state.model):
            return self._test_epoch(state, loader)

    def _test_epoch(self, state: TrainState, loader):
        preds, labels = [], []
        mems = None
        for batch, valid in loader:
            if self.mem_len is None:
                p, lab = self._predict_step(state, self._put_batch(batch))
            else:
                if mems is None:
                    mems = self._init_mems(batch)
                p, lab, mems = mems_predict_step(
                    state, self._put_batch(batch), mems)
            if self.mesh is not None:
                p, lab = (self.mesh.all_gather(x, self.mesh.data_axis)
                          for x in (p, lab))
                if self.mesh.num_processes > 1:
                    # every process scores the whole split
                    mine = self.mesh.local_rows(np.asarray(valid, np.uint8))
                    valid = self.mesh.all_gather(
                        self._put(mine), self.mesh.data_axis
                    ).cpu().numpy().astype(bool)
            preds.append(p.cpu().numpy()[valid])
            labels.append(lab.cpu().numpy()[valid])
        return np.concatenate(preds), np.concatenate(labels)

    def test_score_model(self, state: TrainState, loader,
                         use_zero: bool = False) -> Dict[str, float]:
        preds, labels = self.test_epoch(state, loader)
        return metrics_lib.score_regression(preds, labels, use_zero=use_zero)

    def train(self, state: TrainState, train_loader, dev_loader, test_loader,
              n_epochs: int, logger=None,
              epoch_callback=None, use_zero: bool = False,
              start_epoch: int = 0, start_batch: int = 0,
              initial_history=None, step_callback=None,
              max_steps: Optional[int] = None
              ) -> Tuple[TrainState, Dict]:
        """The epoch loop, with the JAX trainer's per-epoch records.
        ``epoch_callback(state, epoch)`` runs after each epoch's logging;
        ``step_callback(state, epoch, batch_idx)`` after every optimizer
        step. ``start_epoch``/``start_batch``/``initial_history`` resume an
        interrupted run (position the train loader with
        BatchIterator.restore_position first); ``max_steps`` stops after
        that many steps in this call, and the summary's "interrupted"
        entry then holds the resume position {"epoch", "next_batch"}."""
        history = list(initial_history or [])
        valid_losses = [r["valid_loss"] for r in history]
        test_accs = [r["test_acc"] for r in history]
        steps_left = max_steps
        interrupted = None
        for epoch_i in range(int(start_epoch), int(n_epochs)):
            t0 = time.monotonic()
            cb = None
            if step_callback is not None:
                def cb(st, bi, _e=epoch_i):
                    step_callback(st, _e, bi)
            state, train_loss, info = self._train_epoch(
                state, train_loader,
                start_batch=start_batch if epoch_i == start_epoch else 0,
                step_callback=cb, max_steps=steps_left)
            if steps_left is not None:
                steps_left -= info["steps"]
            if info["stopped_at_batch"] is not None:
                interrupted = {"epoch": epoch_i,
                               "next_batch": info["stopped_at_batch"]}
                break
            valid_loss = self.eval_epoch(state, dev_loader)
            scores = self.test_score_model(state, test_loader,
                                           use_zero=use_zero)
            dt = time.monotonic() - t0
            valid_losses.append(valid_loss)
            test_accs.append(scores["acc"])
            record = {
                "epoch": epoch_i,
                "train_loss": train_loss,
                # a mid-epoch-resumed epoch's train_loss averages only the
                # post-resume batches
                **({"resumed_mid_epoch": True}
                   if epoch_i == start_epoch and start_batch else {}),
                "valid_loss": valid_loss,
                "test_acc": scores["acc"],
                "test_mae": scores["mae"],
                "test_corr": scores["corr"],
                "test_f_score": scores["f_score"],
                "best_valid_loss": min(valid_losses),
                "best_test_acc": max(test_accs),
                "epoch_seconds": dt,
            }
            history.append(record)
            if logger is not None:
                logger.log(record)
            if epoch_callback is not None:
                epoch_callback(state, epoch_i)
            if (steps_left is not None and steps_left <= 0
                    and epoch_i + 1 < int(n_epochs)):
                interrupted = {"epoch": epoch_i + 1, "next_batch": 0}
                break
        return state, {"history": history,
                       "best_valid_loss": min(valid_losses) if valid_losses
                       else float("inf"),
                       "best_test_acc": max(test_accs) if test_accs else 0.0,
                       "interrupted": interrupted}
