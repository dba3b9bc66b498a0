"""Batch inference / serving (port of ``serving.py``'s ``Predictor``).

    predictor = Predictor(model, batch_size=128)
    preds = predictor.predict_split(packed_split)   # [N] float32
    scores = predictor.score_split(packed_split)    # Acc-2/MAE/corr/F1

The model runs on the device its params live on. With ``mem_len`` (XLNet
segment recurrence) ``predict_split`` threads the memory through the
ordered batch stream, as the model was trained. With ``mesh`` (one
Predictor per rank, each given the same requests) a batch's rows split over
the data axis and the predictions are gathered in order, and a model axis
> 1 runs MAG-BERT tensor-parallel (``parallel/tp.py``).
``Predictor.from_checkpoint`` serves the latest training checkpoint
(``utils/checkpoint.py``).

The serving artifact (JAX ``serving.py``'s export half):

    program = export_forward(model, seq_len=50, visual_dim=47,
                             acoustic_dim=74)
    save_artifact("model.pt2", program, meta={"family": "bert"})
    serve = load_artifact("model.pt2", device="cuda")
    logits = serve(input_ids, visual, acoustic, attention_mask,
                   token_type_ids)
    preds, labels = predict_batches(serve, loader)

``export_forward`` writes the deterministic forward with its weights as a
``torch.export`` program, the batch dimension symbolic, and a JSON sidecar
(``path.json``) records its calling convention. The default artifact is
portable: a copy of the model on the einsum attention and the plain MAG
gate, only ``aten`` ops, so ``torch`` alone loads and runs it (on the card
or the CPU). ``keep_attention_impl=True`` keeps the fused kernels, as the
port's custom ops (``ops/export_ops.py``), for a fixed batch on CUDA.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.models.mag import MAG
from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib
from bert_multimodal_transformer_tpu_torch.parallel.mesh import Mesh
from bert_multimodal_transformer_tpu_torch.training import (
    metrics as metrics_lib,
)


@dataclasses.dataclass
class _Handle:
    """Predictions of one dispatched batch: on CUDA a pinned host buffer
    that an asynchronous copy fills, and the event that marks the copy
    done; on the CPU the result itself."""

    host: torch.Tensor
    done: Optional[torch.cuda.Event] = None


class Predictor:
    """Fixed-shape batch predictor.

    ``wire_dtype`` (e.g. ``torch.bfloat16``) casts the float modality
    features (visual/acoustic, the bulk of a request) on the host before
    the device transfer. With a bf16-compute model this loses nothing: the
    model casts those inputs to bf16 anyway.

    ``prefetch`` keeps up to that many batches in flight during
    ``predict_split``: CUDA work is asynchronous, so batch n+1 is staged
    (host cast, pinned copy, forward enqueued) before batch n's
    predictions are fetched, and the fetch waits only for batch n's
    device-to-host copy. 0 gives the strictly serial loop.

    ``mem_len`` (XLNet) must equal the model config's: ``predict_split``
    then starts a zero memory (n_layer × [batch_size, mem_len, D] at the
    model dtype) and carries it from batch to batch in order, the way
    ``Trainer.test_epoch`` scores a memory-trained model. Such a predictor
    serves no independent requests (``submit``/``predict_requests``
    refuse): the memory makes each batch depend on the ones before it.

    ``mesh`` (JAX ``Predictor(mesh=)``): this rank's place in a (data,
    model) mesh. Each batch's rows split over the data axis (the batch size
    a multiple of its size) and every rank returns all the predictions,
    gathered in order. A model axis > 1 shards the full-size model in
    place (``parallel/tp.py::shard_model_``), with the attention
    head-sharded when its config has ``tp_attention_mesh``.
    """

    def __init__(self, model: torch.nn.Module, device=None,
                 batch_size: int = 128,
                 wire_dtype: Optional[torch.dtype] = None,
                 prefetch: int = 2, mem_len: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        # num_labels == 1 → regression [B]; > 1 → class logits [B, C]
        self.num_labels = getattr(getattr(model, "config", None),
                                  "num_labels", 1)
        self.model = model
        self.device = (torch.device(device) if device is not None
                       else next(model.parameters()).device)
        self.batch_size = batch_size
        self.wire_dtype = wire_dtype
        self.prefetch = prefetch
        self.mem_len = mem_len
        self.mesh = mesh
        cfg = getattr(model, "config", None)
        if mem_len is not None:
            if getattr(cfg, "mem_len", None) != mem_len:
                raise ValueError(
                    f"Predictor(mem_len={mem_len}) needs the model built "
                    f"with config.mem_len={mem_len} (got "
                    f"{getattr(cfg, 'mem_len', None)})")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    "Predictor(mesh=...) takes a parallel.mesh.Mesh, got "
                    f"{type(mesh).__name__}")
            if mem_len is not None and mesh.size > 1:
                raise NotImplementedError(
                    "mem_len over a mesh of more than one rank is not "
                    "ported yet (ROADMAP A.10)")
            if batch_size % mesh.data_size:
                raise ValueError(
                    f"batch_size={batch_size} does not split over "
                    f"{mesh.data_size} data ranks")
            tp_mesh = getattr(cfg, "tp_attention_mesh", None)
            if tp_mesh is not None and tp_mesh is not mesh:
                raise ValueError("the model's tp_attention_mesh is not the "
                                 "Predictor's mesh")
            if mesh.model_size > 1:
                tp_lib.shard_model_(model, mesh, tp_mesh is not None)

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, checkpoint_dir: str,
                        **kw) -> "Predictor":
        """A predictor over ``model`` with the params of the latest
        checkpoint under ``checkpoint_dir`` loaded into it (a params-only
        restore: no optimizer state is read). ``kw`` go to the
        constructor. A model already sharded over a mesh takes its
        chunks. A checkpoint of any trainer serves: plain, tensor-parallel
        and FSDP runs write the model layout at full size, and a
        pipelined run's pipeline layout is turned back into it (JAX
        ``driver.py:630-640``)."""
        from bert_multimodal_transformer_tpu_torch.parallel.pp import (
            is_pp_layout,
            model_params_from_pp_params,
        )
        from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
            CheckpointManager,
        )

        params = CheckpointManager(checkpoint_dir).restore_params()
        if params is None:
            raise FileNotFoundError(
                f"no checkpoint found under {checkpoint_dir}")
        if is_pp_layout(params):
            params = model_params_from_pp_params(params)
        model.load_state_dict(tp_lib.local_state_dict(model, params))
        return cls(model, **kw)

    def _init_mems(self):
        cfg = self.model.config
        dt = getattr(self.model, "dtype", torch.float32)
        return tuple(torch.zeros((self.batch_size, self.mem_len,
                                  cfg.d_model), dtype=dt, device=self.device)
                     for _ in range(cfg.n_layer))

    def _to_device(self, x, cast: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
        x = np.asarray(x)
        if self.mesh is not None:
            x = self.mesh.local_rows(x)
        t = torch.as_tensor(x)
        if cast is not None:
            t = t.to(cast)
        if self.device.type == "cuda":
            # pinned, so the copy is asynchronous and overlaps the device
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _dispatch(self, input_ids, visual, acoustic, input_mask,
                  segment_ids, mems=None):
        """Enqueue one batch; returns (its handle, the new memory when
        ``mems`` is given, else None)."""
        args = (self._to_device(input_ids),
                self._to_device(visual, self.wire_dtype),
                self._to_device(acoustic, self.wire_dtype),
                self._to_device(input_mask),
                self._to_device(segment_ids))
        with torch.inference_mode():
            kw = dict(attention_mask=args[3], token_type_ids=args[4],
                      deterministic=True)
            if mems is None:
                logits = self.model(*args[:3], **kw)
            else:
                logits, mems = self.model(*args[:3], mems=mems,
                                          use_cache=True, **kw)[:2]
            if self.num_labels == 1:
                out = logits.reshape(-1)
            else:
                out = logits.reshape(-1, self.num_labels)
            if self.mesh is not None:
                out = self.mesh.all_gather(out, self.mesh.data_axis)
            if not out.is_cuda:
                return _Handle(out), mems
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _Handle(host, done), mems

    def predict_split(self, split: PackedSplit) -> np.ndarray:
        """Predictions for every example, in order: [N] regression values
        (num_labels=1) or [N, C] class logits (num_labels>1)."""
        it = BatchIterator(split, self.batch_size, shuffle=False,
                           drop_remainder=False)
        preds = []
        pending = deque()  # (handle, valid mask) in order
        mems = self._init_mems() if self.mem_len is not None else None
        for batch, valid in it:
            # the memory chain stays on the device: prefetch still overlaps
            handle, mems = self._dispatch(*batch[:5], mems=mems)
            pending.append((handle, valid))
            while len(pending) > max(self.prefetch, 0):
                handle, v = pending.popleft()
                preds.append(self.fetch(handle)[v])
        while pending:
            handle, v = pending.popleft()
            preds.append(self.fetch(handle)[v])
        if not preds:
            shape = (0,) if self.num_labels == 1 else (0, self.num_labels)
            return np.empty(shape, np.float32)
        return np.concatenate(preds)

    def submit(self, input_ids, visual, acoustic, input_mask,
               segment_ids) -> _Handle:
        """Dispatch one independent request without waiting for it: host
        cast, transfer, forward and the copy back are enqueued; pair the
        returned handle with :meth:`fetch`. Not for a memory predictor,
        whose batches depend on the ones before (use predict_split)."""
        if self.mem_len is not None:
            raise ValueError(
                "submit/fetch serve independent requests; a mems "
                "predictor's memory chain makes batches order-dependent "
                "— use predict_split")
        return self._dispatch(input_ids, visual, acoustic, input_mask,
                              segment_ids)[0]

    @staticmethod
    def fetch(handle: _Handle) -> np.ndarray:
        """Wait for one submitted request and return host predictions."""
        if handle.done is not None:
            handle.done.synchronize()
        return handle.host.numpy()

    def predict_requests(self, requests, in_flight: int = 2):
        """Serve a stream of independent requests, keeping up to
        ``in_flight`` dispatched ahead of the fetch point. ``requests``
        yields (input_ids, visual, acoustic, input_mask, segment_ids)
        tuples; predictions are yielded per request, in order.
        ``in_flight=1`` is the synchronous loop."""
        if in_flight < 1:
            raise ValueError(f"in_flight must be >= 1, got {in_flight}")
        pending = deque()
        for req in requests:
            pending.append(self.submit(*req))
            while len(pending) >= in_flight:
                yield self.fetch(pending.popleft())
        while pending:
            yield self.fetch(pending.popleft())

    def predict_classes(self, split: PackedSplit) -> np.ndarray:
        """Argmax class ids for a num_labels>1 head."""
        if self.num_labels == 1:
            raise ValueError(
                "predict_classes needs a classification head "
                "(num_labels>1); use predict_split for regression")
        return np.argmax(self.predict_split(split), axis=-1)

    def score_split(self, split: PackedSplit,
                    use_zero: bool = False) -> Dict[str, float]:
        """MOSI-standard regression scoring (num_labels=1) or
        accuracy/weighted-F1 classification scoring (num_labels>1)."""
        if self.num_labels == 1:
            return metrics_lib.score_regression(
                self.predict_split(split), split.label_ids,
                use_zero=use_zero)
        return metrics_lib.score_classification(
            self.predict_classes(split), split.label_ids)


# ---- the serving artifact ---------------------------------------------------
#
# The reference's deployment story ends at an in-memory torch state_dict
# (multimodal_driver.py:483-552 keeps ``best_model`` and never writes it).
# Portability is the contract, so the export re-builds the model on the
# einsum attention and the plain MAG gate by default: the fused kernels
# serialize as the port's ``magtorch`` custom ops, which a loader can run
# only with this package's kernels at hand. ``keep_attention_impl=True``
# exports them anyway, for a deployment that ships the package
# (platforms then CUDA only).

_MAGIC = "magtorch-serving"
_VERSION = 1
_INPUTS = ("input_ids", "visual", "acoustic", "attention_mask",
           "token_type_ids")
# the calling convention's dtypes, as the JAX artifact's
_INPUT_DTYPES = (torch.int32, torch.float32, torch.float32, torch.int32,
                 torch.int32)
# the largest batch a symbolic artifact takes
_MAX_BATCH = 1 << 20


class _Forward(torch.nn.Module):
    """The trainer's predict signature over a classification model: the
    deterministic forward's logits (XLNet without a memory)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, input_ids, visual, acoustic, attention_mask,
                token_type_ids):
        out = self.model(input_ids, visual, acoustic,
                         attention_mask=attention_mask,
                         token_type_ids=token_type_ids, deterministic=True)
        return out[0] if isinstance(out, tuple) else out


def _serving_copy(model: torch.nn.Module, params, portable: bool
                  ) -> torch.nn.Module:
    """A fresh unsharded model of ``model``'s class and config, with
    ``params`` (default ``model``'s) loaded and no gradient. ``portable``:
    on the einsum attention and the plain MAG gate. No copy holds a mesh:
    the port's ranks are processes, and the serving forward is one
    program."""
    cfg = dataclasses.replace(model.config, tp_attention_mesh=None)
    mm = model.multimodal_config
    if portable:
        cfg = dataclasses.replace(cfg, attention_impl="einsum")
        mm = dataclasses.replace(mm, use_fused_kernel=False)
    mag = next(m for m in model.modules() if isinstance(m, MAG))
    device = next(model.parameters()).device
    copy = type(model)(cfg, mm, mag.visual_dim, mag.acoustic_dim,
                       model.dtype, device=device)
    copy.load_state_dict(model.state_dict() if params is None else params)
    return copy.requires_grad_(False)


def export_forward(model: torch.nn.Module, params=None, *, seq_len: int,
                   visual_dim: int, acoustic_dim: int,
                   platforms: Sequence[str] = ("cuda", "cpu"),
                   keep_attention_impl: bool = False,
                   batch_size: Optional[int] = None):
    """Export ``model``'s deterministic forward as a
    ``torch.export.ExportedProgram`` (JAX ``export_forward``).

    The program has the trainer's predict signature (``input_ids [b,S]
    i32, visual [b,S,Dv] f32, acoustic [b,S,Da] f32, attention_mask [b,S]
    i32, token_type_ids [b,S] i32 -> logits``) with ``b`` symbolic (one
    artifact, any batch size), or fixed to ``batch_size`` when given. The
    weights, ``params`` (a full-size state dict) or else the model's own,
    are captured in it. A model sharded over a mesh
    (``parallel/tp.py::shard_model_``) holds chunks: pass its
    ``parallel.tp.full_state_dict``.

    The export runs on a copy of the model, on the device its params live
    on; the caller's model is left as it is. By default the copy is
    portable (module comment). ``keep_attention_impl=True`` keeps the
    model's attention and MAG gate: the fused kernels enter the program as
    ``magtorch`` custom ops, which run only where this package is
    importable, on CUDA; it needs ``platforms`` CUDA only and a
    ``batch_size``, the two refusals of the JAX entry (the JAX kernels'
    plans resolve from the concrete batch; here a symbolic fused artifact
    would be a feature that the JAX package lacks)."""
    platforms = tuple(p.lower() for p in platforms)
    if keep_attention_impl:
        non_cuda = [p for p in platforms if p != "cuda"]
        if non_cuda:
            raise ValueError(
                "keep_attention_impl=True exports the fused kernels, which "
                f"only run on CUDA — drop {non_cuda} from platforms or "
                "export the portable einsum path (default)")
        if batch_size is None:
            raise ValueError(
                "keep_attention_impl=True exports the fused kernel path "
                "for a fixed batch: pass batch_size=<N>")
    if params is None and getattr(model, "tp_sharding", None) is not None:
        raise ValueError(
            "the model is sharded over a mesh: pass its full-size weights "
            "(params=parallel.tp.full_state_dict(model))")
    copy = _serving_copy(model, params, portable=not keep_attention_impl)
    device = next(copy.parameters()).device
    b = 2 if batch_size is None else int(batch_size)
    shapes = ((b, seq_len), (b, seq_len, visual_dim),
              (b, seq_len, acoustic_dim), (b, seq_len), (b, seq_len))
    args = tuple(torch.ones(shape, dtype=dt, device=device)
                 for shape, dt in zip(shapes, _INPUT_DTYPES))
    dynamic = None
    if batch_size is None:
        # traced at b = 2: a batch of 1 would specialise the dimension
        batch = torch.export.Dim("b", min=1, max=_MAX_BATCH)
        dynamic = tuple({0: batch} for _ in args)
    with torch.no_grad():
        program = torch.export.export(_Forward(copy), args,
                                      dynamic_shapes=dynamic, strict=False)
    program.platforms = platforms
    return program


def _dims(shape) -> list:
    """A shape as the sidecar writes it: symbolic dimensions as "b"."""
    return [str(d) if isinstance(d, int) else "b" for d in shape]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_artifact(path: str, program, *, meta: Optional[dict] = None
                  ) -> None:
    """Write the program (``torch.export.save``) and a JSON sidecar
    (``path.json``) describing its calling convention, the platforms it
    was exported for and the ``magtorch`` ops it holds (none for a
    portable artifact): the consumer-facing contract."""
    from bert_multimodal_transformer_tpu_torch.ops.export_ops import ops_in

    torch.export.save(program, path)
    nodes = {n.name: n for n in program.graph.nodes}
    ins = [nodes[name].meta["val"]
           for name in program.graph_signature.user_inputs]
    outs = [nodes[name].meta["val"]
            for name in program.graph_signature.user_outputs]
    side = {
        "format": _MAGIC,
        "version": _VERSION,
        "fn_name": "forward",
        "platforms": list(getattr(program, "platforms", ("cuda", "cpu"))),
        "inputs": [{"name": n, "shape": _dims(v.shape),
                    "dtype": _dtype_name(v.dtype)}
                   for n, v in zip(_INPUTS, ins)],
        "outputs": [{"shape": _dims(v.shape), "dtype": _dtype_name(v.dtype)}
                    for v in outs],
        "custom_ops": sorted(set(ops_in(program))),
    }
    side.update(meta or {})
    with open(path + ".json", "w") as f:
        json.dump(side, f, indent=2)


def load_artifact(path: str, device=None):
    """Load a saved artifact into a callable ``serve(input_ids, visual,
    acoustic, attention_mask, token_type_ids) -> logits`` (a tensor on
    ``device``), taking numpy arrays or tensors. ``device`` as
    ``config.resolve_device``: None is the card, and raises when none is
    visible. A portable artifact needs only ``torch`` (``torch.export.load``
    and ``.module()``: no code of this package); a fused one needs the
    ``magtorch`` ops, which this function registers first, and CUDA. The
    program is moved to ``device`` when it was exported on another."""
    from bert_multimodal_transformer_tpu_torch.config import resolve_device

    device = resolve_device(device)
    with open(path + ".json") as f:
        side = json.load(f)
    if side.get("format") != _MAGIC:
        raise ValueError(f"{path}.json is not a {_MAGIC} sidecar")
    if device.type not in side["platforms"]:
        raise ValueError(
            f"{path} was exported for {side['platforms']}, not "
            f"{device.type}")
    if side["custom_ops"]:
        from bert_multimodal_transformer_tpu_torch.ops import (  # noqa: F401
            export_ops,
        )
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), device)
    module = program.module()

    def serve(input_ids, visual, acoustic, attention_mask, token_type_ids):
        args = (torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x).to(device=device, dtype=dt)
                for x, dt in zip((input_ids, visual, acoustic,
                                  attention_mask, token_type_ids),
                                 _INPUT_DTYPES))
        with torch.inference_mode():
            return module(*args)

    serve.program = program
    serve.sidecar = side
    return serve


def predict_batches(serve_fn, loader) -> Tuple[np.ndarray, np.ndarray]:
    """Run a (batch, valid) loader through a loaded artifact, the serving
    twin of ``Trainer.test_epoch``. Returns (preds, labels) with the
    padding rows dropped; a regression artifact ([B] or [B, 1] outputs)
    gives 1-D preds, a classification artifact ([B, C]) keeps the class
    axis, as ``Predictor.predict_split``."""
    preds, labels = [], []
    for batch, valid in loader:
        ids, vis, aco, mask, seg, lab = batch
        p = serve_fn(ids, vis, aco, mask, seg)
        p = (p.detach().float().cpu().numpy() if torch.is_tensor(p)
             else np.asarray(p))
        v = np.asarray(valid)
        p = p[v]  # rows first, then any flatten: [B, C] stays per row
        if p.ndim > 1 and p.shape[-1] == 1:
            p = p.reshape(-1)
        preds.append(p)
        labels.append(np.asarray(lab).reshape(-1)[v])
    return np.concatenate(preds), np.concatenate(labels)
