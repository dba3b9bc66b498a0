"""Batch inference / serving (port of ``serving.py``'s ``Predictor``).

    predictor = Predictor(model, batch_size=128)
    preds = predictor.predict_split(packed_split)   # [N] float32
    scores = predictor.score_split(packed_split)    # Acc-2/MAE/corr/F1

The model runs on the device its params live on. With ``mem_len`` (XLNet
segment recurrence) ``predict_split`` threads the memory through the
ordered batch stream, as the model was trained. With ``mesh`` (one
Predictor per rank, each given the same requests) a batch's rows split over
the data axis and the predictions are gathered in order, and a model axis
> 1 runs MAG-BERT tensor-parallel (``parallel/tp.py``). ``from_checkpoint``
and the exported-artifact functions wait for ROADMAP A.6 and A.9.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
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
