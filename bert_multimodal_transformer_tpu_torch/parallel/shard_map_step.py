"""The explicit-collectives train step (port of ``parallel/shard_map_step.py``).

The JAX package writes its data-parallel step twice: the ``Trainer``'s,
sharded by XLA from annotations, and this one, per-device code under
``shard_map`` with the ``pmean`` over the data axis placed by hand. Torch
has no implicit sharding, so the port's ``Trainer`` step already places
its collectives by hand (``training/trainer.py::_make_step``): per-rank
code on the rank's rows, the dropout seed drawn from the state's generator
with the data rank folded in, then every gradient and the loss summed over
the data axis and divided by the data ranks (JAX's ``pmean``), then AdamW.
This module names that step under the JAX entry point, so the two cannot
drift apart (``tests/test_torch_shard_map.py`` holds it against the JAX
step). Under threefry2x32 the two part: the JAX explicit step folds the
data index into the step's key (``fold_in(rng, axis_index)``) and each
rank draws the masks of its local rows, where the ``Trainer``'s step draws
its rows of the global batch's masks, so this entry asks the step for the
folded keys (``make_train_step(explicit=True)``).
"""

from __future__ import annotations

from bert_multimodal_transformer_tpu_torch.parallel.mesh import Mesh
from bert_multimodal_transformer_tpu_torch.training.trainer import (
    make_train_step,
)


def make_shard_map_train_step(mesh: Mesh):
    """``step(state, batch) -> loss`` for one rank of ``mesh``'s data axis:
    ``batch`` is this rank's rows on its device (``Trainer._put_batch``).
    The ``Trainer``'s data-parallel step at grad_accum 1. Data parallelism
    only, as the JAX step: a mesh with a model or pipe axis is refused."""
    if mesh.model_size > 1 or mesh.pipe_size > 1:
        raise ValueError(
            "the explicit-collectives step is data-parallel: the mesh has "
            f"a model axis of {mesh.model_size} and a pipe axis of "
            f"{mesh.pipe_size}")
    return make_train_step(1, mesh, explicit=True)
