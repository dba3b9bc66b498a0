"""Checkpoint / resume (port of ``utils/checkpoint.py``, which wraps Orbax's
``CheckpointManager``).

A capability the reference lacks entirely: it never saves the model
(SURVEY §5: a crash loses the run). A checkpoint holds what the JAX one
holds: the step, the params, the optimizer state (``AdamWHF``'s two
moments and its update count) and the rng: under ``--rng_impl rbg`` the
``TrainState``'s CPU generator state, from which every dropout draw and
every kernel's Philox seed of a step comes; under threefry2x32 the state's
JAX key, two uint32 words (``ops/dropout.py::ThreefryStream``). The file
records which (``rng_impl``), and a restore into a state of the other
stream is refused, as a JAX checkpoint's key shapes (4 words under rbg, 2
under threefry) refuse it.

On disk, step ``n`` is the directory ``<directory>/<n>/`` holding
``params.pt`` (the params by state-dict name, fp32, on the CPU) and
``train_state.pt`` (step, rng, and the moments by parameter name, so a
restore does not depend on the optimizer's parameter order). Both are
``torch.save`` files of tensors, ints and dicts only, and load with
``torch.load(weights_only=True)``. A step is written under a temporary
name and renamed into place, so a process that dies mid-save never leaves
a half-written step (a rename is atomic; the files are not fsynced, so a
power loss of the host can still lose the newest step). The newest
``max_to_keep`` steps stay.

Under tensor parallelism and FSDP (a model sharded by ``parallel/tp.py``
or ``parallel/fsdp.py``) the params and moments are gathered to full
size before the write and each rank takes its chunks and slices on
restore, so a checkpoint does not depend on the mesh, as Orbax's does
not. A pipeline stage (``parallel/pp.py``) writes the whole model in the
pipeline layout, gathered over the stages, as the JAX pipeline trainer
saves it; each stage takes its layers back on restore. In a process
group every rank calls ``save``; rank 0 writes and the ranks meet at a
barrier after it. Saves are synchronous: ``wait_until_finished`` and
``close`` have nothing to wait for.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.ops.dropout import rng_impl_of
from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib

PARAMS_FILE = "params.pt"
TRAIN_STATE_FILE = "train_state.pt"
MOMENTS = ("exp_avg", "exp_avg_sq")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _cpu_fp32(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32) for k, v in
            tensors.items()}


class CheckpointManager:
    """Step-numbered checkpoints of a ``training/trainer.py::TrainState``
    under ``directory`` (created if missing)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(
                os.path.join(self.directory, name, TRAIN_STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int) -> None:
        """Write ``state`` as step ``step``; the write is done when this
        returns."""
        model, opt = state.model, state.optimizer
        params = _cpu_fp32(tp_lib.full_state_dict(model))
        named = dict(model.named_parameters())
        moments = {}
        for key in MOMENTS:
            local = {name: opt.state[p][key] for name, p in named.items()
                     if key in opt.state.get(p, {})}
            moments[key] = _cpu_fp32(tp_lib.full_state_dict(model, local))
        if _writer():
            self._write(step, params, {
                "step": int(state.step),
                "opt_state": {"count": int(opt.count), **moments},
                "rng": state.generator.get_state(),
                "rng_impl": rng_impl_of(state.generator)})
        if _world() > 1:
            dist.barrier()

    def _write(self, step: int, params, train_state) -> None:
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(params, os.path.join(tmp, PARAMS_FILE))
        torch.save(train_state, os.path.join(tmp, TRAIN_STATE_FILE))
        if os.path.exists(final):
            old = f"{final}.old-{os.getpid()}"
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        for stale in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(stale))

    def restore(self, template_state, step: int):
        """Load step ``step`` into ``template_state`` in place and return
        it: the params into its model (on the model's device, fp32; a
        sharded model takes its chunks), the moments and count into its
        optimizer (params restored first, the moments matched to them by
        name), the generator state or key and the step count. Raises
        ``ValueError``, changing nothing, when the checkpoint's stream is
        not the template's (rbg against threefry2x32)."""
        params = self.restore_params(step)
        if params is None:
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        train = _load(os.path.join(self._step_dir(step), TRAIN_STATE_FILE))
        saved = train.get("rng_impl", "rbg")
        if saved != rng_impl_of(template_state.generator):
            raise ValueError(
                f"checkpoint step {step} under {self.directory} holds an "
                f"--rng_impl {saved} stream; this run draws with "
                f"--rng_impl {rng_impl_of(template_state.generator)}: "
                "resume with the interrupted run's --rng_impl")
        model, opt = template_state.model, template_state.optimizer
        model.load_state_dict(tp_lib.local_state_dict(model, params))
        named = dict(model.named_parameters())
        moments = {key: tp_lib.local_state_dict(model,
                                                 train["opt_state"][key])
                   for key in MOMENTS}
        unknown = set(moments["exp_avg"]) - set(named)
        if unknown:
            raise KeyError(f"checkpoint step {step} has moments of "
                           f"parameters the model lacks: {sorted(unknown)}")
        opt.state.clear()
        for name, p in named.items():
            if name in moments["exp_avg"]:
                opt.state[p] = {key: moments[key][name].to(p.device, p.dtype)
                                for key in MOMENTS}
        opt.count = int(train["opt_state"]["count"])
        template_state.generator.set_state(train["rng"])
        template_state.step = int(train["step"])
        return template_state

    def restore_params(self, step: Optional[int] = None
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Only the params, full size, fp32 on the CPU (no template
        needed): for inference against a checkpoint. The latest step when
        ``step`` is None; None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), PARAMS_FILE)
        if not os.path.isfile(path):
            return None
        return _load(path)

    def restore_latest(self, template_state):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(template_state, step)

    def step_bytes(self, step: int) -> int:
        """Bytes on disk of step ``step``."""
        d = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing is held open."""
