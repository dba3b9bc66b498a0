"""The rank mesh over ``torch.distributed`` (port of ``parallel/mesh.py``).

The JAX package drives a (data, model) mesh of devices from one process,
or a (data, pipe[, model]) one for pipeline parallelism (JAX
``parallel/pp.py::make_pp_mesh``). Here each place of the mesh is a
process (a rank) on its own device, and a ``Mesh`` holds what one rank
needs: its coordinates, its device and the process groups of its axes.

* ranks are laid out data-major, as the JAX mesh reshapes its device list
  to (data, pipe, model): rank = (data_rank · pipe_size + pipe_rank) ·
  model_size + model_rank, the pipe axis outside the model axis, so a
  stage's model ranks are neighbours (``make_pp_mesh``);
* ranks go round-robin on the visible cards (``placement``), or all on the
  CPU when there is none; the backend is NCCL when every rank has a card of
  its own, gloo when ranks share a card or run on the CPU
  (``choose_backend``), chosen once before the process group starts and
  never changed after an error;
* ``run_ranks`` starts the ranks with ``torch.multiprocessing`` spawn, each
  under the same timeout, joins each to the process group
  (``parallel/multiprocess.py::initialize``, the one bootstrap, for one
  process or several) and returns what each rank's function returned;
* the ranks may run in several processes (``parallel/multiprocess.py``):
  ``make_mesh(num_processes=)`` records how many, each holding whole data
  rows, and ``Mesh.local_rows`` then splits a process's rows over its own
  data ranks.

Batch rows split over the data axis (``Mesh.local_rows``); the tensor
parallel split over the model axis is ``parallel/tp.py``, the parameter
and moment shards over the data axis ``parallel/fsdp.py``, and the stages
over the pipe axis ``parallel/pp.py`` (one activation tensor at a time
between neighbouring stages: ``Mesh.pipe_send`` / ``Mesh.pipe_recv``).
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def placement(world_size: int, devices: Optional[Sequence] = None
              ) -> List[torch.device]:
    """Each rank's device: ``devices`` as given (one per rank), else the
    visible cards round-robin (rank r on card r mod n), else the CPU."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices given for "
                             f"{world_size} ranks")
        return devices
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return [torch.device("cpu")] * world_size
    return [torch.device("cuda", r % n) for r in range(world_size)]


def choose_backend(devices: Sequence, hosts: Optional[Sequence[str]] = None
                   ) -> str:
    """NCCL when every rank has a card of its own; gloo when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU.
    ``hosts``, each rank's host, tells apart the cards of several hosts
    (one host when None)."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    cards = list(zip(hosts or [""] * len(devices), map(str, devices)))
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the (data[, pipe], model) mesh. With one rank and
    no process group (``make_mesh()`` in a plain process) every collective
    is the identity."""

    data_size: int
    model_size: int
    rank: int
    device: torch.device
    backend: Optional[str]
    data_group: Any = None
    model_group: Any = None
    data_axis: str = DATA_AXIS
    model_axis: str = MODEL_AXIS
    pipe_size: int = 1
    pipe_group: Any = None
    pipe_axis: str = PIPE_AXIS
    pipelined: bool = False   # made by make_pp_mesh
    # the processes the ranks run in, each holding whole data rows
    # (parallel/multiprocess.py)
    num_processes: int = 1

    @property
    def data_rank(self) -> int:
        return self.rank // (self.pipe_size * self.model_size)

    @property
    def pipe_rank(self) -> int:
        return (self.rank // self.model_size) % self.pipe_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def size(self) -> int:
        return self.data_size * self.pipe_size * self.model_size

    @property
    def local_data_size(self) -> int:
        """The data ranks of this rank's process."""
        return self.data_size // self.num_processes

    @property
    def local_data_rank(self) -> int:
        """This rank's place among its process's data ranks."""
        return self.data_rank % self.local_data_size

    def _group(self, axis: str):
        if axis == self.data_axis:
            return self.data_group, self.data_size
        if axis == self.model_axis:
            return self.model_group, self.model_size
        if axis == self.pipe_axis:
            return self.pipe_group, self.pipe_size
        raise ValueError(f"no mesh axis {axis!r}")

    def _pipe_peer(self, step: int) -> int:
        """The global rank ``step`` stages along the pipe axis (same data
        and model place)."""
        p = self.pipe_rank + step
        if not 0 <= p < self.pipe_size:
            raise ValueError(f"stage {self.pipe_rank} has no stage {p}")
        return self.rank + step * self.model_size

    def pipe_send(self, t: torch.Tensor, step: int) -> None:
        """Send ``t`` to the stage ``step`` (±1) along the pipe axis; it
        must post the matching ``pipe_recv``. Gloo's point-to-point calls
        take host tensors only, so under gloo the tensor goes through host
        memory."""
        src = t.detach().contiguous()
        if self.backend == "gloo":
            src = src.cpu()
        dist.send(src, dst=self._pipe_peer(step))

    def pipe_recv(self, shape, dtype: torch.dtype,
                  step: int) -> torch.Tensor:
        """The tensor the stage ``step`` (±1) along the pipe axis sends
        (``pipe_send``), on this rank's device."""
        host = self.backend == "gloo"
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if host else self.device)
        dist.recv(buf, src=self._pipe_peer(step))
        return buf.to(self.device)

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over the ranks of ``axis``; returns it."""
        group, size = self._group(axis)
        if size > 1:
            dist.all_reduce(t, group=group)
        return t

    def all_reduce_list_(self, tensors: List[torch.Tensor],
                         axis: str) -> None:
        """Sum every tensor of ``tensors`` in place over the ranks of
        ``axis``, in one collective (flattened into one buffer)."""
        if not tensors or self._group(axis)[1] == 1:
            return
        flat = self.all_reduce_(torch.cat([t.reshape(-1) for t in tensors]),
                                axis)
        for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(f.view_as(t))

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order of
        ``axis`` (gloo gathers through the host)."""
        group, size = self._group(axis)
        if size == 1:
            return t
        src = t.contiguous()
        if self.backend == "gloo":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def local_rows(self, x, grad_accum: int = 1):
        """This data rank's rows of a global batch array or tensor ``x``
        (rows along dim 0). With ``grad_accum`` A the batch's B rows run as
        A micro-batches of B/A rows, and each data rank takes its share of
        every micro-batch: rows [i·B/A + d·B/(A·D), ...) of micro-batch i
        for data rank d of D. At A = 1 that is one contiguous block, so a
        gather over the data axis restores the batch's order. When the
        ranks run in several processes, ``x`` holds only this process's
        rows (``parallel/multiprocess.py::process_rows``), split the same
        way over the process's data ranks."""
        size, rank = self.local_data_size, self.local_data_rank
        if size == 1:
            return x
        b = x.shape[0]
        if b % (grad_accum * size):
            raise ValueError(
                f"batch {b} does not split into {grad_accum} micro-batches "
                f"over {size} data ranks")
        per = b // (grad_accum * size)
        rows = x.reshape((grad_accum, size, per) + x.shape[1:])
        rows = rows[:, rank]
        out = rows.reshape((grad_accum * per,) + x.shape[1:])
        return np.ascontiguousarray(out) if isinstance(x, np.ndarray) else (
            out.contiguous())


def mesh_shape(config: MeshConfig, n: int):
    """(data, model) for ``config`` over ``n`` ranks, with the JAX
    ``make_mesh`` checks and messages; every rank must hold a place."""
    model = max(1, config.model_parallel)
    data = config.data_parallel
    if data == -1:
        if n % model != 0:
            raise ValueError(
                f"model_parallel={model} does not divide the {n} available "
                f"devices; with data_parallel=-1 every device must be used "
                f"(pick model_parallel from the divisors of {n})")
        data = n // model
    if data < 1:
        raise ValueError(f"mesh needs data axis >= 1, got {data}")
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs more than the {n} available devices")
    if data * model < n:
        raise ValueError(
            f"mesh {data}x{model} leaves {n - data * model} of the {n} ranks "
            "without a place; every rank must hold one")
    return data, model


def _axis_groups(data: int, pipe: int, model: int, rank: int):
    """This rank's (data, pipe, model) groups of the started process group
    (no pipe group on a mesh without a pipe axis). ``new_group`` is
    collective: every rank creates every group, in the same order."""
    def place(d, p, m):
        return (d * pipe + p) * model + m

    mine = {}
    for axis, size, others in (
            ("data", data, [(None, p, m) for p in range(pipe)
                            for m in range(model)]),
            ("model", model, [(d, p, None) for d in range(data)
                              for p in range(pipe)]),
            ("pipe", pipe, [(d, None, m) for d in range(data)
                            for m in range(model)])):
        if axis == "pipe" and pipe == 1:
            continue
        for d, p, m in others:
            ranks = [place(i if d is None else d, i if p is None else p,
                           i if m is None else m) for i in range(size)]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = g
    return mine.get("data"), mine.get("pipe"), mine.get("model")


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              num_processes: int = 1) -> Mesh:
    """The (data, model) mesh over the ranks of the started process group
    (one rank when none was started). ``devices``, one per rank, defaults
    to ``placement``'s. The shape is checked before any process group is
    touched (``mesh_shape``), so a wrong shape raises the same way with or
    without one. ``num_processes``: the ranks run in that many processes
    (``parallel/multiprocess.py::initialize``), each holding whole data
    rows. Every rank calls it, in the same order (the axis groups are
    created collectively)."""
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = len(devices) if devices is not None else world
    data, model = mesh_shape(config, n)
    if data % num_processes:
        raise ValueError(
            f"the {data} data ranks do not split over {num_processes} "
            "processes (each process must hold whole data rows)")
    if n != world:
        raise ValueError(
            f"{n} devices given, but the process group has {world} ranks "
            "(start one rank per device: parallel.mesh.run_ranks or "
            "parallel.multiprocess.initialize)")
    return _build_mesh(data, 1, model, devices, config.data_axis,
                       config.model_axis, num_processes=num_processes)


def _build_mesh(data: int, pipe: int, model: int,
                devices: Optional[Sequence], data_axis: str = DATA_AXIS,
                model_axis: str = MODEL_AXIS,
                pipelined: bool = False, num_processes: int = 1) -> Mesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    devs = placement(world, devices)
    backend = dist.get_backend() if dist.is_initialized() else None
    data_group = pipe_group = model_group = None
    if world > 1:
        data_group, pipe_group, model_group = _axis_groups(data, pipe,
                                                           model, rank)
    return Mesh(data_size=data, model_size=model, rank=rank,
                device=devs[rank], backend=backend, data_group=data_group,
                model_group=model_group, data_axis=data_axis,
                model_axis=model_axis, pipe_size=pipe,
                pipe_group=pipe_group, pipelined=pipelined,
                num_processes=num_processes)


def make_pp_mesh(n_stages: int, data_parallel: int = 1,
                 devices: Optional[Sequence] = None,
                 model_parallel: int = 1) -> Mesh:
    """The (data, pipe[, model]) mesh over the ranks of the started process
    group (JAX ``parallel/pp.py::make_pp_mesh``): the pipe axis outside the
    model axis, so a stage's model ranks are neighbours and consecutive
    stages are contiguous blocks. Every rank must hold a place. Every rank
    calls it, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = len(devices) if devices is not None else world
    model = max(1, model_parallel)
    need = n_stages * data_parallel * model
    if need > n:
        raise ValueError(
            f"pp mesh {data_parallel}x{n_stages}x{model} needs {need} "
            f"devices, have {n}")
    if need < n:
        raise ValueError(
            f"pp mesh {data_parallel}x{n_stages}x{model} leaves "
            f"{n - need} of the {n} ranks without a place; every rank must "
            "hold one")
    if n != world:
        raise ValueError(
            f"{n} devices given, but the process group has {world} ranks "
            "(start one rank per device: parallel.mesh.run_ranks or "
            "parallel.multiprocess.initialize)")
    return _build_mesh(data_parallel, n_stages, model, devices,
                       pipelined=True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, join, devices, timeout_s, args,
               results):
    from bert_multimodal_transformer_tpu_torch.parallel.multiprocess import (
        initialize,
    )

    try:
        coordinator, num_processes, process_id = join
        initialize(coordinator, num_processes, process_id, local_rank=rank,
                   local_world=world_size,
                   device=placement(world_size, devices)[rank],
                   timeout_s=timeout_s)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *,
              timeout_s: float, devices: Optional[Sequence] = None,
              coordinator_address: Optional[str] = None,
              num_processes: int = 1, process_id: int = 0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, each
    joined to the process group first (``parallel/multiprocess.py::
    initialize``: one per ``devices``, else ``placement``'s, the backend
    every rank agrees on), and return the ranks' results in rank order.
    ``fn`` must be importable by name (a module-level function). The ranks
    are this process's local ranks of ``num_processes`` processes, process
    ``process_id``, meeting at ``coordinator_address`` (``host:port``); in
    one process, at a free localhost port when it is None. Raises with the
    failing rank's traceback when one fails, and stops every rank when
    ``timeout_s`` passes first."""
    import torch.multiprocessing as mp

    join = (coordinator_address or f"127.0.0.1:{_free_port()}",
            num_processes, process_id)
    results = mp.get_context("spawn").Queue()
    context = mp.spawn(_rank_main,
                       args=(fn, world_size, join, devices, timeout_s, args,
                             results),
                       nprocs=world_size, join=False)
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(got)} of {world_size} ranks still "
                    f"running after {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [p.exitcode for p in context.processes
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"a rank exited with code {dead[0]} without a "
                        "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        while not context.join(timeout=max(deadline - time.monotonic(),
                                           1.0)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not exit within {timeout_s} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
        for p in context.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world_size)]
