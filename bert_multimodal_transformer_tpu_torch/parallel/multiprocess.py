"""Multi-process runs (port of ``parallel/multiprocess.py``): several driver
processes, each owning its local devices, train one model over one
process group.

The JAX package runs one process per host: every process calls
``jax.distributed.initialize`` against one coordinator and runs the same
program over the global device list; each process feeds only the rows of
its own devices. Here a process runs its local ranks (one per card it owns,
or the model and pipe block when ranks share a card or run on the CPU),
and all of them join one ``torch.distributed`` process group:

* :func:`initialize` joins a rank to the global group through the
  coordinator's store, after choosing one backend for every rank from
  every rank's (host, device); it is also how ``parallel/mesh.py::
  run_ranks`` starts the ranks of one process;
* :func:`process_rows` / :func:`local_row_slice` pick a process's rows of a
  global batch, and :class:`ShardedBatchIterator` yields them: every
  process draws the same global shuffle from the same seed;
* the ``Trainer(multiprocess=True)`` (``training/trainer.py``) hands each
  local rank its own rows of the process's rows (``Mesh.local_rows`` of a
  mesh made with ``num_processes``), so no global array is assembled: a
  rank only ever holds its own rows (the counterpart of JAX
  ``put_global_batch``).

Global rank = process_id × local ranks + local rank. Ranks are laid out
data-major (``parallel/mesh.py``), so a process's ranks hold whole data
rows and its model axis stays inside it.
"""

from __future__ import annotations

import datetime
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, local_rank: int = 0, local_world: int = 1,
               device="cpu", timeout_s: float = 600.0) -> None:
    """Join this rank (``local_rank`` of this process's ``local_world``,
    on ``device``) to the process group of ``num_processes`` processes
    over ``tcp://<coordinator_address>`` (``host:port``; global rank 0,
    process 0's first rank, serves the store there). Every rank of every
    process calls it, before any collective: it is the one bootstrap of
    the port's ranks, also for the ranks of one process
    (``parallel/mesh.py::run_ranks``).

    The ranks first trade (host, device) and their process's rank count
    through the store, so that every rank picks the same backend
    (``parallel/mesh.py::choose_backend``: NCCL only when every rank has a
    card of its own, else gloo) before the group starts; a card becomes
    the current device, and CPU ranks share their host's cores. Raises
    ValueError when ``process_id`` is out of range, when the processes'
    local rank counts differ, or when the started group's size or rank
    disagrees with the flags."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        choose_backend,
    )

    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside "
                         f"[0, {num_processes})")
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} outside "
                         f"[0, {local_world})")
    device = torch.device(device)
    world = num_processes * local_world
    rank = process_id * local_world + local_rank
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), is_master=rank == 0,
                          timeout=timeout, wait_for_workers=False)
    if local_rank == 0:
        store.set(f"local_world/{process_id}", str(local_world))
    counts = [int(store.get(f"local_world/{p}"))
              for p in range(num_processes)]
    if any(c != local_world for c in counts):
        raise ValueError(
            f"the processes run different local rank counts {counts}: every "
            "process must own the same number of ranks (the mesh holds "
            "whole data rows a process)")
    store.set(f"place/{rank}", json.dumps([socket.gethostname(),
                                           str(device)]))
    hosts, devices = zip(*(json.loads(store.get(f"place/{r}"))
                           for r in range(world)))
    backend = choose_backend(devices, hosts)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        here = hosts.count(hosts[rank])
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // here))
    dist.init_process_group(backend, store=dist.PrefixStore("group", store),
                            world_size=world, rank=rank, timeout=timeout)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise ValueError(
            f"the process group reports rank {dist.get_rank()}/"
            f"{dist.get_world_size()}, flags say {rank}/{world}: this rank "
            "did not join the distributed runtime")
    if rank == 0:
        print(f"ranks: {world} on {list(devices)} over {num_processes} "
              f"process(es), backend {backend}", flush=True)


def local_row_slice(global_batch: int, num_processes: int,
                    process_id: int) -> slice:
    """The contiguous row-block ``[pid·B/P, (pid+1)·B/P)`` of a [B, ...]
    global batch that process ``pid`` of ``P`` owns (JAX
    ``local_row_slice``). It is :func:`process_rows` at grad_accum 1.

    Under gradient accumulation (A > 1) a process does not take one
    block: the step runs the batch as A micro-batches and data rank d
    takes its share of every one (``Mesh.local_rows``), so a process
    takes, for each micro-batch, the rows of its data ranks
    (:func:`process_rows`). The JAX package can take the block and let
    XLA move the rows inside its step; the port moves no rows between
    processes, and a run over P processes then equals one process over
    the same data ranks bit for bit at any A."""
    if global_batch % num_processes != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{num_processes} processes")
    rows = global_batch // num_processes
    return slice(process_id * rows, (process_id + 1) * rows)


def process_rows(x: np.ndarray, num_processes: int, process_id: int,
                 grad_accum: int = 1) -> np.ndarray:
    """Process ``process_id``'s rows of the global batch array ``x`` (rows
    along axis 0) run as ``grad_accum`` micro-batches: for each micro-batch
    in order, its ``process_id``-th of ``num_processes`` row-blocks. At
    grad_accum 1 that is ``x[local_row_slice(...)]``."""
    b = x.shape[0]
    if grad_accum == 1:
        return x[local_row_slice(b, num_processes, process_id)]
    if b % (grad_accum * num_processes):
        raise ValueError(
            f"global batch {b} does not split into {grad_accum} "
            f"micro-batches over {num_processes} processes")
    rows = x.reshape((grad_accum, num_processes, -1) + x.shape[1:])
    return np.ascontiguousarray(rows[:, process_id].reshape(
        (-1,) + x.shape[1:]))


class ShardedBatchIterator:
    """Per-process view of the global batch stream (JAX
    ``ShardedBatchIterator``).

    Wraps a ``BatchIterator`` built with the same seed in every process,
    so every process draws the same epoch shuffle and walks the same
    global batches; each yields only its own rows (:func:`process_rows`
    with ``grad_accum``, the micro-batches a train batch runs as). The
    valid mask of a padded tail batch is sliced the same way.
    ``shuffles_done`` and ``restore_position`` pass through, so a resume
    works per process."""

    def __init__(self, split: PackedSplit, global_batch_size: int, *,
                 shuffle: bool, drop_remainder: bool, seed: int = 0,
                 num_processes: int, process_id: int, grad_accum: int = 1):
        local_row_slice(global_batch_size, num_processes, process_id)
        if global_batch_size % (grad_accum * num_processes):
            raise ValueError(
                f"global batch {global_batch_size} does not split into "
                f"{grad_accum} micro-batches over {num_processes} processes")
        self._nproc = num_processes
        self._pid = process_id
        self._accum = grad_accum
        self.global_batch_size = global_batch_size
        self._it = BatchIterator(split, global_batch_size, shuffle=shuffle,
                                 drop_remainder=drop_remainder, seed=seed)

    @property
    def shuffles_done(self) -> int:
        return self._it.shuffles_done

    def restore_position(self, shuffles_done: int) -> None:
        self._it.restore_position(shuffles_done)

    def __len__(self) -> int:
        return len(self._it)

    def __iter__(self):
        return self.iter_from(0)

    def _rows(self, x):
        return process_rows(x, self._nproc, self._pid, self._accum)

    def iter_from(self, start_batch: int = 0):
        for batch, valid in self._it.iter_from(start_batch):
            yield tuple(self._rows(a) for a in batch), self._rows(valid)


def local_rank_count(n_cards: int, pipe: int = 1, model: int = 1) -> int:
    """How many ranks a driver process runs (the JAX driver's rule: a
    process owns its local devices): one a card when it sees
    ``n_cards`` cards, and at least the pipe × model block, whose ranks
    then share the cards (or the CPU, ``n_cards`` 0). Data parallelism
    takes what is left, over these ranks and the processes."""
    return max(n_cards, max(1, pipe) * max(1, model))
