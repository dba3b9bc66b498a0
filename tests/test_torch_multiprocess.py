"""Multi-process runs in the port (``parallel/multiprocess.py``, the driver's
``--num_processes``, the rank-count rule) against the JAX package's
``parallel/multiprocess.py`` and ``tests/test_multiprocess.py``.

* ``local_row_slice`` and ``ShardedBatchIterator`` equal JAX's at
  grad_accum 1 for 1, 2 and 4 processes, with and without shuffle and
  drop; at grad_accum 2 each process holds its data ranks' share of every
  micro-batch, so that a process's rows, split over its own data ranks,
  are each global data rank's rows (``Mesh.local_rows``); JAX's
  indivisible-batch error and the resume passthrough;
* the rank count of a driver process (one a card, at least pipe × model);
* the JAX driver's guards exit 2 with its words;
* two ``--device cpu --tiny`` driver processes over a loopback
  coordinator (grad_accum 2, ragged train and eval tails) equal one
  process's two spawned ranks bit for bit: the epoch line and the final
  params; process 1 prints nothing; only process 0 writes the metrics;
  an interrupted run resumed over two processes ends with the
  uninterrupted run's params bit for bit.

Every subprocess and spawned rank runs under a timeout of its own.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.parallel import multiprocess as tmp
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    choose_backend,
    run_ranks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240


def _arrays(n=21, seq=6, dv=3, da=4, seed=5):
    r = np.random.RandomState(seed)
    return (r.randint(0, 100, (n, seq)).astype(np.int32),
            r.randn(n, seq, dv).astype(np.float32),
            r.randn(n, seq, da).astype(np.float32),
            np.ones((n, seq), np.int32), np.zeros((n, seq), np.int32),
            r.randn(n).astype(np.float32))


def _both_views(nproc, shuffle, drop, gb=8, seed=3):
    from bert_multimodal_transformer_tpu.data.pipeline import (
        PackedSplit as JPackedSplit,
    )
    from bert_multimodal_transformer_tpu.parallel.multiprocess import (
        ShardedBatchIterator as JShardedBatchIterator,
    )

    arrays = _arrays()
    kw = dict(shuffle=shuffle, drop_remainder=drop, seed=seed,
              num_processes=nproc)
    return ([list(tmp.ShardedBatchIterator(PackedSplit(*arrays), gb,
                                           process_id=p, **kw))
             for p in range(nproc)],
            [list(JShardedBatchIterator(JPackedSplit(*arrays), gb,
                                        process_id=p, **kw))
             for p in range(nproc)])


@pytest.mark.parametrize("nproc", [1, 2, 4])
@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_sharded_iterator_equals_jax(nproc, shuffle, drop):
    """Every process's batches and masks equal the JAX view's, and
    ``local_row_slice`` equals JAX's."""
    from bert_multimodal_transformer_tpu.parallel.multiprocess import (
        local_row_slice as jlocal_row_slice,
    )

    got, want = _both_views(nproc, shuffle, drop)
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w) > 0
        for (gb, gv), (wb, wv) in zip(g, w, strict=True):
            np.testing.assert_array_equal(gv, wv)
            for a, b in zip(gb, wb, strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for b in (8, 12, 40):
        for p in range(nproc):
            assert (tmp.local_row_slice(b, nproc, p)
                    == jlocal_row_slice(b, nproc, p))


def _data_rank(data, rank, nproc):
    return Mesh(data_size=data, model_size=1, rank=rank,
                device=torch.device("cpu"), backend=None,
                num_processes=nproc)


@pytest.mark.parametrize("nproc,data", [(2, 2), (2, 4), (4, 4)])
def test_process_rows_at_grad_accum_2_are_their_data_ranks_rows(nproc,
                                                                data):
    """At grad_accum 2 the processes' rows together are the global batch
    (each row once), and a process's rows split over its own data ranks
    (``local_rows`` of a mesh over the processes) are each global data
    rank's rows (``local_rows`` of the same data rank in one process)
    of the global batch: a run over the processes equals one process over
    the same data ranks."""
    arrays = _arrays(n=36)
    split = PackedSplit(*arrays)
    gb, accum = 16, 2
    glob = list(BatchIterator(split, gb, shuffle=True, drop_remainder=False,
                              seed=3))
    views = [list(tmp.ShardedBatchIterator(
        split, gb, shuffle=True, drop_remainder=False, seed=3,
        num_processes=nproc, process_id=p, grad_accum=accum))
        for p in range(nproc)]
    for bi, (batch, valid) in enumerate(glob):
        ids = np.concatenate([v[bi][0][0] for v in views])
        assert sorted(map(tuple, ids)) == sorted(map(tuple, batch[0]))
        assert sum(int(v[bi][1].sum()) for v in views) == int(valid.sum())
        for rank in range(data):
            mesh = _data_rank(data, rank, nproc)
            p = rank // mesh.local_data_size
            for a, pa in zip(batch + (valid,), views[p][bi][0]
                             + (views[p][bi][1],)):
                np.testing.assert_array_equal(
                    mesh.local_rows(pa, accum),
                    dataclasses.replace(mesh, num_processes=1).local_rows(
                        a, accum))
    assert np.array_equal(
        tmp.process_rows(np.arange(8), 2, 1), np.arange(4, 8))


def test_indivisible_batch_rejected_with_jax_words():
    split = PackedSplit(*_arrays())
    with pytest.raises(ValueError, match="global batch 9 not divisible by "
                       "2 processes"):
        tmp.ShardedBatchIterator(split, 9, shuffle=False,
                                 drop_remainder=False, num_processes=2,
                                 process_id=0)
    with pytest.raises(ValueError, match="does not split into 2 "
                       "micro-batches over 4 processes"):
        tmp.ShardedBatchIterator(split, 12, shuffle=False,
                                 drop_remainder=False, num_processes=4,
                                 process_id=0, grad_accum=2)


def test_resume_passthrough():
    """``restore_position`` gives the per-process stream of an iterator
    that already drew that many shuffles (JAX
    ``test_sharded_iterator_resume_passthrough``)."""
    split = PackedSplit(*_arrays())

    def make():
        return tmp.ShardedBatchIterator(split, 8, shuffle=True,
                                        drop_remainder=True, seed=11,
                                        num_processes=2, process_id=1)

    a = make()
    for _ in range(2):
        list(a)
    epoch3_a = list(a)
    b = make()
    b.restore_position(2)
    epoch3_b = list(b)
    assert a.shuffles_done == b.shuffles_done == 3
    for (ba, va), (bb, vb) in zip(epoch3_a, epoch3_b, strict=True):
        np.testing.assert_array_equal(va, vb)
        for x, y in zip(ba, bb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cards", [0, 1, 4, 8])
@pytest.mark.parametrize("pipe,model", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_rank_count_follows_the_jax_mesh(cards, pipe, model):
    """A process runs one rank a card and at least the pipe × model block:
    one rank on one card or the CPU without a model or pipe axis, the
    block when ranks share the cards, every card's rank otherwise (the
    data axis takes the rest, as the JAX ``make_mesh()`` over every
    device). The driver reads it through ``local_ranks``."""
    want = max(cards, pipe * model)
    assert tmp.local_rank_count(cards, pipe, model) == want
    args = tdriver.build_parser().parse_args(
        ["--pipeline_parallel", str(pipe), "--model_parallel", str(model)])
    assert tdriver.local_ranks(args, cards) == want
    if cards <= 1 and pipe * model == 1:
        assert want == 1   # one rank, no spawn: the single-device path


@pytest.mark.parametrize("devices,hosts,want", [
    (["cuda:0", "cuda:1"], None, "nccl"),
    (["cuda:0", "cuda:0"], None, "gloo"),
    (["cuda:0", "cuda:0"], ["a", "b"], "nccl"),
    (["cuda:0", "cuda:0"], ["a", "a"], "gloo"),
    (["cuda:0", "cpu"], ["a", "b"], "gloo"),
    (["cpu", "cpu"], None, "gloo"),
])
def test_one_backend_for_the_ranks_of_every_host(devices, hosts, want):
    """One function picks the backend, for the ranks of one process and of
    several (``initialize`` passes each rank's host): NCCL only when every
    rank has a card of its own, a card being one device of one host."""
    assert choose_backend(devices, hosts) == want


def test_trainer_refuses_a_multiprocess_mesh_without_multiprocess():
    """A mesh over two processes holds each process's rows only: a
    ``Trainer`` that expects the global batch there raises, naming the
    option; with it the trainer builds."""
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )

    model = torch.nn.Linear(2, 1)
    mesh = _data_rank(2, 0, 2)
    with pytest.raises(ValueError, match="multiprocess=True"):
        Trainer(model=model, tx=None, mesh=mesh)
    tr = Trainer(model=model, tx=None, mesh=mesh, multiprocess=True)
    assert tr.mesh is mesh


GUARD_CASES = (["--tp_shard_attention", "--model_parallel", "2"],
               ["--pipeline_parallel", "2"],
               ["--train_batch_size", "7"],
               ["--process_id", "2"],
               ["--mem_len", "4", "--model", "xlnet-base-cased"],
               ["--predict_only"])


@pytest.mark.parametrize("extra", GUARD_CASES,
                         ids=lambda e: "-".join(a.strip("-") for a in e))
def test_driver_num_processes_guards(extra, capsys):
    """The JAX driver's guards of ``test_driver_num_processes_guards``
    (and its ``--mem_len`` and ``--predict_only`` ones) exit 2 with the
    JAX driver's words, before any process group starts."""
    from bert_multimodal_transformer_tpu import driver as jdriver

    base = ["--model", "bert-base-uncased", "--synthetic", "--tiny",
            "--num_processes", "2"]
    assert jdriver.main(base + extra) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tdriver.main(base + extra + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want and "ROADMAP" not in got


# ---- two driver processes against one process's two ranks -----------------

RUN = ["--model", "bert-base-uncased", "--dataset", "mosi", "--synthetic",
       "--tiny", "--device", "cpu", "--n_epochs", "1", "--seed", "3",
       "--train_batch_size", "4", "--gradient_accumulation_step", "2",
       "--synthetic_sizes", "36", "10", "10", "--dev_batch_size", "4",
       "--test_batch_size", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(extra):
    """Two driver processes over a loopback coordinator: [(exit status,
    output)] for process 0 and 1."""
    env = dict(os.environ, PYTHONPATH=REPO, WANDB_MODE="disabled")
    flags = RUN + ["--num_processes", "2", "--coordinator_address",
                   f"127.0.0.1:{_free_port()}"] + extra
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bert_multimodal_transformer_tpu_torch.driver",
         *flags, "--process_id", str(p)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in (1, 0)][::-1]
    out = []
    try:
        for p in procs:
            out.append((p.wait(RUN_TIMEOUT_S), p.stdout.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    return out


def _one_process_two_ranks(ckpt):
    """One process's two spawned data ranks on the same run (the driver's
    own rank function over a two-rank mesh)."""
    args = tdriver.build_parser().parse_args(RUN + ["--checkpoint_dir",
                                                    ckpt])
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        return run_ranks(tdriver._rank_main, 2, (args, ["cpu"] * 2),
                         timeout_s=RUN_TIMEOUT_S, devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Started together: the uninterrupted two-process run, one process's
    two ranks, a two-process run stopped after 2 steps then resumed over
    two processes, each into a checkpoint directory of its own, and two
    ranks whose checkpoint directories differ (``_ranks_with_own_dirs``)."""
    d = tmp_path_factory.mktemp("mp")
    dirs = {k: str(d / k) for k in ("full", "ranks", "resumed",
                                    "own dirs")}

    def interrupted_then_resumed():
        first = _two_processes(["--checkpoint_dir", dirs["resumed"],
                                "--save_every_steps", "1", "--max_steps",
                                "2"])
        return first, _two_processes(["--checkpoint_dir", dirs["resumed"],
                                      "--resume"])

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {
            "own dirs": pool.submit(_ranks_with_own_dirs, dirs["own dirs"]),
            "full": pool.submit(_two_processes,
                                ["--checkpoint_dir", dirs["full"]]),
            "ranks": pool.submit(_one_process_two_ranks, dirs["ranks"]),
            "resumed": pool.submit(interrupted_then_resumed)}
        out = {k: f.result() for k, f in futures.items()}
    return out, dirs


def _epoch_line(text):
    (line,) = [ln for ln in text.splitlines() if ln.startswith("epoch:")]
    return line


def _params(directory):
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    return CheckpointManager(directory).restore_params()


def _line_of(record):
    return (f"epoch:{record['epoch']}, train_loss:{record['train_loss']}, "
            f"valid_loss:{record['valid_loss']}, "
            f"test_acc:{record['test_acc']}")


def test_two_processes_equal_one_process_two_ranks(runs):
    """Both processes exit 0; process 0's epoch line is the two-rank run's
    record bit for bit, process 1 prints no epoch line and no seed; the
    final params are equal bit for bit; only process 0 wrote the
    metrics (one line for the one epoch)."""
    out, dirs = runs
    (rc0, text0), (rc1, text1) = out["full"]
    assert rc0 == 0 and rc1 == 0, (text0, text1)
    assert "epoch:" not in text1 and "Seed:" not in text1
    assert "backend gloo" in text0
    ranks = out["ranks"]
    assert [r["rc"] for r in ranks] == [0, 0]
    assert _epoch_line(text0) == _line_of(ranks[0]["history"][0])
    got, want = _params(dirs["full"]), _params(dirs["ranks"])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with open(os.path.join(dirs["full"], "metrics.jsonl")) as f:
        assert len([ln for ln in f if ln.strip()]) == 1


def test_resumed_two_processes_continue_bit_for_bit(runs):
    """The run stopped after 2 of its 5 steps, then resumed over two
    processes, ends with the uninterrupted run's params bit for bit and
    its validation and test scores."""
    out, dirs = runs
    first, second = out["resumed"]
    assert [rc for rc, _ in first + second] == [0, 0, 0, 0], (first, second)
    assert "Resuming at epoch 0, batch 2" in second[0][1]
    assert "epoch:" not in second[1][1]
    got, want = _params(dirs["resumed"]), _params(dirs["full"])
    assert all(torch.equal(got[k], want[k]) for k in want)
    full = _epoch_line(out["full"][0][1]).split(", ")
    resumed = _epoch_line(second[0][1]).split(", ")
    assert resumed[2:] == full[2:]
    with open(os.path.join(dirs["resumed"], "resume_meta.json")) as f:
        assert json.load(f)["start_epoch"] == 1


def _rank_with_own_dir(rank, args, devices, root):
    """A driver rank whose checkpoint directory no other rank sees, as on
    hosts that do not share ``--checkpoint_dir``."""
    args = argparse.Namespace(**{**vars(args), "checkpoint_dir":
                                 os.path.join(root, f"rank{rank}")})
    return tdriver._rank_main(rank, args, devices)


def _ranks_with_own_dirs(root):
    """Two ranks of one run, each checkpointing into a directory of its
    own under ``root``, saving every step."""
    args = tdriver.build_parser().parse_args(RUN + [
        "--save_every_steps", "1", "--checkpoint_dir", root])
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        return run_ranks(_rank_with_own_dir, 2, (args, ["cpu"] * 2, root),
                         timeout_s=RUN_TIMEOUT_S, devices=["cpu"] * 2)


def test_ranks_agree_on_a_save_their_hosts_see_differently(runs):
    """With ``--save_every_steps 1`` the epoch's last step is saved before
    the epoch-end save, which then finds it in rank 0's directory and in
    no other: rank 0's view decides for every rank, so no rank enters the
    save's collectives alone, the run ends, and only rank 0 wrote."""
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    out, dirs = runs
    assert [r["rc"] for r in out["own dirs"]] == [0, 0]
    root = dirs["own dirs"]
    assert CheckpointManager(os.path.join(root, "rank0")).latest_step() == 5
    assert CheckpointManager(os.path.join(root, "rank1")).latest_step() is None


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_fsdp.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
