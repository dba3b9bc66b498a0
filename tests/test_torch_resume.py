"""Checkpoint, resume and predict-only through the port's driver, on the
CPU at ``--tiny``: the contract of ``tests/test_resume.py`` for the JAX
driver.

A run killed mid-epoch (``--max_steps`` with ``--save_every_steps 1``) or
at an epoch's end, then ``--resume``d, ends at the uninterrupted run's
params, moments, update count and generator state bit for bit: the same
batches in the same shuffled order (the resume meta carries the iterator
position), the same dropout streams (the generator is checkpointed), the
same optimizer trajectory. Also under ``--model_parallel 2`` (two CPU
ranks over gloo, each run under its own timeout), whose checkpoints hold
full-size tensors.
"""

import concurrent.futures
import contextlib
import json

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.training import metrics as jmetrics
from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    TRAIN_STATE_FILE,
    CheckpointManager,
)

RANK_TIMEOUT_S = 240


def _argv(ckpt_dir, *extra, model="bert-base-uncased", seed=5):
    return ["--model", model, "--dataset", "mosi", "--synthetic", "--tiny",
            "--train_batch_size", "8", "--dev_batch_size", "8",
            "--test_batch_size", "8", "--synthetic_sizes", "20", "8", "8",
            "--seed", str(seed), "--compute_dtype", "float32",
            "--device", "cpu", "--checkpoint_dir", str(ckpt_dir), *extra]


@contextlib.contextmanager
def _quiet():
    """No wandb, and one intra-op thread: the fastest for the tiny model,
    and it keeps the test from competing with parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("WANDB_MODE", "disabled")
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet_tests():
    with _quiet():
        yield


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted two-epoch run the resumes are held against."""
    d = tmp_path_factory.mktemp("straight")
    with _quiet():
        assert tdriver.main(_argv(d, "--n_epochs", "2")) == 0
    return d


def _assert_same_state(a_dir, b_dir):
    """The latest checkpoints of two runs hold the same bits: params,
    moments, update count, generator state and step."""
    a, b = CheckpointManager(str(a_dir)), CheckpointManager(str(b_dir))
    assert a.latest_step() == b.latest_step()
    pa, pb = a.restore_params(), b.restore_params()
    assert set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    ta, tb = (torch.load(f"{m.directory}/{m.latest_step()}/"
                         f"{TRAIN_STATE_FILE}", weights_only=True)
              for m in (a, b))
    assert ta["step"] == tb["step"]
    assert torch.equal(ta["rng"], tb["rng"])
    assert ta["opt_state"]["count"] == tb["opt_state"]["count"]
    for key in ("exp_avg", "exp_avg_sq"):
        ma, mb = ta["opt_state"][key], tb["opt_state"][key]
        assert set(ma) == set(mb) and ma
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (key, k)


def _records(ckpt_dir):
    return [json.loads(line) for line in
            (ckpt_dir / "metrics.jsonl").read_text().strip().splitlines()]


def test_driver_midepoch_resume_bit_exact(tmp_path, straight, capsys):
    """Killed after 2 of epoch 0's 3 steps (20 % 8: 2 full batches and a
    ragged one), resumed with a DIFFERENT --seed: the driver adopts the
    meta's seed (data, init and dropout derive from it, so the bit
    equality below proves it), continues the history and marks the
    mid-epoch-resumed epoch."""
    assert tdriver.main(_argv(tmp_path / "resumed", "--n_epochs", "2",
                              "--save_every_steps", "1",
                              "--max_steps", "2")) == 0
    meta = json.loads((tmp_path / "resumed" / "resume_meta.json")
                      .read_text())
    assert meta == {"state_step": 2, "start_epoch": 0, "start_batch": 2,
                    "iter_shuffles_to_burn": 1, "seed": 5}
    capsys.readouterr()
    assert tdriver.main(_argv(tmp_path / "resumed", "--n_epochs", "2",
                              "--resume", seed=9)) == 0
    out = capsys.readouterr().out
    assert "Resume: adopting the interrupted run's seed 5 (was 9)" in out
    assert "Resuming at epoch 0, batch 2 (step 2)" in out
    _assert_same_state(straight, tmp_path / "resumed")
    recs = _records(tmp_path / "resumed")
    assert [r["epoch"] for r in recs] == [0, 1]
    assert recs[0].get("resumed_mid_epoch") is True
    assert "resumed_mid_epoch" not in recs[1]
    assert recs[1]["valid_loss"] == _records(straight)[1]["valid_loss"]
    # the step-level saves kept the newest three
    assert CheckpointManager(str(tmp_path / "resumed")).all_steps() == \
        [2, 3, 6]


def test_driver_epoch_resume_bit_exact(tmp_path, straight):
    """Interrupted exactly at epoch 0's end (--max_steps = its 3 steps),
    then resumed with the same --n_epochs: epoch 1 replays the shuffle the
    uninterrupted run draws."""
    assert tdriver.main(_argv(tmp_path / "twostage", "--n_epochs", "2",
                              "--max_steps", "3")) == 0
    meta = json.loads((tmp_path / "twostage" / "resume_meta.json")
                      .read_text())
    assert meta["start_epoch"] == 1 and meta["start_batch"] == 0
    assert tdriver.main(_argv(tmp_path / "twostage", "--n_epochs", "2",
                              "--resume")) == 0
    _assert_same_state(straight, tmp_path / "twostage")
    assert [r["epoch"] for r in _records(tmp_path / "twostage")] == [0, 1]


def test_driver_refuses_foreign_checkpoint_dir(tmp_path, capsys):
    """A fresh (non-resume) run into a directory holding another run's
    checkpoints exits 2, before anything is built or saved."""
    assert tdriver.main(_argv(tmp_path / "d", "--n_epochs", "1")) == 0
    before = sorted(p.name for p in (tmp_path / "d").iterdir())
    capsys.readouterr()
    assert tdriver.main(_argv(tmp_path / "d", "--n_epochs", "1")) == 2
    err = capsys.readouterr().err
    assert "already contains checkpoints (latest step 3)" in err
    assert sorted(p.name for p in (tmp_path / "d").iterdir()) == before


def test_driver_xlnet_resume_smoke(tmp_path):
    """The resume machinery on MAG-XLNet (another state dict, left-padded
    packing): interrupted mid-epoch, resumed, it ends at the uninterrupted
    run's state."""
    kw = dict(model="xlnet-base-cased")
    assert tdriver.main(_argv(tmp_path / "straight", "--n_epochs", "2",
                              **kw)) == 0
    assert tdriver.main(_argv(tmp_path / "x", "--n_epochs", "2",
                              "--save_every_steps", "1", "--max_steps", "2",
                              **kw)) == 0
    assert tdriver.main(_argv(tmp_path / "x", "--n_epochs", "2",
                              "--resume", **kw)) == 0
    recs = _records(tmp_path / "x")
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in recs)
    _assert_same_state(tmp_path / "straight", tmp_path / "x")


TP = ("--model_parallel", "2", "--tp_shard_attention", "--attention_impl",
      "fused", "--n_epochs", "2")


def test_driver_tp_midepoch_resume_bit_exact(tmp_path):
    """``--model_parallel 2 --tp_shard_attention``: the uninterrupted run
    and the interrupted one (2 steps, saved every step) start together;
    the resumed run ends at the uninterrupted one's state, and every
    checkpoint holds full-size tensors (the mesh gathers them)."""
    def run(name, *extra):
        return tdriver.run(_argv(tmp_path / name, *TP, *extra),
                           rank_timeout_s=RANK_TIMEOUT_S)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        straight = pool.submit(run, "straight")
        first = pool.submit(run, "resumed", "--save_every_steps", "1",
                            "--max_steps", "2")
        rc, ranks = straight.result()
        assert rc == 0 and [r["rc"] for r in ranks] == [0, 0]
        assert first.result()[0] == 0
    rc, ranks = run("resumed", "--resume")
    assert rc == 0 and [r["rc"] for r in ranks] == [0, 0]
    assert [r["epoch"] for r in ranks[0]["history"]] == [0, 1]
    _assert_same_state(tmp_path / "straight", tmp_path / "resumed")
    params = CheckpointManager(str(tmp_path / "resumed")).restore_params()
    assert params["bert.encoder.layer.0.intermediate_dense.weight"].shape \
        == (64, 32)


def test_predict_only_prints_the_jax_keys(tmp_path, capsys):
    """``--predict_only`` scores the test split with the latest
    checkpoint: one JSON line whose keys are the JAX driver's ("test_" +
    ``score_regression``'s), equal to the last epoch's test metrics of the
    run that wrote the checkpoint; with ``--wire_dtype bfloat16`` the
    scores stay finite."""
    assert tdriver.main(_argv(tmp_path / "p", "--n_epochs", "1")) == 0
    last = _records(tmp_path / "p")[-1]
    capsys.readouterr()
    assert tdriver.main(_argv(tmp_path / "p", "--predict_only")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    scores = json.loads(lines[-1])
    want = {"test_" + k for k in jmetrics.score_regression(
        np.array([0.5, -1.0, 2.0]), np.array([1.0, -0.5, 1.5]))}
    assert set(scores) == want
    for k in want:
        assert scores[k] == last[k], k
    assert tdriver.main(_argv(tmp_path / "p", "--predict_only",
                              "--wire_dtype", "bfloat16")) == 0
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) == want
    assert all(np.isfinite(v) for v in scores.values())
