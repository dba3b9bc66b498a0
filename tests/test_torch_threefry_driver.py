"""The port's driver under ``--rng_impl threefry2x32``, on the CPU.

* A tiny synthetic run's logged losses match the JAX driver's run at the
  same seed and flags (its default threefry2x32), within the epoch-record
  band of ``tests/test_torch_training.py`` (rtol 2e-3): the same init, data
  order and dropout masks on both sides;
* a run interrupted mid-epoch and resumed from its checkpoint ends in the
  uninterrupted run's state bit for bit: the checkpoint holds the state's
  JAX key (``rng_impl`` "threefry2x32", two words);
* a checkpoint of the other stream is refused on resume, both ways, with
  exit 2 and a message naming both streams.
"""

import contextlib
import json
import re

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    TRAIN_STATE_FILE,
    CheckpointManager,
)

RECORD_RTOL = 2e-3
RUN = ["--dataset", "mosi", "--synthetic", "--tiny", "--train_batch_size",
       "8", "--dev_batch_size", "8", "--test_batch_size", "8",
       "--synthetic_sizes", "20", "8", "8", "--compute_dtype", "float32",
       "--seed", "5"]
EPOCH = re.compile(r"epoch:(\d+), train_loss:([^,]+), valid_loss:([^,]+)")


@contextlib.contextmanager
def _jax_prng_impl():
    """The JAX driver sets ``jax_default_prng_impl`` from its flag; put the
    previous value back for the rest of the worker."""
    import jax

    before = jax.config.jax_default_prng_impl
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", before)


def _epochs(out):
    return [(int(m[1]), float(m[2]), float(m[3]))
            for m in EPOCH.finditer(out)]


def test_driver_losses_match_the_jax_driver(capsys, monkeypatch):
    from bert_multimodal_transformer_tpu import driver as jdriver

    monkeypatch.setenv("WANDB_MODE", "disabled")
    argv = RUN + ["--n_epochs", "2", "--rng_impl", "threefry2x32"]
    with _jax_prng_impl():
        assert jdriver.main(argv) == 0
    want = _epochs(capsys.readouterr().out)
    assert tdriver.main(argv + ["--device", "cpu"]) == 0
    got = _epochs(capsys.readouterr().out)
    assert [e[0] for e in got] == [e[0] for e in want] == [0, 1]
    np.testing.assert_allclose([e[1:] for e in got], [e[1:] for e in want],
                               rtol=RECORD_RTOL)


def _ckpt_argv(d, *extra, rng_impl="threefry2x32"):
    return RUN + ["--device", "cpu", "--rng_impl", rng_impl,
                  "--checkpoint_dir", str(d), *extra]


def _state(d):
    m = CheckpointManager(str(d))
    step = m.latest_step()
    return m.restore_params(), torch.load(
        f"{m.directory}/{step}/{TRAIN_STATE_FILE}", weights_only=True)


def test_midepoch_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    assert tdriver.main(_ckpt_argv(tmp_path / "straight", "--n_epochs",
                                   "2")) == 0
    assert tdriver.main(_ckpt_argv(tmp_path / "resumed", "--n_epochs", "2",
                                   "--save_every_steps", "1",
                                   "--max_steps", "2")) == 0
    capsys.readouterr()
    assert tdriver.main(_ckpt_argv(tmp_path / "resumed", "--n_epochs", "2",
                                   "--resume")) == 0
    assert "Resuming at epoch 0, batch 2 (step 2)" in capsys.readouterr().out
    (pa, ta), (pb, tb) = _state(tmp_path / "straight"), _state(
        tmp_path / "resumed")
    assert ta["rng_impl"] == tb["rng_impl"] == "threefry2x32"
    assert ta["rng"].shape == (2,) and torch.equal(ta["rng"], tb["rng"])
    assert ta["step"] == tb["step"]
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in ta["opt_state"][key].items():
            assert torch.equal(v, tb["opt_state"][key][k]), (key, k)


@pytest.mark.parametrize("saved,resumed", [("rbg", "threefry2x32"),
                                           ("threefry2x32", "rbg")])
def test_resume_refuses_the_other_stream(tmp_path, capsys, saved, resumed):
    d = tmp_path / "run"
    assert tdriver.main(_ckpt_argv(d, "--n_epochs", "2", "--max_steps", "2",
                                   "--save_every_steps", "1",
                                   rng_impl=saved)) == 0
    meta = json.loads((d / "resume_meta.json").read_text())
    capsys.readouterr()
    assert tdriver.main(_ckpt_argv(d, "--n_epochs", "2", "--resume",
                                   rng_impl=resumed)) == 2
    err = capsys.readouterr().err
    assert (f"holds an --rng_impl {saved} stream" in err
            and f"draws with --rng_impl {resumed}" in err), err
    # nothing was written by the refused run
    assert CheckpointManager(str(d)).latest_step() == meta["state_step"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "disabled")
