"""The port's numpy copy of ``data/validate.py`` against the JAX package's
original, on the inputs of ``tests/test_native_and_utils.py``'s validator
tests (ROADMAP A.12), and the port's ``utils/profiling.py``
``time_step`` and ``trace`` (A.11) on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.data import synthetic as jsynthetic
from bert_multimodal_transformer_tpu.data import validate as jvalidate
from bert_multimodal_transformer_tpu_torch.data import synthetic
from bert_multimodal_transformer_tpu_torch.data import validate
from bert_multimodal_transformer_tpu_torch.utils import profiling

DV, DA = 5, 7


def _data(n_train, n_dev, n_test, seed=0):
    """The same dataset for both packages (their synthetic copies are held
    equal in tests/test_torch_driver.py)."""
    kw = dict(visual_dim=DV, acoustic_dim=DA, n_train=n_train, n_dev=n_dev,
              n_test=n_test, seed=seed)
    return synthetic.make_dataset(**kw), jsynthetic.make_dataset(**kw)


def _misaligned(data):
    (words, visual, acoustic), label, seg = data["train"][0]
    data["train"][0] = ((words, visual[:-1], acoustic), label, seg)
    return data


def _not_a_triple(data):
    data["dev"][0] = ("just words", 1.0)
    return data


def _non_finite(data):
    (words, visual, acoustic), label, seg = data["test"][0]
    visual = np.array(visual, copy=True)
    visual[0, 0] = np.nan
    data["test"][0] = ((words, visual, acoustic), label, seg)
    return data


def _one_d(data):
    (words, visual, acoustic), label, seg = data["train"][1]
    data["train"][1] = ((words, np.asarray(visual)[:, 0], acoustic), label,
                        seg)
    return data


@pytest.mark.parametrize("edit,dims", [
    (None, (DV, DA)), (None, (None, None)), (_misaligned, (None, None)),
    (None, (DV + 1, DA)), (None, (DV, DA + 2)), (_not_a_triple, (DV, DA)),
    (_non_finite, (None, None)), (_one_d, (None, None))],
    ids=["accepts", "infers-dims", "misaligned", "visual-dim",
         "acoustic-dim", "not-a-triple", "non-finite", "one-d"])
def test_validate_equals_jax(edit, dims):
    """``validate`` returns the JAX original's sizes, or raises its error
    with its message."""
    ours, theirs = _data(4, 2, 2)
    if edit is not None:
        ours, theirs = edit(ours), edit(theirs)
    try:
        want = jvalidate.validate(theirs, *dims)
    except jvalidate.ValidationError as e:
        with pytest.raises(validate.ValidationError) as got:
            validate.validate(ours, *dims)
        assert str(got.value) == str(e)
        return
    assert validate.validate(ours, *dims) == want == {
        "train": 4, "dev": 2, "test": 2}


@pytest.mark.parametrize("edit,extra", [(None, []),
                                        (None, [str(DV), str(DA)]),
                                        (_misaligned, []),
                                        (None, [str(DV + 1), str(DA)])],
                         ids=["ok", "dims", "misaligned", "wrong-dim"])
def test_main_equals_jax(edit, extra, tmp_path, capsys):
    """``main`` on a pickle: the JAX original's exit status and output."""
    ours, theirs = _data(3, 2, 1, seed=4)
    if edit is not None:
        ours, theirs = edit(ours), edit(theirs)
    paths = []
    for name, data in (("ours", ours), ("theirs", theirs)):
        path = str(tmp_path / f"{name}.pkl")
        synthetic.write_pickle(path, data)
        paths.append(path)
    rc = validate.main([paths[0]] + extra)
    got = capsys.readouterr()
    want_rc = jvalidate.main([paths[1]] + extra)
    want = capsys.readouterr()
    assert rc == want_rc
    assert (got.out, got.err) == (want.out, want.err)
    assert validate.main([]) == jvalidate.main([]) == 2


def test_time_step_keys_and_counts():
    """``time_step`` returns the JAX function's keys; the step runs
    ``warmup + n_steps`` times; CPU outputs need no device wait."""
    calls = []

    def step(x, scale=1.0):
        calls.append(1)
        return {"y": (x * scale,)}

    out = profiling.time_step(step, torch.ones(3), n_steps=4, warmup=2,
                              scale=2.0)
    assert set(out) == {"seconds_per_step", "steps_per_second",
                        "total_seconds", "n_steps"}
    assert len(calls) == 6 and out["n_steps"] == 4.0
    assert out["total_seconds"] > 0
    assert out["seconds_per_step"] == pytest.approx(
        out["total_seconds"] / 4)
    assert out["steps_per_second"] == pytest.approx(
        4 / out["total_seconds"])


def test_trace_none_is_a_no_op_and_a_dir_gets_a_trace(tmp_path):
    with profiling.trace(None):
        x = torch.ones(2) + 1
    assert torch.equal(x, torch.full((2,), 2.0))
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(log_dir)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
