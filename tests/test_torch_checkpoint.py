"""The port's checkpoint files (``utils/checkpoint.py``,
``utils/safetensors_io.py``, ``serving.py::Predictor.from_checkpoint``) on
the CPU.

Safetensors: the port's reader and writer against the JAX package's, in
both directions, byte for byte, BF16 included, and the same refusals of
corrupt files. Checkpoints: a ``CheckpointManager`` round trip is bit-exact
(params, both moments, the update count, the generator state, the step),
a restored state steps on exactly as the saved one does, ``max_to_keep``
holds, and every file loads with ``torch.load(weights_only=True)``.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from bert_multimodal_transformer_tpu.training import metrics as jmetrics
from bert_multimodal_transformer_tpu.utils import (
    safetensors_io as jst,
)
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MagXLNetForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training.optim import (
    make_optimizer,
)
from bert_multimodal_transformer_tpu_torch.training.trainer import (
    Trainer,
    make_train_step,
)
from bert_multimodal_transformer_tpu_torch.utils import (
    safetensors_io as tst,
)
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    PARAMS_FILE,
    TRAIN_STATE_FILE,
    CheckpointManager,
)

V, B, S, DV, DA = 64, 4, 10, 3, 5


def _tensors():
    rng = np.random.RandomState(0)
    return {
        "a.weight": rng.randn(4, 8).astype(np.float32),
        "a.bias": rng.randn(8).astype(np.float16),
        "d": rng.randn(3).astype(np.float64),
        "ids": rng.randint(0, 100, (3, 5)).astype(np.int64),
        "i32": rng.randint(-9, 9, (2, 2)).astype(np.int32),
        "flag": np.array([True, False]),
        "scalar": np.array(3.5, dtype=np.float32),
        "small": rng.randint(-3, 3, (2,)).astype(np.int8),
        "big_endian": np.arange(4, dtype=">f4"),
    }


def test_safetensors_files_cross_read_byte_for_byte(tmp_path):
    """A file of either writer reads back through the other reader with
    the same arrays, and the two writers' bytes are equal."""
    t = _tensors()
    meta = {"format": "pt"}
    tp, jp = str(tmp_path / "t.safetensors"), str(tmp_path / "j.safetensors")
    tst.save_safetensors(tp, t, metadata=meta)
    jst.save_safetensors(jp, t, metadata=meta)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    for path in (tp, jp):
        for back in (tst.load_safetensors(path), jst.load_safetensors(path)):
            assert set(back) == set(t)
            for k, v in t.items():
                assert back[k].dtype == v.dtype.newbyteorder("=")
                np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bf16_widens_exactly_in_both(tmp_path):
    p = str(tmp_path / "bf16.safetensors")
    x = torch.randn(5, 7).to(torch.bfloat16)
    save_file({"w": x, "f": torch.arange(3.0)}, p)
    want = x.float().numpy()
    for back in (tst.load_safetensors(p), jst.load_safetensors(p)):
        assert back["w"].dtype == np.float32
        np.testing.assert_array_equal(back["w"], want)
        np.testing.assert_array_equal(back["f"], [0.0, 1.0, 2.0])


def _header_file(path, header, payload=16):
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)) + hj + b"\x00" * payload)


@pytest.mark.parametrize("case", ["too_short", "truncated_header",
                                  "out_of_bounds", "wrong_size",
                                  "unknown_dtype"])
def test_corrupt_files_fail_in_both(tmp_path, case):
    """Each corruption raises ValueError with the same message in the port
    and in the JAX package."""
    p = str(tmp_path / "bad.safetensors")
    if case == "too_short":
        open(p, "wb").write(b"\x01\x02")
    elif case == "truncated_header":
        tst.save_safetensors(p, _tensors())
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:20])
    elif case == "out_of_bounds":
        _header_file(p, {"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 1 << 20]}})
    elif case == "wrong_size":
        _header_file(p, {"x": {"dtype": "F32", "shape": [5],
                               "data_offsets": [0, 16]}})
    else:
        _header_file(p, {"x": {"dtype": "F8_E4M3", "shape": [4],
                               "data_offsets": [0, 4]}})
    with pytest.raises(ValueError) as jerr:
        jst.load_safetensors(p)
    with pytest.raises(ValueError) as terr:
        tst.load_safetensors(p)
    assert str(terr.value) == str(jerr.value)


def _model(family, seed=0):
    if family == "bert":
        return MagBertForSequenceClassification(
            BertConfig.tiny(V), MultimodalConfig(dropout_prob=0.1), DV, DA,
            device="cpu", generator=torch.Generator().manual_seed(seed))
    return MagXLNetForSequenceClassification(
        XLNetConfig.tiny(V), MultimodalConfig(dropout_prob=0.1,
                                              injection_index=1), DV, DA,
        device="cpu", generator=torch.Generator().manual_seed(seed))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, V, (B, S)).astype(np.int32)),
            torch.from_numpy(rng.randn(B, S, DV).astype(np.float32)),
            torch.from_numpy(rng.randn(B, S, DA).astype(np.float32)),
            torch.ones(B, S, dtype=torch.int32),
            torch.zeros(B, S, dtype=torch.int32),
            torch.from_numpy(rng.uniform(-3, 3, (B, 1)).astype(np.float32)))


def _state(family, seed=0):
    trainer = Trainer(model=_model(family, seed), tx=make_optimizer(1e-3, 8))
    return trainer.init_state(seed)


def _moments(state):
    """Every moment by (param name, key); a param without a gradient yet
    (XLNet's ``mask_emb`` outside the two-stream mode) has none."""
    opt = state.optimizer
    return {(name, key): opt.state[p][key].clone()
            for name, p in state.model.named_parameters()
            for key in ("exp_avg", "exp_avg_sq")
            if key in opt.state.get(p, {})}


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_round_trip_is_bit_exact(tmp_path, family):
    """Save after three steps; restore into a state built from another
    seed: params, moments, count, generator state and step are the saved
    ones, and both states take the next step to the same bits."""
    step = make_train_step()
    saved = _state(family)
    for i in range(3):
        step(saved, _batch(i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(saved, step=saved.step)
    assert mgr.latest_step() == 3

    other = _state(family, seed=7)
    step(other, _batch(9))  # moments and a count to be overwritten
    restored = mgr.restore(other, 3)
    assert restored is other and restored.step == 3
    assert restored.optimizer.count == saved.optimizer.count == 3
    assert torch.equal(restored.generator.get_state(),
                       saved.generator.get_state())
    want, got = saved.model.state_dict(), restored.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    want_m, got_m = _moments(saved), _moments(restored)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k

    for st in (saved, restored):
        step(st, _batch(3))
    for k, v in saved.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k


def test_files_max_to_keep_and_params_only(tmp_path):
    """Five saves keep the newest three; an interrupted write's temporary
    directory is no step; both files load with weights_only=True;
    ``restore_params`` needs no template and gives fp32 CPU tensors."""
    state = _state("bert")
    step = make_train_step()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore_params() is None
    assert mgr.restore_latest(state) is None
    for i in range(5):
        step(state, _batch(i))
        mgr.save(state, step=state.step)
    os.makedirs(os.path.join(mgr.directory, ".6.tmp-1"))
    os.makedirs(os.path.join(mgr.directory, "7"))  # no train_state.pt
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    for name in (PARAMS_FILE, TRAIN_STATE_FILE):
        torch.load(os.path.join(mgr.directory, "5", name),
                   weights_only=True)
    params = CheckpointManager(mgr.directory).restore_params()
    assert set(params) == set(state.model.state_dict())
    for k, v in state.model.state_dict().items():
        assert params[k].dtype == torch.float32
        assert params[k].device.type == "cpu"
        assert torch.equal(params[k], v), k
    n_params = sum(v.numel() for v in params.values())
    assert mgr.step_bytes(5) > 3 * 4 * n_params
    # saving a step again replaces it whole
    mgr.save(state, step=5)
    assert mgr.all_steps() == [3, 4, 5]


def test_predictor_from_checkpoint(tmp_path):
    """``Predictor.from_checkpoint`` loads the latest params into a fresh
    model and predicts what the trained model predicts; its scores carry
    the JAX metrics' keys; an empty directory raises."""
    state = _state("bert")
    make_train_step()(state, _batch(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, step=state.step)
    arrays = [t.numpy() for t in _batch(5)]
    split = PackedSplit(input_ids=arrays[0], visual=arrays[1],
                        acoustic=arrays[2], input_mask=arrays[3],
                        segment_ids=arrays[4],
                        label_ids=arrays[5].reshape(-1))
    want = Predictor(state.model, batch_size=3).predict_split(split)
    predictor = Predictor.from_checkpoint(_model("bert", seed=3),
                                          mgr.directory, batch_size=3)
    np.testing.assert_array_equal(predictor.predict_split(split), want)
    scores = predictor.score_split(split)
    assert set(scores) == set(jmetrics.score_regression(
        np.asarray(want), split.label_ids))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.from_checkpoint(_model("bert"), str(tmp_path / "empty"))


def test_checkpoint_modules_import_no_outside_package():
    """The slice's modules run where none of jax, flax, orbax,
    transformers and safetensors is installed (the chip's machine has
    neither of the last two): importing them pulls none of those in, nor
    the JAX package."""
    code = (
        "import sys\n"
        "import bert_multimodal_transformer_tpu_torch.utils.checkpoint\n"
        "import bert_multimodal_transformer_tpu_torch.utils.pretrained\n"
        "import bert_multimodal_transformer_tpu_torch.utils.safetensors_io\n"
        "import bert_multimodal_transformer_tpu_torch.utils.convert\n"
        "import bert_multimodal_transformer_tpu_torch.serving\n"
        "import bert_multimodal_transformer_tpu_torch.driver\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'orbax', 'transformers', 'safetensors',\n"
        "        'bert_multimodal_transformer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes: the fastest for
    them, and it keeps the module from competing with the parallel test
    workers for the host's cores (as ``tests/test_torch_resume.py``)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
