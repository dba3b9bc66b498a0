"""The port's training path (``training/trainer.py`` over the MAG-BERT
forward and backward, ``training/optim.py``) against the JAX package's
``Trainer``, on the CPU.

Both sides start from the same weights (the JAX params converted by
``utils/convert.params_from_flax``) and see the same batches, at
``BertConfig.tiny()`` in fp32 with every dropout 0 (the only randomness of
a step). Tolerances, as the JAX trainer's own torch-twin tests
(``tests/test_trajectory_torch.py``, ``tests/test_epoch_torch.py``):
losses rtol 1e-3 / atol 1e-6 and final params rtol 1e-3 / atol 5e-5 (fp32
drift from summation order compounds over the steps; a wrong eps, decay
group or grad scaling moves them by > 1e-2), epoch records rtol 2e-3.

With dropout on, no stream can be compared with JAX; the port's own
contract is checked instead: same seed, same step; the saved-probs and
recompute backward give the same step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MeshConfig as JMeshConfig,
    MultimodalConfig as JMultimodalConfig,
)
from bert_multimodal_transformer_tpu.data.pipeline import (
    BatchIterator as JBatchIterator,
    PackedSplit as JPackedSplit,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.parallel.mesh import make_mesh
from bert_multimodal_transformer_tpu.training import optim as joptim
from bert_multimodal_transformer_tpu.training import trainer as jtrainer
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttrainer
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

B, S, V, DV, DA = 8, 12, 128, 5, 7
LR, WD, WARMUP_PROP = 1e-3, 0.01, 0.1
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5
RECORD_RTOL = 2e-3
RECORD_KEYS = {"epoch", "train_loss", "valid_loss", "test_acc", "test_mae",
               "test_corr", "test_f_score", "best_valid_loss",
               "best_test_acc", "epoch_seconds"}


def _split(n, seed):
    """A seeded split with ragged lengths and labels in [-3, 3]."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, S + 1, n)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.randint(1, V, (n, S)).astype(np.int32) * mask
    segs = np.zeros((n, S), np.int32)
    visual = rng.randn(n, S, DV).astype(np.float32) * mask[..., None]
    acoustic = rng.randn(n, S, DA).astype(np.float32) * mask[..., None]
    labels = rng.uniform(-3, 3, n).astype(np.float32)
    return ids, visual, acoustic, mask, segs, labels


def _configs(attention_impl, rate=0.0):
    jcfg = dataclasses.replace(
        JBertConfig.tiny(V), attention_impl=attention_impl,
        hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)
    tcfg = dataclasses.replace(
        BertConfig.tiny(V), attention_impl=attention_impl,
        hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)
    return (jcfg, JMultimodalConfig(beta_shift=1.0, dropout_prob=rate),
            tcfg, MultimodalConfig(beta_shift=1.0, dropout_prob=rate))


def _pair(attention_impl="einsum", n_steps=20, grad_accum=1):
    """The JAX Trainer and the port's, over the same initial weights."""
    jcfg, jmm, tcfg, tmm = _configs(attention_impl)
    jmodel = jbert.MagBertForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA)
    sample = _split(B, 0)
    params = jmodel.init(jax.random.PRNGKey(0), *sample[:5])["params"]
    params = jax.device_get(params)
    jtx = joptim.make_optimizer(LR, n_steps, warmup_proportion=WARMUP_PROP,
                                weight_decay=WD)
    jtr = jtrainer.Trainer(
        model=jmodel, tx=jtx, grad_accum=grad_accum, donate=False,
        mesh=make_mesh(JMeshConfig(data_parallel=1),
                       devices=jax.devices()[:1]))
    jstate = jtr.create_state_from_params(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(1))

    tmodel = tbert.MagBertForSequenceClassification(tcfg, tmm, DV, DA,
                                                    device="cpu")
    ttx = toptim.make_optimizer(LR, n_steps, warmup_proportion=WARMUP_PROP,
                                weight_decay=WD)
    ttr = ttrainer.Trainer(model=tmodel, tx=ttx, grad_accum=grad_accum)
    tstate = ttr.create_state_from_params(params_from_flax(params), 1)
    return jtr, jstate, ttr, tstate


def _assert_params_close(jstate, tstate):
    want = params_from_flax(jax.device_get(jstate.params))
    got = tstate.model.state_dict()
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("attention_impl,n_steps",
                         [("einsum", 20), ("fused", 5)])
def test_train_steps_match_jax_trainer(attention_impl, n_steps):
    """The train step (forward, MSE, backward, HF AdamW with its schedule)
    for n_steps on the same batches: every loss and the final params."""
    jtr, jstate, ttr, tstate = _pair(attention_impl, n_steps)
    batches = [_split(B, 10 + i) for i in range(n_steps)]
    jl, tl = [], []
    for batch in batches:
        jstate, loss = jtr._train_step(jstate, jtr._put_batch(batch))
        jl.append(float(jax.device_get(loss)))
        tl.append(float(ttr._train_step(tstate, ttr._put_batch(batch))))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert abs(tl[0] - tl[-1]) > 1e-3  # the trajectory moved
    assert tstate.step == n_steps and tstate.optimizer.count == n_steps
    _assert_params_close(jstate, tstate)


def test_grad_accum_and_masked_tail_match_jax_trainer():
    """grad_accum=2 (two micro-batches, gradients averaged) on two full
    batches, then the masked step on a ragged batch of 5 valid rows
    zero-padded to 8 (gradients divided by the valid count)."""
    jtr, jstate, ttr, tstate = _pair("einsum", n_steps=3, grad_accum=2)
    jl, tl = [], []
    for i in range(2):
        batch = _split(B, 30 + i)
        jstate, loss = jtr._train_step(jstate, jtr._put_batch(batch))
        jl.append(float(jax.device_get(loss)))
        tl.append(float(ttr._train_step(tstate, ttr._put_batch(batch))))
    batch = _split(B, 40)
    valid = np.arange(B) < 5
    batch = tuple(np.where(valid.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
                  .astype(a.dtype) for a in batch)
    jstate, loss = jtr._train_step_masked(jstate, jtr._put_batch(batch),
                                          jtr._put_valid(valid))
    jl.append(float(jax.device_get(loss)))
    tl.append(float(ttr._train_step_masked(tstate, ttr._put_batch(batch),
                                           valid)))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_params_close(jstate, tstate)


def test_train_epochs_match_jax_trainer():
    """Trainer.train over 2 epochs of a 40/16/16 split at batch 8, the
    JAX loaders and the port's with the same seeds: the same record keys,
    and train/valid loss, MAE, corr, acc and F1 close."""
    n_epochs, sizes = 2, (40, 16, 16)
    splits = [_split(n, 50 + i) for i, n in enumerate(sizes)]
    total = -(-sizes[0] // B) * n_epochs
    jtr, jstate, ttr, tstate = _pair("einsum", n_steps=total)

    def loaders(split_cls, it_cls):
        return [it_cls(split_cls(*s), B, shuffle=i == 0,
                       drop_remainder=False, seed=9)
                for i, s in enumerate(splits)]

    _, jsum = jtr.train(jstate, *loaders(JPackedSplit, JBatchIterator),
                        n_epochs=n_epochs)
    _, tsum = ttr.train(tstate, *loaders(PackedSplit, BatchIterator),
                        n_epochs=n_epochs)
    assert tsum["interrupted"] is None and jsum["interrupted"] is None
    assert len(tsum["history"]) == len(jsum["history"]) == n_epochs
    for got, want in zip(tsum["history"], jsum["history"]):
        assert set(got) == set(want) == RECORD_KEYS
        assert got["epoch"] == want["epoch"]
        for key in ("train_loss", "valid_loss", "test_mae",
                    "best_valid_loss"):
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=RECORD_RTOL, err_msg=key)
        np.testing.assert_allclose(got["test_corr"], want["test_corr"],
                                   atol=0.02)
        # a classification metric flips only where a prediction crosses 0
        for key in ("test_acc", "test_f_score", "best_test_acc"):
            assert abs(got[key] - want[key]) <= 2.0 / sizes[2] + 1e-9, key
    np.testing.assert_allclose(tsum["best_valid_loss"],
                               jsum["best_valid_loss"], rtol=RECORD_RTOL)


def _dropout_trainer(attention_impl="fused"):
    _, _, tcfg, tmm = _configs(attention_impl, rate=0.1)
    model = tbert.MagBertForSequenceClassification(
        tcfg, tmm, DV, DA, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tx = toptim.make_optimizer(LR, 4, warmup_proportion=WARMUP_PROP)
    return ttrainer.Trainer(model=model, tx=tx)


def test_dropout_step_replays_from_its_seed(monkeypatch):
    """With dropout on: a step is finite and moves the params; the same
    weights and dropout seed give the same loss and params whether the
    attention backward runs from saved probs or recomputes them; another
    seed gives another loss."""
    batch = _split(B, 60)
    results = []
    for save, seed in (("1", 5), ("0", 5), ("1", 6)):
        monkeypatch.setenv("FUSED_ATTN_SAVE", save)
        tr = _dropout_trainer()
        start = {k: v.clone() for k, v in tr.model.state_dict().items()}
        state = tr.create_state_from_params(None, seed)
        loss = tr._train_step(state, tr._put_batch(batch))
        assert bool(torch.isfinite(loss))
        params = tr.model.state_dict()
        assert not torch.equal(params["classifier.weight"],
                               start["classifier.weight"])
        results.append((float(loss), params))
    (l_saved, p_saved), (l_recomputed, p_recomputed), (l_other, _) = results
    assert l_saved == l_recomputed
    for name, p in p_saved.items():
        torch.testing.assert_close(p, p_recomputed[name], rtol=0,
                                   atol=1e-7, msg=name)
    assert l_other != l_saved


def test_init_state_is_seeded():
    tr = _dropout_trainer("einsum")
    tr.init_state(3)
    a = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.init_state(4)
    b = {k: v.clone() for k, v in tr.model.state_dict().items()}
    state = tr.init_state(3)
    assert all(torch.equal(a[k], v) for k, v in
               tr.model.state_dict().items())
    assert not torch.equal(a["classifier.weight"], b["classifier.weight"])
    assert state.step == 0 and state.optimizer.count == 0


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "A.10"),
    ({"tp_shard_attention": True}, "A.10"),
    ({"fsdp": True}, "A.10"),
    ({"multiprocess": True}, "A.10"),
    ({"compiler_options": {"x": "1"}}, "A.10"),
    ({"mem_len": 4}, "A.8"),
])
def test_unported_trainer_options_raise(kw, item):
    """An option whose item is open raises naming it. ``mem_len`` (A.8) is
    ported: on MAG-BERT, whose config has no memory, it raises as the JAX
    trainer does, naming ``config.mem_len``. ``mesh`` and
    ``tp_shard_attention`` (the A.10 tensor parallelism for MAG-BERT) are
    ported: a mesh that is not a ``parallel.mesh.Mesh`` raises, and
    tp_shard_attention without a model axis > 1 raises the JAX trainer's
    guard (tests/test_torch_tensor_parallel.py runs them on ranks).
    ``compiler_options`` are XLA's and have no torch counterpart: they
    raise ValueError saying so, naming no item. ``fsdp`` (A.10.2) is
    ported: without a mesh there is no data axis to split over, so the
    trainer builds and steps as the plain one (JAX's one-device mesh
    replicates every leaf the same way; the ranks run in
    tests/test_torch_fsdp.py). ``multiprocess`` (A.10.4) is ported: in
    one process the process's rows are the whole batch, so the trainer
    steps as the plain one, bit for bit; with ``mem_len`` it raises the
    JAX trainer's refusal (the processes run in
    tests/test_torch_multiprocess.py)."""
    _, _, tcfg, tmm = _configs("einsum")
    model = tbert.MagBertForSequenceClassification(tcfg, tmm, DV, DA,
                                                   device="cpu")
    if item == "A.8":
        with pytest.raises(ValueError, match="config.mem_len"):
            ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                             **kw)
        return
    if "mesh" in kw or "tp_shard_attention" in kw:
        exc, match = ((TypeError, "parallel.mesh.Mesh") if "mesh" in kw
                      else (ValueError, "model axis > 1"))
        with pytest.raises(exc, match=match):
            ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                             **kw)
        return
    if "fsdp" in kw:
        tr = ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                              **kw)
        st = tr.init_state(0)
        assert getattr(model, "fsdp_sharding", None) is None
        assert st.step == 0
        return
    if "multiprocess" in kw:
        with pytest.raises(ValueError, match="multiprocess does not "
                           "compose with mem_len") as e:
            ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                             mem_len=4, **kw)
        assert "ROADMAP" not in str(e.value)
        losses = []
        for multiprocess in (True, False):
            model = tbert.MagBertForSequenceClassification(tcfg, tmm, DV, DA,
                                                           device="cpu")
            tr = ttrainer.Trainer(model=model,
                                  tx=toptim.make_optimizer(LR, 1),
                                  multiprocess=multiprocess)
            st = tr.init_state(0)
            batch = _split(B, seed=3)
            losses.append((float(tr._train_step(st, tr._put_batch(batch))),
                           model.classifier.weight.detach().clone()))
        assert losses[0][0] == losses[1][0]
        assert torch.equal(losses[0][1], losses[1][1])
        return
    if "compiler_options" in kw:
        with pytest.raises(ValueError, match="XLA compiler options") as e:
            ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                             **kw)
        assert "ROADMAP" not in str(e.value)
        return
    with pytest.raises(NotImplementedError, match=item):
        ttrainer.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                         **kw)


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
