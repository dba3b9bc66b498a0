"""The port's models and ``Trainer`` under ``rng_impl="threefry2x32"``
against the JAX package's under its default threefry2x32 stream, on the
CPU, with dropout on (rate 0.1 at every site).

Where the two sides draw the same masks, a dropout-on forward and train
step agree as closely as dropout-off ones do, so the bands are the
dropout-off bands the port's tests already use: forward logits rtol 1e-4 /
atol 1e-5 (``tests/test_parity_torch.py``), losses rtol 1e-3 / atol 1e-6
and params rtol 1e-3 / atol 5e-5 (``tests/test_torch_training.py``). A
mask drawn from another key moves the logits and the loss by far more
(checked against a neighbouring key).

* The einsum forward of tiny MAG-BERT and MAG-XLNet from the same weights;
* ``Trainer.init_state(seed)`` against the JAX trainer's
  ``init_state(PRNGKey(seed), sample)`` (the params within 2e-6 relative,
  the state key equal), then two train steps, at grad_accum 1 and 2;
* on the fused branch each layer's kernel seed is JAX's ``randint`` of
  that site's key (the JAX fused model run in interpret mode, its
  ``make_rng`` intercepted);
* a rematerialized step equals the plain step bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MeshConfig as JMeshConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.models import xlnet as jxlnet
from bert_multimodal_transformer_tpu.parallel.mesh import make_mesh
from bert_multimodal_transformer_tpu.training import optim as joptim
from bert_multimodal_transformer_tpu.training import trainer as jtrainer
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.models import xlnet as txlnet
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.dropout import ThreefryRngs
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr
from bert_multimodal_transformer_tpu_torch.utils import jax_random as jr
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
    xlnet_params_from_flax,
)

B, S, V, DV, DA = 8, 10, 64, 5, 7
RATE = 0.1
LR, WARMUP_PROP = 1e-3, 0.1
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5
NORMAL_RTOL = 2e-6


def _batch(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(4, S + 1, B)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.randint(1, V, (B, S)).astype(np.int32) * mask
    segs = np.zeros((B, S), np.int32)
    vis = rng.randn(B, S, DV).astype(np.float32) * mask[..., None]
    ac = rng.randn(B, S, DA).astype(np.float32) * mask[..., None]
    labels = rng.uniform(-3, 3, B).astype(np.float32)
    return ids, vis, ac, mask, segs, labels


def _models(family, impl="einsum", remat=False):
    if family == "bert":
        jc = dataclasses.replace(
            JBertConfig.tiny(V), attention_impl=impl,
            hidden_dropout_prob=RATE, attention_probs_dropout_prob=RATE)
        tc = dataclasses.replace(
            BertConfig.tiny(V), attention_impl=impl,
            hidden_dropout_prob=RATE, attention_probs_dropout_prob=RATE)
        return (jbert.MagBertForSequenceClassification(
                    jc, JMultimodalConfig(dropout_prob=RATE), DV, DA),
                tbert.MagBertForSequenceClassification(
                    tc, MultimodalConfig(dropout_prob=RATE), DV, DA,
                    remat=remat, device="cpu"), params_from_flax)
    jc = dataclasses.replace(JXLNetConfig.tiny(V), attention_impl=impl,
                             dropout=RATE)
    tc = dataclasses.replace(XLNetConfig.tiny(V), attention_impl=impl,
                             dropout=RATE)
    mm = dict(dropout_prob=RATE, injection_index=1)
    return (jxlnet.MagXLNetForSequenceClassification(
                jc, JMultimodalConfig(**mm), DV, DA),
            txlnet.MagXLNetForSequenceClassification(
                tc, MultimodalConfig(**mm), DV, DA, remat=remat,
                device="cpu"), xlnet_params_from_flax)


def _torch_forward(model, batch, key):
    ids, vis, ac, mask, segs = (torch.from_numpy(a) for a in batch[:5])
    return model(ids, vis, ac, attention_mask=mask, token_type_ids=segs,
                 deterministic=False,
                 dropout_rng=ThreefryRngs.from_key(key)).detach().numpy()


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_dropout_forward_matches_jax(family):
    jm, tm, convert = _models(family)
    batch = _batch(0)
    params = jm.init(jax.random.PRNGKey(0), *batch[:5])["params"]
    tm.load_state_dict(convert(jax.device_get(params)), strict=False)
    want = np.asarray(jm.apply(
        {"params": params}, *batch[:3], attention_mask=batch[3],
        token_type_ids=batch[4], deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(5)}))
    got = _torch_forward(tm, batch, jr.PRNGKey(5))
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    other = _torch_forward(tm, batch, jr.PRNGKey(6))
    assert np.abs(other - want).max() > 100 * FWD_ATOL


def _pair(family, grad_accum, n_steps=2):
    """The JAX Trainer and the port's, each from its own init_state at
    seed 3 (the port's Trainer under threefry2x32)."""
    jm, tm, _ = _models(family)
    sample = _batch(0)
    jtr = jtrainer.Trainer(
        model=jm, grad_accum=grad_accum, donate=False,
        tx=joptim.make_optimizer(LR, n_steps, warmup_proportion=WARMUP_PROP),
        mesh=make_mesh(JMeshConfig(data_parallel=1),
                       devices=jax.devices()[:1]))
    jstate = jtr.init_state(jax.random.PRNGKey(3), sample)
    ttrainer = ttr.Trainer(
        model=tm, grad_accum=grad_accum, rng_impl="threefry2x32",
        tx=toptim.make_optimizer(LR, n_steps, warmup_proportion=WARMUP_PROP))
    tstate = ttrainer.init_state(3)
    return jtr, jstate, ttrainer, tstate


def _assert_params_close(jstate, tstate, family, **tol):
    convert = params_from_flax if family == "bert" else \
        xlnet_params_from_flax
    want = convert(jax.device_get(jstate.params))
    got = tstate.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("family,grad_accum", [("bert", 1), ("bert", 2),
                                               ("xlnet", 1)])
def test_init_and_two_steps_match_jax_trainer(family, grad_accum):
    jtr, jstate, ttrainer, tstate = _pair(family, grad_accum)
    _assert_params_close(jstate, tstate, family, rtol=NORMAL_RTOL, atol=0)
    assert tstate.generator.key == tuple(
        int(x) for x in np.asarray(jstate.rng))
    jl, tl = [], []
    for i in range(2):
        batch = _batch(10 + i)
        jstate, loss = jtr._train_step(jstate, jtr._put_batch(batch))
        jl.append(float(jax.device_get(loss)))
        tl.append(float(ttrainer._train_step(tstate,
                                             ttrainer._put_batch(batch))))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_params_close(jstate, tstate, family, rtol=PARAM_RTOL,
                         atol=PARAM_ATOL)
    assert tstate.generator.key == tuple(
        int(x) for x in np.asarray(jstate.rng))


@pytest.mark.parametrize("family,impl", [("bert", "fused"),
                                         ("xlnet", "fused")])
def test_fused_kernel_seeds_are_jaxs_randint(family, impl, monkeypatch):
    """Each layer's kernel seed: JAX's ``randint(key, (1, 1), 0, 2**31 −
    1)`` of the key its fused model draws at that attention scope."""
    jm, tm, convert = _models(family, impl)
    batch = _batch(1)
    params = jm.init(jax.random.PRNGKey(0), *batch[:5])["params"]
    keys = []
    real = flax_scope.Scope.make_rng

    def make_rng(self, name="params"):
        key = real(self, name)
        if name == "dropout" and self.path[-1] in ("attention", "rel_attn"):
            keys.append(key)
        return key

    monkeypatch.setattr(flax_scope.Scope, "make_rng", make_rng)
    jm.apply({"params": params}, *batch[:3], attention_mask=batch[3],
             token_type_ids=batch[4], deterministic=False,
             rngs={"dropout": jax.random.PRNGKey(5)})
    want = [int(jax.random.randint(k, (1, 1), 0, 2 ** 31 - 1)[0, 0])
            for k in keys]
    seeds = []
    real_draw = tfa.draw_seed

    def draw_seed(rng):
        seeds.append(real_draw(rng))
        return seeds[-1]

    monkeypatch.setattr(tfa, "draw_seed", draw_seed)
    tm.load_state_dict(convert(jax.device_get(params)), strict=False)
    with torch.no_grad():
        _torch_forward(tm, batch, jr.PRNGKey(5))
    assert len(want) == 2 and seeds == want


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_remat_step_equals_the_plain_step_bit_for_bit(family):
    """One threefry train step with each layer rematerialized: the
    recompute rederives the keys from the scope counters, so the loss and
    every parameter equal the plain step's."""
    out = []
    for remat in (False, True):
        _, tm, _ = _models(family, remat=remat)
        tr = ttr.Trainer(model=tm, rng_impl="threefry2x32",
                         tx=toptim.make_optimizer(LR, 2))
        st = tr.init_state(4)
        loss = float(tr._train_step(st, tr._put_batch(_batch(20))))
        out.append((loss, {k: v.clone() for k, v in
                           tm.state_dict().items()}))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


@pytest.fixture(autouse=True, scope="module")
def _jax_threefry():
    """JAX's default stream, threefry2x32, for this module: the JAX
    driver's tests run in process set ``jax_default_prng_impl`` from its
    ``--rng_impl`` flag (default rbg) and a worker runs modules one after
    another."""
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", before)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
