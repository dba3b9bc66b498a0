"""XLNet's memory (segment recurrence) in the port: the model with ``mems``
and ``use_cache``, the trainer's memory steps and epoch loops, the
``Predictor(mem_len=)`` chain and the driver's ``--mem_len``, against the
JAX package on the same weights and seeded inputs (the port's counterparts
of ``tests/test_mems_trainer.py``), plus the long-memory geometries that
reach the flash-streamed rel tiers.

Tolerances: fp32 logits 1e-4 abs and the new memory 1e-5 (two layers of
the same math summed in another order, as ``tests/test_torch_xlnet.py``;
the memory is a layer's input, one layer shallower than the logits).
Training: the bands of ``tests/test_torch_training.py`` (losses rtol 1e-3,
params rtol 1e-3 / atol 5e-5). Fused against einsum at long memory: the
gradients 1e-4 relative to each leaf's largest entry, the losses 5e-3
relative (the JAX package's own band for that comparison).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    MeshConfig as JMeshConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.data.pipeline import (
    PackedSplit as JPackedSplit,
)
from bert_multimodal_transformer_tpu.models import xlnet as jxl
from bert_multimodal_transformer_tpu.parallel.mesh import make_mesh
from bert_multimodal_transformer_tpu.serving import Predictor as JPredictor
from bert_multimodal_transformer_tpu.training import optim as joptim
from bert_multimodal_transformer_tpu.training import trainer as jtrainer
from bert_multimodal_transformer_tpu_torch.config import (
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttrainer
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    xlnet_params_from_flax,
)

B, S, V, DV, DA, MLEN = 8, 10, 128, 5, 7, 6
LOGITS_ATOL, MEMS_ATOL = 1e-4, 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5


def _inputs(n=B, s=S, seed=0):
    """Left-padded XLNet rows (row 0 unpadded), segments 0 / 2 (<cls>) / 3
    (pads), modality rows zero on pads, labels."""
    rng = np.random.RandomState(seed)
    n_real = rng.randint(3, s + 1, n)
    n_real[0] = s
    real = np.arange(s)[None, :] >= (s - n_real)[:, None]
    ids = np.where(real, rng.randint(5, V, (n, s)), 2).astype(np.int32)
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    vis = (rng.randn(n, s, DV) * real[..., None]).astype(np.float32)
    ac = (rng.randn(n, s, DA) * real[..., None]).astype(np.float32)
    labels = rng.uniform(-3, 3, n).astype(np.float32)
    return ids, vis, ac, real.astype(np.int32), segs, labels


def _configs(mem_len=MLEN, **kw):
    common = dict(mem_len=mem_len, dropout=0.0, summary_last_dropout=0.0,
                  **kw)
    return (dataclasses.replace(JXLNetConfig.tiny(V), **common),
            dataclasses.replace(XLNetConfig.tiny(V), **common))


def _mm():
    return (JMultimodalConfig(beta_shift=1.0, dropout_prob=0.0,
                              injection_index=1),
            MultimodalConfig(beta_shift=1.0, dropout_prob=0.0,
                             injection_index=1))


@pytest.fixture(scope="module")
def jparams():
    """One JAX init of the tiny MAG-XLNet (no target_mapping: no
    mask_emb, which nothing here reads)."""
    jcfg, _ = _configs()
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, _mm()[0], visual_dim=DV, acoustic_dim=DA)
    ids, vis, ac, mask, segs, _ = _inputs()
    params = jmodel.init(jax.random.PRNGKey(0), ids, vis, ac,
                         attention_mask=mask, token_type_ids=segs)["params"]
    return jax.device_get(params)


def _pair(params, **kw):
    jcfg, tcfg = _configs(**kw)
    jmm, tmm = _mm()
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA)
    tmodel = txl.MagXLNetForSequenceClassification(tcfg, tmm, DV, DA,
                                                   device="cpu")
    missing, unexpected = tmodel.load_state_dict(
        xlnet_params_from_flax(params), strict=False)
    assert missing == ["transformer.mask_emb"] and not unexpected
    return jmodel, tmodel


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _mems(seed, n=B, mlen=MLEN, d=32, layers=2):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(n, mlen, d).astype(np.float32)
                 for _ in range(layers))


def _both(jmodel, jparams, tmodel, batch, mems):
    """(JAX, port) (logits, new mems) of one use_cache call."""
    ids, vis, ac, mask, segs, _ = batch
    jout = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        mems=tuple(jnp.asarray(m) for m in mems),
                        use_cache=True)
    with torch.no_grad():
        tout = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                      token_type_ids=torch.from_numpy(segs),
                      mems=[torch.as_tensor(np.asarray(m)) for m in mems],
                      use_cache=True)
    return (jout[0], jout[1]), (tout[0], tout[1])


def _close_out(j, t):
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                               atol=LOGITS_ATOL, rtol=0)
    assert len(t[1]) == len(j[1])
    for a, w in zip(t[1], j[1]):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=MEMS_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["bi", "reuse_len", "uni"])
@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_model_with_memory_matches_jax(jparams, attention_impl, mode):
    """Two chained segments through the classifier's use_cache path (K =
    MLEN + S, the memory columns unmasked, segment 0, positions from
    klen): the logits and each layer's new memory against the JAX model,
    the second segment reading the first's memory; in bi attention, with
    ``reuse_len`` (the memory keeps the first rows of each segment) and in
    uni attention (the causal mask over memory and segment)."""
    kw = {"bi": {}, "reuse_len": {"reuse_len": 4},
          "uni": {"attn_type": "uni"}}[mode]
    jmodel, tmodel = _pair(jparams, attention_impl=attention_impl, **kw)
    j, t = _both(jmodel, jparams, tmodel, _inputs(seed=1), _mems(3))
    _close_out(j, t)
    j2, t2 = _both(jmodel, jparams, tmodel, _inputs(seed=2),
                   [np.asarray(m) for m in j[1]])
    _close_out(j2, t2)
    if mode == "reuse_len":
        # the new memory ends with rows 0..3 of the segment's layer input
        h0 = tmodel.transformer.word_embedding.weight[
            torch.from_numpy(_inputs(seed=2)[0][:, :4]).long()]
        np.testing.assert_array_equal(t2[1][0][:, -4:].numpy(),
                                      h0.detach().numpy())


def test_memory_matters_and_is_detached(jparams):
    """The memory changes the logits, and the new memory carries no
    gradient while the loss reaches the params through it."""
    _, tmodel = _pair(jparams)
    ids, vis, ac, mask, segs, _ = _inputs(seed=4)
    kw = dict(attention_mask=torch.from_numpy(mask),
              token_type_ids=torch.from_numpy(segs), use_cache=True)
    zeros = [torch.zeros(B, MLEN, 32) for _ in range(2)]
    a, new = tmodel(*_t(ids, vis, ac), mems=zeros, **kw)[:2]
    b = tmodel(*_t(ids, vis, ac), mems=[m * 3 + 1 for m in new], **kw)[0]
    assert float((a - b).abs().max()) > 1e-6
    assert all(not m.requires_grad for m in new)
    b.sum().backward()
    assert tmodel.transformer.layer[0].rel_attn.k.grad is not None


def test_long_memory_fused_fs_matches_jax_einsum(jparams):
    """Q = 384 with a 384-row memory (K = 768, past the head-blocked reach)
    under ``rel_bias_impl="stream"``: every layer takes the rel
    flash-streamed tier (#16/#17's plain versions), and the logits, the
    new memory and one step's gradients match the JAX einsum model."""
    s, mlen = 384, 384
    jmodel, tmodel = _pair(jparams, mem_len=mlen, attention_impl="fused",
                           rel_bias_impl="stream")
    jmodel = jxl.MagXLNetForSequenceClassification(
        _configs(mem_len=mlen)[0], _mm()[0], visual_dim=DV, acoustic_dim=DA)
    b = 2
    ids, vis, ac, mask, segs, _ = _inputs(n=b, s=s, seed=5)
    mems = _mems(6, n=b, mlen=mlen)
    c = np.random.RandomState(1).randn(b, 1).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, ids, vis, ac, attention_mask=mask,
                           token_type_ids=segs, mems=tuple(mems),
                           use_cache=True)
        return jnp.sum(out[0] * c), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams)
    names = ("attn_fwd_rel_fs_reference", "attn_bwd_rel_fs_reference")
    before = [getattr(tfa, n).calls for n in names]
    logits, new = tmodel(*_t(ids, vis, ac),
                         attention_mask=torch.from_numpy(mask),
                         token_type_ids=torch.from_numpy(segs),
                         mems=list(_t(*mems)), use_cache=True)[:2]
    (logits * torch.from_numpy(c)).sum().backward()
    assert [getattr(tfa, n).calls - x for n, x in zip(names, before)] == [
        2, 2]
    _close_out(want, (logits.detach(), new))
    grads = xlnet_params_from_flax(jax.device_get(want_g))
    for name, p in tmodel.named_parameters():
        if name.endswith("mask_emb"):
            continue
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   rtol=0, err_msg=name)


# --- the trainer -------------------------------------------------------------


def _trainers(params, n_steps=4, grad_accum=1, **kw):
    """The JAX Trainer and the port's over the same weights, with the
    memory, every dropout 0."""
    jcfg, tcfg = _configs(**kw)
    jmm, tmm = _mm()
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA)
    lr, warm = 1e-3, 0.1
    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(lr, n_steps, warm),
        grad_accum=grad_accum, donate=False, mem_len=jcfg.mem_len,
        mesh=make_mesh(JMeshConfig(data_parallel=1),
                       devices=jax.devices()[:1]))
    jstate = jtr.create_state_from_params(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(1))
    tmodel = txl.MagXLNetForSequenceClassification(tcfg, tmm, DV, DA,
                                                   device="cpu")
    tmodel.load_state_dict(xlnet_params_from_flax(params), strict=False)
    ttr = ttrainer.Trainer(model=tmodel,
                           tx=toptim.make_optimizer(lr, n_steps, warm),
                           grad_accum=grad_accum, mem_len=tcfg.mem_len)
    return jtr, jstate, ttr, ttr.create_state_from_params(None, 1)


def _assert_params_close(jstate, tstate):
    want = xlnet_params_from_flax(jax.device_get(jstate.params))
    got = tstate.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def _assert_mems_close(jm, tm, atol=MEMS_ATOL):
    for a, w in zip(tm, jm, strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=PARAM_RTOL)


def test_predict_chain_matches_manual_chain_and_jax(jparams):
    """The trainer's carried predict chain equals the model's use_cache
    path driven by hand from zeros, and the JAX trainer's chain; segment
    2 reflects segment 1's memory."""
    jtr, jstate, ttr, tstate = _trainers(jparams)
    b1, b2 = _inputs(seed=10), _inputs(seed=11)
    mems = ttr._init_mems(b1)
    assert [tuple(m.shape) for m in mems] == [(B, MLEN, 32)] * 2
    assert all(m.dtype == torch.float32 and not bool(m.any()) for m in mems)
    p1, _, m1 = ttrainer.mems_predict_step(tstate, ttr._put_batch(b1), mems)
    p2, _, _ = ttrainer.mems_predict_step(tstate, ttr._put_batch(b2), m1)
    jm = jtr._init_mems(b1)
    jp1, _, jm1 = jtr._predict_step_mems(jstate, jtr._put_batch(b1), jm)
    jp2, _, _ = jtr._predict_step_mems(jstate, jtr._put_batch(b2), jm1)
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp1), atol=LOGITS_ATOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp2), atol=LOGITS_ATOL)
    _assert_mems_close(jm1, m1)

    def manual(batch, mems_in):
        ids, vis, ac, mask, segs, _ = batch
        with torch.no_grad():
            out = tstate.model(*_t(ids, vis, ac),
                               attention_mask=torch.from_numpy(mask),
                               token_type_ids=torch.from_numpy(segs),
                               mems=mems_in, use_cache=True)
        return out[0].reshape(-1), out[1]

    zeros = [torch.zeros(B, MLEN, 32) for _ in range(2)]
    l1, mm1 = manual(b1, zeros)
    l2, _ = manual(b2, mm1)
    assert torch.equal(l1, p1) and torch.equal(l2, p2)
    fresh, _ = manual(b2, zeros)
    assert float((l2 - fresh).abs().max()) > 1e-6


def test_train_and_carry_match_jax(jparams):
    """Three memory train steps (the memory carried), then the epoch
    loops: each against the JAX trainer on the same batches — the losses,
    the params, the carried memory, the mean dev MSE and the test
    predictions; the carried memory is not zero after a real segment."""
    jtr, jstate, ttr, tstate = _trainers(jparams, n_steps=6)
    jm, tm = jtr._init_mems(_inputs()), ttr._init_mems(_inputs())
    jl, tl = [], []
    for i in range(3):
        batch = _inputs(seed=20 + i)
        jstate, loss, jm = jtr._train_step_mems(jstate, jtr._put_batch(batch),
                                                jm)
        jl.append(float(loss))
        loss, tm = ttr._train_step_mems(tstate, ttr._put_batch(batch), tm)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert float(tm[0].abs().max()) > 0
    _assert_mems_close(jm, tm, atol=PARAM_ATOL)
    _assert_params_close(jstate, tstate)
    loader = [(_inputs(seed=30), np.ones(B, bool)),
              (_inputs(seed=31), np.ones(B, bool))]
    jstate, jmean = jtr.train_epoch(jstate, loader)
    tstate, tmean = ttr.train_epoch(tstate, loader)
    np.testing.assert_allclose(tmean, jmean, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ttr.eval_epoch(tstate, loader),
                               jtr.eval_epoch(jstate, loader),
                               rtol=LOSS_RTOL)
    tp, _ = ttr.test_epoch(tstate, loader)
    jp, _ = jtr.test_epoch(jstate, loader)
    assert tp.shape == (2 * B,) and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=LOSS_RTOL)


def test_trainer_validates_mem_len():
    """As the JAX trainer: ``Trainer(mem_len=)`` needs the model built with
    the same ``config.mem_len``."""
    _, tcfg = _configs(mem_len=None)
    model = txl.MagXLNetForSequenceClassification(tcfg, _mm()[1], DV, DA,
                                                  device="cpu")
    with pytest.raises(ValueError, match="config.mem_len"):
        ttrainer.Trainer(model=model, tx=toptim.make_optimizer(1e-3, 10),
                         mem_len=MLEN)
    with pytest.raises(ValueError, match="config.mem_len"):
        Predictor(model, batch_size=B, mem_len=MLEN)


def test_grad_accum_chains_the_memory_like_jax(jparams):
    """grad_accum = 2 with the memory: the two micro-batches run as
    sequential segments (micro 2 reads micro 1's memory) against the
    step's params; the memory is B/A rows, the returned memory the last
    micro-batch's. Against the JAX trainer: the loss, the params, the
    memory; a broken chain (zeros into micro 2) gives another loss."""
    jtr, jstate, ttr, tstate = _trainers(jparams, grad_accum=2)
    b1, b2 = _inputs(seed=40), _inputs(seed=41)
    big = tuple(np.concatenate([a, b]) for a, b in zip(b1, b2))
    tm = ttr._init_mems(big, for_train=True)
    assert tm[0].shape[0] == B   # micro rows, not the 16-row batch
    jm = jtr._init_mems(big, for_train=True)
    jstate, jl, jm = jtr._train_step_mems(jstate, jtr._put_batch(big), jm)
    tl, tm = ttr._train_step_mems(tstate, ttr._put_batch(big), tm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_mems_close(jm, tm)
    _assert_params_close(jstate, tstate)
    # the chain matters: micro 2 from zeros scores another loss
    _, tmodel = _pair(jparams)
    zeros = [torch.zeros(B, MLEN, 32) for _ in range(2)]
    ids, vis, ac, mask, segs, labels = b1
    with torch.no_grad():
        m1 = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                    token_type_ids=torch.from_numpy(segs), mems=zeros,
                    use_cache=True)[1]
        ids, vis, ac, mask, segs, labels = b2
        kw = dict(attention_mask=torch.from_numpy(mask),
                  token_type_ids=torch.from_numpy(segs), use_cache=True)
        chained = tmodel(*_t(ids, vis, ac), mems=list(m1), **kw)[0]
        fresh = tmodel(*_t(ids, vis, ac), mems=zeros, **kw)[0]
    assert float((chained - fresh).abs().max()) > 1e-6


def test_masked_tail_carries_the_memory_like_jax(jparams):
    """The ragged tail batch (5 valid rows zero-padded to 8) through the
    masked memory step, after a full step, against the JAX trainer's
    ``_train_step_mems_masked``: the loss, the params and the carried
    memory; and with every row valid the masked step is the unmasked
    one."""
    jtr, jstate, ttr, tstate = _trainers(jparams)
    jm, tm = jtr._init_mems(_inputs()), ttr._init_mems(_inputs())
    batch = _inputs(seed=50)
    jstate, jl0, jm = jtr._train_step_mems(jstate, jtr._put_batch(batch), jm)
    tl0, tm = ttr._train_step_mems(tstate, ttr._put_batch(batch), tm)
    valid = np.arange(B) < 5
    batch = tuple(np.where(valid.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
                  .astype(a.dtype) for a in _inputs(seed=51))
    jstate, jl1, jm = jtr._train_step_mems_masked(
        jstate, jtr._put_batch(batch), jm, jtr._put_valid(valid))
    tl1, tm = ttr._train_step_mems_masked(tstate, ttr._put_batch(batch), tm,
                                          valid)
    np.testing.assert_allclose([float(tl0), float(tl1)],
                               [float(jl0), float(jl1)], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _assert_mems_close(jm, tm, atol=PARAM_ATOL)
    _assert_params_close(jstate, tstate)
    # every row valid: the masked step is the unmasked one
    _, _, ttr2, st_a = _trainers(jparams)
    _, _, ttr3, st_b = _trainers(jparams)
    full = ttr2._put_batch(_inputs(seed=52))
    la, ma = ttr2._train_step_mems(st_a, full, ttr2._init_mems(_inputs()))
    lb, mb = ttr3._train_step_mems_masked(st_b, full,
                                          ttr3._init_mems(_inputs()),
                                          np.ones(B, bool))
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-6)
               for a, b in zip(ma, mb))


def test_predictor_with_memory_matches_the_trainer_chain_and_jax(jparams):
    """``Predictor(mem_len=)`` over a 20-row split (8 + 8 + a ragged 4) at
    batch 8: the trainer's memory test chain, the JAX ``Predictor(mem_len
    =)``; a predictor without memory scores otherwise; a memory predictor
    refuses independent requests."""
    jmodel, tmodel = _pair(jparams)
    arrays = _inputs(n=20, seed=60)
    split = PackedSplit(*arrays)
    ttr = ttrainer.Trainer(model=tmodel, tx=toptim.make_optimizer(1e-3, 4),
                           mem_len=MLEN)
    state = ttr.create_state_from_params(None, 1)
    want, _ = ttr.test_epoch(state, BatchIterator(split, B, shuffle=False,
                                                  drop_remainder=False))
    pred = Predictor(tmodel, batch_size=B, mem_len=MLEN)
    got = pred.predict_split(split)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jpred = JPredictor(jmodel, jparams,
                       mesh=make_mesh(JMeshConfig(data_parallel=1),
                                      devices=jax.devices()[:1]),
                       batch_size=B, mem_len=MLEN)
    np.testing.assert_allclose(got, jpred.predict_split(JPackedSplit(*arrays)),
                               atol=LOGITS_ATOL, rtol=0)
    plain = Predictor(tmodel, batch_size=B).predict_split(split)
    assert float(np.abs(plain - got).max()) > 1e-6
    with pytest.raises(ValueError, match="predict_split"):
        pred.submit(*arrays[:5])
    with pytest.raises(ValueError, match="predict_split"):
        next(pred.predict_requests([arrays[:5]]))


def test_driver_mem_len_end_to_end(monkeypatch, capsys):
    """``--mem_len`` through the port's CLI on MAG-XLNet (train, eval and
    test with the memory), alone and with ``--gradient_accumulation_step
    2`` (the memory has the micro-batch's rows): exit 0, finite records, a
    fresh memory per epoch and per split; on MAG-BERT, exit 2 with the JAX
    driver's message."""
    from bert_multimodal_transformer_tpu_torch import driver as tdriver
    from bert_multimodal_transformer_tpu_torch.utils import logging as tlog

    monkeypatch.setenv("WANDB_MODE", "disabled")
    records, inits = [], []
    monkeypatch.setattr(tlog.MetricLogger, "log",
                        lambda self, rec: records.append(rec))
    real = ttrainer.Trainer._init_mems

    def init(self, batch, **kw):
        mems = real(self, batch, **kw)
        inits.append((np.asarray(batch[0]).shape[0], tuple(mems[0].shape),
                      kw.get("for_train", False)))
        return mems

    monkeypatch.setattr(ttrainer.Trainer, "_init_mems", init)
    common = ["--model", "xlnet-base-cased", "--dataset", "mosi",
              "--synthetic", "--tiny", "--n_epochs", "1",
              "--dev_batch_size", "8", "--test_batch_size", "8",
              "--seed", "3", "--compute_dtype", "float32", "--mem_len", "8",
              "--device", "cpu"]
    rc = tdriver.main(common + ["--train_batch_size", "8",
                                "--synthetic_sizes", "16", "8", "8"])
    assert rc == 0 and len(records) == 1
    assert np.isfinite(records[0]["train_loss"])
    assert np.isfinite(records[0]["test_mae"])
    assert inits == [(8, (8, 8, 32), True), (8, (8, 8, 32), False),
                     (8, (8, 8, 32), False)]
    inits.clear()
    rc = tdriver.main(common + ["--train_batch_size", "8",
                                "--gradient_accumulation_step", "2",
                                "--synthetic_sizes", "32", "8", "8"])
    assert rc == 0 and np.isfinite(records[-1]["train_loss"])
    # a 16-row loader batch runs as two 8-row segments
    assert inits[0] == (16, (8, 8, 32), True)
    capsys.readouterr()
    rc = tdriver.main(["--model", "bert-base-uncased", "--synthetic",
                       "--tiny", "--mem_len", "8", "--device", "cpu"])
    assert rc == 2 and "XLNet" in capsys.readouterr().err


def test_mems_relik_fs_tier_matches_einsum():
    """Long memory under ``rel_bias_impl="auto"``: qlen = mlen = 128 (K =
    256) at H = 4, Dh = 32, past the full-H backward's reach, routes the
    fused branch onto the ingredients fs tier (#23/#24's plain versions,
    P = 2·qlen + mlen ≥ Q + K) through three memory train steps, and the
    losses match the einsum branch's."""
    h, dh, ql, ml = 4, 32, 128, 128
    assert tfa.rel_tier(ql, ql + ml, dh, True, True) == "ik_fs"

    def run(attention_impl):
        _, tcfg = _configs(mem_len=ml)
        cfg = dataclasses.replace(tcfg, d_model=h * dh, n_head=h,
                                  d_inner=2 * h * dh,
                                  attention_impl=attention_impl,
                                  rel_bias_impl="auto")
        model = txl.MagXLNetForSequenceClassification(
            cfg, _mm()[1], DV, DA, device="cpu",
            generator=torch.Generator().manual_seed(0))
        tr = ttrainer.Trainer(model=model, tx=toptim.make_optimizer(1e-3, 10),
                              mem_len=ml)
        st = tr.create_state_from_params(None, 0)
        mems = tr._init_mems(_inputs(n=4, s=ql))
        losses = []
        for i in range(3):
            loss, mems = tr._train_step_mems(
                st, tr._put_batch(_inputs(n=4, s=ql, seed=20 + i)), mems)
            losses.append(float(loss))
        return np.asarray(losses)

    before = tfa.attn_bwd_relik_fs_reference.calls
    fused = run("fused")
    assert tfa.attn_bwd_relik_fs_reference.calls - before == 3 * 2
    einsum = run("einsum")
    rel = np.abs(fused - einsum) / np.maximum(np.abs(einsum), 1e-12)
    assert np.isfinite(fused).all()
    assert rel.max() < 5e-3, (rel, fused, einsum)


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
