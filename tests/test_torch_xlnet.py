"""The port's MAG-XLNet (``models/xlnet.py``) against the JAX package's, with
the same weights (the JAX params converted by
``utils/convert.xlnet_params_from_flax``) and the same seeded inputs, on the
CPU: the position and mask helpers, the model in every attention mode on
both attention branches, the converter, the decay mask, the trainer and the
predictor. The JAX fused branch runs its Pallas kernels in interpret mode,
the port's its kernels' plain versions.

Tolerances: fp32 logits and hidden states 1e-4 abs (two layers of the same
math summed in another order, as ``tests/test_torch_bert.py``); bf16 logits
1e-3 abs and hidden states two bf16 ulps (2^-6 relative plus 2^-6
absolute), for the reason given there. Training: the bands of
``tests/test_torch_training.py`` (losses rtol 1e-3, params rtol 1e-3 /
atol 5e-5). Inputs are packed as the XLNet pipeline packs them: left
padding, segment ids 0 on tokens, 2 on <cls> and 3 on pads.
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
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttrainer
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    xlnet_params_from_flax,
)

B, S, V, DV, DA, M = 4, 10, 128, 5, 7, 3
FP32_ATOL = 1e-4
BF16_HIDDEN_TOL, BF16_LOGITS_ATOL = 2.0 ** -6, 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5

# attention modes of the config: (attn_type, same_length, bi_data)
MODES = {"bi": ("bi", False, False), "uni": ("uni", False, False),
         "uni_same_length": ("uni", True, False),
         "bi_data": ("bi", False, True)}


def _inputs(n=B, seed=0):
    """Left-padded rows as the XLNet packing gives them (row 0 unpadded)."""
    rng = np.random.RandomState(seed)
    n_real = rng.randint(3, S + 1, n)
    n_real[0] = S
    pad = S - n_real
    real = np.arange(S)[None, :] >= pad[:, None]
    ids = np.where(real, rng.randint(5, V, (n, S)), 2).astype(np.int32)
    mask = real.astype(np.int32)
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    vis = (rng.randn(n, S, DV) * real[..., None]).astype(np.float32)
    ac = (rng.randn(n, S, DA) * real[..., None]).astype(np.float32)
    labels = rng.uniform(-3, 3, n).astype(np.float32)
    return ids, vis, ac, mask, segs, labels


def _two_stream(seed=1):
    """A perm_mask [B, S, S] (1 = cannot see) and target_mapping [B, M, S]
    over the last M positions, with one query row that sees nothing."""
    rng = np.random.RandomState(seed)
    perm = (rng.rand(B, S, S) < 0.3).astype(np.float32)
    perm[:, :, S - M:] = 1.0
    perm[1, S - 1, :] = 1.0
    tm = np.zeros((B, M, S), np.float32)
    for j in range(M):
        tm[:, j, S - M + j] = 1.0
    return perm, tm


def _configs(attention_impl="einsum", mode="bi", dropout=0.1, **kw):
    attn_type, same_length, bi_data = MODES[mode]
    common = dict(attention_impl=attention_impl, attn_type=attn_type,
                  same_length=same_length, bi_data=bi_data, dropout=dropout,
                  summary_last_dropout=dropout, **kw)
    return (dataclasses.replace(JXLNetConfig.tiny(V), **common),
            dataclasses.replace(XLNetConfig.tiny(V), **common))


def _mm(dropout=0.1):
    return (JMultimodalConfig(beta_shift=1.0, dropout_prob=dropout,
                              injection_index=1),
            MultimodalConfig(beta_shift=1.0, dropout_prob=dropout,
                             injection_index=1))


@pytest.fixture(scope="module")
def jparams():
    """One JAX init, with target_mapping so that mask_emb exists; every
    attention mode and impl shares the param shapes."""
    jcfg, _ = _configs()
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, _mm()[0], visual_dim=DV, acoustic_dim=DA)
    ids, vis, ac, mask, segs, _ = _inputs()
    perm, tm = _two_stream()
    params = jmodel.init(jax.random.PRNGKey(0), ids, vis, ac,
                         attention_mask=mask, token_type_ids=segs,
                         perm_mask=perm, target_mapping=tm)["params"]
    return jax.device_get(params)


def _pair(params, attention_impl="einsum", mode="bi", dtype="float32",
          **kw):
    jcfg, tcfg = _configs(attention_impl, mode, **kw)
    jmm, tmm = _mm()
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA, dtype=getattr(jnp, dtype))
    tmodel = txl.MagXLNetForSequenceClassification(
        tcfg, tmm, DV, DA, getattr(torch, dtype), device="cpu")
    tmodel.load_state_dict(xlnet_params_from_flax(params), strict=True)
    return jmodel, tmodel


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, dtype="float32", logits=False):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    elif logits:
        np.testing.assert_allclose(got, want, atol=BF16_LOGITS_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_HIDDEN_TOL,
                                   rtol=BF16_HIDDEN_TOL)


# --- positions, masks, rel_shift --------------------------------------------


@pytest.mark.parametrize("q,p,klen,heads", [
    (6, 12, 6, 2),    # bi: P = K + Q
    (6, 7, 6, 2),     # uni: P = K + 1
    (5, 14, 9, 3),    # Q != K
])
def test_rel_shift_matches_jax(q, p, klen, heads):
    x = np.random.RandomState(q + p).randn(2, heads, q, p).astype(
        np.float32)
    want = jxl.rel_shift(jnp.asarray(x), klen)
    got = txl.rel_shift(torch.from_numpy(x), klen)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a non-contiguous input (the bf16 bd of a transposed einsum) too
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 3, 2)))
    np.testing.assert_array_equal(
        txl.rel_shift(xt.transpose(-1, -2), klen).numpy(), np.asarray(want))


@pytest.mark.parametrize("attn_type,clamp_len,bi_data", [
    ("bi", -1, False), ("uni", -1, False), ("bi", 4, False),
    ("bi", -1, True), ("uni", 3, True)])
def test_relative_positional_encoding_matches_jax(attn_type, clamp_len,
                                                  bi_data):
    want = jxl.relative_positional_encoding(7, 9, 16, attn_type, clamp_len,
                                            bi_data)
    got = txl.relative_positional_encoding(7, 9, 16, attn_type, clamp_len,
                                           bi_data)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mlen,same_length", [(0, False), (0, True),
                                              (3, False), (3, True)])
def test_causal_attn_mask_matches_jax(mlen, same_length):
    np.testing.assert_array_equal(
        txl.causal_attn_mask(6, mlen, same_length).numpy(),
        np.asarray(jxl.causal_attn_mask(6, mlen, same_length)))


# --- the model against JAX ---------------------------------------------------


def test_converter_consumes_every_leaf(jparams):
    sd = xlnet_params_from_flax(jparams)
    n_leaves = len(jax.tree_util.tree_leaves(jparams))
    assert len(sd) == n_leaves
    _, tmodel = _pair(jparams)
    assert set(sd) == set(tmodel.state_dict())
    layer = jparams["transformer"]["layer_1"]
    np.testing.assert_array_equal(
        sd["transformer.layer.1.rel_attn.q"].numpy(),
        np.asarray(layer["rel_attn"]["q"]))       # raw [D, H·Dh]: as is
    np.testing.assert_array_equal(
        sd["transformer.layer.1.ff.layer_1.weight"].numpy(),
        np.asarray(layer["ff"]["layer_1"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["transformer.word_embedding.weight"].numpy(),
        np.asarray(jparams["transformer"]["word_embedding"]["embedding"]))
    np.testing.assert_array_equal(
        sd["logits_proj.weight"].numpy(),
        np.asarray(jparams["logits_proj"]["kernel"]).T)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_logits_match_jax_fp32(jparams, attention_impl, mode):
    jmodel, tmodel = _pair(jparams, attention_impl, mode)
    ids, vis, ac, mask, segs, _ = _inputs(seed=2)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1)
    _close(got, want)


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_logits_match_jax_bf16(jparams, attention_impl):
    jmodel, tmodel = _pair(jparams, attention_impl, dtype="bfloat16")
    ids, vis, ac, mask, segs, _ = _inputs(seed=3)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        output_hidden_states=True)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs),
                 output_hidden_states=True)
    _close(got[0], want[0], "bfloat16", logits=True)
    for g, w in zip(got[1], want[1], strict=True):
        assert g.dtype == torch.bfloat16
        _close(g, w, "bfloat16")


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_two_stream_matches_jax(jparams, attention_impl):
    """perm_mask and target_mapping: the query stream reads the M target
    positions; a query row that may see nothing takes the uniform softmax
    (the fused kernel's max-subtracted form), not NaN."""
    jmodel, tmodel = _pair(jparams, attention_impl)
    ids, vis, ac, mask, segs, _ = _inputs(seed=4)
    perm, tm = _two_stream()
    kw = dict(attention_mask=mask, token_type_ids=segs, perm_mask=perm,
              target_mapping=tm)
    want = jmodel.apply({"params": jparams}, ids, vis, ac, **kw,
                        output_hidden_states=True)
    got = tmodel(*_t(ids, vis, ac), **{k: torch.from_numpy(v)
                                       for k, v in kw.items()},
                 output_hidden_states=True)
    _close(got[0], want[0])
    for (gh, gg), (wh, wg) in zip(got[1][1:], want[1][1:], strict=True):
        _close(gh, wh)
        _close(gg, wg)
    assert all(bool(torch.isfinite(g).all()) for g in got[1][-1])


def test_extras_match_jax(jparams):
    """head_mask [L, H], output_attentions (both per-layer probs) and
    inputs_embeds, on the fused config: head_mask and output_attentions
    take the einsum branch, as in JAX; inputs_embeds alone stays fused."""
    jmodel, tmodel = _pair(jparams, "fused")
    ids, vis, ac, mask, segs, _ = _inputs(seed=5)
    head_mask = np.array([[1.0, 0.0], [0.5, 1.0]], np.float32)
    kw = dict(attention_mask=mask, token_type_ids=segs)
    want = jmodel.apply({"params": jparams}, ids, vis, ac, **kw,
                        head_mask=head_mask, output_attentions=True,
                        output_hidden_states=True)
    got = tmodel(*_t(ids, vis, ac), **dict(zip(kw, _t(mask, segs))),
                 head_mask=torch.from_numpy(head_mask),
                 output_attentions=True, output_hidden_states=True)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1], strict=True):
        _close(g, w)
    for g, w in zip(got[2], want[2], strict=True):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)
    emb = np.asarray(jparams["transformer"]["word_embedding"]["embedding"])[
        ids]
    want = jmodel.apply({"params": jparams}, None, vis, ac, **kw,
                        inputs_embeds=emb)
    got = tmodel(None, *_t(vis, ac), **dict(zip(kw, _t(mask, segs))),
                 inputs_embeds=torch.from_numpy(emb))
    _close(got, want)


def test_pack_qkv_matches_jax(jparams):
    """pack_qkv (one [D, 3·H·Dh] product for q, k and v) on the fused
    branch: the JAX model's logits with the same option."""
    jmodel, tmodel = _pair(jparams, "fused", pack_qkv=True)
    ids, vis, ac, mask, segs, _ = _inputs(seed=8)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    _close(got, want)


def test_input_mask_is_the_inverted_attention_mask(jparams):
    """input_mask (1 = padding) gives the logits of attention_mask (0 =
    padding); passing both raises, as in JAX."""
    _, tmodel = _pair(jparams, "fused")
    ids, vis, ac, mask, segs, _ = _inputs(seed=9)
    kw = dict(token_type_ids=torch.from_numpy(segs))
    a = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
               **kw)
    b = tmodel(*_t(ids, vis, ac), input_mask=torch.from_numpy(1 - mask),
               **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="only one of"):
        tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
               input_mask=torch.from_numpy(1 - mask))


def test_labels_give_the_jax_loss(jparams):
    jmodel, tmodel = _pair(jparams, "fused")
    ids, vis, ac, mask, segs, labels = _inputs(seed=6)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        labels=labels)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs),
                 labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(got[0].detach()), float(want[0]),
                               rtol=1e-4)
    _close(got[1], want[1])


def test_no_decay_matches_jax_decay_mask(jparams):
    """The port's rule on its names gives the partition of the JAX
    ``decay_mask`` on the JAX tree (converted leaf by leaf)."""
    want = {k: bool(v) for k, v in xlnet_params_from_flax(
        joptim.decay_mask(jparams)).items()}
    _, tmodel = _pair(jparams)
    got = toptim.decay_mask(tmodel.named_parameters())
    assert got == want
    assert not got["transformer.layer.0.rel_attn.r_w_bias"]
    assert not got["transformer.layer.0.ff.layer_norm.weight"]
    assert got["transformer.layer.0.rel_attn.seg_embed"]


def test_dropout_forward_is_seeded(jparams):
    """The training forward (dropout 0.1, fused): finite, the same for the
    same seed, another for another seed, and the two streams of a
    two-stream layer draw different kernel seeds."""
    _, tmodel = _pair(jparams, "fused")
    ids, vis, ac, mask, segs, _ = _inputs(seed=7)
    kw = dict(attention_mask=torch.from_numpy(mask),
              token_type_ids=torch.from_numpy(segs), deterministic=False)
    a, b, c = (tmodel(*_t(ids, vis, ac), dropout_rng=s, **kw)
               for s in (3, 3, 4))
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("kw,item", [
    ({"mem_len": 4}, "A.8"), ({"reuse_len": 2}, "A.8"),
    ({"rel_bias_impl": "inkernel"}, "B.7"),
    ({"tp_attention_mesh": object()}, "A.10")])
def test_unported_config_options_raise(kw, item):
    """An option whose item is still open raises naming it; the memory's
    options (A.8) and ``rel_bias_impl="inkernel"`` (B.7), both ported,
    build a config that keeps them. ``tp_attention_mesh`` (A.10, XLNet
    tensor parallelism) is ported: a mesh is kept, anything else raises
    TypeError, as ``BertConfig`` does."""
    if item in ("A.8", "B.7"):
        cfg = XLNetConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        return
    if item == "A.10":
        from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
            make_mesh,
        )

        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            XLNetConfig(**kw)
        mesh = make_mesh(devices=["cpu"])
        assert XLNetConfig(tp_attention_mesh=mesh).tp_attention_mesh is mesh
        return
    with pytest.raises(NotImplementedError, match=item):
        XLNetConfig(**kw)


def test_unported_forward_options_raise(jparams):
    """flash still raises (remat is ported: ``tests/test_torch_remat.py``).
    The memory's forward options (ported)
    run: ``mems`` widen the keys to mlen + Q and match the JAX model's
    logits; ``use_cache`` with ``config.mem_len`` returns one new [B,
    mem_len, D] memory per layer, and without it the memory slot is None,
    as in JAX."""
    _, tmodel = _pair(jparams)
    jmodel, tmem = _pair(jparams, mem_len=2)
    ids, vis, ac, mask, segs, _ = _inputs()
    mems = np.random.RandomState(9).randn(2, B, 2, 32).astype(np.float32)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        mems=tuple(mems))
    got = tmodel(*_t(ids, vis, ac), mems=list(_t(*mems)))
    _close(got, want)
    logits, new_mems = tmem(*_t(ids, vis, ac), use_cache=True)
    assert [tuple(m.shape) for m in new_mems] == [(B, 2, 32)] * 2
    assert not any(m.requires_grad for m in new_mems)
    assert tmodel(*_t(ids, vis, ac), use_cache=True)[1] is None
    with pytest.raises(ValueError):
        XLNetConfig(attention_impl="flash")


def test_bare_constructors_raise_without_a_card(monkeypatch):
    """device=None means the card: without one every model constructor
    raises naming device="cpu" instead of building on the CPU unasked."""
    from bert_multimodal_transformer_tpu_torch.config import BertConfig
    from bert_multimodal_transformer_tpu_torch.models import bert as tbert
    from bert_multimodal_transformer_tpu_torch.models.mag import MAG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
            lambda: tbert.MagBertForSequenceClassification(
                BertConfig.tiny(), MultimodalConfig(), DV, DA),
            lambda: tbert.MagBertModel(BertConfig.tiny(), MultimodalConfig(),
                                       DV, DA),
            lambda: MAG(32, DV, DA),
            lambda: txl.MagXLNetForSequenceClassification(
                XLNetConfig.tiny(), MultimodalConfig(), DV, DA),
            lambda: txl.MagXLNetModel(XLNetConfig.tiny(), MultimodalConfig(),
                                      DV, DA)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


# --- training and serving against JAX ----------------------------------------


def _trainers(params, attention_impl, n_steps, grad_accum=1):
    """The JAX Trainer and the port's over the same weights, every dropout
    0. The JAX tree here has no mask_emb (no target_mapping at init): the
    port keeps its own, which no fine-tuning step touches."""
    jcfg, tcfg = _configs(attention_impl, dropout=0.0)
    jmm, tmm = _mm(0.0)
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA)
    params = {k: dict(v) for k, v in params.items()}
    params["transformer"] = {k: v for k, v in params["transformer"].items()
                             if k != "mask_emb"}
    lr, warm = 1e-3, 0.1
    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(lr, n_steps, warm),
        grad_accum=grad_accum, donate=False,
        mesh=make_mesh(JMeshConfig(data_parallel=1),
                       devices=jax.devices()[:1]))
    jstate = jtr.create_state_from_params(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(1))
    tmodel = txl.MagXLNetForSequenceClassification(tcfg, tmm, DV, DA,
                                                   device="cpu")
    missing, unexpected = tmodel.load_state_dict(
        xlnet_params_from_flax(params), strict=False)
    assert missing == ["transformer.mask_emb"] and not unexpected
    ttr = ttrainer.Trainer(model=tmodel,
                           tx=toptim.make_optimizer(lr, n_steps, warm),
                           grad_accum=grad_accum)
    return jtr, jstate, ttr, ttr.create_state_from_params(None, 1)


def _assert_params_close(jstate, tstate):
    want = xlnet_params_from_flax(jax.device_get(jstate.params))
    got = tstate.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_train_steps_match_jax_trainer(jparams, attention_impl):
    n_steps = 5
    jtr, jstate, ttr, tstate = _trainers(jparams, attention_impl, n_steps)
    jl, tl = [], []
    for i in range(n_steps):
        batch = _inputs(n=8, seed=10 + i)
        jstate, loss = jtr._train_step(jstate, jtr._put_batch(batch))
        jl.append(float(jax.device_get(loss)))
        tl.append(float(ttr._train_step(tstate, ttr._put_batch(batch))))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert abs(tl[0] - tl[-1]) > 1e-3  # the trajectory moved
    _assert_params_close(jstate, tstate)


def test_grad_accum_and_masked_tail_match_jax_trainer(jparams):
    """grad_accum=2 on a full batch, then the masked step on a ragged batch
    of 5 valid rows zero-padded to 8, through the fused branch."""
    jtr, jstate, ttr, tstate = _trainers(jparams, "fused", 2, grad_accum=2)
    batch = _inputs(n=8, seed=30)
    jstate, jl0 = jtr._train_step(jstate, jtr._put_batch(batch))
    tl0 = ttr._train_step(tstate, ttr._put_batch(batch))
    valid = np.arange(8) < 6
    batch = tuple(np.where(valid.reshape((8,) + (1,) * (a.ndim - 1)), a, 0)
                  .astype(a.dtype) for a in _inputs(n=8, seed=31))
    jstate, jl1 = jtr._train_step_masked(jstate, jtr._put_batch(batch),
                                         jtr._put_valid(valid))
    tl1 = ttr._train_step_masked(tstate, ttr._put_batch(batch), valid)
    np.testing.assert_allclose([float(tl0), float(tl1)],
                               [float(jl0), float(jl1)], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _assert_params_close(jstate, tstate)


def test_predictor_matches_jax(jparams):
    jmodel, tmodel = _pair(jparams, "fused")
    arrays = _inputs(n=11, seed=40)
    jpred = JPredictor(jmodel, jparams,
                       mesh=make_mesh(JMeshConfig(data_parallel=1)),
                       batch_size=4)
    want = jpred.predict_split(JPackedSplit(*arrays))
    got = Predictor(tmodel, batch_size=4).predict_split(PackedSplit(*arrays))
    assert got.shape == (11,)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


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
