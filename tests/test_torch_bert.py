"""The port's MAG-BERT forward against the JAX package's, with the same
weights (the JAX params converted by ``utils/convert.params_from_flax``)
and the same seeded inputs, on the CPU.

Tolerances: fp32 logits and hidden states 1e-4 abs (the same math
through two layers, in another library's summation order). bf16: both
sides round at the same points (dense outputs, bias adds, LayerNorm and
GELU outputs, probs), but XLA and PyTorch sum in different orders, so an
activation can land one bf16 ulp (2^-7 relative at most) apart and carry
that through the stack: hidden states (|x| ≲ 4) are held to two ulps,
2^-6 relative plus 2^-6 absolute, and the logits (|x| ≈ 2^-6 at this
init) to 1e-3, about eight ulps at their scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

DV, DA = 5, 7
B, S = 3, 10
FP32_ATOL = 1e-4
BF16_HIDDEN_TOL = 2.0 ** -6
BF16_LOGITS_ATOL = 1e-3


def _inputs(seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    visual = rng.randn(B, S, DV).astype(np.float32)
    acoustic = rng.randn(B, S, DA).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, 7:] = 0
    mask[1, 3:] = 0
    segs = np.zeros((B, S), np.int32)
    segs[2, 5:] = 1
    return ids, visual, acoustic, mask, segs


def _pair(attention_impl="einsum", dtype="float32", num_labels=1, seed=0):
    """A JAX model with initialized params and the port's model holding
    the same weights."""
    jcfg = dataclasses.replace(JBertConfig.tiny(),
                               attention_impl=attention_impl,
                               num_labels=num_labels)
    tcfg = dataclasses.replace(BertConfig.tiny(),
                               attention_impl=attention_impl,
                               num_labels=num_labels)
    mm = JMultimodalConfig(beta_shift=1.0, dropout_prob=0.1)
    jmodel = jbert.MagBertForSequenceClassification(
        jcfg, mm, visual_dim=DV, acoustic_dim=DA,
        dtype=getattr(jnp, dtype))
    ids, vis, ac, mask, _ = _inputs()
    params = jmodel.init(jax.random.PRNGKey(seed), ids, vis, ac, mask)[
        "params"]
    tmodel = tbert.MagBertForSequenceClassification(
        tcfg, MultimodalConfig(beta_shift=1.0, dropout_prob=0.1), DV, DA,
        getattr(torch, dtype), device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(params)),
                           strict=True)
    return jmodel, params, tmodel


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_params_from_flax_covers_every_param():
    jmodel, params, tmodel = _pair()
    sd = params_from_flax(jax.device_get(params))
    assert set(sd) == set(tmodel.state_dict())
    qkv_j = np.asarray(params["bert"]["encoder"]["layer_1"]["attention"][
        "qkv"]["kernel"])
    np.testing.assert_array_equal(
        sd["bert.encoder.layer.1.attention.qkv.weight"].numpy(), qkv_j.T)
    np.testing.assert_array_equal(
        sd["bert.MAG.w_hv_v"].numpy(),
        np.asarray(params["bert"]["MAG"]["w_hv_v"]))
    np.testing.assert_array_equal(
        sd["bert.embeddings.LayerNorm.weight"].numpy(),
        np.asarray(params["bert"]["embeddings"]["LayerNorm"]["scale"]))
    for v in sd.values():
        assert v.dtype == torch.float32


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_logits_match_jax_fp32(attention_impl):
    jmodel, params, tmodel = _pair(attention_impl)
    ids, vis, ac, mask, segs = _inputs(seed=1)
    want = jmodel.apply({"params": params}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_logits_match_jax_bf16(attention_impl):
    jmodel, params, tmodel = _pair(attention_impl, dtype="bfloat16")
    ids, vis, ac, mask, segs = _inputs(seed=2)
    want = jmodel.apply({"params": params}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        output_hidden_states=True)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs),
                 output_hidden_states=True)
    assert got[0].dtype == torch.float32  # logits cast to fp32, as in JAX
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=BF16_LOGITS_ATOL, rtol=0)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=BF16_HIDDEN_TOL,
                                   rtol=BF16_HIDDEN_TOL)


def test_fused_branch_calls_the_packed_entry(monkeypatch):
    """attention_impl='fused' goes through fused_attention_packed once per
    layer; head_mask and output_attentions take the einsum branch."""
    calls = []
    real = tbert.fused_attention_packed

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tbert, "fused_attention_packed", spy)
    _, _, tmodel = _pair("fused")
    ids, vis, ac, mask, _ = _inputs()
    tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask))
    assert calls == [(B, S, 3 * 32)] * 2
    tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
           head_mask=torch.ones(2))
    tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
           output_attentions=True)
    assert len(calls) == 2
    assert tfa.attn_fwd_packed_cuda.launches == 0  # CPU: no kernel launch


def test_hidden_states_and_attentions_match_jax():
    jmodel, params, tmodel = _pair("fused")
    ids, vis, ac, mask, segs = _inputs(seed=3)
    want = jmodel.apply({"params": params}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        output_hidden_states=True, output_attentions=True)
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs),
                 output_hidden_states=True, output_attentions=True)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=FP32_ATOL, rtol=0)
    assert len(got[1]) == len(want[1]) == 3  # embeddings+MAG, 2 layers
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=FP32_ATOL, rtol=0)
    assert len(got[2]) == 2
    for g, w in zip(got[2], want[2]):
        assert tuple(g.shape) == (B, 2, S, S)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_head_mask_matches_jax(shape):
    jmodel, params, tmodel = _pair()
    ids, vis, ac, mask, _ = _inputs(seed=4)
    hm = np.ones(shape, np.float32)
    hm[..., 1] = 0.0
    if len(shape) == 2:
        hm[0] = [0.5, 1.0]
    want = jmodel.apply({"params": params}, ids, vis, ac,
                        attention_mask=mask, head_mask=jnp.asarray(hm))
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 head_mask=torch.from_numpy(hm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("num_labels", [1, 3])
def test_labels_loss_matches_jax(num_labels):
    jmodel, params, tmodel = _pair("fused", num_labels=num_labels)
    ids, vis, ac, mask, _ = _inputs(seed=5)
    labels = (np.array([0.5, -1.0, 2.0], np.float32) if num_labels == 1
              else np.array([0, 2, 1], np.float32))
    want_loss, want_logits = jmodel.apply(
        {"params": params}, ids, vis, ac, attention_mask=mask,
        labels=jnp.asarray(labels))
    got_loss, got_logits = tmodel(*_t(ids, vis, ac),
                                  attention_mask=torch.from_numpy(mask),
                                  labels=torch.from_numpy(labels))
    assert tuple(got_logits.shape) == (B, num_labels)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=FP32_ATOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               atol=FP32_ATOL)


def test_defaults_and_inputs_embeds_match_jax():
    """No mask / segment ids (all-ones / zeros defaults), and the
    inputs_embeds entry."""
    jmodel, params, tmodel = _pair("fused")
    ids, vis, ac, _, _ = _inputs(seed=6)
    want = jmodel.apply({"params": params}, ids, vis, ac)
    got = tmodel(*_t(ids, vis, ac))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)
    emb = np.asarray(params["bert"]["embeddings"]["word_embeddings"])[ids]
    want_e = jmodel.apply({"params": params}, None, vis, ac,
                          inputs_embeds=jnp.asarray(emb))
    got_e = tmodel(None, *_t(vis, ac), inputs_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e),
                               atol=FP32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="exactly one"):
        tmodel(None, *_t(vis, ac))


def test_mag_bert_model_outputs_match_jax():
    jmodel, params, tmodel = _pair("fused")
    jbase = jbert.MagBertModel(JBertConfig.tiny(), JMultimodalConfig(),
                               visual_dim=DV, acoustic_dim=DA)
    ids, vis, ac, mask, _ = _inputs(seed=7)
    seq_w, pooled_w = jbase.apply({"params": params["bert"]}, ids, vis, ac,
                                  mask)
    seq, pooled = tmodel.bert(*_t(ids, vis, ac), torch.from_numpy(mask))
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(seq_w),
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(pooled.detach().numpy(),
                               np.asarray(pooled_w), atol=FP32_ATOL, rtol=0)
    assert float(pooled.detach().abs().max()) <= 1.0  # tanh-bounded


@pytest.mark.parametrize("attention_impl", ["einsum", "fused"])
def test_training_mode_forward_raises(attention_impl):
    """Training mode without a dropout_rng raises; with one, the forward
    is finite, differs from eval, replays exactly from the same seed and
    changes with the seed, and its gradient reaches every param."""
    _, _, tmodel = _pair(attention_impl)
    ids, vis, ac, mask, _ = _inputs()
    args = _t(ids, vis, ac)
    kw = dict(attention_mask=torch.from_numpy(mask))
    with pytest.raises(ValueError, match="dropout_rng"):
        tmodel(*args, deterministic=False, **kw)
    eval_out = tmodel(*args, **kw)
    a = tmodel(*args, deterministic=False, dropout_rng=3, **kw)
    b = tmodel(*args, deterministic=False,
               dropout_rng=torch.Generator().manual_seed(3), **kw)
    c = tmodel(*args, deterministic=False, dropout_rng=4, **kw)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    assert not torch.allclose(a, eval_out)
    assert not torch.equal(a, c)
    a.sum().backward()
    for name, p in tmodel.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name


def test_seeded_init_is_reproducible_and_fp32():
    cfg, mm = BertConfig.tiny(), MultimodalConfig()

    def build(seed):
        return tbert.MagBertForSequenceClassification(
            cfg, mm, DV, DA, torch.bfloat16, device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    for k in a:
        assert a[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["classifier.weight"], c["classifier.weight"])
    w = a["bert.encoder.layer.0.attention.qkv.weight"]
    assert tuple(w.shape) == (3 * 32, 32)
    assert 0.01 < float(w.std()) < 0.03  # normal(0, initializer_range)
    assert torch.equal(a["bert.encoder.layer.0.attention.qkv.bias"],
                       torch.zeros(96))
    assert torch.equal(a["bert.embeddings.LayerNorm.weight"],
                       torch.ones(32))


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
