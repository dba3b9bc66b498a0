"""The PyTorch port's plain ops, helpers and configs against the JAX
package, on the same seeded numpy inputs (CPU).

Tolerances: fp32 ops are held to 1e-5 abs (the same math, summed in
another order by another library); bf16 attention to one bf16 rounding of
its output (2^-8 relative), since both sides round probs and context once.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu import config as jcfg
from bert_multimodal_transformer_tpu.data import pipeline as jpipe
from bert_multimodal_transformer_tpu.ops import activations as jact
from bert_multimodal_transformer_tpu.ops import attention as jattn
from bert_multimodal_transformer_tpu.ops import mag as jmag
from bert_multimodal_transformer_tpu.training import losses as jlosses
from bert_multimodal_transformer_tpu.training import metrics as jmetrics
from bert_multimodal_transformer_tpu.utils import seeding as jseed
from bert_multimodal_transformer_tpu_torch import config as tcfg
from bert_multimodal_transformer_tpu_torch.data import pipeline as tpipe
from bert_multimodal_transformer_tpu_torch.ops import activations as tact
from bert_multimodal_transformer_tpu_torch.ops import attention as tattn
from bert_multimodal_transformer_tpu_torch.ops import dropout as tdrop
from bert_multimodal_transformer_tpu_torch.ops import mag as tmag
from bert_multimodal_transformer_tpu_torch.training import losses as tlosses
from bert_multimodal_transformer_tpu_torch.training import metrics as tmetrics
from bert_multimodal_transformer_tpu_torch.utils import seeding as tseed

FP32_ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("name", ["gelu", "relu", "swish", "gelu_new",
                                  "mish"])
def test_activations_match_jax(name):
    x = np.random.RandomState(0).randn(4, 33).astype(np.float32) * 3
    want = jact.ACT2FN[name](jnp.asarray(x))
    got = tact.ACT2FN[name](torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_ATOL)


def test_extended_attention_mask_matches_jax():
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    want = jattn.extended_attention_mask(jnp.asarray(mask))
    got = tattn.extended_attention_mask(torch.from_numpy(mask))
    assert tuple(got.shape) == (2, 1, 1, 4)
    np.testing.assert_array_equal(_np(got), _np(want))


def _qkv(seed=0, b=2, h=3, s=9, dh=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, dh).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 5:] = 0
    mask[1, :] = 0  # fully padded row
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extras", ["plain", "head_mask", "probs"])
def test_dot_product_attention_matches_jax(dtype, extras):
    q, k, v, mask = _qkv()
    head_mask = (np.array([1.0, 0.0, 0.5], np.float32)
                 if extras == "head_mask" else None)
    ret = extras == "probs"
    jd, td = jcfg.dtype_from_str(dtype), tcfg.dtype_from_str(dtype)
    want = jattn.dot_product_attention(
        *(jnp.asarray(t, jd) for t in (q, k, v)),
        jattn.extended_attention_mask(jnp.asarray(mask)), scale=0.35,
        head_mask=None if head_mask is None else jnp.asarray(head_mask),
        return_probs=ret)
    got = tattn.dot_product_attention(
        *(torch.from_numpy(t).to(td) for t in (q, k, v)),
        tattn.extended_attention_mask(torch.from_numpy(mask)), scale=0.35,
        head_mask=None if head_mask is None else torch.from_numpy(head_mask),
        return_probs=ret)
    if ret:
        (want, want_p), (got, got_p) = want, got
        assert got_p.dtype == torch.float32
        np.testing.assert_allclose(_np(got_p), _np(want_p), atol=FP32_ATOL)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=FP32_ATOL)
    else:
        # one bf16 rounding of the context, either way (2^-8 relative)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7,
                                   atol=2 ** -7)


def test_dot_product_attention_dropout_raises():
    """Rate > 0 in training mode without a generator raises; with one,
    about 1 − rate of the probs are kept (within 5σ), each scaled by
    1/(1 − rate); deterministic=True turns the rate off."""
    q, k, v, _ = _qkv(b=4, h=4, s=32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="requires dropout_rng"):
        tattn.dot_product_attention(*t, None, scale=1.0, dropout_rate=0.1,
                                    deterministic=False)
    rate = 0.25
    ctx, probs = tattn.dot_product_attention(
        *t, None, scale=0.35, dropout_rate=rate, deterministic=False,
        dropout_rng=torch.Generator().manual_seed(0), return_probs=True)
    _, plain = tattn.dot_product_attention(*t, None, scale=0.35,
                                           return_probs=True)
    keep = probs != 0
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * sigma
    torch.testing.assert_close(probs[keep], plain[keep] / (1 - rate),
                               rtol=0, atol=0)
    want = torch.matmul(probs, torch.from_numpy(v))
    torch.testing.assert_close(ctx, want, rtol=0, atol=FP32_ATOL)
    again = tattn.dot_product_attention(
        *t, None, scale=0.35, dropout_rate=rate, deterministic=True)
    torch.testing.assert_close(again, torch.matmul(plain, t[2]), rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_scales_like_flax(dtype, rate):
    """Where both keep an element, the port's dropout and Flax's
    nn.Dropout give the same bits: x / (1 − rate) with the divisor rounded
    to x's dtype first (bf16(0.9) = 0.8984375). The streams differ, so
    only the elements both keep are compared; a missing generator
    raises."""
    import flax.linen as fnn

    x = np.random.RandomState(3).randn(64, 96).astype(np.float32) + 0.1
    jd, td = jcfg.dtype_from_str(dtype), tcfg.dtype_from_str(dtype)
    want = _np(fnn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x, jd), rngs={"dropout": jax.random.PRNGKey(0)}))
    got = tdrop.dropout(torch.from_numpy(x).to(td), rate,
                        torch.Generator().manual_seed(0))
    assert got.dtype == td
    got = _np(got)
    both = (got != 0) & (want != 0)
    assert both.sum() > 0.2 * x.size
    np.testing.assert_array_equal(got[both], want[both])
    with pytest.raises(ValueError, match="generator"):
        tdrop.dropout(torch.from_numpy(x), rate, None)


def _mag_inputs(seed=0, n=6, d=16, dv=5, da=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32) * 2,
            rng.randn(n, dv).astype(np.float32),
            rng.randn(n, da).astype(np.float32))


def _jax_mag_params(d=16, dv=5, da=7):
    p = jmag.init_mag_params(jax.random.PRNGKey(3), d, dv, da)
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("beta", [1.0, 1e-3, 50.0])
def test_mag_gate_matches_jax(beta):
    text, vis, ac = _mag_inputs()
    params = _jax_mag_params()
    params["ln_gamma"] = params["ln_gamma"] * 1.5
    params["ln_beta"] = params["ln_beta"] + 0.25
    want = jmag.mag_gate({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(text), jnp.asarray(vis),
                         jnp.asarray(ac), beta_shift=beta)
    got = tmag.mag_gate({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(text), torch.from_numpy(vis),
                        torch.from_numpy(ac), beta_shift=beta)
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_ATOL)


def test_mag_norms_guard_and_clamp_match_jax():
    rng = np.random.RandomState(1)
    text = rng.randn(4, 8).astype(np.float32)
    h_m = rng.randn(4, 8).astype(np.float32) * 0.01
    h_m[1] = 0.0   # ‖H_m‖ = 0 → 1 guard
    h_m[2] *= 1e4  # α below the clamp
    want = jmag.mag_norms(jnp.asarray(text), jnp.asarray(h_m), 1.0)
    got = tmag.mag_norms(torch.from_numpy(text), torch.from_numpy(h_m), 1.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    assert float(got.max()) == 1.0  # clamped rows
    assert float(got[2, 0]) < 1.0


def test_mag_gate_bf16_runs_in_fp32():
    text, vis, ac = _mag_inputs()
    params = {k: torch.from_numpy(v) for k, v in _jax_mag_params().items()}
    t16 = torch.from_numpy(text).to(torch.bfloat16)
    got = tmag.mag_gate(params, t16, torch.from_numpy(vis).bfloat16(),
                        torch.from_numpy(ac).bfloat16())
    want = tmag.mag_gate(params, t16.float(),
                         torch.from_numpy(vis).bfloat16().float(),
                         torch.from_numpy(ac).bfloat16().float())
    assert got.dtype == torch.bfloat16
    # the only bf16 rounding is the final cast
    np.testing.assert_array_equal(_np(got), _np(want.to(torch.bfloat16)))


def test_layer_norm_matches_jax():
    x = np.random.RandomState(2).randn(3, 10).astype(np.float32)
    g = np.linspace(0.5, 1.5, 10).astype(np.float32)
    b = np.linspace(-1, 1, 10).astype(np.float32)
    want = jmag.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tmag.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_ATOL)


def test_init_mag_params_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    got = tmag.init_mag_params(gen, 16, 5, 7)
    want = _jax_mag_params()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    bound = 1.0 / np.sqrt(5 + 16)
    assert float(got["w_hv_v"].abs().max()) <= bound
    assert float(got["w_hv_t"].abs().max()) <= bound
    assert float(got["w_v"].abs().max()) <= 1.0 / np.sqrt(5)
    again = tmag.init_mag_params(torch.Generator().manual_seed(0), 16, 5, 7)
    for k in got:
        assert torch.equal(got[k], again[k])


def test_losses_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 1).astype(np.float32)
    labels = rng.randn(6).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.sequence_classification_loss(
            torch.from_numpy(logits), torch.from_numpy(labels), 1)),
        float(jlosses.sequence_classification_loss(
            jnp.asarray(logits), jnp.asarray(labels), 1)), rtol=1e-6)
    logits3 = rng.randn(6, 3).astype(np.float32)
    cls = np.array([0, 2, 1, 1, 0, 2], np.float32)
    np.testing.assert_allclose(
        float(tlosses.sequence_classification_loss(
            torch.from_numpy(logits3), torch.from_numpy(cls), 3)),
        float(jlosses.sequence_classification_loss(
            jnp.asarray(logits3), jnp.asarray(cls), 3)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_copy_equals_jax_package(seed):
    rng = np.random.RandomState(seed)
    preds = rng.randn(40)
    labels = np.round(rng.randn(40), 1)
    labels[:5] = 0.0
    for use_zero in (False, True):
        assert (tmetrics.score_regression(preds, labels, use_zero)
                == jmetrics.score_regression(preds, labels, use_zero))
    y = rng.randint(0, 3, 40)
    p = rng.randint(0, 3, 40)
    assert (tmetrics.score_classification(p, y)
            == jmetrics.score_classification(p, y))
    assert (tmetrics.binary_weighted_f1(y > 0, p > 1)
            == jmetrics.binary_weighted_f1(y > 0, p > 1))
    assert (tmetrics.multiclass_weighted_f1(y, p)
            == jmetrics.multiclass_weighted_f1(y, p))


def _splits(n=11, s=6):
    rng = np.random.RandomState(5)
    arrays = (rng.randint(0, 50, (n, s)).astype(np.int32),
              rng.randn(n, s, 3).astype(np.float32),
              rng.randn(n, s, 2).astype(np.float32),
              (rng.rand(n, s) > 0.3).astype(np.int32),
              np.zeros((n, s), np.int32),
              rng.randn(n).astype(np.float32))
    return jpipe.PackedSplit(*arrays), tpipe.PackedSplit(*arrays)


def _assert_same_stream(it_j, it_t):
    got_j, got_t = list(it_j), list(it_t)
    assert len(got_j) == len(got_t)
    for (bj, vj), (bt, vt) in zip(got_j, got_t):
        np.testing.assert_array_equal(vj, vt)
        for aj, at in zip(bj, bt):
            assert aj.dtype == at.dtype
            np.testing.assert_array_equal(aj, at)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, True),
                                          (True, False)])
def test_batch_iterator_copy_equals_jax_package(shuffle, drop):
    sj, st = _splits()
    assert len(sj) == len(st)
    idx = np.array([3, 0, 7])
    for a, b in zip(sj.take(idx).as_tuple(), st.take(idx).as_tuple()):
        np.testing.assert_array_equal(a, b)
    kw = dict(shuffle=shuffle, drop_remainder=drop, seed=9)
    ij, it = jpipe.BatchIterator(sj, 4, **kw), tpipe.BatchIterator(st, 4, **kw)
    assert len(ij) == len(it)
    for _ in range(2):  # two epochs: the shuffle stream advances alike
        _assert_same_stream(ij, it)
    assert ij.shuffles_done == it.shuffles_done
    ij.restore_position(1)
    it.restore_position(1)
    _assert_same_stream(ij.iter_from(1), it.iter_from(1))


def test_seeding_matches_jax_package():
    for s in (0, 42, "17", 9999):
        assert tseed.parse_seed(s) == jseed.parse_seed(s)
    assert 0 <= tseed.parse_seed("random") <= 9999
    with pytest.raises(ValueError):
        tseed.parse_seed("10000")
    for v in ("yes", "0", "T", False):
        assert tseed.str2bool(v) == jseed.str2bool(v)
    with pytest.raises(ValueError):
        tseed.str2bool("maybe")
    g1, g2 = tseed.set_random_seed(7), tseed.set_random_seed(7)
    assert isinstance(g1, torch.Generator)
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))


def test_configs_match_jax_package():
    for name in ("bert_base_uncased", "bert_large_uncased", "tiny"):
        j, t = getattr(jcfg.BertConfig, name)(), getattr(tcfg.BertConfig,
                                                          name)()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    for name in ("mosi", "mosei"):
        assert (dataclasses.asdict(tcfg.DatasetConfig.from_name(name))
                == dataclasses.asdict(jcfg.DatasetConfig.from_name(name)))
    assert (dataclasses.asdict(tcfg.MultimodalConfig())
            == dataclasses.asdict(jcfg.MultimodalConfig()))
    for name in ("xlnet_base_cased", "tiny"):
        j, t = getattr(jcfg.XLNetConfig, name)(), getattr(tcfg.XLNetConfig,
                                                          name)()
        assert ({f.name for f in dataclasses.fields(t)}
                == {f.name for f in dataclasses.fields(j)})
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.d_head == j.d_head
    assert tcfg.dtype_from_str("bfloat16") is torch.bfloat16
    assert tcfg.dtype_from_str("float32") is torch.float32


def test_config_accepts_qkv_fusion():
    """``qkv_fusion`` (and ``qkv_residual``) are ported: the config keeps
    them, as the JAX ``BertConfig`` does."""
    cfg = tcfg.BertConfig(attention_impl="fused", qkv_fusion=True,
                          qkv_residual=True)
    assert cfg.qkv_fusion and cfg.qkv_residual
    j = jcfg.BertConfig(attention_impl="fused", qkv_fusion=True,
                        qkv_residual=True)
    assert (j.qkv_fusion, j.qkv_residual) == (cfg.qkv_fusion,
                                              cfg.qkv_residual)


@pytest.mark.parametrize("kw,item", [
    ({"tp_attention_mesh": object()}, "A.10"),
    ({"attention_impl": "flash"}, "A.2"),
])
def test_unported_options_raise(kw, item):
    """An option whose item is open raises naming it. ``tp_attention_mesh``
    (A.10, tensor parallelism for MAG-BERT) is ported: a mesh is kept, and
    anything else raises TypeError."""
    if item == "A.10":
        from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
            make_mesh,
        )

        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            tcfg.BertConfig(**kw)
        mesh = make_mesh(devices=["cpu"])
        assert tcfg.BertConfig(tp_attention_mesh=mesh).tp_attention_mesh \
            is mesh
        return
    with pytest.raises(NotImplementedError, match=item):
        tcfg.BertConfig(**kw)


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError):
        tcfg.BertConfig(attention_impl="einsom")
    # the fused MAG gate is ported: the flag is taken as it is
    assert tcfg.MultimodalConfig(use_fused_kernel=True).use_fused_kernel


def test_port_imports_no_jax():
    """The port runs where jax is not installed: importing every module of
    it must not pull jax, flax or the JAX package in."""
    code = (
        "import sys\n"
        "import bert_multimodal_transformer_tpu_torch.serving\n"
        "import bert_multimodal_transformer_tpu_torch.models.bert\n"
        "import bert_multimodal_transformer_tpu_torch.models.xlnet\n"
        "import bert_multimodal_transformer_tpu_torch.utils.convert\n"
        "import bert_multimodal_transformer_tpu_torch.utils.seeding\n"
        "import bert_multimodal_transformer_tpu_torch.utils.profiling\n"
        "import bert_multimodal_transformer_tpu_torch.training.trainer\n"
        "import bert_multimodal_transformer_tpu_torch.training.optim\n"
        "import bert_multimodal_transformer_tpu_torch.driver\n"
        "import bert_multimodal_transformer_tpu_torch.ops.mag_fused\n"
        "import bert_multimodal_transformer_tpu_torch.ops.kernels\n"
        "import bert_multimodal_transformer_tpu_torch.data.synthetic\n"
        "import bert_multimodal_transformer_tpu_torch.data.tokenization\n"
        "import bert_multimodal_transformer_tpu_torch.utils.logging\n"
        "import bert_multimodal_transformer_tpu_torch.parallel.mesh\n"
        "import bert_multimodal_transformer_tpu_torch.parallel.tp\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'bert_multimodal_transformer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
