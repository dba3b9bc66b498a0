"""MAG-BERT's ``attention_impl="flash"`` in the port (``ops/attention.py::
flash_attention``: the flash-streamed kernels #6/#7 at rate 0, here their
plain versions) against the JAX package's flash model (its library Pallas
kernel in interpret mode) and its einsum model, with the same weights (the
JAX params through ``utils/convert.params_from_flax``) and seeded inputs at
``BertConfig.tiny()``, S = 128, fp32; then the JAX gate's five conditions
and the driver.

Tolerances: against the JAX flash model the JAX test's band (rtol 2e-2,
atol 2e-3, ``tests/test_bert.py::test_flash_attention_matches_einsum``) on
the real-token rows and the pooled output: the JAX kernel keeps pads apart
by segment ids, #6 by the additive mask, so pad rows differ (ROADMAP C,
deliberate departures). Against the JAX einsum model, whose additive mask
#6 shares, fp32 1e-5 (two layers of the same math summed in another order)
on those rows, and each parameter's dropout-0 gradient within 1e-5 of its
largest.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

B, S, DV, DA, REAL = 2, 128, 5, 7, 100
TOL = 1e-5
JAX_FLASH_RTOL, JAX_FLASH_ATOL = 2e-2, 2e-3


def _inputs(s=S):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, BertConfig.tiny().vocab_size, (B, s)).astype(
        np.int32)
    mask = np.ones((B, s), np.int32)
    mask[:, min(REAL, s - 8):] = 0
    return (ids, rng.randn(B, s, DV).astype(np.float32),
            rng.randn(B, s, DA).astype(np.float32), mask,
            rng.uniform(-3, 3, B).astype(np.float32))


def _cfg(impl, rate=0.0):
    return dataclasses.replace(
        BertConfig.tiny(), attention_impl=impl, max_position_embeddings=S,
        hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX classifier's params (its ``bert`` the MagBertModel's), the
    JAX einsum and flash models' (sequence, pooled) outputs, the latter
    in ONE interpret-mode call, and ``jax.grad`` of the einsum
    classifier's MSE at dropout 0 (port names)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert

    jcfg = dataclasses.replace(JBertConfig.tiny(), attention_impl="einsum",
                               max_position_embeddings=S,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    mm = JMultimodalConfig(dropout_prob=0.0)
    ids, vis, ac, mask, labels = _inputs()
    jclf = jbert.MagBertForSequenceClassification(jcfg, mm, visual_dim=DV,
                                                  acoustic_dim=DA)
    params = jax.jit(jclf.init)(jax.random.PRNGKey(0), ids, vis, ac,
                                mask)["params"]
    out = {"params": jax.device_get(params)}
    for impl in ("einsum", "flash"):
        m = jbert.MagBertModel(dataclasses.replace(jcfg, attention_impl=impl),
                               mm, visual_dim=DV, acoustic_dim=DA)
        variables = {"params": params["bert"]}
        if impl == "flash":
            with pltpu.force_tpu_interpret_mode():
                out[impl] = jax.device_get(m.apply(variables, ids, vis, ac,
                                                   mask))
        else:
            out[impl] = jax.device_get(m.apply(variables, ids, vis, ac,
                                               mask))

    def loss(p):
        logits = jclf.apply({"params": p}, ids, vis, ac, mask)
        return jnp.mean(jnp.square(logits.reshape(-1) - labels))

    out["grads"] = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jax.jit(jax.grad(loss))(params))).items()}
    return out


def _port(jax_side, impl, rate=0.0, model_cls=tbert.MagBertModel):
    params = jax_side["params"]
    tree = params["bert"] if model_cls is tbert.MagBertModel else params
    model = model_cls(_cfg(impl, rate), MultimodalConfig(dropout_prob=rate),
                      DV, DA, device="cpu")
    model.load_state_dict(params_from_flax(tree), strict=True)
    return model


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def port_flash(jax_side):
    """The port's flash model's (sequence, pooled), and the #6 plain
    version's calls in that forward."""
    ids, vis, ac, mask, _ = _inputs()
    before = tfa.attn_fwd_packed_fs_reference.calls
    with torch.no_grad():
        seq, pooled = _port(jax_side, "flash")(*_t(ids, vis, ac, mask))
    return (seq.numpy(), pooled.numpy(),
            tfa.attn_fwd_packed_fs_reference.calls - before)


def test_flash_matches_the_jax_flash_model(jax_side, port_flash):
    """Real-token rows and the pooled output against the JAX library flash
    kernel (interpret mode), at the JAX test's band; #6 ran once a
    layer."""
    seq, pooled, calls = port_flash
    want_seq, want_pooled = jax_side["flash"]
    assert calls == BertConfig.tiny().num_hidden_layers
    np.testing.assert_allclose(seq[:, :REAL], want_seq[:, :REAL],
                               rtol=JAX_FLASH_RTOL, atol=JAX_FLASH_ATOL)
    np.testing.assert_allclose(pooled, want_pooled, rtol=JAX_FLASH_RTOL,
                               atol=JAX_FLASH_ATOL)


def test_flash_matches_the_jax_einsum_model(jax_side, port_flash):
    """The same rows against the JAX einsum model (the additive mask #6
    shares) at fp32 1e-5."""
    seq, pooled, _ = port_flash
    want_seq, want_pooled = jax_side["einsum"]
    np.testing.assert_allclose(seq[:, :REAL], want_seq[:, :REAL], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pooled, want_pooled, rtol=TOL, atol=TOL)


# (case, S, forward keywords, prob dropout, whether #6 runs)
GATE = [
    ("every condition holds", S, {}, 0.1, True),
    ("a head_mask", S, {"head_mask": True}, 0.0, False),
    ("S not a multiple of 128", S - 8, {}, 0.0, False),
    ("output_attentions", S, {"output_attentions": True}, 0.0, False),
    ("training at prob dropout 0.1", S, {"deterministic": False}, 0.1,
     False),
    ("training at prob dropout 0", S, {"deterministic": False}, 0.0, True),
]


@pytest.mark.parametrize("case,s,kw,rate,flash", GATE,
                         ids=[g[0] for g in GATE])
def test_flash_gate(jax_side, case, s, kw, rate, flash):
    """The JAX gate (``models/bert.py:281-298``): #6 (its plain version)
    runs only with no head_mask, S % 128 == 0, no output_attentions, and
    deterministic or at prob dropout 0; else the einsum math runs, #6
    never."""
    ids, vis, ac, mask, _ = _inputs(s)
    model = _port(jax_side, "flash", rate)
    kw = dict(kw)
    if kw.pop("head_mask", False):
        kw["head_mask"] = torch.ones(BertConfig.tiny().num_attention_heads)
    if not kw.get("deterministic", True):
        kw["dropout_rng"] = 3
    before = tfa.attn_fwd_packed_fs_reference.calls
    with torch.no_grad():
        out = model(*_t(ids, vis, ac, mask), **kw)
    layers = BertConfig.tiny().num_hidden_layers
    ran = tfa.attn_fwd_packed_fs_reference.calls - before
    assert ran == (layers if flash else 0), case
    assert bool(torch.isfinite(out[0]).all())


def test_dropout_0_training_step_gradients_match_jax_einsum(jax_side):
    """One training-mode forward and backward at dropout 0 through #6/#7
    (their plain versions): every parameter's gradient against
    ``jax.grad`` of the JAX einsum classifier's loss."""
    ids, vis, ac, mask, labels = _inputs()
    model = _port(jax_side, "flash",
                  model_cls=tbert.MagBertForSequenceClassification)
    before = tfa.attn_bwd_packed_fs_reference.calls
    logits = model(*_t(ids, vis, ac, mask), deterministic=False,
                   dropout_rng=3)
    torch.mean(torch.square(logits.reshape(-1)
                            - torch.from_numpy(labels))).backward()
    assert (tfa.attn_bwd_packed_fs_reference.calls - before
            == BertConfig.tiny().num_hidden_layers)
    want = jax_side["grads"]
    for name, p in model.named_parameters():
        w = want[name]
        gap = np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= TOL, (name, gap)


def test_driver_flash_trains_on_einsum_and_evaluates_on_flash(capsys):
    """``driver --attention_impl flash --max_seq_length 128`` on the CPU:
    exit 0 with one finite epoch; training at the tiny model's prob
    dropout 0.1 never runs #6/#7, evaluation runs #6 once a layer a
    batch."""
    fwd, bwd = (tfa.attn_fwd_packed_fs_reference,
                tfa.attn_bwd_packed_fs_reference)
    before = fwd.calls, bwd.calls
    rc, _ = tdriver.run(["--attention_impl", "flash", "--max_seq_length",
                         "128", "--synthetic", "--tiny", "--device", "cpu",
                         "--n_epochs", "1", "--train_batch_size", "8",
                         "--dev_batch_size", "8", "--test_batch_size", "8",
                         "--synthetic_sizes", "16", "8", "8", "--seed", "3"])
    assert rc == 0
    assert "epoch:0, train_loss:" in capsys.readouterr().out
    layers = BertConfig.tiny().num_hidden_layers
    assert bwd.calls == before[1]
    assert fwd.calls - before[0] == 2 * layers  # one dev, one test batch


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
