"""The port's HF-3.0.2 AdamW (``training/optim.py``) against the JAX
package's ``adamw_hf``/``make_optimizer``, on the same converted param tree
and the same seeded gradients, on the CPU.

Tolerance: 1e-6 relative, plus 1e-8 absolute: 1e-6 of the params' scale
(|p| ~ 0.01-0.1 at this init and lr), for a param that ends near zero as
the difference of two such terms (p − lr·u), where one fp32 ulp of the
terms is ~1e-9. Both sides compute every scalar in fp32 and apply the same
per-element ops; they differ only where one library fuses a multiply-add
that the other rounds twice (about one fp32 ulp per update). A wrong eps
placement, schedule index or decay group moves params by ≥ 1e-4 relative
here.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.training import optim as joptim
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

DV, DA, B, S = 5, 7, 2, 6
LR, N_STEPS = 1e-3, 10


@pytest.fixture(scope="module")
def pair():
    """JAX params of the tiny MAG-BERT and the port's model holding them."""
    jmodel = jbert.MagBertForSequenceClassification(
        JBertConfig.tiny(), JMultimodalConfig(), visual_dim=DV,
        acoustic_dim=DA)
    rng = np.random.RandomState(0)
    params = jmodel.init(
        jax.random.PRNGKey(0), rng.randint(0, 128, (B, S)),
        rng.randn(B, S, DV).astype(np.float32),
        rng.randn(B, S, DA).astype(np.float32))["params"]
    params = jax.device_get(params)
    tmodel = tbert.MagBertForSequenceClassification(
        BertConfig.tiny(), MultimodalConfig(), DV, DA, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return params, tmodel


def test_schedule_matches_jax():
    for warmup, total in ((1, 10), (0, 5), (3, 3), (10, 100)):
        want = joptim.linear_warmup_decay_schedule(2e-5, warmup, total)
        got = toptim.linear_warmup_decay_schedule(2e-5, warmup, total)
        for step in range(total + 3):
            assert got(step) == float(want(step)), (warmup, total, step)


def test_decay_partition_matches_jax_leaf_by_leaf(pair):
    params, tmodel = pair
    want = params_from_flax(joptim.decay_mask(params))
    got = toptim.decay_mask(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, on in got.items():
        assert on == bool(want[name]), name
    assert not got["bert.MAG.ln_gamma"] and not got["bert.MAG.b_hv"]
    assert got["bert.MAG.w_hv_v"]
    assert not got["bert.encoder.layer.0.output_LayerNorm.weight"]
    assert not got["bert.embeddings.LayerNorm.weight"]
    assert got["bert.encoder.layer.1.attention.qkv.weight"]
    assert not got["classifier.bias"]


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0, 1e3])
def test_adamw_hf_matches_jax_for_ten_steps(pair, max_grad_norm):
    """10 updates with seeded gradients; max_grad_norm 1.0 clips every
    step (‖g‖ ≈ 20), 1e3 never does."""
    params, tmodel = pair
    model = tbert.MagBertForSequenceClassification(
        BertConfig.tiny(), MultimodalConfig(), DV, DA, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    rng = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.randn(*np.shape(p)) * 0.1).astype(np.float32), params)
        for _ in range(N_STEPS)]

    tx = joptim.make_optimizer(LR, N_STEPS, warmup_proportion=0.1,
                               weight_decay=0.01,
                               max_grad_norm=max_grad_norm)
    state = tx.init(params)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    opt = toptim.make_optimizer(LR, N_STEPS, warmup_proportion=0.1,
                                weight_decay=0.01,
                                max_grad_norm=max_grad_norm)(
        model.named_parameters())
    tparams = dict(model.named_parameters())
    for g in grads:
        for name, t in params_from_flax(g).items():
            tparams[name].grad = t
        opt.step()
    assert opt.count == N_STEPS

    want = params_from_flax(jax.device_get(jp))
    start = tmodel.state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
        assert not torch.equal(p, start[name]), name  # every param moved


def test_update_uses_the_previous_schedule_value():
    """Update k uses schedule(k − 1): at warmup 2 the first update has lr
    0 and moves nothing (no decay either), the second moves."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = toptim.linear_warmup_decay_schedule(0.1, 2, 10)
    opt = toptim.adamw_hf([("w", p)], sched)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
    opt.step()
    assert bool((p.detach() < 1.0).all())
    sd = opt.state_dict()
    opt2 = toptim.adamw_hf([("w", p)], sched)
    opt2.load_state_dict(sd)
    assert opt2.count == 2


def test_clipping_has_no_epsilon():
    """optax.clip_by_global_norm semantics: scale by max/‖g‖ only when
    ‖g‖ >= max, and with no epsilon (a gradient exactly at the bound is
    scaled by exactly 1)."""
    for norm, want in ((5.0, 2.0), (2.0, 2.0), (1.0, 1.0)):
        g = torch.tensor([0.6, 0.8]) * norm
        p = torch.nn.Parameter(torch.zeros(2))
        opt = toptim.adamw_hf([("w", p)], lambda k: 0.0, max_grad_norm=2.0)
        p.grad = g.clone()
        opt.step()
        assert float(torch.linalg.vector_norm(p.grad)) == pytest.approx(
            want, rel=1e-7)
    jclip = optax.clip_by_global_norm(2.0)
    out, _ = jclip.update({"w": np.array([3.0, 4.0], np.float32)},
                          jclip.init(None))
    p = torch.nn.Parameter(torch.zeros(2))
    opt = toptim.adamw_hf([("w", p)], lambda k: 0.0, max_grad_norm=2.0)
    p.grad = torch.tensor([3.0, 4.0])
    opt.step()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(out["w"]),
                               rtol=1e-7)


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
