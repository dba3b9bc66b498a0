"""The port's attention with the QKV projection inside (kernels #18, #19,
their autograd ``FusedAttentionQKVProj`` and ``fused_attention_qkvproj``)
against the JAX package's ``fused_attention_qkvproj`` (its Pallas kernels
``_attn_fwd_qkvproj_kernel`` and ``_attn_bwd_qkvproj_kernel``, run in
interpret mode on the CPU), its dispatch, and MAG-BERT under
``qkv_fusion``.

On the CPU the port takes the kernels' plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels against them and skip without a card
(``python -m pytest --noconftest -m cuda
tests/test_torch_qkvproj_attention.py`` on a GPU machine, which need not
have jax: the JAX side is imported only inside the tests that use it).

Tolerances, fp32: against JAX the loss rtol 1e-6 and dx, dW, db within
1e-5 of each gradient's largest element (the JAX test's own bands: the
same math summed in another order); against the port's split structure
the same; the tiny model's logits 1e-5 with ``qkv_fusion`` on and off
(the projection rounds once more in the dense layer, an fp32 ulp), 1e-4
against the JAX model, and its first-step gradients at the training
tests' bands (rtol 1e-3, atol 5e-5). bf16 on the card: #18's output
within one bf16 rounding of the probs and the output (2^-7 relative plus
2^-6 absolute), dqkv within ``dqkv_bf16_bound`` and dx within
``qkvproj_dx_bf16_bound``. With dropout on no stream compares with JAX (off
the TPU its entry routes dropout to its split structure and
``jax.random``): the port's fused path is held against its own split
structure with the same Philox mask.

bf16 #18's plan (``csrc/attn_full_tc.cuh``'s ``project_head_tc``, then
#1's register plan to S = 64) is emulated in plain torch: the projection
in 16-deep mma steps summed in fp32, the bias added in fp32, one rounding,
held within one bf16 rounding of ``_project``; the attention on it is #1's
plan (tests/test_torch_full_tc.py), held within one bf16 rounding of the
plain #18. The plan's shared memory keeps ``qkvproj_fits``' reach.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.kernels import MAX_SMEM_BYTES
from test_torch_full_tc import _bwd_plan as _saved_bwd_plan
from test_torch_full_tc import _fwd_plan as _reg_fwd_plan
from test_torch_full_tc import _mma_abt

# The JAX test's size (tests/test_fused_attention.py).
B, H, S, DH = 3, 4, 50, 64
D = H * DH
SCALE = 1.0 / DH ** 0.5
VALUE_RTOL, GRAD_RTOL = 1e-6, 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _inputs(b=B, s=S, d=D, seed=0):
    """The JAX test's inputs (``_qkvproj_inputs``): x, w [D, 3D], b3, a
    mask with one padded tail, and a context gradient."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, d) * 0.5).astype(np.float32)
    w = (rng.randn(d, 3 * d) / np.sqrt(d)).astype(np.float32)
    b3 = (rng.randn(3 * d) * 0.01).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, (s * 4) // 5:] = 0
    g = rng.randn(b, s, d).astype(np.float32)
    return x, w, b3, mask, g


def _t(*arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in arrays]


def _loss_and_grads(fn, x, w, b3):
    """sum(out²) of ``fn`` and its gradients to x, w, b3."""
    tx, tw, tb = _t(x, w, b3, requires_grad=True)
    loss = (fn(tx, tw, tb).float() ** 2).sum()
    loss.backward()
    return loss.detach().item(), (tx.grad, tw.grad, tb.grad)


def _assert_grads(got, want):
    for name, a, b in zip(("dx", "dW", "db3"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        rd = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
        assert rd < GRAD_RTOL, (name, rd)


@pytest.mark.parametrize("qkv_residual", [False, True])
def test_qkvproj_matches_jax_kernels(qkv_residual):
    """The loss and dx, dW, db through the plain versions of #18 and #19
    (the backward re-projecting from x, or reading the emitted qkv)
    against the JAX entry's Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    x, w, b3, mask, _ = _inputs()

    def jax_loss(x_, w_, b_):
        out = jfa.fused_attention_qkvproj(
            x_, w_, b_, jnp.asarray(mask), n_heads=H, scale=SCALE,
            interpret=True, qkv_residual=qkv_residual)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, w, b3)))
    calls = (tfa.attn_fwd_qkvproj_reference.calls,
             tfa.attn_bwd_qkvproj_reference.calls)
    got, grads = _loss_and_grads(
        lambda tx, tw, tb: tfa.fused_attention_qkvproj(
            tx, tw, tb, torch.from_numpy(mask), n_heads=H, scale=SCALE,
            qkv_residual=qkv_residual), x, w, b3)
    assert (tfa.attn_fwd_qkvproj_reference.calls,
            tfa.attn_bwd_qkvproj_reference.calls) == (calls[0] + 1,
                                                      calls[1] + 1)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    _assert_grads(grads, want_grads)


@pytest.mark.parametrize("qkv_residual", [False, True])
def test_dropout_matches_the_split_structure(qkv_residual, monkeypatch):
    """At rate 0.1 the fused path (#18/#19's plain versions) draws the
    packed kernels' Philox mask from the same seed: the loss and the three
    gradients equal the port's split structure (the dense projection, then
    ``fused_attention_packed`` with #1/#3)."""
    x, w, b3, mask, _ = _inputs(seed=1)
    kw = dict(n_heads=H, scale=SCALE, dropout_rate=0.1, deterministic=False)
    tm = torch.from_numpy(mask)
    fused, fused_grads = _loss_and_grads(
        lambda tx, tw, tb: tfa.fused_attention_qkvproj(
            tx, tw, tb, tm, dropout_rng=torch.Generator().manual_seed(3),
            qkv_residual=qkv_residual, **kw), x, w, b3)
    split, split_grads = _loss_and_grads(
        lambda tx, tw, tb: tfa.fused_attention_packed(
            torch.matmul(tx, tw) + tb, tm,
            dropout_rng=torch.Generator().manual_seed(3), **kw), x, w, b3)
    np.testing.assert_allclose(fused, split, rtol=VALUE_RTOL)
    _assert_grads(fused_grads, split_grads)


def test_shape_validation():
    """The JAX entry's refusals, and the TPU plan knobs."""
    x, w, b3, mask, _ = (torch.from_numpy(a) for a in _inputs(b=1, s=4))
    kw = dict(n_heads=H, scale=SCALE)
    with pytest.raises(ValueError, match="qkv kernel"):
        tfa.fused_attention_qkvproj(x, w[:, :-1], b3, mask, **kw)
    with pytest.raises(ValueError, match="qkv bias"):
        tfa.fused_attention_qkvproj(x, w, b3[:-1], mask, **kw)
    with pytest.raises(ValueError, match="divisible"):
        tfa.fused_attention_qkvproj(x, w, b3, mask, n_heads=7, scale=SCALE)
    with pytest.raises(ValueError, match="requires dropout_rng"):
        tfa.fused_attention_qkvproj(x, w, b3, mask, dropout_rate=0.1,
                                    deterministic=False, **kw)
    for knob in ("interpret", "nb_fwd", "nb_bwd"):
        with pytest.raises(ValueError, match="TPU kernel-plan knobs"):
            tfa.fused_attention_qkvproj(x, w, b3, mask, **{knob: 1}, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **kw)


def _calls():
    return {f.__name__: f.calls for f in (
        tfa.attn_fwd_qkvproj_reference, tfa.attn_bwd_qkvproj_reference,
        tfa.attn_fwd_packed_reference, tfa.attn_bwd_packed_saved_reference,
        tfa.attn_bwd_packed_reference)}


def _entry_step(s, save_env, monkeypatch, d=D, h=H):
    """One forward and backward through the entry at length ``s``; returns
    the plain versions' calls it made."""
    if save_env is not None:
        monkeypatch.setenv("FUSED_ATTN_SAVE", save_env)
    x, w, b3, mask, g = _inputs(b=1, s=s, d=d, seed=2)
    tx, tw, tb = _t(x, w, b3, requires_grad=True)
    before = _calls()
    out = tfa.fused_attention_qkvproj(tx, tw, tb, torch.from_numpy(mask),
                                      n_heads=h, scale=SCALE)
    out.backward(torch.from_numpy(g))
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


def _model_step(kw):
    """One forward and backward of the tiny MAG-BERT with ``qkv_fusion``
    and the model call's keywords ``kw``; returns the calls it made."""
    model = _tiny(True, seed=4)
    ids, vis, ac, mask = _batch()
    before = _calls()
    out = model(ids, vis, ac, mask, **kw)
    (out[0] if isinstance(out, tuple) else out).sum().backward()
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


@pytest.mark.parametrize("case", [
    "S=50", "FUSED_ATTN_SAVE=0", "past the reach", "forward past the reach",
    "head_mask", "output_attentions"])
def test_dispatch(case, monkeypatch):
    """Which plain versions a call reached: #18/#19 at S=50; the split
    structure (#1 with #2, or with #3) under ``FUSED_ATTN_SAVE=0`` and past
    #18/#19's shared-memory plan with a gradient (fp32, Dh = 64: S = 108;
    without one #18 reaches it); the model's einsum branch, no kernel, with
    head_mask or output_attentions."""
    monkeypatch.delenv("FUSED_ATTN_SAVE", raising=False)
    assert tfa.qkvproj_fits(107, 64, 4, True)
    assert not tfa.qkvproj_fits(108, 64, 4, True)
    assert tfa.qkvproj_fits(108, 64, 4, False)
    qkvproj = {"attn_fwd_qkvproj_reference": 1,
               "attn_bwd_qkvproj_reference": 1}
    if case == "S=50":
        assert _entry_step(S, None, monkeypatch) == qkvproj
    elif case == "FUSED_ATTN_SAVE=0":
        assert _entry_step(S, "0", monkeypatch) == {
            "attn_fwd_packed_reference": 1, "attn_bwd_packed_reference": 1}
    elif case == "past the reach":
        assert _entry_step(108, None, monkeypatch, d=DH, h=1) == {
            "attn_fwd_packed_reference": 1,
            "attn_bwd_packed_saved_reference": 1}
    elif case == "forward past the reach":
        before = _calls()
        x, w, b3, mask, _ = _inputs(b=1, s=108, d=DH, seed=2)
        with torch.no_grad():
            tfa.fused_attention_qkvproj(*_t(x, w, b3, mask), n_heads=1,
                                        scale=SCALE)
        assert _calls()["attn_fwd_qkvproj_reference"] == before[
            "attn_fwd_qkvproj_reference"] + 1
    elif case == "head_mask":
        layers, heads = TINY.num_hidden_layers, TINY.num_attention_heads
        assert _model_step({"head_mask": torch.ones(layers, heads)}) == {}
    else:
        assert _model_step({"output_attentions": True}) == {}


# --- the tiny MAG-BERT ------------------------------------------------------

TINY = BertConfig.tiny()
MB, MS, DV, DA = 4, 12, 3, 5


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    mask = np.ones((MB, MS), np.int32)
    mask[1, 7:] = 0
    ids = rng.randint(1, TINY.vocab_size, (MB, MS)).astype(np.int32) * mask
    vis = rng.randn(MB, MS, DV).astype(np.float32)
    ac = rng.randn(MB, MS, DA).astype(np.float32)
    return (torch.from_numpy(ids).long(), torch.from_numpy(vis),
            torch.from_numpy(ac), torch.from_numpy(mask))


def _tiny(qkv_fusion, seed=None, state=None):
    cfg = dataclasses.replace(
        TINY, attention_impl="fused", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, qkv_fusion=qkv_fusion,
        qkv_residual=qkv_fusion)
    model = MagBertForSequenceClassification(
        cfg, MultimodalConfig(dropout_prob=0.0), DV, DA, device="cpu",
        generator=(None if seed is None
                   else torch.Generator().manual_seed(seed)))
    if state is not None:
        model.load_state_dict(state)
    return model


def test_model_with_and_without_qkv_fusion():
    """The same parameters (``state_dict`` keys and shapes) and the same
    logits within 1e-5 with ``qkv_fusion`` on and off; the fused model's
    forward runs #18 once a layer."""
    plain = _tiny(False, seed=6)
    fused = _tiny(True, state=plain.state_dict())
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in fused.state_dict().items()}
    batch = _batch()
    before = tfa.attn_fwd_qkvproj_reference.calls
    with torch.no_grad():
        got = fused(*batch)
        want = plain(*batch)
    assert (tfa.attn_fwd_qkvproj_reference.calls
            == before + TINY.num_hidden_layers)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_model_matches_jax_model():
    """The tiny MAG-BERT with ``qkv_fusion`` and ``qkv_residual`` against
    the JAX model with the same flags (its qkvproj kernels in interpret
    mode; fp32, dropout 0) from the same params (``params_from_flax``):
    logits within 1e-4, every first-step gradient of the MSE loss within
    rtol 1e-3 / atol 5e-5."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    jcfg = dataclasses.replace(
        JBertConfig.tiny(), attention_impl="fused", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, qkv_fusion=True, qkv_residual=True)
    jmodel = jbert.MagBertForSequenceClassification(
        jcfg, JMultimodalConfig(dropout_prob=0.0), visual_dim=DV,
        acoustic_dim=DA)
    ids, vis, ac, mask = (x.numpy() for x in _batch())
    ids = ids.astype(np.int32)
    labels = np.linspace(-2.0, 2.0, MB).astype(np.float32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids, vis, ac,
                                        mask)["params"])

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, ids, vis, ac, mask,
                              deterministic=True)
        return jnp.mean((logits[:, 0] - labels) ** 2), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = _tiny(True, state=params_from_flax(params))
    logits = model(*_batch())
    loss = ((logits[:, 0] - torch.from_numpy(labels)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    want_grads = params_from_flax(jax.device_get(jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-3, atol=5e-5, err_msg=name)


# --- bf16 #18's plan, emulated ------------------------------------------

PLAN_H = 2     # test_torch_full_tc's register-plan emulation's heads


def _proj_plan(x, w, b3):
    """bf16 #18's (and #19's) projection in plain torch: x·W over 16-deep
    mma steps summed in fp32, + b3 in fp32, one rounding to bf16."""
    return (_mma_abt(x, w.t()) + b3.float()).to(torch.bfloat16)


def _bf16_case(s, dh, seed):
    x, w, b3, mask, _ = _inputs(2, s, PLAN_H * dh, seed)
    mask[1, :] = 0                          # a batch row masked whole
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b3)],
            torch.from_numpy(mask).float())


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40), (65, 16)])
def test_tc_projection_matches_project(s, dh):
    """The tensor-core projection's arithmetic (16-deep steps, the fp32
    sum, the fp32 bias, one rounding) lies within one bf16 rounding of
    ``_project`` (the fp32 product, then the bias, one rounding)."""
    (x, w, b3), _ = _bf16_case(s, dh, seed=s + dh)
    got, want = _proj_plan(x, w, b3), tfa._project(x, w, b3)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= 2.0 ** -7 * want.float().abs() + 2.0 ** -20).all())
    assert float(want.float().abs().max()) > 0.5


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plan_to_s64_is_ones_plan_on_its_qkv(s, dh, rate):
    """bf16 #18 to S = 64 is the projection's plan, then #1's register plan
    on the projected head: its out, p and pd are #1's plan on the emitted
    qkv (the same bits by construction, which the card's test holds), and
    lie within one bf16 rounding of the plain #18."""
    (x, w, b3), mask = _bf16_case(s, dh, seed=2 * s + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 60 + 3
    qkv = _proj_plan(x, w, b3)
    got, _ = _reg_fwd_plan(qkv, mask, scale, rate, seed)
    want = tfa.attn_fwd_qkvproj_reference(
        x, w, b3, mask, n_heads=PLAN_H, scale=scale, rate=rate, seed=seed,
        save=True, emit_qkv=True)
    for a, b_ in zip((got[0], qkv, got[1], got[2]), want):
        np.testing.assert_allclose(a.float().numpy(), b_.float().numpy(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)


# --- bf16 #19's plan, emulated ------------------------------------------


def _bwd19_plan(p, pd, src, w, b3, g, scale, recompute):
    """bf16 #19's (head, batch row) pass in plain torch: #3's tiles filled
    by the projection's plan (``recompute``) or from the saved qkv, then #3's
    compute half (tests/test_torch_full_tc.py's ``_bwd_plan``: bf16
    operands, 16-deep steps summed in fp32, the quad's lane order)."""
    qkv = _proj_plan(src, w, b3) if recompute else src
    return _saved_bwd_plan(p, pd, qkv, g, scale)


def _dx_plan(dqkv, w):
    """bf16 #19's dx tile plan in plain torch: dqkv [B, S, 3D] · Wᵀ over
    16-deep mma steps summed in fp32 (the 32-deep ring slices and 128 ×
    128 block tiles change no sum), rounded once to bf16."""
    return _mma_abt(dqkv, w).to(torch.bfloat16)


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40), (65, 16)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_plan_is_threes_plan_on_its_tiles(s, dh, rate):
    """bf16 #19's compute half is #3's: from x it gives #3's emulated dqkv
    on #18's emitted qkv bit for bit, as it does from that qkv, and both
    lie within ``dqkv_bf16_bound`` of the plain #19."""
    (x, w, b3), mask = _bf16_case(s, dh, seed=3 * s + dh)
    g = torch.from_numpy(np.random.RandomState(s).randn(
        2, s, PLAN_H * dh).astype(np.float32)).to(torch.bfloat16)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 59 + 1
    qkv = _proj_plan(x, w, b3)
    _, p, pd = tfa.attn_fwd_packed_reference(
        qkv, mask, n_heads=PLAN_H, scale=scale, rate=rate, seed=seed,
        save=True)
    from_x = _bwd19_plan(p, pd, x, w, b3, g, scale, True)
    from_qkv = _bwd19_plan(p, pd, qkv, w, b3, g, scale, False)
    assert torch.equal(from_x, from_qkv)
    assert torch.equal(from_qkv, _saved_bwd_plan(p, pd, qkv, g, scale))
    want, _ = tfa.attn_bwd_qkvproj_reference(
        p, pd, qkv, w, b3, g, n_heads=PLAN_H, scale=scale, recompute=False)
    bound = tfa.dqkv_bf16_bound(want, p, pd, qkv, g, n_heads=PLAN_H,
                                scale=scale)
    assert bool(((from_x.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("b,s,dh", [(2, 50, 16), (3, 33, 40)])
def test_dx_tile_plan_matches_the_plain_dx(b, s, dh):
    """bf16 #19's dx plan on the emulated dqkv lies within
    ``qkvproj_dx_bf16_bound`` of the plain #19's dx (its dqkv's bound
    carried through |W|), with M = B·S off the 128-row tile."""
    x, w, b3, mask, g = _inputs(b, s, PLAN_H * dh, seed=b + s)
    x, w, b3, g = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in (x, w, b3, g))
    mask = torch.from_numpy(mask).float()
    scale = 1.0 / dh ** 0.5
    qkv = _proj_plan(x, w, b3)
    _, p, pd = tfa.attn_fwd_packed_reference(
        qkv, mask, n_heads=PLAN_H, scale=scale, rate=0.1, seed=5, save=True)
    dqkv = _bwd19_plan(p, pd, qkv, w, b3, g, scale, False)
    want_dqkv, want_dx = tfa.attn_bwd_qkvproj_reference(
        p, pd, qkv, w, b3, g, n_heads=PLAN_H, scale=scale, recompute=False)
    bound = tfa.dqkv_bf16_bound(want_dqkv, p, pd, qkv, g, n_heads=PLAN_H,
                                scale=scale)
    got = _dx_plan(dqkv, w)
    assert (b * s) % 128 != 0
    assert bool(((got.float() - want_dx.float()).abs()
                 <= tfa.qkvproj_dx_bf16_bound(want_dx, bound, w)).all())
    assert float(want_dx.float().abs().max()) > 0.1


def _header_constant(name):
    from pathlib import Path
    import re

    header = (Path(tfa.__file__).resolve().parents[1] / "csrc"
              / "attn_full_tc.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         header).group(1))


def test_qkvproj_reach_is_unchanged_and_fits():
    """``qkvproj_fits`` keeps its reach (bf16 S = 468 without a gradient
    and 122 with one at Dh = 64, 228 / 91 at Dh = 128; fp32 253 / 107 and
    119 / 73) with the bf16 plans' shared memory (#1's register tiles and
    the projection's ring to S = 64, the head [S][3·Dh] past it, #19's
    head beside #3's fp32 plan), which fits 227 KB wherever the reach
    goes; the plans' constants are the header's."""
    names = ("kProjStages", "kProjRows", "kProjCols", "kProjRegRows",
             "kProjRegDepth", "kProjRowsDepth")
    assert tuple(map(_header_constant, names)) == (
        tfa.QKVPROJ_TC_STAGES, tfa.QKVPROJ_TC_ROWS, tfa.QKVPROJ_TC_COLS,
        tfa.QKVPROJ_TC_REG_ROWS, tfa.QKVPROJ_TC_REG_DEPTH,
        tfa.QKVPROJ_TC_ROWS_DEPTH)
    reach = {(64, 2): (468, 122), (128, 2): (228, 91), (64, 4): (253, 107),
             (128, 4): (119, 73)}
    for (dh, itemsize), (fwd, bwd) in reach.items():
        for s, grad in ((fwd, False), (bwd, True)):
            assert tfa.qkvproj_fits(s, dh, itemsize, grad)
            assert not tfa.qkvproj_fits(s + 1, dh, itemsize, grad)
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for s in range(1, tfa.MAX_SEQ_LEN + 1):
            if tfa.qkvproj_fits(s, dh, 2, False):
                assert tfa.qkvproj_fwd_smem_bytes(s, dh, 2) <= MAX_SMEM_BYTES
            if tfa.qkvproj_fits(s, dh, 2, True):
                assert tfa.qkvproj_bwd_smem_bytes(s, dh, 2, True) <= (
                    MAX_SMEM_BYTES)
    assert tfa.qkvproj_tc_stage_bytes(64) == 40960
    assert tfa.qkvproj_fwd_smem_bytes(50, 64, 2) == 147968
    # bf16 #19's tensor-core plan: two batch rows a block to S = 64, #3's
    # plan from the saved qkv, fitting wherever the reach goes
    assert _header_constant("kBwdProjRows") == tfa.QKVPROJ_TC_BWD_ROWS
    assert tfa.qkvproj_bwd_smem_bytes(50, 64, 2, True) == (
        2 * 4 * 64 * 72 * 2 + tfa.qkvproj_tc_stage_bytes(64, 2, 64))
    assert tfa.qkvproj_bwd_smem_bytes(122, 64, 2, True) == (
        4 * 128 * 72 * 2 + 2 * 128 * 136 * 2)
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for s in range(1, 200):
            assert tfa.qkvproj_bwd_smem_bytes(s, dh, 2, False) == (
                tfa.full_tc_bwd_smem_bytes(s, dh))
            if tfa.qkvproj_fits(s, dh, 2, True):
                assert tfa._rows16(s) // 8 <= (22 if dh <= 64 else 18)


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card(device, dtype, b, s, h, dh, seed):
    td = getattr(torch, dtype)
    x, w, b3, mask, g = _inputs(b, s, h * dh, seed)
    return ([torch.from_numpy(a).to(device, td) for a in (x, w, b3, g)],
            torch.from_numpy(mask).to(device).float())


def _close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", [
    ("bfloat16", 64, 50, 12, 64),    # bert-base at S=50
    ("bfloat16", 8, 50, 16, 64),     # bert-large width
    ("float32", 4, 77, 12, 64),
    ("bfloat16", 2, 122, 4, 64),     # the backward's longest S in bf16
    ("float32", 3, 33, 2, 128),      # the widest head
    ("bfloat16", 4, 64, 4, 64),      # bf16 #18's register plan's last S
    ("bfloat16", 4, 65, 4, 64),      # its row plan's first
    ("bfloat16", 2, 50, 4, 128),     # the widest head, two column passes
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_qkvproj_kernels_match_plain_on_card(cuda_device, dtype, b, s, h,
                                             dh, rate):
    """#18 (saved probs, emitted qkv) against its plain version and #1 on
    its emitted qkv (bit for bit in fp32 and, to S = 64, where both run #1's
    register plan, in bf16; past it in bf16 within one bf16 rounding, with
    the same keep mask); #19 from x equal to #19 from that qkv bit for bit,
    and against the plain backward; the same bits twice."""
    (x, w, b3, g), mask = _card(cuda_device, dtype, b, s, h, dh, 13)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 61 + 5
    kw = dict(n_heads=h, scale=scale)
    out, qkv, p, pd = tfa.attn_fwd_qkvproj_cuda(
        x, w, b3, mask, rate=rate, seed=seed, save=True, emit_qkv=True, **kw)
    r_out, r_qkv, r_p, r_pd = tfa.attn_fwd_qkvproj_reference(
        x, w, b3, mask, rate=rate, seed=seed, save=True, emit_qkv=True, **kw)
    for got, want in ((out, r_out), (qkv, r_qkv), (p, r_p), (pd, r_pd)):
        _close(got, want, dtype)
    packed = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                      save=True, **kw)
    if dtype == "float32" or s <= tfa.FULL_TC_REG_MAX_SEQ_LEN:
        assert all(torch.equal(a, b_) for a, b_ in zip((out, p, pd), packed))
    else:
        for a, b_ in zip((out, p, pd), packed):
            _close(a, b_, dtype)
        live = (p > 0) & (packed[1] > 0)
        assert torch.equal((pd > 0)[live], (packed[2] > 0)[live])
    saved = tfa.attn_bwd_qkvproj_cuda(p, pd, qkv, w, b3, g, recompute=False,
                                      **kw)
    recomputed = tfa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g,
                                           recompute=True, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(saved, recomputed))
    r_dqkv, r_dx = tfa.attn_bwd_qkvproj_reference(p, pd, qkv, w, b3, g,
                                                  recompute=False, **kw)
    torch.cuda.synchronize()
    if dtype == "float32":
        _close(saved[0], r_dqkv, dtype)
        _close(saved[1], r_dx, dtype)
    else:
        bound = tfa.dqkv_bf16_bound(r_dqkv, p, pd, qkv, g, **kw)
        assert bool(((saved[0].float() - r_dqkv.float()).abs()
                     <= bound).all())
        dx_bound = tfa.qkvproj_dx_bf16_bound(r_dx, bound, w)
        assert bool(((saved[1].float() - r_dx.float()).abs()
                     <= dx_bound).all())
    again = tfa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g, recompute=True,
                                      **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, recomputed))


@pytest.mark.cuda
@pytest.mark.parametrize("qkv_residual", [False, True])
def test_qkvproj_autograd_launches_the_kernels(cuda_device, qkv_residual,
                                               monkeypatch):
    """With a gradient, one #18 and one #19 call (two launches); without
    one, #18 alone; under ``FUSED_ATTN_SAVE=0`` #1 and #2."""
    monkeypatch.delenv("FUSED_ATTN_SAVE", raising=False)
    (x, w, b3, g), mask = _card(cuda_device, "bfloat16", 4, 50, 12, 64, 15)
    fns = (tfa.attn_fwd_qkvproj_cuda, tfa.attn_bwd_qkvproj_cuda,
           tfa.attn_fwd_packed_cuda, tfa.attn_bwd_packed_cuda)
    kw = dict(n_heads=12, scale=0.125, dropout_rate=0.1,
              deterministic=False, qkv_residual=qkv_residual)

    def step(grad):
        before = [f.launches for f in fns]
        xs = [t.clone().requires_grad_(grad) for t in (x, w, b3)]
        out = tfa.fused_attention_qkvproj(
            *xs, mask, dropout_rng=torch.Generator().manual_seed(1), **kw)
        if grad:
            out.backward(g)
        return tuple(f.launches - n for f, n in zip(fns, before))

    assert step(True) == (1, 2, 0, 0)
    assert step(False) == (1, 0, 0, 0)
    monkeypatch.setenv("FUSED_ATTN_SAVE", "0")
    assert step(True) == (0, 0, 1, 1)


@pytest.mark.cuda
def test_qkvproj_forward_reach_on_card(cuda_device):
    """bf16 #18 at the last S it takes without a gradient (468 at Dh = 64:
    the head [S][3·Dh] beside #1's row plan) against its plain version,
    serving and with saved probs and the emitted qkv; S = 469 is
    refused."""
    (x, w, b3, g), mask = _card(cuda_device, "bfloat16", 1, 468, 2, 64, 17)
    kw = dict(n_heads=2, scale=0.125)
    out = tfa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **kw)[0]
    _close(out, tfa.attn_fwd_qkvproj_reference(x, w, b3, mask, **kw)[0],
           "bfloat16")
    fwd = dict(rate=0.1, seed=5, save=True, emit_qkv=True, **kw)
    for got, want in zip(tfa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **fwd),
                         tfa.attn_fwd_qkvproj_reference(x, w, b3, mask,
                                                        **fwd)):
        _close(got, want, "bfloat16")
    (x, w, b3, g), mask = _card(cuda_device, "bfloat16", 1, 469, 2, 64, 17)
    with pytest.raises(ValueError, match="qkvproj_fits"):
        tfa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh", [
    (8, 50, 12, 64),     # bert-base; M = 400, off dx's 128-row tile
    (3, 64, 12, 64),     # two batch rows a block: its last S, a lone row
    (3, 65, 12, 64),     # one batch row a block: its first S
    (2, 122, 12, 64),    # the backward's reach in bf16
    (5, 50, 16, 64),     # bert-large width
    (3, 64, 4, 128),     # the widest head, two rows a block
    (2, 91, 4, 128),     # the widest head's reach
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_dqkv_is_threes_on_card(cuda_device, b, s, h, dh, rate):
    """bf16 #19 runs #3's compute half: its dqkv from the saved qkv is
    #3's on the same (p, pd, qkv, g) bit for bit, and from x the same
    again; dx is held within ``qkvproj_dx_bf16_bound`` of the plain dx on
    the same dqkv."""
    (x, w, b3, g), mask = _card(cuda_device, "bfloat16", b, s, h, dh, 21)
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    _, qkv, p, pd = tfa.attn_fwd_qkvproj_cuda(
        x, w, b3, mask, rate=rate, seed=9, save=True, emit_qkv=True, **kw)
    dqkv, dx = tfa.attn_bwd_qkvproj_cuda(p, pd, qkv, w, b3, g,
                                         recompute=False, **kw)
    three = tfa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)
    from_x = tfa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g, recompute=True,
                                       **kw)
    want_dx = torch.matmul(dqkv.float(), w.float().t())
    torch.cuda.synchronize()
    assert torch.equal(dqkv, three)
    assert torch.equal(from_x[0], dqkv) and torch.equal(from_x[1], dx)
    bound = tfa.qkvproj_dx_bf16_bound(
        want_dx, torch.zeros_like(dqkv, dtype=torch.float32), w)
    assert bool(((dx.float() - want_dx).abs() <= bound).all())


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
