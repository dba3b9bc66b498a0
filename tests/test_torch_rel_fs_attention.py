"""The port's flash-streamed rel tier (kernels #16/#17): their plain
versions through ``FusedRelAttentionFS`` on the CPU against the JAX
package's ``_fused_rel_attention_fs`` (Pallas, interpret mode), a ragged
geometry against the port's own einsum math, the tier rule ``rel_tier``
at the edges where the fs tier starts, the model's paths onto it, and the
dropout contract (the mask is the other rel tiers', replayed exactly in
the backward, with the right keep rate and an unbiased output).

Tolerances: out and lse 1e-5, dq, dk, dv and debias 3e-5 (atol and rtol):
the same recurrence in another summation order (the port's key blocks are
64 keys, JAX's 128; the online softmax rescales once per block). Against
the whole-row einsum math (the softmax in one piece): 2e-5 for the output
and 3e-5 for the gradients, the band of the packed fs tier's test
(``tests/test_torch_long_attention.py``). The tests marked ``cuda`` hold
the CUDA kernels against these plain versions and skip without a card
(``python -m pytest --noconftest -m cuda tests/test_torch_rel_fs_attention.py``
on a GPU machine).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.dropout import draw_seed

B, H, DH = 2, 4, 32
D = H * DH
SCALE = 1.0 / DH ** 0.5
OUT_TOL, GRAD_TOL = 1e-5, 3e-5
WHOLE_OUT_TOL, WHOLE_GRAD_TOL = 2e-5, 3e-5
PLAIN = ("attn_fwd_rel_reference", "attn_bwd_rel_reference",
         "attn_bwd_rel_saved_reference", "attn_fwd_rel_hb_reference",
         "attn_bwd_rel_hb_reference", "attn_fwd_rel_fs_reference",
         "attn_bwd_rel_fs_reference", "attn_fwd_relik_fs_reference",
         "attn_bwd_relik_fs_reference")
FS = {"attn_fwd_rel_fs_reference": 1, "attn_bwd_rel_fs_reference": 1}


def _calls():
    return {name: getattr(tfa, name).calls for name in PLAIN}


def _ran(before):
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


def _case(q_len, k_len, seed, b=B, h=H, dh=DH, masked_row=False):
    """Seeded q, k, v, g and an XLNet-like ebias: O(1) bias, −1e30 on the
    first keys of batch row 0 (left padding; the memory columns are real)
    and on one whole key block of one row (a block masked whole); with
    ``masked_row`` one query row masked whole, whose lse is −1e30 to fp32
    precision, so the backward rebuilds p = 1 there, as the JAX fs tier
    does (the whole-row tiers give 1/K)."""
    rng = np.random.RandomState(seed)
    d = h * dh
    q = rng.randn(b, q_len, d).astype(np.float32)
    k, v = (rng.randn(b, k_len, d).astype(np.float32) for _ in "kv")
    g = rng.randn(b, q_len, d).astype(np.float32)
    eb = (rng.randn(b, h, q_len, k_len) * 0.5).astype(np.float32)
    eb[0, :, :, :5] -= 1e30
    eb[b - 1, 0, 3, :min(64, k_len - 1)] -= 1e30
    if masked_row:
        eb[b - 1, h - 1, 1, :] -= 1e30
    return q, k, v, eb, g


def _autograd(fn, arrays, g):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return out.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("q_len,k_len", [(256, 384), (256, 256)])
def test_fs_tier_matches_jax(q_len, k_len):
    """#16's and #17's plain versions through ``FusedRelAttentionFS``
    against JAX ``_fused_rel_attention_fs`` at rate 0, hb = H, qb = kb =
    128 (several q and k blocks), a query row masked whole included: out
    and lse, then dq, dk, dv and the unscaled debias."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.fused_attention import (
        _fused_rel_attention_fs,
        _fwd_rel_fs_pallas,
    )

    arrays = _case(q_len, k_len, seed=q_len + k_len, masked_row=True)
    g = arrays[4]
    jx = [jnp.asarray(a) for a in arrays[:4]]
    seed = jnp.zeros((1, 1), jnp.int32)
    kw = dict(scale=SCALE, rate=0.0, n_heads=H, hb=H, qb=128, kb=128,
              interpret=True)
    want_out, want_lse = _fwd_rel_fs_pallas(*jx, seed, **kw)
    _, vjp = jax.vjp(lambda *a: _fused_rel_attention_fs(
        *a, seed, SCALE, 0.0, H, H, 128, 128, True), *jx)
    want_g = vjp(jnp.asarray(g))
    before = _calls()
    out, grads = _autograd(
        lambda *xs: tfa.FusedRelAttentionFS.apply(*xs, H, SCALE, 0.0, 0),
        arrays[:4], g)
    assert _ran(before) == FS
    _, lse = tfa.attn_fwd_rel_fs_reference(
        *(torch.from_numpy(a) for a in arrays[:4]), n_heads=H, scale=SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(B, H, q_len),
                               atol=OUT_TOL, rtol=OUT_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "debias"), grads, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def _einsum_rel(q, k, v, eb, keep=None, rate=0.0):
    """Whole-row rel attention in plain autograd math: softmax(q·kᵀ·scale
    + ebias), the keep mask if given, ·v."""
    p = tfa._rel_probs(q, k, eb, H, SCALE)
    if keep is not None:
        p = torch.where(keep, p * tfa.inv_keep(rate), 0.0)
    return tfa._merge_heads(torch.matmul(p, tfa._ctx_heads(v, H)))


def test_fs_tier_takes_a_ragged_geometry():
    """At Q = 70, K = 131 (ragged last q tile and key block, K ≠ Q as under
    memory; the JAX fs tier needs multiples of 128) against the whole-row
    einsum math and its autograd gradients."""
    arrays = _case(70, 131, seed=3)
    g = arrays[4]
    out, grads = _autograd(
        lambda *xs: tfa.FusedRelAttentionFS.apply(*xs, H, SCALE, 0.0, 0),
        arrays[:4], g)
    want, want_g = _autograd(_einsum_rel, arrays[:4], g)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=WHOLE_OUT_TOL,
                               rtol=WHOLE_OUT_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "debias"), grads, want_g):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=WHOLE_GRAD_TOL,
                                   rtol=WHOLE_GRAD_TOL, err_msg=name)


# --- the tier rule ---------------------------------------------------------


@pytest.mark.parametrize("q_len,k_len,grad,ik,tier", [
    (640, 640, True, False, "hb"),
    (641, 641, True, False, "fs"),
    (641, 641, False, False, "fs"),
    (8, 700, True, False, "fs"),
    (1000, 8, True, False, "fs"),      # K ≤ 512, Q past the hb reach
    (641, 641, True, True, "ik_fs"),
    (512, 1024, True, False, "fs"),    # --mem_len 512 at S = 512, stream
    (512, 1024, True, True, "ik_fs"),  # the same under auto
    (50, 100, True, False, "full"),    # --mem_len 50 at S = 50
])
def test_rel_tier_takes_fs_past_the_head_blocked_reach(q_len, k_len, grad,
                                                       ik, tier):
    """At Dh = 64: past the head-blocked reach without the ingredients the
    tier is "fs", at any Q and K; every geometry has a tier."""
    assert tfa.rel_tier(q_len, k_len, 64, grad, ik) == tier


@pytest.mark.parametrize("q_len,k_len,grad", [
    (641, 641, True), (641, 641, False), (8, 700, True), (8, 700, False)])
def test_entry_takes_the_fs_tier(q_len, k_len, grad):
    """``fused_rel_attention`` runs #16 (and #17 with a gradient) past 640,
    with and without a gradient, finite everywhere."""
    rng = np.random.RandomState(q_len + k_len)
    xs = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
          .requires_grad_(grad) for shape in (
              (1, q_len, 64), (1, k_len, 64), (1, k_len, 64),
              (1, 1, q_len, k_len))]
    before = _calls()
    out = tfa.fused_rel_attention(*xs, n_heads=1, scale=0.125)
    if grad:
        out.sum().backward()
        assert all(bool(torch.isfinite(x.grad).all()) for x in xs)
    assert bool(torch.isfinite(out).all())
    assert _ran(before) == (FS if grad else
                            {"attn_fwd_rel_fs_reference": 1})


DV, DA = 5, 7


def _xlnet_inputs(b, s, seed):
    rng = np.random.RandomState(seed)
    n_real = rng.randint(s // 2, s + 1, b)
    n_real[0] = s
    real = np.arange(s)[None, :] >= (s - n_real)[:, None]
    ids = np.where(real, rng.randint(5, 128, (b, s)), 2).astype(np.int32)
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    vis = (rng.randn(b, s, DV) * real[..., None]).astype(np.float32)
    ac = (rng.randn(b, s, DA) * real[..., None]).astype(np.float32)
    return ids, vis, ac, real.astype(np.int32), segs


def _xlnet_model(**kw):
    from bert_multimodal_transformer_tpu_torch.config import (
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    cfg = dataclasses.replace(XLNetConfig.tiny(), attention_impl="fused",
                              **kw)
    return MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(beta_shift=1.0, injection_index=1), DV, DA,
        torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kw", [
    {"rel_bias_impl": "stream"},
    {"bi_data": True},               # a [B, P, D] position stream
    {"attn_type": "uni"},            # P = K + 1 < Q + K
])
def test_tiny_xlnet_takes_the_fs_tier_past_640(kw):
    """Each path the ingredients do not take, at S = 648 past the
    head-blocked reach: one training forward and backward of the tiny model
    runs #16/#17's plain versions in every layer, finite."""
    ids, vis, ac, mask, segs = _xlnet_inputs(2, 648, seed=2)
    model = _xlnet_model(**kw)
    before = _calls()
    logits = model(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                   attention_mask=torch.from_numpy(mask),
                   token_type_ids=torch.from_numpy(segs))
    logits.sum().backward()
    layers = model.config.n_layer
    assert _ran(before) == {k: layers for k in FS}
    assert bool(torch.isfinite(logits).all())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)


# --- the dropout stream ----------------------------------------------------


def test_fs_keep_mask_is_the_other_tiers_mask(monkeypatch):
    """With q = 0 and no bias every score is 0 and p = 1/K; with v_h the
    identity (K = Dh) out[q, h, c] = keep(q, c)/(K·(1 − rate)), > 0 exactly
    where (b, h, q, c) is kept. #16's plain version draws its mask a key
    block at a time; at two block widths its mask is
    ``dropout_keep_mask``'s, and the full-H and head-blocked plain versions
    give the same mask."""
    b, q_len, h, dh, rate, seed = 2, 8, 2, 32, 0.2, 2 ** 40 + 3
    q = torch.zeros(b, q_len, h * dh)
    v = torch.eye(dh)[None, :, None, :].expand(b, dh, h, dh).reshape(
        b, dh, h * dh)
    k = torch.randn(b, dh, h * dh, generator=torch.Generator().manual_seed(1))
    eb = torch.zeros(b, h, q_len, dh)
    keep = tfa.dropout_keep_mask(seed, b, h, q_len, dh, rate)

    def kept(out):
        return out.view(b, q_len, h, dh).permute(0, 2, 1, 3) > 0

    kw = dict(n_heads=h, scale=1.0, rate=rate, seed=seed)
    assert torch.equal(kept(tfa.attn_fwd_rel_reference(q, k, v, eb, **kw)),
                       keep)
    assert torch.equal(kept(tfa.attn_fwd_rel_hb_reference(q, k, v, eb,
                                                          **kw)), keep)
    for width in (tfa.FS_KEY_BLOCK, 8):
        monkeypatch.setattr(tfa, "FS_KEY_BLOCK", width)
        out, _ = tfa.attn_fwd_rel_fs_reference(q, k, v, eb, **kw)
        assert torch.equal(kept(out), keep), width
    assert not bool(keep.all())


def test_fs_dropout_replays_the_mask():
    """At rate 0.2 (ragged Q = 70, K = 90) the fs tier's forward and
    backward use one mask: output and gradients equal the whole-row
    autograd math fed ``dropout_keep_mask`` for the same seed."""
    rate, seed = 0.2, draw_seed(torch.Generator().manual_seed(11))
    arrays = _case(70, 90, seed=8)
    g = arrays[4]
    out, grads = _autograd(
        lambda *xs: tfa.FusedRelAttentionFS.apply(*xs, H, SCALE, rate, seed),
        arrays[:4], g)
    keep = tfa.dropout_keep_mask(seed, B, H, 70, 90, rate)
    want, want_g = _autograd(
        lambda *xs: _einsum_rel(*xs, keep=keep, rate=rate), arrays[:4], g)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=WHOLE_OUT_TOL,
                               rtol=WHOLE_OUT_TOL)
    for name, a, w in zip(("dq", "dk", "dv", "debias"), grads, want_g):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=WHOLE_GRAD_TOL,
                                   rtol=WHOLE_GRAD_TOL, err_msg=name)
    undropped = tfa.FusedRelAttentionFS.apply(
        *(torch.from_numpy(a) for a in arrays[:4]), H, SCALE, 0.0, 0)
    assert not torch.allclose(out, undropped)


def test_fs_dropout_keep_rate_and_unbiased_output():
    """#16's plain version: the kept share of the whole mask within 5σ of
    1 − rate, and E[out] over 64 seeds at rate 0.3 within 6 standard errors
    of the rate-0 output, elementwise (K = 150: three key blocks, the last
    ragged)."""
    rate = 0.3
    q, k, v, eb, _ = (torch.from_numpy(a) for a in _case(12, 150, seed=6))
    eb = eb.clamp(min=-2.0)     # no masked key: every output moves
    keep = tfa.dropout_keep_mask(7, B, H, 12, 150, rate)
    n = keep.numel()
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * (
        rate * (1 - rate) / n) ** 0.5
    kw = dict(n_heads=H, scale=SCALE)
    ref, _ = tfa.attn_fwd_rel_fs_reference(q, k, v, eb, **kw)
    outs = torch.stack([
        tfa.attn_fwd_rel_fs_reference(q, k, v, eb, rate=rate, seed=s,
                                      **kw)[0]
        for s in range(64)]).double()
    stderr = outs.std(dim=0) / 8.0
    assert bool(((outs.mean(dim=0) - ref.double()).abs()
                 <= 6 * stderr + 1e-6).all())
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dh", [40, 64, 128])
def test_fs_forward_bf16_plan_fits(dh):
    """bf16 #16's shared-memory plan (the tensor-core kernel: q, the k and
    v rings, the ebias ring, scores and weights) fits a block at every
    head width; at Dh ≤ 64 two blocks share an SM's 228 KB (1 KB each
    reserved). fp32's fits too."""
    plan = tfa.rel_fs_fwd_smem_bytes(dh)
    assert plan <= tfa.MAX_SMEM_BYTES
    assert tfa.rel_fs_fwd_smem_bytes(dh, 4) <= tfa.MAX_SMEM_BYTES
    if dh <= 64:
        assert 2 * (plan + 1024) <= 228 * 1024
    # q and the k/v rings [5·64][72], the ebias ring [2·64][72] bf16,
    # the fp32 scores and the bf16 weights [64][72], m, l and α
    assert tfa.rel_fs_fwd_smem_bytes(64) == 92928


@pytest.mark.parametrize("dh", [40, 64, 128])
def test_fs_backward_bf16_plan_fits(dh):
    """bf16 #17's plan (the rel tensor-core passes: #7's with the ebias
    ring for the mask bias) fits a block at every head width; at Dh ≤ 64
    two dK/dV blocks share an SM's 228 KB (1 KB each reserved). fp32's
    fits too."""
    plan = tfa.rel_fs_bwd_smem_bytes(dh)
    assert plan <= tfa.MAX_SMEM_BYTES
    assert tfa.rel_fs_bwd_smem_bytes(dh, 4) <= tfa.MAX_SMEM_BYTES
    if dh <= 64:
        assert 2 * (plan + 1024) <= 228 * 1024
    # dK/dV: k, v and the q/g/o rings [8·64][72], pd_c/ds_c and the ebias
    # ring [4·64][72] bf16
    assert tfa.rel_fs_bwd_smem_bytes(64) == 110592


def test_fs_forward_raises_past_its_plan(monkeypatch):
    """The #16 wrapper refuses a plan past 227 KB before it touches the
    card, and names it."""
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    eb = torch.zeros(1, 1, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.attn_fwd_rel_fs_cuda(q, q, q, eb, n_heads=1, scale=0.125)
    monkeypatch.setattr(tfa, "rel_fs_fwd_smem_bytes",
                        lambda dh, itemsize=2: tfa.MAX_SMEM_BYTES + 1)
    with pytest.raises(ValueError, match="shared-memory plan at Dh=64"):
        tfa.attn_fwd_rel_fs_cuda(q, q, q, eb, n_heads=1, scale=0.125)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,q_len,k_len,h,dh", [
    ("float32", 2, 70, 131, 3, 64),     # ragged, K ≠ Q
    ("float32", 2, 200, 136, 2, 128),   # the widest head, K < Q
    ("bfloat16", 2, 512, 1024, 12, 64),
    # bf16 #16's tensor-core edges: K off 8 (the ebias by plain loads),
    # the 50-row memory, K < Q at the widest head, a zero-padded k-depth
    ("bfloat16", 2, 70, 131, 3, 64),
    ("bfloat16", 2, 512, 562, 12, 64),
    ("bfloat16", 2, 200, 136, 2, 128),
    ("bfloat16", 2, 256, 320, 3, 40),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fs_kernels_match_plain_on_card(cuda_device, dtype, b, q_len, k_len,
                                        h, dh, rate):
    """#16 and #17 against their plain versions (bf16 with a query row
    masked whole beside ``_case``'s key block masked whole); the same bits
    twice."""
    td = getattr(torch, dtype)
    q, k, v, eb, g = (torch.from_numpy(a).to(cuda_device, td)
                      for a in _case(q_len, k_len, seed=9, b=b, h=h, dh=dh,
                                     masked_row=dtype == "bfloat16"))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate)
    seed = 2 ** 59 + 1
    out, lse = tfa.attn_fwd_rel_fs_cuda(q, k, v, eb, seed=seed, **kw)
    r_out, r_lse = tfa.attn_fwd_rel_fs_reference(q, k, v, eb, seed=seed,
                                                 **kw)
    err = (out.float() - r_out.float()).abs()
    bound = (2e-5 + 2e-5 * r_out.float().abs() if dtype == "float32"
             else 2.0 ** -6 + 2.0 ** -7 * r_out.float().abs())
    assert bool((err <= bound).all()), float(err.max())
    assert bool(((lse - r_lse).abs() <= 1e-4 + 1e-6 * r_lse.abs()).all())
    grads = tfa.attn_bwd_rel_fs_cuda(q, k, v, eb, seed, out, lse, g, **kw)
    want = tfa.attn_bwd_rel_fs_reference(q, k, v, eb, seed, out, lse, g,
                                         **kw)
    if dtype == "float32":
        bounds = [2e-5 + 2e-5 * w.float().abs() for w in want]
    else:
        bounds = tfa.rel_fs_grads_bf16_bound(want, q, k, v, eb, seed, out,
                                             lse, g, **kw)
    for name, a, w, bd in zip(("dq", "dk", "dv", "debias"), grads, want,
                              bounds):
        assert bool(((a.float() - w.float()).abs() <= bd).all()), name
    again = tfa.attn_bwd_rel_fs_cuda(q, k, v, eb, seed, out, lse, g, **kw)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    out2, lse2 = tfa.attn_fwd_rel_fs_cuda(q, k, v, eb, seed=seed, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_fs_keep_mask_on_card(cuda_device):
    """bf16 #16's keep mask is the plain Philox mask bit for bit: with q =
    0 and a zero ebias every prob is 1/K, and with v_h the identity (K = Dh
    = 128, two key blocks) the output is > 0 exactly where (b, h, q, k) is
    kept; Q = 96 leaves the last q tile ragged."""
    b, q_len, h, dh, rate, seed = 2, 96, 3, 128, 0.1, 2 ** 62 + 17
    q = torch.zeros(b, q_len, h * dh, device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.randn(b, dh, h * dh, device=cuda_device).bfloat16()
    v = torch.eye(dh, device=cuda_device)[None, :, None, :].expand(
        b, dh, h, dh).reshape(b, dh, h * dh).bfloat16()
    eb = torch.zeros(b, h, q_len, dh, device=cuda_device,
                     dtype=torch.bfloat16)
    out, _ = tfa.attn_fwd_rel_fs_cuda(q, k, v, eb, n_heads=h,
                                      scale=dh ** -0.5, rate=rate, seed=seed)
    keep = tfa.dropout_keep_mask(seed, b, h, q_len, dh, rate, cuda_device)
    assert torch.equal(out.view(b, q_len, h, dh).permute(0, 2, 1, 3) > 0,
                       keep)
    assert not bool(keep.all())


@pytest.mark.cuda
def test_fs_backward_keep_mask_on_card(cuda_device):
    """bf16 #17's keep mask (its dK/dV pass's) is the plain Philox mask bit
    for bit: with q = k = 0 and a zero ebias every prob is 1/K, and with
    g_h the identity (Q = Dh = 128) dV[k, h, c] = pd(c, k) is > 0 exactly
    where (b, h, c, k) is kept; K = 200 leaves the last key tile ragged."""
    b, q_len, k_len, h, dh, rate = 2, 128, 200, 3, 128, 0.1
    seed = 2 ** 62 + 19
    q = torch.zeros(b, q_len, h * dh, device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.zeros(b, k_len, h * dh, device=cuda_device,
                    dtype=torch.bfloat16)
    v = torch.randn(b, k_len, h * dh, device=cuda_device).bfloat16()
    eb = torch.zeros(b, h, q_len, k_len, device=cuda_device,
                     dtype=torch.bfloat16)
    g = torch.eye(dh, device=cuda_device)[None, :, None, :].expand(
        b, q_len, h, dh).reshape(b, q_len, h * dh).bfloat16()
    kw = dict(n_heads=h, scale=dh ** -0.5, rate=rate)
    out, lse = tfa.attn_fwd_rel_fs_cuda(q, k, v, eb, seed=seed, **kw)
    dv = tfa.attn_bwd_rel_fs_cuda(q, k, v, eb, seed, out, lse, g, **kw)[2]
    keep = tfa.dropout_keep_mask(seed, b, h, q_len, k_len, rate, cuda_device)
    assert torch.equal(dv.view(b, k_len, h, dh).permute(0, 2, 3, 1) > 0,
                       keep)


@pytest.mark.cuda
def test_fs_tier_launches_its_kernels(cuda_device):
    """``fused_rel_attention`` at Q = 512, K = 1024 with a gradient
    launches #16 once and #17's two passes, and no other rel kernel."""
    rng = np.random.RandomState(4)
    q, g = (torch.from_numpy(rng.randn(2, 512, 768).astype(np.float32)).to(
        cuda_device, torch.bfloat16) for _ in "qg")
    k, v = (torch.from_numpy(rng.randn(2, 1024, 768).astype(np.float32)).to(
        cuda_device, torch.bfloat16).requires_grad_() for _ in "kv")
    eb = torch.zeros(2, 12, 512, 1024, device=cuda_device,
                     dtype=torch.bfloat16, requires_grad=True)
    names = ("attn_fwd_rel_fs_cuda", "attn_bwd_rel_fs_cuda",
             "attn_fwd_rel_hb_cuda", "attn_fwd_rel_cuda")
    before = [getattr(tfa, n).launches for n in names]
    q.requires_grad_()
    tfa.fused_rel_attention(q, k, v, eb, n_heads=12, scale=0.125,
                            dropout_rate=0.1,
                            dropout_rng=torch.Generator().manual_seed(1),
                            deterministic=False).backward(g)
    assert [getattr(tfa, n).launches - c
            for n, c in zip(names, before)] == [1, 2, 0, 0]
    assert all(bool(torch.isfinite(x.grad.float()).all())
               for x in (q, k, v, eb))


@pytest.mark.cuda
@pytest.mark.parametrize("impl,s,mlen,launched", [
    ("stream", 256, 512, ("attn_fwd_rel_fs_cuda", "attn_bwd_rel_fs_cuda")),
    ("auto", 256, 512, ("attn_fwd_relik_fs_cuda", "attn_bwd_relik_fs_cuda")),
    ("auto", 50, 50, ("attn_fwd_rel_cuda", "attn_bwd_rel_saved_cuda")),
])
def test_memory_steps_launch_their_kernels_on_card(cuda_device, impl, s,
                                                   mlen, launched):
    """Two memory train steps of a 2-layer MAG-XLNet at xlnet-base widths
    (H = 12, Dh = 64), bf16, on the card: the tier's kernels launch in
    every layer, the losses are finite and the memory is carried."""
    from bert_multimodal_transformer_tpu_torch.config import (
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.training import optim
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )

    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(), n_layer=2,
                              vocab_size=128, attention_impl="fused",
                              rel_bias_impl=impl, mem_len=mlen)
    model = MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(injection_index=1), DV, DA, torch.bfloat16,
        device=cuda_device, generator=torch.Generator(
            device=cuda_device).manual_seed(0))
    tr = Trainer(model=model, tx=optim.make_optimizer(1e-5, 4), mem_len=mlen)
    st = tr.create_state_from_params(None, 0)

    def batch(seed):
        ids, vis, ac, mask, segs = _xlnet_inputs(4, s, seed)
        labels = np.random.RandomState(seed).randn(4).astype(np.float32)
        return ids, vis, ac, mask, segs, labels

    mems = tr._init_mems(batch(0))
    before = [getattr(tfa, n).launches for n in launched]
    for i in range(2):
        loss, mems = tr._train_step_mems(st, tr._put_batch(batch(i)), mems)
        assert np.isfinite(float(loss))
    assert all(getattr(tfa, n).launches > c for n, c in zip(launched, before))
    assert float(mems[0].float().abs().max()) > 0


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
