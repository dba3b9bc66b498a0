"""The port's long-sequence rel attention: the flash-streamed ingredients
kernels #23/#24 and the head-blocked rel kernels #14/#15, through their
plain versions on the CPU, against the JAX package's
``fused_rel_attention_ingredients`` on its fs tier and
``_fused_rel_attention_hb`` (Pallas, interpret mode); the tier rule
``rel_tier`` and the model's ingredients eligibility; the dropout stream;
and the tiny MAG-XLNet at S = 256 and 768 against the JAX einsum model
(at 768 under ``rel_bias_impl="stream"`` through the rel flash-streamed
tier, #16/#17; ``tests/test_torch_rel_fs_attention.py`` holds that tier's
kernels to JAX).

Tolerances: the ingredients fs tier against JAX 5e-5 (values and grads,
atol and rtol), the band of the JAX package's own test of that tier
(``tests/test_fused_attention.py``: the online softmax rescales once per
key block, the port's blocks are 64 keys, JAX's 128; and the einsum
reference there sums the bias in another order). The head-blocked tier
is the full-H math in another summation order: 1e-5. The tiny model as
``tests/test_torch_long_attention.py``: logits 1e-4; gradients 1e-4
relative to each leaf's largest entry. The tests marked ``cuda`` hold the
CUDA kernels against these plain versions and skip without a card
(``python -m pytest --noconftest -m cuda
tests/test_torch_long_rel_attention.py`` on a GPU machine).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa

B, H, DH = 2, 4, 32
D = H * DH
SCALE = 1.0 / DH ** 0.5
IK_TOL, HB_TOL = 5e-5, 1e-5
PLAIN = ("attn_fwd_rel_reference", "attn_bwd_rel_reference",
         "attn_bwd_rel_saved_reference", "attn_fwd_rel_hb_reference",
         "attn_bwd_rel_hb_reference", "attn_fwd_rel_fs_reference",
         "attn_bwd_rel_fs_reference", "attn_fwd_relik_fs_reference",
         "attn_bwd_relik_fs_reference")


def _calls():
    return {name: getattr(tfa, name).calls for name in PLAIN}


def _ran(before):
    """The plain versions called since ``before``, with their counts."""
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


def _ingredients(s, k_len, p_len, seed=17, b=B, h=H, dh=DH):
    """Seeded ingredients as the JAX package's fs test builds them: rw,
    rr (scaled), r, k, v, ed (scaled), a 0/1 segd and a −1e9 maskb on a
    tenth of the keys, and a context gradient."""
    rng = np.random.RandomState(seed)
    d, sc = h * dh, 1.0 / dh ** 0.5
    arrays = dict(
        rw=rng.randn(b, s, d), rr=rng.randn(b, s, d) * sc,
        r=rng.randn(p_len, d), k=rng.randn(b, k_len, d),
        v=rng.randn(b, k_len, d), ed=rng.randn(b, h, s) * sc,
        segd=rng.randint(0, 2, (b, s, k_len)),
        maskb=-1e9 * (rng.rand(b, s, k_len) < 0.1),
        g=rng.randn(b, s, d))
    return {n: a.astype(np.float32) for n, a in arrays.items()}


DIFF = ("rw", "rr", "r", "k", "v", "ed")


def _port_grads(x, **kw):
    """Value and grads of Σ tanh(out) through the port's entry (its plain
    versions on the CPU)."""
    xs = {n: torch.from_numpy(x[n]).requires_grad_() for n in DIFF}
    out = tfa.fused_rel_attention_ingredients(
        *(xs[n] for n in DIFF), torch.from_numpy(x["segd"]),
        torch.from_numpy(x["maskb"]), n_heads=H, scale=SCALE, **kw)
    val = torch.tanh(out).sum()
    val.backward()
    return float(val.detach()), [xs[n].grad.numpy() for n in DIFF]


@pytest.mark.parametrize("s,k_len,p_len", [(256, 256, 512), (128, 384, 512)])
def test_ingredients_fs_matches_jax(s, k_len, p_len):
    """#23's and #24's plain versions through ``FusedRelAttentionIKFS``
    against JAX ``fused_rel_attention_ingredients(tier="fs")`` (qb = kb =
    128, several blocks each way): the loss and the grads of rw, rr, r, k,
    v and ed, d_r accumulated over rows and query blocks."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.fused_attention import (
        fused_rel_attention_ingredients,
    )

    x = _ingredients(s, k_len, p_len)
    segd, maskb = jnp.asarray(x["segd"]), jnp.asarray(x["maskb"])

    def loss(*a):
        return jnp.sum(jnp.tanh(fused_rel_attention_ingredients(
            *a, segd, maskb, n_heads=H, scale=SCALE, tier="fs",
            fs_plan=(H, 128, 128))))

    want_val, want = jax.value_and_grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x[n]) for n in DIFF))
    before = _calls()
    val, got = _port_grads(x, tier="fs")
    assert _ran(before) == {"attn_fwd_relik_fs_reference": 1,
                            "attn_bwd_relik_fs_reference": 1}
    np.testing.assert_allclose(val, float(want_val), rtol=1e-5)
    for name, a, w in zip(DIFF, got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=IK_TOL,
                                   rtol=IK_TOL, err_msg=name)


def test_ingredients_fs_takes_a_ragged_length():
    """At Q = K = 200, P = 400 (a ragged last key block; the JAX fs tier
    needs multiples of 128) against the JAX einsum assembly: rel_shift of
    rr·rᵀ plus ed·segd plus maskb, softmax, PV, and its grads."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.models.xlnet import rel_shift

    s, p_len = 200, 400
    x = _ingredients(s, s, p_len, seed=3)
    segd, maskb = jnp.asarray(x["segd"]), jnp.asarray(x["maskb"])

    def loss(rw, rr, r, k, v, ed):
        bd = jnp.einsum("bqhf,phf->bhqp", rr.reshape(B, s, H, DH),
                        r.reshape(p_len, H, DH))
        ebias = (rel_shift(bd, s) + ed[:, :, :, None] * segd[:, None]
                 + maskb[:, None])
        score = jnp.einsum("bqhf,bkhf->bhqk", rw.reshape(B, s, H, DH),
                           k.reshape(B, s, H, DH)) * SCALE + ebias
        ctx = jnp.einsum("bhqk,bkhf->bqhf", jax.nn.softmax(score, axis=-1),
                         v.reshape(B, s, H, DH))
        return jnp.sum(jnp.tanh(ctx.reshape(B, s, D)))

    want_val, want = jax.value_and_grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x[n]) for n in DIFF))
    val, got = _port_grads(x, tier="fs")
    np.testing.assert_allclose(val, float(want_val), rtol=1e-5)
    for name, a, w in zip(DIFF, got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=IK_TOL,
                                   rtol=IK_TOL, err_msg=name)


def test_head_blocked_rel_tier_matches_jax():
    """#14's and #15's plain versions through ``FusedRelAttentionHB``
    against JAX ``_fused_rel_attention_hb`` (hb = 2: two head blocks) at
    rate 0, fp32, Q = 48 ≠ K = 80: out, dq, dk, dv and debias."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.fused_attention import (
        _fused_rel_attention_hb,
    )

    rng = np.random.RandomState(5)
    q_len, k_len = 48, 80
    arrays = [rng.randn(B, q_len, D), rng.randn(B, k_len, D),
              rng.randn(B, k_len, D), rng.randn(B, H, q_len, k_len) * 0.5]
    arrays = [a.astype(np.float32) for a in arrays]
    arrays[3][0, :, :, :3] -= 1e30
    g = rng.randn(B, q_len, D).astype(np.float32)
    seed = jnp.zeros((1, 1), jnp.int32)
    want, vjp = jax.vjp(
        lambda *a: _fused_rel_attention_hb(*a, seed, SCALE, 0.0, H, 2, True,
                                           (None, None)),
        *(jnp.asarray(a) for a in arrays))
    want_g = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = _calls()
    out = tfa.FusedRelAttentionHB.apply(*xs, H, SCALE, 0.0, 0)
    out.backward(torch.from_numpy(g))
    assert _ran(before) == {"attn_fwd_rel_hb_reference": 1,
                            "attn_bwd_rel_hb_reference": 1}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=HB_TOL, rtol=HB_TOL)
    for name, x, w in zip(("dq", "dk", "dv", "debias"), xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=HB_TOL, rtol=HB_TOL, err_msg=name)


# --- the tier rule ---------------------------------------------------------


def _rel_entry_calls(q_len, k_len, grad):
    """The plain versions ``fused_rel_attention`` runs at (Q, K), Dh = 64,
    with a backward when ``grad``."""
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
    return _ran(before)


FULL = {"attn_fwd_rel_reference": 1}
HB = {"attn_fwd_rel_hb_reference": 1}


@pytest.mark.parametrize("q_len,k_len,grad,ik,tier,ran", [
    (512, 512, False, True, "full", FULL),
    (513, 513, False, False, "hb", HB),
    (513, 513, False, True, "ik_fs", None),
    (141, 141, True, True, "full", {**FULL, "attn_bwd_rel_saved_reference": 1}),
    (142, 142, True, False, "hb", {**HB, "attn_bwd_rel_hb_reference": 1}),
    (142, 142, True, True, "ik_fs", None),
    (640, 640, True, False, "hb", {**HB, "attn_bwd_rel_hb_reference": 1}),
    (641, 641, True, True, "ik_fs", None),
    (8, 600, True, False, "hb", {**HB, "attn_bwd_rel_hb_reference": 1}),
])
def test_rel_tier_at_its_edges(q_len, k_len, grad, ik, tier, ran,
                               monkeypatch):
    """At Dh = 64: the full-H tier to K = 512 without a gradient and to
    Q = K = 141 with one (``rel_bwd_fits``; a K past 512 never, whatever
    the backward's plan); past it the ingredients tier where eligible,
    else the head-blocked one to 640. ``fused_rel_attention`` (no
    ingredients) takes ``rel_tier``'s tier, as its plain versions' call
    counts show."""
    monkeypatch.delenv("FUSED_ATTN_SAVE", raising=False)
    assert tfa.rel_tier(q_len, k_len, 64, grad, ik) == tier
    if ran is not None:
        assert _rel_entry_calls(q_len, k_len, grad) == ran


def test_rel_tier_raises_past_the_head_blocked_reach():
    """Without the ingredients, past 640 the rule no longer raises: it
    takes the rel flash-streamed tier (#16/#17), with a gradient and
    without; the entry runs its plain forward there."""
    for q_len, k_len in ((641, 641), (8, 641)):
        for grad in (True, False):
            assert tfa.rel_tier(q_len, k_len, 64, grad, False) == "fs"
    before = _calls()
    with torch.no_grad():
        out = tfa.fused_rel_attention(
            torch.zeros(1, 4, 64), torch.zeros(1, 641, 64),
            torch.zeros(1, 641, 64), torch.zeros(1, 1, 4, 641), n_heads=1,
            scale=1.0)
    assert _ran(before) == {"attn_fwd_rel_fs_reference": 1}
    assert tuple(out.shape) == (1, 4, 64) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kw,err,match", [
    ({"interpret": True}, ValueError, "TPU"),
    ({"fs_plan": (4, 128, 128)}, ValueError, "TPU"),
    ({"tier": "full", "k_len": 513}, ValueError, "past the full-H"),
    ({"tier": "hb"}, ValueError, "unknown tier"),
    ({"dropout_rate": 0.1, "deterministic": False}, ValueError,
     "requires dropout_rng"),
    ({"p_len": 23}, ValueError, "P ≥ Q"),
])
def test_ingredients_entry_refuses_bad_arguments(kw, err, match):
    k_len = kw.pop("k_len", 16)
    x = _ingredients(8, k_len, kw.pop("p_len", k_len + 8), b=1, h=2, dh=8)
    ts = [torch.from_numpy(x[n]) for n in (*DIFF, "segd", "maskb")]
    with pytest.raises(err, match=match):
        tfa.fused_rel_attention_ingredients(*ts, n_heads=2, scale=1.0, **kw)


# --- the dropout stream ----------------------------------------------------


def test_ingredients_keep_mask_is_the_philox_mask(monkeypatch):
    """With rw = rr = ed = 0 every score is 0 and p = 1/K; with v_h the
    identity (K = Dh) out[q, h, c] = keep(q, c)/(K·(1 − rate)), > 0 exactly
    where (b, h, q, c) is kept. #23's plain version draws its mask a key
    block at a time; at two block widths the mask is ``dropout_keep_mask``."""
    b, q_len, h, dh, rate, seed = 2, 8, 2, 32, 0.2, 2 ** 40 + 3
    x = _ingredients(q_len, dh, q_len + dh, b=b, h=h, dh=dh)
    for n in ("rw", "rr", "ed", "maskb"):
        x[n][...] = 0.0
    x["v"] = np.tile(np.eye(dh, dtype=np.float32)[None, :, None, :],
                     (b, 1, h, 1)).reshape(b, dh, h * dh)
    ts = [torch.from_numpy(x[n]) for n in (*DIFF, "segd", "maskb")]
    keep = tfa.dropout_keep_mask(seed, b, h, q_len, dh, rate)
    for width in (tfa.FS_KEY_BLOCK, 8):
        monkeypatch.setattr(tfa, "FS_KEY_BLOCK", width)
        out, _ = tfa.attn_fwd_relik_fs_reference(
            *ts, n_heads=h, scale=1.0, rate=rate, seed=seed)
        kept = out.view(b, q_len, h, dh).permute(0, 2, 1, 3) > 0
        assert torch.equal(kept, keep), width
    assert not bool(keep.all())


def test_ingredients_dropout_replays_the_mask():
    """At rate 0.1 the forward and the backward use one mask: the autograd
    gradients of ``FusedRelAttentionIKFS`` equal those of the whole-row
    plain math (``_relik_scores``, softmax, the mask, PV) fed
    ``dropout_keep_mask`` for the same seed, fp32, ragged Q = 70, K = 90,
    P > Q + K."""
    rate, seed = 0.1, 2 ** 33 + 9
    q_len, k_len = 70, 90
    x = _ingredients(q_len, k_len, q_len + k_len + 3, seed=8)
    segd, maskb = torch.from_numpy(x["segd"]), torch.from_numpy(x["maskb"])
    g = torch.from_numpy(x["g"])
    xs = [torch.from_numpy(x[n]).requires_grad_() for n in DIFF]
    out = tfa.FusedRelAttentionIKFS.apply(*xs, segd, maskb, H, SCALE, rate,
                                          seed)
    out.backward(g)
    ys = [torch.from_numpy(x[n]).requires_grad_() for n in DIFF]
    s = tfa._relik_scores(*ys[:4], ys[5], segd, maskb, H, SCALE)
    keep = tfa.dropout_keep_mask(seed, B, H, q_len, k_len, rate)
    p = torch.where(keep, torch.softmax(s, dim=-1) * tfa.inv_keep(rate), 0.0)
    want = tfa._merge_heads(torch.matmul(p, tfa._ctx_heads(ys[4], H)))
    want.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    for name, a, w in zip(DIFF, xs, ys):
        np.testing.assert_allclose(a.grad.numpy(), w.grad.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # the dropout really dropped: rate 0 gives another output
    assert not torch.allclose(out, tfa.FusedRelAttentionIKFS.apply(
        *xs, segd, maskb, H, SCALE, 0.0, 0))


def test_ingredients_forward_plan_fits_every_head_width():
    """#23's shared-memory plan, bf16 (the tensor-core kernel) and fp32,
    lies inside a block's 227 KB at every head width the kernel takes."""
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for itemsize in (2, 4):
            assert tfa.relik_fs_fwd_smem_bytes(dh, itemsize) <= (
                tfa.MAX_SMEM_BYTES)
    # at Dh = 64 two bf16 blocks share an SM's 228 KB (1 KB each reserved)
    assert 2 * (tfa.relik_fs_fwd_smem_bytes(64) + 1024) <= 228 * 1024


def test_ingredients_forward_raises_past_its_plan(monkeypatch):
    """The #23 wrapper refuses a plan past 227 KB before it touches the
    card, and names it."""
    x = {n: torch.from_numpy(a).to(torch.bfloat16)
         for n, a in _ingredients(8, 8, 16).items()}
    ins = [x[n] for n in (*DIFF, "segd", "maskb")]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.attn_fwd_relik_fs_cuda(*ins, n_heads=H, scale=SCALE)
    monkeypatch.setattr(tfa, "relik_fs_fwd_smem_bytes",
                        lambda dh, itemsize=2: tfa.MAX_SMEM_BYTES + 1)
    with pytest.raises(ValueError, match=f"shared-memory plan at Dh={DH}"):
        tfa.attn_fwd_relik_fs_cuda(*ins, n_heads=H, scale=SCALE)


@pytest.mark.parametrize("q_len,k_len,p_extra", [(70, 131, 0), (130, 70, 3)])
def test_wide_bd_product_read_on_its_diagonal_is_the_shift(q_len, k_len,
                                                           p_extra):
    """#23's bf16 kernel computes bd as BDʷ = rr_tile · r_windowᵀ per (64-row
    q tile, 64-key block), the window rows Q − q0 − 63 + k0 + w (w < 128,
    zero outside [0, P)) taken as two 64-row chunks, chunk c at Q − q0 − 63
    + 64c; score (qi, j) reads BDʷ[qi][63 − qi + j]. That tiling, in plain
    torch at a ragged Q and K, gives the bd term of
    ``attn_fwd_relik_fs_reference``'s scores (``_relik_scores`` with rw,
    ed and maskb zero)."""
    x = {n: torch.from_numpy(a) for n, a in
         _ingredients(q_len, k_len, q_len + k_len + p_extra, seed=5).items()}
    zero = torch.zeros_like
    want = tfa._relik_scores(zero(x["rw"]), x["rr"], x["r"], x["k"],
                             zero(x["ed"]), x["segd"], zero(x["maskb"]), H,
                             SCALE)
    p_len = x["r"].shape[0]
    rr = tfa._ctx_heads(x["rr"], H)                       # [B, H, Q, Dh]
    r = x["r"].reshape(p_len, H, DH).permute(1, 0, 2)     # [H, P, Dh]
    got = torch.full_like(want, float("nan"))
    for q0 in range(0, q_len, 64):
        q_rows = min(64, q_len - q0)
        p_base = q_len - q0 - 63

        def chunk(c):
            rows = p_base + 64 * c + torch.arange(64)
            ok = (rows >= 0) & (rows < p_len)
            return torch.where(ok[None, :, None],
                               r[:, rows.clamp(0, p_len - 1)], 0.0)

        for i, k0 in enumerate(range(0, k_len, 64)):
            k_rows = min(64, k_len - k0)
            window = torch.cat([chunk(i), chunk(i + 1)], dim=1)
            tile = torch.zeros(B, H, 64, DH)
            tile[:, :, :q_rows] = rr[:, :, q0:q0 + q_rows]
            bdw = torch.matmul(tile, window.transpose(-1, -2))  # [B,H,64,128]
            qi = torch.arange(q_rows)[:, None]
            j = torch.arange(k_rows)[None, :]
            got[:, :, q0:q0 + q_rows, k0:k0 + k_rows] = bdw[
                :, :, qi, 63 - qi + j]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


# --- the model ---------------------------------------------------------------

DV, DA = 5, 7


def _xlnet_inputs(b, s, seed):
    """Left-padded XLNet rows (row 0 full) with segments 0 / 2 (<cls>) / 3
    (pads), modality rows zero on pads."""
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


def _xlnet_model(attention_impl, device="cpu", **kw):
    from bert_multimodal_transformer_tpu_torch.config import (
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    cfg = dataclasses.replace(XLNetConfig.tiny(), attention_impl=attention_impl,
                              **kw)
    return MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(beta_shift=1.0, injection_index=1), DV, DA,
        torch.float32, device=device,
        generator=torch.Generator(device=device).manual_seed(0))


@pytest.mark.parametrize("s,impl,tier", [
    (256, "auto", "relik_fs"), (256, "stream", "rel_hb"),
    (768, "auto", "relik_fs")])
def test_tiny_xlnet_long_sequence_matches_jax(s, impl, tier):
    """``XLNetConfig.tiny()`` (Dh = 16: the full-H backward reaches Q = K =
    162), fused, fp32, dropout off, with segments and left padding: the
    logits and one step's gradients against the JAX einsum model on the
    same params. With a gradient the fused branch takes the ingredients
    tier under ``rel_bias_impl="auto"`` and the head-blocked tier under
    ``"stream"``."""
    _tiny_xlnet_matches_jax(s, impl, tier)


def _tiny_xlnet_matches_jax(s, impl, tier):
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.config import (
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import xlnet as jxl
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    b = 2
    ids, vis, ac, mask, segs = _xlnet_inputs(b, s, seed=s)
    c = np.random.RandomState(1).randn(b, 1).astype(np.float32)
    jmodel = jxl.MagXLNetForSequenceClassification(
        JXLNetConfig.tiny(), JMultimodalConfig(beta_shift=1.0,
                                               injection_index=1),
        visual_dim=DV, acoustic_dim=DA, dtype=jnp.float32)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), ids[:, :8], vis[:, :8], ac[:, :8],
        attention_mask=mask[:, :8], token_type_ids=segs[:, :8])["params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, vis, ac,
                              attention_mask=mask, token_type_ids=segs)
        return jnp.sum(logits * c), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    tmodel = _xlnet_model("fused", rel_bias_impl=impl)
    # the JAX init ran without target_mapping, so it made no mask_emb
    missing, unexpected = tmodel.load_state_dict(
        xlnet_params_from_flax(jax.device_get(params)), strict=False)
    assert missing == ["transformer.mask_emb"] and not unexpected
    before = _calls()
    got = tmodel(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                 attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    (got * torch.from_numpy(c)).sum().backward()
    layers = tmodel.config.n_layer
    assert _ran(before) == {f"attn_fwd_{tier}_reference": layers,
                            f"attn_bwd_{tier}_reference": layers}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    grads = xlnet_params_from_flax(jax.device_get(want_g))
    for name, p in tmodel.named_parameters():
        if name.endswith("mask_emb"):
            continue   # the query stream's input: no two-stream here
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   rtol=0, err_msg=name)


def test_tiny_xlnet_stream_raises_past_the_head_blocked_reach():
    """``rel_bias_impl="stream"`` at S = 768, past the head-blocked reach,
    no longer raises: every layer takes the rel flash-streamed tier
    (#16/#17's plain versions), and the logits and one step's gradients
    match the JAX einsum model as on the other tiers."""
    _tiny_xlnet_matches_jax(768, "stream", "rel_fs")


@pytest.mark.parametrize("kw,call_kw,tier", [
    ({}, {}, "relik_fs"),
    ({"rel_bias_impl": "stream"}, {}, "rel_hb"),
    ({"bi_data": True}, {}, "rel_hb"),       # a [B, P, D] position stream
    ({"attn_type": "uni"}, {}, "rel_hb"),    # P = K + 1 < Q + K
    ({}, {"head_mask": True}, None),          # the einsum branch
    ({}, {"output_attentions": True}, None),
])
def test_ingredients_eligibility(kw, call_kw, tier):
    """Each condition of the ingredients tier (JAX ``models/xlnet.py``
    :216-229), one training forward of the tiny model at S = 170, past the
    full-H backward's reach: eligible, it takes #23/#24's plain versions;
    else the head-blocked tier, or the einsum branch under ``head_mask`` or
    ``output_attentions``, as the JAX model."""
    ids, vis, ac, mask, segs = _xlnet_inputs(2, 170, seed=4)
    model = _xlnet_model("fused", **kw)
    if call_kw.pop("head_mask", False):
        call_kw["head_mask"] = torch.ones(model.config.n_head)
    before = _calls()
    out = model(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                attention_mask=torch.from_numpy(mask),
                token_type_ids=torch.from_numpy(segs), **call_kw)
    logits = out[0] if isinstance(out, tuple) else out
    logits.sum().backward()
    layers = model.config.n_layer
    want = {} if tier is None else {f"attn_fwd_{tier}_reference": layers,
                                    f"attn_bwd_{tier}_reference": layers}
    assert _ran(before) == want


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(x, device, dtype):
    return {n: torch.from_numpy(a).to(device, getattr(torch, dtype))
            for n, a in x.items()}


def _card_close(got, want, dtype):
    """fp32: 2e-5 (atol and rtol). bf16: one rounding of each side's
    output, 2^-7 relative plus 2^-6 absolute, for a forward."""
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        bound = 2e-5 + 2e-5 * want.float().abs()
    else:
        bound = 2.0 ** -6 + 2.0 ** -7 * want.float().abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,k_len,h,dh", [
    ("float32", 2, 70, 131, 3, 64),     # ragged, P > Q + K
    ("float32", 2, 200, 200, 2, 128),   # the widest head
    ("bfloat16", 2, 512, 512, 12, 64),
    # the tensor-core plan's edges: a zero-padded k-depth, tiles ragged
    # off 16, the widest head, Q ≠ K as under the memory
    ("bfloat16", 2, 128, 128, 3, 40),
    ("bfloat16", 2, 200, 200, 4, 64),
    ("bfloat16", 2, 130, 130, 2, 128),
    ("bfloat16", 2, 96, 200, 4, 64),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ingredients_kernels_match_plain_on_card(cuda_device, dtype, b, s,
                                                 k_len, h, dh, rate):
    x = _card(_ingredients(s, k_len, s + k_len + 5, b=b, h=h, dh=dh),
              cuda_device, dtype)
    ins = [x[n] for n in (*DIFF, "segd", "maskb")]
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate)
    seed = 2 ** 59 + 1
    out, lse = tfa.attn_fwd_relik_fs_cuda(*ins, seed=seed, **kw)
    r_out, r_lse = tfa.attn_fwd_relik_fs_reference(*ins, seed=seed, **kw)
    _card_close(out, r_out, dtype)
    assert bool(((lse - r_lse).abs() <= 1e-4 + 1e-6 * r_lse.abs()).all())
    grads = tfa.attn_bwd_relik_fs_cuda(*ins, seed, out, lse, x["g"], **kw)
    want = tfa.attn_bwd_relik_fs_reference(*ins, seed, out, lse, x["g"],
                                           **kw)
    if dtype == "float32":
        for a, w in zip(grads, want):
            _card_close(a, w, dtype)
    else:
        bounds = tfa.relik_grads_bf16_bound(want, *ins, seed, lse, x["g"],
                                            out, **kw)
        for a, w, bd in zip(grads, want, bounds):
            assert bool(((a.float() - w.float()).abs() <= bd).all())
    again = tfa.attn_bwd_relik_fs_cuda(*ins, seed, out, lse, x["g"], **kw)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.cuda
def test_head_blocked_rel_kernels_equal_full_h_on_card(cuda_device):
    """Where both reach, #14 gives #11's bits and #15 gives #12's."""
    rng = np.random.RandomState(23)
    q, k, v, g = (torch.from_numpy(rng.randn(4, 128, 768).astype(np.float32))
                  .to(cuda_device, torch.bfloat16) for _ in range(4))
    eb = torch.from_numpy(rng.randn(4, 12, 128, 128).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    kw = dict(n_heads=12, scale=0.125, rate=0.1)
    assert torch.equal(tfa.attn_fwd_rel_hb_cuda(q, k, v, eb, seed=9, **kw),
                       tfa.attn_fwd_rel_cuda(q, k, v, eb, seed=9, **kw))
    assert all(torch.equal(a, c) for a, c in zip(
        tfa.attn_bwd_rel_hb_cuda(q, k, v, eb, 9, g, **kw),
        tfa.attn_bwd_rel_cuda(q, k, v, eb, 9, g, **kw)))


@pytest.mark.cuda
def test_long_rel_tiers_launch_their_kernels(cuda_device):
    """The entries launch the tier's kernels on CUDA tensors: #14 + #15
    through ``fused_rel_attention`` at Q = K = 512 with a gradient, #23 +
    #24 (three launches) through ``fused_rel_attention_ingredients``."""
    x = _card(_ingredients(512, 512, 1024, b=2, h=12, dh=64), cuda_device,
              "bfloat16")
    rng = torch.Generator().manual_seed(1)
    f0, b0 = tfa.attn_fwd_rel_hb_cuda.launches, tfa.attn_bwd_rel_hb_cuda.launches
    q, k, v = (x[n].clone().requires_grad_() for n in ("rw", "k", "v"))
    eb = torch.zeros(2, 12, 512, 512, device=cuda_device,
                     dtype=torch.bfloat16, requires_grad=True)
    tfa.fused_rel_attention(q, k, v, eb, n_heads=12, scale=0.125,
                            dropout_rate=0.1, dropout_rng=rng,
                            deterministic=False).backward(x["g"])
    assert (tfa.attn_fwd_rel_hb_cuda.launches - f0,
            tfa.attn_bwd_rel_hb_cuda.launches - b0) == (1, 1)
    f0 = tfa.attn_fwd_relik_fs_cuda.launches
    b0 = tfa.attn_bwd_relik_fs_cuda.launches
    xs = [x[n].clone().requires_grad_() for n in DIFF]
    tfa.fused_rel_attention_ingredients(
        *xs, x["segd"], x["maskb"], n_heads=12, scale=0.125,
        dropout_rate=0.1, dropout_rng=rng, deterministic=False).backward(
            x["g"])
    assert (tfa.attn_fwd_relik_fs_cuda.launches - f0,
            tfa.attn_bwd_relik_fs_cuda.launches - b0) == (1, 3)
