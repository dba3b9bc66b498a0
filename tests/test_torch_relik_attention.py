"""The port's full-H ingredients rel attention, the MAG-XLNet path under
``rel_bias_impl="inkernel"``: kernels #20-#22 through their plain versions
on the CPU against the JAX package's ``fused_rel_attention_ingredients``
on its full tier (Pallas, interpret mode); the dropout contract; the tier
rule ``rel_tier`` and the entry's tier choice; and the tiny MAG-XLNet under
"inkernel" against the JAX model with the same config and weights.

Tolerances: the entry against JAX, fp32 at rate 0, the output 1e-5 and
the grads 5e-5 (atol and rtol): the same math summed in another order, d_r a sum over every (row, query) of a diagonal (the band of
the JAX package's own test, ``tests/test_fused_attention.py``: 3e-5 against
the einsum assembly). The tiny model as ``tests/test_torch_xlnet.py``:
logits 1e-4; gradients 1e-4 relative to each leaf's largest entry. The
tests marked ``cuda`` hold the CUDA kernels against these plain versions
and skip without a card (``python -m pytest --noconftest -m cuda
tests/test_torch_relik_attention.py`` on a GPU machine).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa

B, H, DH = 2, 2, 32
D = H * DH
SCALE = 1.0 / DH ** 0.5
TOL = 5e-5
DIFF = ("rw", "rr", "r", "k", "v", "ed")
INGREDIENTS = (*DIFF, "segd", "maskb")
PLAIN = ("attn_fwd_rel_reference", "attn_bwd_rel_reference",
         "attn_bwd_rel_saved_reference", "attn_fwd_rel_hb_reference",
         "attn_bwd_rel_hb_reference", "attn_fwd_relik_reference",
         "attn_bwd_relik_reference", "attn_bwd_relik_saved_reference",
         "attn_fwd_relik_fs_reference", "attn_bwd_relik_fs_reference")


def _calls():
    return {name: getattr(tfa, name).calls for name in PLAIN}


def _ran(before):
    """The plain versions called since ``before``, with their counts."""
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


def _ingredients(q_len, k_len, p_len, seed=5, b=B, h=H, dh=DH):
    """Seeded ingredients as the JAX package's full-tier test builds them:
    rw, rr (scaled), r, k, v, ed (scaled), a 0/1 segd, a −1e9 maskb on a
    tenth of the keys, and a context gradient."""
    rng = np.random.RandomState(seed)
    d, sc = h * dh, 1.0 / dh ** 0.5
    arrays = dict(
        rw=rng.randn(b, q_len, d), rr=rng.randn(b, q_len, d) * sc,
        r=rng.randn(p_len, d), k=rng.randn(b, k_len, d),
        v=rng.randn(b, k_len, d), ed=rng.randn(b, h, q_len) * sc,
        segd=rng.randint(0, 2, (b, q_len, k_len)),
        maskb=-1e9 * (rng.rand(b, q_len, k_len) < 0.1),
        g=rng.randn(b, q_len, d))
    return {n: a.astype(np.float32) for n, a in arrays.items()}


def _port_grads(x, **kw):
    """The output and the grads of Σ tanh(out) through the port's entry
    (its plain versions on the CPU)."""
    xs = {n: torch.from_numpy(x[n]).requires_grad_() for n in DIFF}
    out = tfa.fused_rel_attention_ingredients(
        *(xs[n] for n in DIFF), torch.from_numpy(x["segd"]),
        torch.from_numpy(x["maskb"]), n_heads=H, scale=SCALE, **kw)
    torch.tanh(out).sum().backward()
    return out.detach().numpy(), [xs[n].grad.numpy() for n in DIFF]


@pytest.mark.parametrize("q_len,k_len,save", [
    (24, 24, True), (24, 24, False), (16, 30, True)])
def test_full_tier_matches_jax(q_len, k_len, save):
    """#20's plain version with #22's (saved probs) or #21's (recompute)
    through ``FusedRelAttentionIK`` against JAX
    ``fused_rel_attention_ingredients(tier="full")``, fp32 at rate 0: the
    output, and the grads of Σ tanh(out) to rw, rr, r, k, v and ed, d_r
    summed over both rows. K = Q + 14 is the memory's K ≠ Q, with P =
    Q + K."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.fused_attention import (
        fused_rel_attention_ingredients,
    )

    x = _ingredients(q_len, k_len, q_len + k_len)
    segd, maskb = jnp.asarray(x["segd"]), jnp.asarray(x["maskb"])

    def forward(*a):
        return fused_rel_attention_ingredients(
            *a, segd, maskb, n_heads=H, scale=SCALE, tier="full",
            save_probs=save)

    def loss(*a):
        return jnp.sum(jnp.tanh(forward(*a)))

    args = [jnp.asarray(x[n]) for n in DIFF]
    want_out = forward(*args)
    want = jax.grad(loss, argnums=tuple(range(6)))(*args)
    before = _calls()
    out, got = _port_grads(x, save_probs=save)
    bwd = ("attn_bwd_relik_saved_reference" if save
           else "attn_bwd_relik_reference")
    assert _ran(before) == {"attn_fwd_relik_reference": 1, bwd: 1}
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5,
                               rtol=1e-5)
    for name, a, w in zip(DIFF, got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=name)


# --- the dropout stream ----------------------------------------------------


def test_full_tier_keep_mask_is_the_philox_mask():
    """With rw = rr = ed = 0 and no mask every score is 0 and p = 1/K; with
    v_h the identity (K = Dh) out[q, h, c] = keep(q, c)/(K·(1 − rate)),
    > 0 exactly where (b, h, q, c) is kept: #20's plain mask is
    ``dropout_keep_mask``, and its saved pd is nonzero exactly there."""
    q_len, rate, seed = 8, 0.2, 2 ** 41 + 7
    x = _ingredients(q_len, DH, q_len + DH)
    for n in ("rw", "rr", "ed", "maskb"):
        x[n][...] = 0.0
    x["v"] = np.tile(np.eye(DH, dtype=np.float32)[None, :, None, :],
                     (B, 1, H, 1)).reshape(B, DH, D)
    ts = [torch.from_numpy(x[n]) for n in INGREDIENTS]
    keep = tfa.dropout_keep_mask(seed, B, H, q_len, DH, rate)
    out, p, pd = tfa.attn_fwd_relik_reference(
        *ts, n_heads=H, scale=1.0, rate=rate, seed=seed, save=True)
    assert torch.equal(out.view(B, q_len, H, DH).permute(0, 2, 1, 3) > 0,
                       keep)
    assert torch.equal(pd > 0, keep) and bool((p > 0).all())
    assert not bool(keep.all())


def test_full_tier_replays_the_mask_exactly():
    """At rate 0.1, fp32, Q ≠ K: the recompute backward (#21's plain
    version, the mask replayed from the seed) gives the saved-probs
    backward's (#22's) bits, and both match torch.autograd through #20's
    plain forward at the same seed."""
    rate, seed = 0.1, 2 ** 35 + 1
    x = _ingredients(12, 20, 40, seed=8)
    ts = [torch.from_numpy(x[n]) for n in INGREDIENTS]
    g = torch.from_numpy(x["g"])
    kw = dict(n_heads=H, scale=SCALE)
    _, p, pd = tfa.attn_fwd_relik_reference(*ts, rate=rate, seed=seed,
                                            save=True, **kw)
    saved = tfa.attn_bwd_relik_saved_reference(p, pd, *ts[:5], ts[6], g,
                                               **kw)
    recomputed = tfa.attn_bwd_relik_reference(*ts, seed, g, rate=rate, **kw)
    assert all(torch.equal(a, b) for a, b in zip(saved, recomputed))
    xs = [t.clone().requires_grad_() for t in ts[:6]]
    tfa.attn_fwd_relik_reference(*xs, *ts[6:], rate=rate, seed=seed,
                                 **kw).backward(g)
    for name, got, x_ in zip(DIFF, saved, xs):
        np.testing.assert_allclose(got.numpy(), x_.grad.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_full_tier_forward_is_the_rel_forward_on_the_assembled_bias():
    """#20's plain version equals #11's on ebias = rel_shift(rr·rᵀ) +
    ed·segd + maskb at the same seed and rate (the same mask), within fp32
    rounding: the two add the score's terms in another order."""
    from bert_multimodal_transformer_tpu_torch.models.xlnet import rel_shift

    rate, seed, q_len, k_len = 0.1, 77, 10, 18
    x = _ingredients(q_len, k_len, q_len + k_len, seed=9)
    ts = {n: torch.from_numpy(x[n]) for n in INGREDIENTS}
    bd = torch.einsum("bqhf,phf->bhqp", ts["rr"].view(B, q_len, H, DH),
                      ts["r"].view(q_len + k_len, H, DH))
    ebias = (rel_shift(bd, k_len) + ts["ed"][..., None] * ts["segd"][:, None]
             + ts["maskb"][:, None])
    kw = dict(n_heads=H, scale=SCALE, rate=rate, seed=seed, save=True)
    got = tfa.attn_fwd_relik_reference(*(ts[n] for n in INGREDIENTS), **kw)
    want = tfa.attn_fwd_rel_reference(ts["rw"], ts["k"], ts["v"], ebias, **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=0)


# --- the tier rule ---------------------------------------------------------


@pytest.mark.parametrize("q_len,k_len,grad,tier", [
    (50, 50, True, "ik_full"),      # the driver's S = 50
    (50, 100, True, "ik_full"),     # --mem_len 50: K = 100, P = 150
    (95, 95, True, "ik_full"),      # the backward's widest square plan
    (96, 96, True, "ik_fs"),
    (8, 512, False, "ik_full"),     # the forward to K = 512
    (8, 513, False, "ik_fs"),
])
def test_inkernel_tier_by_reach(q_len, k_len, grad, tier):
    """At Dh = 64 under "inkernel": the full-H ingredients kernels while
    #20 reaches (K ≤ 512) and, with a gradient, #21/#22's plan fits; then
    the ingredients fs tier. The entry with ``tier=None`` takes the same
    tier, as its plain versions' call counts show."""
    assert tfa.rel_tier(q_len, k_len, 64, grad, True, inkernel=True) == tier
    x = _ingredients(q_len, k_len, q_len + k_len, b=1, h=1, dh=64)
    xs = [torch.from_numpy(x[n]).requires_grad_(grad and n in DIFF)
          for n in INGREDIENTS]
    before = _calls()
    out = tfa.fused_rel_attention_ingredients(*xs, n_heads=1, scale=0.125)
    if grad:
        out.sum().backward()
    name = "relik" if tier == "ik_full" else "relik_fs"
    want = {f"attn_fwd_{name}_reference": 1}
    if grad:
        want[f"attn_bwd_{name}_reference" if name == "relik_fs"
             else "attn_bwd_relik_saved_reference"] = 1
    assert _ran(before) == want


@pytest.mark.parametrize("q_len,k_len,grad,ik,inkernel,tier", [
    (50, 50, True, True, False, "full"),
    (141, 141, True, True, False, "full"),
    (142, 142, True, True, False, "ik_fs"),
    (512, 512, False, True, False, "full"),
    (513, 513, False, True, False, "ik_fs"),
    (50, 50, True, False, False, "full"),
    (142, 142, True, False, False, "hb"),
    (641, 641, True, False, False, "fs"),
    (50, 50, True, False, True, "full"),
    (142, 142, True, False, True, "hb"),
    (641, 641, False, False, True, "fs")])
def test_auto_and_stream_tiers_are_unchanged(q_len, k_len, grad, ik,
                                             inkernel, tier):
    """Without ``inkernel`` ("auto": ingredients eligible; "stream": not)
    the rule gives the tiers it gave before the full-H ingredients kernels;
    with it, an ineligible geometry (bi_data, uni attention) gives the same
    stream forms."""
    assert tfa.rel_tier(q_len, k_len, 64, grad, ik,
                        inkernel=inkernel) == tier


def test_full_tier_past_its_reach_raises():
    x = _ingredients(8, 513, 521, b=1, h=1, dh=64)
    ts = [torch.from_numpy(x[n]) for n in INGREDIENTS]
    with pytest.raises(ValueError, match="reach"):
        tfa.fused_rel_attention_ingredients(*ts, n_heads=1, scale=0.125,
                                            tier="full")


# --- the tiny MAG-XLNet under "inkernel" -------------------------------------


def _configs(**kw):
    """The JAX and the port's tiny MAG-XLNet configs (fused, "inkernel",
    dropout 0) and MAG configs."""
    from bert_multimodal_transformer_tpu.config import (
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.config import (
        MultimodalConfig,
        XLNetConfig,
    )

    common = dict(attention_impl="fused", rel_bias_impl="inkernel",
                  dropout=0.0, summary_last_dropout=0.0, **kw)
    mm = dict(beta_shift=1.0, dropout_prob=0.0, injection_index=1)
    return ((dataclasses.replace(JXLNetConfig.tiny(V), **common),
             JMultimodalConfig(**mm)),
            (dataclasses.replace(XLNetConfig.tiny(V), **common),
             MultimodalConfig(**mm)))


@pytest.fixture(scope="module")
def jparams():
    """One JAX init of the tiny MAG-XLNet; every variant below shares its
    param shapes."""
    import jax

    from bert_multimodal_transformer_tpu.models import xlnet as jxl

    jmodel = jxl.MagXLNetForSequenceClassification(
        *_configs()[0], visual_dim=DV, acoustic_dim=DA)
    ids, vis, ac, mask, segs = _inputs(seed=0)
    return jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), ids, vis, ac, attention_mask=mask,
        token_type_ids=segs)["params"])


def _pair(params, **kw):
    """The JAX and the port's tiny MAG-XLNet on ``params``, the weights
    carried across by ``xlnet_params_from_flax``."""
    from bert_multimodal_transformer_tpu.models import xlnet as jxl
    from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    (jcfg, jmm), (tcfg, tmm) = _configs(**kw)
    jmodel = jxl.MagXLNetForSequenceClassification(
        jcfg, jmm, visual_dim=DV, acoustic_dim=DA)
    tmodel = txl.MagXLNetForSequenceClassification(tcfg, tmm, DV, DA,
                                                   device="cpu")
    missing, unexpected = tmodel.load_state_dict(
        xlnet_params_from_flax(params), strict=False)
    assert missing == ["transformer.mask_emb"] and not unexpected
    return jmodel, tmodel


V, DV, DA, S, MLEN = 128, 5, 7, 10, 6


def _inputs(n=4, seed=0):
    """Left-padded XLNet rows (row 0 unpadded), segments 0 / 2 / 3."""
    rng = np.random.RandomState(seed)
    n_real = rng.randint(3, S + 1, n)
    n_real[0] = S
    real = np.arange(S)[None, :] >= (S - n_real)[:, None]
    ids = np.where(real, rng.randint(5, V, (n, S)), 2).astype(np.int32)
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    vis = (rng.randn(n, S, DV) * real[..., None]).astype(np.float32)
    ac = (rng.randn(n, S, DA) * real[..., None]).astype(np.float32)
    return ids, vis, ac, real.astype(np.int32), segs


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_tiny_xlnet_inkernel_matches_jax(jparams):
    """Logits and one step's gradients, every leaf, against the JAX model
    under "inkernel" on the same weights; every layer takes #20 and #22's
    plain versions."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    jmodel, tmodel = _pair(jparams)
    ids, vis, ac, mask, segs = _inputs(seed=3)
    c = np.random.RandomState(1).randn(len(ids), 1).astype(np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, vis, ac,
                              attention_mask=mask, token_type_ids=segs)
        return jnp.sum(logits * c), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    before = _calls()
    got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    (got * torch.from_numpy(c)).sum().backward()
    layers = tmodel.config.n_layer
    assert _ran(before) == {"attn_fwd_relik_reference": layers,
                            "attn_bwd_relik_saved_reference": layers}
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


def test_tiny_xlnet_inkernel_with_mems_matches_jax(jparams):
    """With a memory (K = mlen + Q, P = Q + K): the logits and the new
    memory of one ``use_cache`` call against the JAX model under
    "inkernel"; every layer takes #20's plain version."""
    import jax.numpy as jnp

    jmodel, tmodel = _pair(jparams, mem_len=MLEN)
    ids, vis, ac, mask, segs = _inputs(seed=4)
    rng = np.random.RandomState(6)
    mems = [rng.randn(len(ids), MLEN, 32).astype(np.float32)
            for _ in range(tmodel.config.n_layer)]
    want, want_mems = jmodel.apply(
        {"params": jparams}, ids, vis, ac, attention_mask=mask,
        token_type_ids=segs, mems=tuple(jnp.asarray(m) for m in mems),
        use_cache=True)
    before = _calls()
    with torch.no_grad():
        got, got_mems = tmodel(*_t(ids, vis, ac),
                               attention_mask=torch.from_numpy(mask),
                               token_type_ids=torch.from_numpy(segs),
                               mems=_t(*mems), use_cache=True)
    assert _ran(before) == {"attn_fwd_relik_reference":
                            tmodel.config.n_layer}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    for g, w in zip(got_mems, want_mems, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("kw", [{"bi_data": True}, {"attn_type": "uni"}])
def test_tiny_xlnet_inkernel_ineligible_takes_the_stream_forms(jparams, kw):
    """``bi_data`` (a [B, P, D] position stream) and uni attention (P = K +
    1 < Q + K) are not eligible for the ingredients: under "inkernel" they
    take the full-H rel kernels over the assembled ebias (#11's plain
    version) and match the JAX model under "inkernel", which falls back
    the same way (``tests/test_fused_attention.py``)."""
    jmodel, tmodel = _pair(jparams, **kw)
    ids, vis, ac, mask, segs = _inputs(seed=5)
    want = jmodel.apply({"params": jparams}, ids, vis, ac,
                        attention_mask=mask, token_type_ids=segs)
    before = _calls()
    with torch.no_grad():
        got = tmodel(*_t(ids, vis, ac), attention_mask=torch.from_numpy(mask),
                     token_type_ids=torch.from_numpy(segs))
    assert _ran(before) == {"attn_fwd_rel_reference": tmodel.config.n_layer}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


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
@pytest.mark.parametrize("dtype,b,q_len,k_len,h,dh", [
    ("float32", 2, 37, 77, 3, 64),      # ragged, K ≠ Q, P > Q + K
    ("float32", 2, 40, 40, 2, 128),     # the widest head
    ("bfloat16", 4, 50, 50, 12, 64),    # the driver's S = 50
    ("bfloat16", 2, 50, 100, 12, 64),   # --mem_len 50
    # bf16 #20's and #21's tensor-core plans at their edges: K odd, the
    # register plan's last K and the score tile's first, two q tiles, the
    # widest head (both forward plans), #21's reach (Q = K = 95; Q = 1 at K
    # = 435) and its query chunks (Q = 1000 at K = 8, Dh = 8: two)
    ("bfloat16", 2, 50, 57, 4, 64),
    ("bfloat16", 2, 50, 64, 4, 64),
    ("bfloat16", 2, 50, 65, 4, 64),
    ("bfloat16", 2, 77, 77, 4, 64),
    ("bfloat16", 2, 50, 50, 6, 128),
    ("bfloat16", 2, 40, 100, 6, 128),
    ("bfloat16", 2, 95, 95, 4, 64),
    ("bfloat16", 2, 1, 435, 4, 64),
    ("bfloat16", 2, 1000, 8, 2, 8),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_full_tier_kernels_match_plain_on_card(cuda_device, dtype, b, q_len,
                                               k_len, h, dh, rate):
    """#20 (saved p, pd), #22 and #21 against their plain versions, and the
    same bits twice (dr summed in a fixed order)."""
    x = _card(_ingredients(q_len, k_len, q_len + k_len + 3, b=b, h=h, dh=dh),
              cuda_device, dtype)
    ins = [x[n] for n in INGREDIENTS]
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    seed = 2 ** 60 + 5
    out, p, pd = tfa.attn_fwd_relik_cuda(*ins, rate=rate, seed=seed,
                                         save=True, **kw)
    want = tfa.attn_fwd_relik_reference(*ins, rate=rate, seed=seed,
                                        save=True, **kw)
    for a, w in zip((out, p, pd), want):
        _card_close(a, w, dtype)
    saved_in = (p, pd, *ins[:5], x["segd"], x["g"])
    for run, plain, args in (
            (tfa.attn_bwd_relik_saved_cuda,
             tfa.attn_bwd_relik_saved_reference, (saved_in, {})),
            (tfa.attn_bwd_relik_cuda, tfa.attn_bwd_relik_reference,
             ((*ins, seed, x["g"]), {"rate": rate}))):
        got = run(*args[0], **args[1], **kw)
        ref = plain(*args[0], **args[1], **kw)
        if dtype == "float32":
            for a, w in zip(got, ref):
                _card_close(a, w, dtype)
        else:
            bounds = tfa.relik_full_grads_bf16_bound(
                ref, p, pd, *ins[:5], x["segd"], x["g"], **kw)
            for a, w, bd in zip(got, ref, bounds):
                assert bool(((a.float() - w.float()).abs() <= bd).all())
        again = run(*args[0], **args[1], **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
def test_full_tier_launches_its_kernels(cuda_device):
    """The entry launches #20 and #22 (two launches: the pass and the dr
    sum) at the training default, #21 under ``save_probs=False``."""
    x = _card(_ingredients(50, 50, 100, b=2, h=12, dh=64), cuda_device,
              "bfloat16")
    rng = torch.Generator().manual_seed(3)
    for save, bwd in ((None, tfa.attn_bwd_relik_saved_cuda),
                      (False, tfa.attn_bwd_relik_cuda)):
        f0, b0 = tfa.attn_fwd_relik_cuda.launches, bwd.launches
        xs = [x[n].clone().requires_grad_() for n in DIFF]
        tfa.fused_rel_attention_ingredients(
            *xs, x["segd"], x["maskb"], n_heads=12, scale=0.125,
            dropout_rate=0.1, dropout_rng=rng, deterministic=False,
            save_probs=save).backward(x["g"])
        assert (tfa.attn_fwd_relik_cuda.launches - f0,
                bwd.launches - b0) == (1, 2)
        assert all(bool(torch.isfinite(t.grad).all()) for t in xs)


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
