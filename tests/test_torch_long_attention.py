"""The port's long-sequence packed attention tiers (the head-blocked
kernels #4/#5 and the flash-streamed kernels #6/#7, through their plain
versions on the CPU) against the JAX package's ``_fused_attention_packed_hb``
and ``_fused_attention_packed_fs`` (Pallas, interpret mode), the tier
dispatch of ``fused_attention_packed``, the dropout stream shared by every
tier, and the tiny MAG-BERT at S = 256 (head-blocked) and S = 768
(flash-streamed) against the JAX einsum model.

Geometry: B=2, H=2, Dh=64, S=256, fp32, one row's last 40 keys masked (the
JAX package's own fs tests). Tolerances: the head-blocked tier is the
full-H math in another summation order: 1e-5 (values and grads, atol and
rtol). The flash-streamed tier as the JAX fs tests hold theirs: 2e-5 on
the forward (and lse), 3e-5 on the grads (the online softmax rescales its
running sums once per key block; the port's blocks are 64 keys, JAX's
128). The tests marked ``cuda`` hold the CUDA kernels against these plain
versions and skip without a card (``python -m pytest --noconftest -m cuda
tests/test_torch_long_attention.py`` on a GPU machine).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa

B, H, S, DH = 2, 2, 256, 64
D = H * DH
SCALE = 1.0 / DH ** 0.5
HB_TOL = 1e-5
FS_FWD_TOL, FS_GRAD_TOL = 2e-5, 3e-5
PLAIN = ("attn_fwd_packed_reference", "attn_bwd_packed_reference",
         "attn_bwd_packed_saved_reference", "attn_fwd_packed_hb_reference",
         "attn_bwd_packed_hb_reference", "attn_fwd_packed_fs_reference",
         "attn_bwd_packed_fs_reference")


def _inputs(seed=0, b=B, s=S, h=H, dh=DH):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * dh).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, -40:] = 0
    g = rng.randn(b, s, h * dh).astype(np.float32)
    return qkv, mask, g


def _calls():
    return {name: getattr(tfa, name).calls for name in PLAIN}


def _ran(before):
    """The plain versions called since ``before``, with their counts."""
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


@pytest.fixture
def jax_side():
    """jax, jax.numpy and the JAX package's fused_attention module."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    return jax, jnp, jfa


def _jax_tier(jax_side, which, qkv, mask, g):
    """(out, dqkv, lse or None) through the JAX tier ``which`` at rate 0:
    head-blocked with hb=1 (two head blocks), or flash-streamed with hb=2,
    qb=kb=128."""
    jax, jnp, jfa = jax_side
    bias = ((1.0 - jnp.asarray(mask, jnp.float32)) * -10000.0)[:, None, :]
    seed = jnp.zeros((1, 1), jnp.int32)
    if which == "hb":
        def f(x):
            return jfa._fused_attention_packed_hb(
                x, bias, seed, float(SCALE), 0.0, H, 1, True, None, None)
        lse = None
    else:
        def f(x):
            return jfa._fused_attention_packed_fs(
                x, bias, seed, float(SCALE), 0.0, H, 2, 128, 128, True)
        lse = jfa._fwd_packed_fs_pallas(
            jnp.asarray(qkv), bias, seed, scale=float(SCALE), rate=0.0,
            n_heads=H, hb=2, qb=128, kb=128, interpret=True)[1]
        lse = np.asarray(lse).reshape(B, H, S)
    x = jnp.asarray(qkv)
    dqkv = jax.grad(lambda y: jnp.vdot(f(y), jnp.asarray(g)))(x)
    return np.asarray(f(x)), np.asarray(dqkv), lse


def test_head_blocked_tier_matches_jax(jax_side):
    """The entry at S=256 with a gradient takes the head-blocked tier (#4
    forward, #5 recompute backward) and matches JAX's head-blocked
    kernels."""
    qkv, mask, g = _inputs(seed=1)
    want, want_d, _ = _jax_tier(jax_side, "hb", qkv, mask, g)
    x = torch.from_numpy(qkv).requires_grad_()
    before = _calls()
    out = tfa.fused_attention_packed(x, torch.from_numpy(mask), n_heads=H,
                                     scale=SCALE)
    out.backward(torch.from_numpy(g))
    assert _ran(before) == {"attn_fwd_packed_hb_reference": 1,
                            "attn_bwd_packed_hb_reference": 1}
    np.testing.assert_allclose(out.detach().numpy(), want, atol=HB_TOL,
                               rtol=HB_TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_d, atol=HB_TOL,
                               rtol=HB_TOL)


def test_flash_streamed_tier_matches_jax(jax_side):
    """#6 and #7's plain versions through ``FusedAttentionPackedFS`` at
    S=256 against JAX's flash-streamed kernels: the output, the lse
    residual and the grads."""
    qkv, mask, g = _inputs(seed=2)
    want, want_d, want_lse = _jax_tier(jax_side, "fs", qkv, mask, g)
    x = torch.from_numpy(qkv).requires_grad_()
    mask_t = torch.from_numpy(mask).float()
    before = _calls()
    out = tfa.FusedAttentionPackedFS.apply(x, mask_t, H, SCALE, 0.0, 0)
    out.backward(torch.from_numpy(g))
    assert _ran(before) == {"attn_fwd_packed_fs_reference": 1,
                            "attn_bwd_packed_fs_reference": 1}
    _, lse = tfa.attn_fwd_packed_fs_reference(x.detach(), mask_t, n_heads=H,
                                              scale=SCALE)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, S)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FS_FWD_TOL,
                               rtol=FS_FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FS_FWD_TOL,
                               rtol=FS_FWD_TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_d, atol=FS_GRAD_TOL,
                               rtol=FS_GRAD_TOL)


def test_flash_streamed_takes_a_ragged_length():
    """Unlike the JAX fs tier (S % 128 == 0), the port's takes any S: at
    S=200 (a ragged last key block of 8) its output and grads are the
    whole-row tier's."""
    qkv, mask, g = _inputs(seed=3, s=200)
    mask_t = torch.from_numpy(mask).float()
    x = torch.from_numpy(qkv).requires_grad_()
    out = tfa.FusedAttentionPackedFS.apply(x, mask_t, H, SCALE, 0.0, 0)
    out.backward(torch.from_numpy(g))
    y = torch.from_numpy(qkv).requires_grad_()
    ref = tfa.FusedAttentionPacked.apply(y, mask_t, H, SCALE, 0.0, 0, False)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=FS_FWD_TOL, rtol=FS_FWD_TOL)
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                               atol=FS_GRAD_TOL, rtol=FS_GRAD_TOL)


@pytest.mark.parametrize("s,grad,want", [
    (140, True, {"attn_fwd_packed_reference": 1,
                 "attn_bwd_packed_saved_reference": 1}),
    (141, True, {"attn_fwd_packed_hb_reference": 1,
                 "attn_bwd_packed_hb_reference": 1}),
    (512, True, {"attn_fwd_packed_hb_reference": 1,
                 "attn_bwd_packed_hb_reference": 1}),
    (513, True, {"attn_fwd_packed_hb_reference": 1,
                 "attn_bwd_packed_hb_reference": 1}),
    (640, True, {"attn_fwd_packed_hb_reference": 1,
                 "attn_bwd_packed_hb_reference": 1}),
    (641, True, {"attn_fwd_packed_fs_reference": 1,
                 "attn_bwd_packed_fs_reference": 1}),
    (140, False, {"attn_fwd_packed_reference": 1}),
    (141, False, {"attn_fwd_packed_reference": 1}),
    (512, False, {"attn_fwd_packed_reference": 1}),
    (513, False, {"attn_fwd_packed_hb_reference": 1}),
    (640, False, {"attn_fwd_packed_hb_reference": 1}),
    (641, False, {"attn_fwd_packed_fs_reference": 1}),
])
def test_dispatch_takes_the_tier(s, grad, want, monkeypatch):
    """At Dh=64 the entry takes the full-H kernels up to S=140 with a
    gradient (max_bwd_seq_len) and S=512 without (MAX_SEQ_LEN), the
    head-blocked tier up to HB_MAX_SEQ_LEN=640, and the flash-streamed tier
    past it; the CPU plain versions' call counts show which ran."""
    monkeypatch.delenv("FUSED_ATTN_SAVE", raising=False)
    assert tfa.max_bwd_seq_len(64) == 140 and tfa.MAX_SEQ_LEN == 512
    assert tfa.HB_MAX_SEQ_LEN == 640
    qkv, mask, g = _inputs(seed=4, b=1, s=s, h=1)
    x = torch.from_numpy(qkv).requires_grad_(grad)
    before = _calls()
    out = tfa.fused_attention_packed(x, torch.from_numpy(mask), n_heads=1,
                                     scale=SCALE)
    if grad:
        out.backward(torch.from_numpy(g))
        assert torch.isfinite(x.grad).all()
    assert _ran(before) == want
    assert tfa.packed_tier(s, 64, grad) == {
        "attn_fwd_packed_reference": "full",
        "attn_fwd_packed_hb_reference": "hb",
        "attn_fwd_packed_fs_reference": "fs"}[next(iter(want))]


def test_head_blocked_reach_fits_the_kernels_plans():
    """HB_MAX_SEQ_LEN lies inside #4's and #5's shared-memory plans (bf16,
    the tensor-core kernels, and fp32) at every head width the kernels take
    (Dh ≤ 128); at Dh=64 two bf16 #4 blocks share an SM. fp32 #5's plan
    grows with S and runs out at S = 704, Dh = 128."""
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for itemsize in (2, 4):
            assert tfa.hb_fwd_smem_bytes(tfa.HB_MAX_SEQ_LEN, dh,
                                         itemsize) <= tfa.MAX_SMEM_BYTES
            assert tfa.hb_bwd_smem_bytes(tfa.HB_MAX_SEQ_LEN, dh,
                                         itemsize) <= tfa.MAX_SMEM_BYTES
    assert tfa.hb_bwd_smem_bytes(704, 128, 4) > tfa.MAX_SMEM_BYTES
    # scores [32][644] fp32, Q and the ring [32 + 128][72] bf16, bias [640]
    assert tfa.hb_fwd_smem_bytes(640, 64) == 108032
    # S = 600 walks whole 64-key blocks, as S = 640
    assert tfa.hb_fwd_smem_bytes(600, 64) == tfa.hb_fwd_smem_bytes(640, 64)
    # 1 KB of each SM's 228 KB is reserved per block
    assert 2 * (tfa.hb_fwd_smem_bytes(640, 64) + 1024) <= 228 * 1024


@pytest.mark.parametrize("dh", [40, 64, 128])
def test_head_blocked_backward_bf16_plan_fits(dh):
    """bf16 #5's plan (its two tensor-core passes, nothing S-sized) fits a
    block at any S; at Dh ≤ 64 two blocks share an SM's 228 KB (1 KB each
    reserved)."""
    plan = tfa.hb_bwd_smem_bytes(tfa.HB_MAX_SEQ_LEN, dh)
    assert plan == tfa.hb_bwd_smem_bytes(141, dh) <= tfa.MAX_SMEM_BYTES
    if dh <= 64:
        assert 2 * (plan + 1024) <= 228 * 1024
    # K, V and the Q/g rings [6·64][72] bf16, pd_c/ds_c [2·64][72], bias
    assert tfa.hb_bwd_smem_bytes(512, 64) == 73984


def test_flash_streamed_backward_plan_fits_every_head_width():
    """#7's shared-memory plan (the larger of its two passes), bf16 (the
    tensor-core kernels) and fp32, lies inside a block's 227 KB at every
    head width the kernels take; at Dh=64 two bf16 blocks share an SM."""
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for itemsize in (2, 4):
            assert tfa.fs_bwd_smem_bytes(dh, itemsize) <= tfa.MAX_SMEM_BYTES
    # K, V and the Q/g/o rings [8·64][72] bf16, pd_c/ds_c [2·64][72], bias
    assert tfa.fs_bwd_smem_bytes(64) == 92416
    assert 2 * (tfa.fs_bwd_smem_bytes(64) + 1024) <= 228 * 1024


def test_flash_streamed_forward_plan_fits_every_head_width():
    """#6's shared-memory plan, bf16 (the tensor-core kernel) and fp32,
    lies inside a block's 227 KB at every head width the kernel takes."""
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for itemsize in (2, 4):
            assert tfa.fs_fwd_smem_bytes(dh, itemsize) <= tfa.MAX_SMEM_BYTES
    # at Dh = 64 two bf16 blocks share an SM's 228 KB (1 KB each reserved)
    assert 2 * (tfa.fs_fwd_smem_bytes(64) + 1024) <= 228 * 1024


def test_flash_streamed_forward_raises_past_its_plan(monkeypatch):
    """The #6 wrapper refuses a plan past 227 KB before it touches the
    card, and names it."""
    qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfa.attn_fwd_packed_fs_cuda(qkv, None, n_heads=1, scale=0.125)
    monkeypatch.setattr(tfa, "fs_fwd_smem_bytes",
                        lambda dh, itemsize=2: tfa.MAX_SMEM_BYTES + 1)
    with pytest.raises(ValueError, match="shared-memory plan at Dh=64"):
        tfa.attn_fwd_packed_fs_cuda(qkv, None, n_heads=1, scale=0.125)


@pytest.mark.parametrize("wrapper,plan,where", [
    ("attn_fwd_packed_hb_cuda", "hb_fwd_smem_bytes", "S=8, Dh=64"),
    ("attn_bwd_packed_hb_cuda", "hb_bwd_smem_bytes", "S=8, Dh=64"),
    ("attn_bwd_packed_fs_cuda", "fs_bwd_smem_bytes", "Dh=64"),
])
def test_long_kernels_raise_past_their_plans(wrapper, plan, where,
                                             monkeypatch):
    """The #4, #5 and #7 wrappers refuse a plan past 227 KB before they
    touch the card, and name it."""
    qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
    ctx = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    fn = getattr(tfa, wrapper)

    def call():
        if wrapper == "attn_fwd_packed_hb_cuda":
            return fn(qkv, None, n_heads=1, scale=0.125)
        if wrapper == "attn_bwd_packed_hb_cuda":
            return fn(qkv, None, 0, ctx, n_heads=1, scale=0.125)
        return fn(qkv, None, 0, ctx, lse, ctx, n_heads=1, scale=0.125)

    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()
    monkeypatch.setattr(tfa, plan, lambda *a, **k: tfa.MAX_SMEM_BYTES + 1)
    with pytest.raises(ValueError, match=f"shared-memory plan at {where}"):
        call()


def _hb_bwd_tc_plan(qkv, mask, seed, g, n_heads, scale, rate):
    """bf16 #5's plan (``csrc/attn_bwd_packed_tc.cuh`` with its own
    statistics) in plain torch, fp32: the statistics walk over key blocks
    of 64 keeps each row's online max m, denominator l and δ·l = Σ e·dp
    (dp = d(pd) dropped and scaled by the replayed mask) under one
    rescale α = exp(m − m'); then p = exp(s − m)·(1/l), pd and ds = p·(dp −
    δ)·scale, and dQ = ds·K, dK = dsᵀ·Q, dV = pdᵀ·g."""
    b, s, _ = qkv.shape
    q, k, v = (x.float() for x in tfa._heads(qkv, n_heads))
    gh = tfa._ctx_heads(g, n_heads).float()
    sc = (torch.matmul(q, k.transpose(-1, -2)) * scale
          + tfa._bias(mask, b, s, qkv.device)[:, None, None, :])
    dp = torch.matmul(gh, v.transpose(-1, -2))
    keep = tfa.dropout_keep_mask(seed, b, n_heads, s, s, rate)
    dp = torch.where(keep, dp * tfa.inv_keep(rate), 0.0)
    m = torch.full(sc.shape[:3], -float("inf"))
    den, dn = torch.zeros_like(m), torch.zeros_like(m)
    for k0 in range(0, s, 64):
        sb, db = sc[..., k0:k0 + 64], dp[..., k0:k0 + 64]
        m_new = torch.maximum(m, sb.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sb - m_new[..., None])
        den = den * alpha + e.sum(dim=-1)
        dn = dn * alpha + (e * db).sum(dim=-1)
        m = m_new
    p = torch.exp(sc - m[..., None]) * (1.0 / den)[..., None]
    pd = torch.where(keep, p * tfa.inv_keep(rate), 0.0)
    ds = p * (dp - (dn / den)[..., None]) * scale
    return tfa._pack(torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
                     torch.matmul(pd.transpose(-1, -2), gh))


def test_head_blocked_backward_plan_is_the_recompute_backward():
    """The statistics walk and the flash backward of bf16 #5's plan, run
    in fp32 plain torch at B=2 S=150 (three key blocks, the last ragged)
    H=2 Dh=16, rate 0.1, batch row 1 masked whole (every score near −10⁴),
    give #2's (#5's plain version's) dqkv within 1e-5: the online m, l and
    δ are the whole-row softmax's and Σ_k t to fp32 rounding. With lse =
    m + log l in place of m and 1/l the masked row would miss it: an fp32
    lse near −10⁴ keeps ~5e-4 of p's relative precision."""
    qkv, mask, g = _inputs(seed=6, s=150, dh=16)
    mask[1] = 0
    t_qkv, t_mask, t_g = (torch.from_numpy(a) for a in (qkv, mask, g))
    seed, scale = 2 ** 41 + 9, 0.25
    want = tfa.attn_bwd_packed_hb_reference(t_qkv, t_mask, seed, t_g,
                                            n_heads=H, scale=scale, rate=0.1)
    got = _hb_bwd_tc_plan(t_qkv, t_mask, seed, t_g, H, scale, 0.1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert float(want[1].abs().max()) > 0.01


def test_every_tier_drops_the_same_elements():
    """At rate 0.1 with one seed, the full-H, head-blocked and
    flash-streamed plain versions give the same output and the same
    gradients (fp32): the keep mask of element (b, h, q, k) is one Philox
    draw whatever the tier or its blocking."""
    qkv, mask, g = _inputs(seed=5, s=200)
    t_qkv, t_mask, t_g = (torch.from_numpy(a) for a in (qkv, mask, g))
    kw = dict(n_heads=H, scale=SCALE, rate=0.1, seed=2 ** 40 + 7)
    full = tfa.attn_fwd_packed_reference(t_qkv, t_mask, **kw)
    hb = tfa.attn_fwd_packed_hb_reference(t_qkv, t_mask, **kw)
    fs, lse = tfa.attn_fwd_packed_fs_reference(t_qkv, t_mask, **kw)
    assert torch.equal(full, hb)
    np.testing.assert_allclose(fs.numpy(), full.numpy(), atol=FS_FWD_TOL,
                               rtol=FS_FWD_TOL)
    seed, rate = kw.pop("seed"), kw.pop("rate")
    d_full = tfa.attn_bwd_packed_reference(t_qkv, t_mask, seed, t_g,
                                           rate=rate, **kw)
    d_hb = tfa.attn_bwd_packed_hb_reference(t_qkv, t_mask, seed, t_g,
                                            rate=rate, **kw)
    d_fs = tfa.attn_bwd_packed_fs_reference(t_qkv, t_mask, seed, fs, lse,
                                            t_g, rate=rate, **kw)
    assert torch.equal(d_full, d_hb)
    np.testing.assert_allclose(d_fs.numpy(), d_full.numpy(),
                               atol=FS_GRAD_TOL, rtol=FS_GRAD_TOL)
    # the dropout really dropped: rate 0 gives another output
    assert not torch.allclose(full, tfa.attn_fwd_packed_reference(
        t_qkv, t_mask, n_heads=H, scale=SCALE))


def test_key_offset_draws_are_the_whole_rows():
    """The fs plain version draws its mask a key block at a time
    (``dropout_bits(..., k0=)``): the same bits as the whole row's."""
    whole = tfa.dropout_bits(99, 2, 3, 5, 150)
    for k0, n in ((0, 64), (64, 64), (128, 22), (6, 13)):
        assert torch.equal(tfa.dropout_bits(99, 2, 3, 5, n, k0=k0),
                           whole[..., k0:k0 + n])


# --- the tiny model against the JAX einsum model ------------------------

DV, DA = 5, 7


@pytest.mark.parametrize("s,tier", [(256, "hb"), (768, "fs")])
def test_tiny_model_long_sequence_matches_jax(s, tier):
    """``BertConfig.tiny()`` with a position table of S rows, fused
    branch, dropout 0: the logits and one step's gradients against the JAX
    einsum model on the same params (converted by ``params_from_flax``,
    which carries the S-row table). With a gradient the fused branch takes
    the head-blocked tier at S=256 and the flash-streamed one at S=768
    (Dh=16: the full-H backward reaches S=162). Tolerances as
    tests/test_torch_bert.py: logits 1e-4; gradients 1e-4 relative to
    each leaf's largest entry."""
    import jax
    import jax.numpy as jnp

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
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    b = 2
    rng = np.random.RandomState(s)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    vis = rng.randn(b, s, DV).astype(np.float32)
    ac = rng.randn(b, s, DA).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 3:] = 0
    c = rng.randn(b, 1).astype(np.float32)

    jcfg = dataclasses.replace(JBertConfig.tiny(), attention_impl="einsum",
                               max_position_embeddings=s)
    jmodel = jbert.MagBertForSequenceClassification(
        jcfg, JMultimodalConfig(beta_shift=1.0, dropout_prob=0.1),
        visual_dim=DV, acoustic_dim=DA, dtype=jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids[:, :8],
                                  vis[:, :8], ac[:, :8], mask[:, :8])[
        "params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, vis, ac,
                              attention_mask=mask)
        return jnp.sum(logits * c), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)

    tcfg = dataclasses.replace(BertConfig.tiny(), attention_impl="fused",
                               max_position_embeddings=s)
    tmodel = tbert.MagBertForSequenceClassification(
        tcfg, MultimodalConfig(beta_shift=1.0, dropout_prob=0.1), DV, DA,
        torch.float32, device="cpu")
    sd = params_from_flax(jax.device_get(params))
    assert tuple(sd["bert.embeddings.position_embeddings.weight"].shape) == (
        s, 32)
    tmodel.load_state_dict(sd, strict=True)
    before = _calls()
    got = tmodel(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                 attention_mask=torch.from_numpy(mask))
    (got * torch.from_numpy(c)).sum().backward()
    layers = tcfg.num_hidden_layers
    assert _ran(before) == {f"attn_fwd_packed_{tier}_reference": layers,
                            f"attn_bwd_packed_{tier}_reference": layers}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    grads = params_from_flax(jax.device_get(want_g))
    for name, p in tmodel.named_parameters():
        w = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   rtol=0, err_msg=name)


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(device, dtype, b, s, h, dh, seed):
    """Seeded inputs on the card; in bf16 the last batch row is fully
    padded (the tensor-core kernels' edge)."""
    qkv, mask, g = _inputs(seed, b, s, h, dh)
    if dtype == "bfloat16" and b > 1:
        mask[-1] = 0
    td = getattr(torch, dtype)
    return (torch.from_numpy(qkv).to(device, td),
            torch.from_numpy(mask).to(device).float(),
            torch.from_numpy(g).to(device, td))


def _close(got, want, dtype, bound=None):
    """fp32: 2e-5. bf16: one rounding of each side's output (2^-7
    relative, 2^-6 absolute), or ``bound`` (``dqkv_bf16_bound``) for a
    gradient."""
    if dtype == "float32":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=2e-5)
        return
    err = (got.float() - want.float()).abs()
    if bound is None:
        bound = 2.0 ** -6 + 2.0 ** -7 * want.float().abs()
    assert bool((err <= bound).all()), float(err.max())


def _grad_bound(dtype, want, qkv, mask, g, seed, h, dh, rate):
    """``dqkv_bf16_bound`` from the whole-row plain probs (None in fp32)."""
    if dtype == "float32":
        return None
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    _, p, pd = tfa.attn_fwd_packed_reference(qkv, mask, seed=seed,
                                             rate=rate, save=True, **kw)
    return tfa.dqkv_bf16_bound(want, p, pd, qkv, g, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", [
    ("bfloat16", 4, 512, 12, 64),
    ("bfloat16", 2, 640, 4, 128),    # the hb reach at the widest head
    ("float32", 2, 333, 3, 64),
    # #4's tensor-core edges: a zero-padded k-depth and ragged off 16
    ("bfloat16", 2, 333, 3, 40),
    ("bfloat16", 2, 200, 4, 64),
    # #5's: the first S that takes it with a gradient (and, as every bf16
    # case, a batch row masked whole)
    ("bfloat16", 2, 141, 12, 64),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_blocked_kernels_match_plain_on_card(cuda_device, dtype, b, s,
                                                  h, dh, rate):
    qkv, mask, g = _card_case(cuda_device, dtype, b, s, h, dh, seed=21)
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate)
    seed = 2 ** 61 + 3
    out = tfa.attn_fwd_packed_hb_cuda(qkv, mask, seed=seed, **kw)
    _close(out, tfa.attn_fwd_packed_hb_reference(qkv, mask, seed=seed, **kw),
           dtype)
    assert torch.equal(out, tfa.attn_fwd_packed_hb_cuda(qkv, mask, seed=seed,
                                                        **kw))
    dqkv = tfa.attn_bwd_packed_hb_cuda(qkv, mask, seed, g, **kw)
    want = tfa.attn_bwd_packed_hb_reference(qkv, mask, seed, g, **kw)
    _close(dqkv, want, dtype,
           _grad_bound(dtype, want, qkv, mask, g, seed, h, dh, rate))
    assert torch.equal(dqkv, tfa.attn_bwd_packed_hb_cuda(qkv, mask, seed, g,
                                                         **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", [
    ("bfloat16", 2, 1024, 12, 64),
    ("float32", 2, 700, 3, 64),      # a ragged last key block
    ("bfloat16", 2, 130, 2, 128),
    # the tensor-core plan's edges: a zero-padded k-depth, a q tile and a
    # key block ragged off 16
    ("bfloat16", 2, 256, 3, 40),
    ("bfloat16", 2, 200, 4, 64),
    ("bfloat16", 2, 700, 2, 64),     # #7's ragged last key tile
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_streamed_kernels_match_plain_on_card(cuda_device, dtype, b,
                                                    s, h, dh, rate):
    qkv, mask, g = _card_case(cuda_device, dtype, b, s, h, dh, seed=22)
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate)
    seed = 2 ** 60 + 5
    out, lse = tfa.attn_fwd_packed_fs_cuda(qkv, mask, seed=seed, **kw)
    r_out, r_lse = tfa.attn_fwd_packed_fs_reference(qkv, mask, seed=seed,
                                                    **kw)
    _close(out, r_out, dtype)
    assert bool(((lse - r_lse).abs() <= 1e-5 + 1e-6 * r_lse.abs()).all())
    dqkv = tfa.attn_bwd_packed_fs_cuda(qkv, mask, seed, out, lse, g, **kw)
    want = tfa.attn_bwd_packed_fs_reference(qkv, mask, seed, out, lse, g,
                                            **kw)
    _close(dqkv, want, dtype,
           _grad_bound(dtype, want, qkv, mask, g, seed, h, dh, rate))
    assert torch.equal(dqkv, tfa.attn_bwd_packed_fs_cuda(
        qkv, mask, seed, out, lse, g, **kw))


@pytest.mark.cuda
def test_head_blocked_kernels_equal_full_h_on_card(cuda_device):
    """Where both reach, #4 gives #1's function and #5 gives #2's. fp32 #4
    and #5 run #1's and #2's row code: the same bits. In bf16 #1 past S = 64
    runs #4's tensor-core plan (csrc/attn_full_tc.cuh), held to it within
    the bf16 forward bound; #5 rebuilds
    p from its own online statistics where #2 takes the whole-row softmax,
    so it is held to #2 within ``dqkv_bf16_bound``."""
    qkv, mask, g = _card_case(cuda_device, "bfloat16", 4, 128, 12, 64, 23)
    kw = dict(n_heads=12, scale=0.125, rate=0.1)
    _close(tfa.attn_fwd_packed_hb_cuda(qkv, mask, seed=9, **kw),
           tfa.attn_fwd_packed_cuda(qkv, mask, seed=9, **kw), "bfloat16")
    want = tfa.attn_bwd_packed_cuda(qkv, mask, 9, g, **kw)
    _close(tfa.attn_bwd_packed_hb_cuda(qkv, mask, 9, g, **kw), want,
           "bfloat16", _grad_bound("bfloat16", want, qkv, mask, g, 9, 12, 64,
                                   0.1))
    for s in (128, 512):
        qkv, mask, g = _card_case(cuda_device, "float32", 2, s, 3, 64, 25)
        assert torch.equal(
            tfa.attn_fwd_packed_hb_cuda(qkv, mask, seed=9, **kw),
            tfa.attn_fwd_packed_cuda(qkv, mask, seed=9, **kw))
    qkv, mask, g = _card_case(cuda_device, "float32", 2, 128, 3, 64, 26)
    assert torch.equal(tfa.attn_bwd_packed_hb_cuda(qkv, mask, 9, g, **kw),
                       tfa.attn_bwd_packed_cuda(qkv, mask, 9, g, **kw))


@pytest.mark.cuda
def test_head_blocked_keep_mask_on_card(cuda_device):
    """bf16 #4's keep mask is the plain Philox mask bit for bit: with Q = K
    = 0 every prob is 1/S, and with V_h the identity (S = Dh = 128) the
    output is > 0 exactly where (b, h, q, c) is kept."""
    b, s, h, dh, rate, seed = 2, 128, 3, 128, 0.1, 2 ** 62 + 11
    qkv = torch.zeros(b, s, 3, h, dh, device=cuda_device,
                      dtype=torch.bfloat16)
    qkv[:, :, 2] = torch.eye(s, device=cuda_device)[None, :, None, :]
    out = tfa.attn_fwd_packed_hb_cuda(qkv.reshape(b, s, -1), None,
                                      n_heads=h, scale=dh ** -0.5,
                                      rate=rate, seed=seed)
    keep = tfa.dropout_keep_mask(seed, b, h, s, s, rate, cuda_device)
    assert torch.equal(out.view(b, s, h, dh).permute(0, 2, 1, 3) > 0, keep)


@pytest.mark.cuda
def test_head_blocked_backward_keep_mask_on_card(cuda_device):
    """bf16 #5's keep mask (its dK/dV pass's) is the plain Philox mask bit
    for bit: with Q = K = 0 every prob is 1/S, and with g_h the identity
    (S = Dh = 128) dV[k, h, c] = pd(c, k) is > 0 exactly where (b, h, c, k)
    is kept."""
    b, s, h, dh, rate, seed = 2, 128, 3, 128, 0.1, 2 ** 62 + 13
    qkv = torch.zeros(b, s, 3, h, dh, device=cuda_device,
                      dtype=torch.bfloat16)
    g = torch.eye(s, device=cuda_device)[None, :, None, :].expand(
        b, s, h, dh).reshape(b, s, h * dh).bfloat16()
    dqkv = tfa.attn_bwd_packed_hb_cuda(qkv.reshape(b, s, -1), None, seed, g,
                                       n_heads=h, scale=dh ** -0.5,
                                       rate=rate)
    keep = tfa.dropout_keep_mask(seed, b, h, s, s, rate, cuda_device)
    dv = dqkv.view(b, s, 3, h, dh)[:, :, 2].permute(0, 2, 3, 1)
    assert torch.equal(dv > 0, keep)


@pytest.mark.cuda
def test_long_tiers_launch_their_kernels(cuda_device):
    """The entry launches the tier's kernels on a CUDA tensor: #4 + #5 (two
    launches in bf16) at S=512 with a gradient, #1 without; #6 + #7 (two
    launches) at S=700."""
    for s, want_fwd, want_bwd, n_bwd in (
            (512, "attn_fwd_packed_hb_cuda", "attn_bwd_packed_hb_cuda", 2),
            (700, "attn_fwd_packed_fs_cuda", "attn_bwd_packed_fs_cuda", 2)):
        qkv, mask, g = _card_case(cuda_device, "bfloat16", 2, s, 12, 64, 24)
        fwd, bwd = getattr(tfa, want_fwd), getattr(tfa, want_bwd)
        f0, b0 = fwd.launches, bwd.launches
        x = qkv.clone().requires_grad_()
        tfa.fused_attention_packed(
            x, mask, n_heads=12, scale=0.125, dropout_rate=0.1,
            dropout_rng=torch.Generator().manual_seed(1),
            deterministic=False).backward(g)
        assert (fwd.launches - f0, bwd.launches - b0) == (1, n_bwd)


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
