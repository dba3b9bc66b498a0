"""The port's packed attention (kernels #1-#3 and their autograd) against
the JAX package's ``fused_attention_packed`` (its Pallas kernels, run in
interpret mode on the CPU), the Philox dropout stream, plus the wrappers'
checks and the build's failure path.

On the CPU the port takes the kernels' plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels themselves against those versions
and skip without a card. A GPU machine need not have jax installed, so the
JAX side is imported only by the tests that use it, and the card's tests
run with ``python -m pytest --noconftest -m cuda
tests/test_torch_fused_attention.py`` (``tests/conftest.py`` imports jax).

Tolerances: fp32 1e-5 (same math, sums in another order; atol and rtol
1e-5 for gradients, as the JAX package's own tests). bf16 forward: both
sides round the probs and the context once from fp32 sums, so an element
may differ by one bf16 rounding: 2^-7 relative plus 2^-6 absolute (a prob
that rounds the other way moves the context by ≲ 2^-9·|v|). bf16
gradients: ``dqkv_bf16_bound``, one ulp of every rounded pd_c and ds_c
element and of the output. With dropout on, no stream can be compared
with JAX (off the TPU it routes to the einsum path and ``jax.random``):
the tests hold the port's three versions against each other and against
``torch.autograd`` through the plain forward with the same mask.
"""

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops import kernels as tk
from bert_multimodal_transformer_tpu_torch.ops.dropout import draw_seed

B, H, S, DH = 3, 2, 50, 16
D = H * DH
SCALE = 1.0 / DH ** 0.5
FP32_ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _inputs(b=B, s=S, h=H, dh=DH, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * dh).astype(np.float32)
    lengths = rng.randint(1, s + 1, b)
    lengths[0] = 0  # a fully padded row
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return qkv, mask


@pytest.fixture
def jax_fa():
    """The JAX package's jax.numpy and fused_attention module."""
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    return jnp, jfa


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_packed_forward_matches_jax_kernel(jax_fa, dtype, masked):
    jnp, jfa = jax_fa
    qkv, mask = _inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.fused_attention_packed(
        jnp.asarray(qkv, jd), jnp.asarray(mask) if masked else None,
        n_heads=H, scale=SCALE)
    got = tfa.fused_attention_packed(
        torch.from_numpy(qkv).to(td),
        torch.from_numpy(mask) if masked else None, n_heads=H, scale=SCALE)
    assert got.dtype == td and tuple(got.shape) == (B, S, D)
    _assert_close(got, want, dtype)


def test_packed_forward_fp32_mask_equals_int_mask():
    qkv, mask = _inputs(seed=1)
    t = torch.from_numpy(qkv)
    a = tfa.fused_attention_packed(t, torch.from_numpy(mask), n_heads=H,
                                   scale=SCALE)
    b = tfa.fused_attention_packed(t, torch.from_numpy(mask).float(),
                                   n_heads=H, scale=SCALE)
    assert torch.equal(a, b)


def test_packed_forward_head_dim_64_matches_jax_kernel(jax_fa):
    """The serving head width (Dh = 64) at a short ragged S."""
    jnp, jfa = jax_fa
    qkv, mask = _inputs(b=2, s=13, h=2, dh=64, seed=2)
    want = jfa.fused_attention_packed(jnp.asarray(qkv), jnp.asarray(mask),
                                      n_heads=2, scale=0.125)
    got = tfa.fused_attention_packed(torch.from_numpy(qkv),
                                     torch.from_numpy(mask), n_heads=2,
                                     scale=0.125)
    _assert_close(got, want, "float32")


def test_dropout_and_saved_probs_raise():
    """Rate > 0 without a generator raises (as the JAX entry); a device
    generator or a rate of 1 raises; save_probs without a gradient saves
    nothing; deterministic=True turns the rate off."""
    qkv = torch.zeros(1, 4, 3 * D)
    with pytest.raises(ValueError, match="requires dropout_rng"):
        tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                   dropout_rate=0.1, deterministic=False)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                   dropout_rate=1.0, deterministic=False,
                                   dropout_rng=torch.Generator())
    with pytest.raises(TypeError, match="Generator"):
        draw_seed(7)
    out = tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                     save_probs=True)
    assert out.grad_fn is None and tuple(out.shape) == (1, 4, D)
    a = tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                   dropout_rate=0.1, deterministic=True)
    assert torch.equal(a, out)


def test_long_sequence_raises_naming_the_tiers():
    """Past the forward's reach the entry no longer raises: it takes the
    head-blocked tier up to HB_MAX_SEQ_LEN and the flash-streamed one past
    it (tests/test_torch_long_attention.py holds both to JAX)."""
    for s, tier in ((tfa.MAX_SEQ_LEN + 1, "hb"),
                    (tfa.HB_MAX_SEQ_LEN + 1, "fs")):
        qkv = torch.zeros(1, s, 3 * D)
        ref = getattr(tfa, f"attn_fwd_packed_{tier}_reference")
        before = ref.calls
        out = tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0)
        assert ref.calls == before + 1 and tuple(out.shape) == (1, s, D)
        assert tfa.packed_tier(s, DH, False) == tier


@pytest.mark.parametrize("kw", [{"interpret": True}, {"nb_fwd": 2},
                                {"nb_bwd": 1}])
def test_tpu_plan_knobs_raise(kw):
    with pytest.raises(ValueError, match="TPU"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 3 * D), None,
                                   n_heads=H, scale=1.0, **kw)


def test_bad_geometry_raises():
    with pytest.raises(ValueError, match="3·D"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 10), None, n_heads=H,
                                   scale=1.0)
    with pytest.raises(ValueError, match="divisible"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 3 * 30), None,
                                   n_heads=4, scale=1.0)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = tfa.attn_fwd_packed_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.attn_fwd_packed_cuda(torch.zeros(1, 4, 3 * D), None, n_heads=H,
                                 scale=1.0)
    assert tfa.attn_fwd_packed_cuda.launches == before


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises: nothing falls back."""
    monkeypatch.setattr(tk, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk.build_kernels()


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A compiler that exits non-zero makes the build raise with its
    output, and leaves no library behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tk, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="bad kernel"):
        tk.build_kernels()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    first = tk.library_path()
    assert first.parent == tk._BUILD_DIR
    src = tmp_path / "csrc"
    src.mkdir()
    for f in tk._sources():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(tk, "_CSRC", src)
    assert tk.library_path() == first
    (src / "attn_fwd_packed.cu").write_text("// changed\n")
    assert tk.library_path() != first


# --- the dropout stream ---------------------------------------------------


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    words = tfa.philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert " ".join(f"{int(w[0]):08x}" for w in words) == want


def test_keep_mask_is_independent_of_tiling():
    """The draw of (b, h, q, k) is a pure function of the seed and the
    element: any q/k tile of the whole mask equals the mask of that tile,
    evaluated on its own at the tile's coordinates."""
    seed, b, h, s = 2 ** 40 + 12345, 3, 2, 37
    whole = tfa.dropout_bits(seed, b, h, s, s)
    for q0, k0, qt, kt in [(0, 0, 16, 64), (16, 4, 16, 8), (5, 13, 7, 11),
                           (32, 32, 5, 5)]:
        q1, k1 = min(q0 + qt, s), min(k0 + kt, s)
        tile = torch.empty(b, h, q1 - q0, k1 - k0, dtype=torch.int64)
        for q in range(q0, q1):
            for k in range(k0, k1):
                words = tfa.philox4x32_10(
                    (torch.tensor(k // 4), torch.tensor(q),
                     torch.arange(h)[None, :], torch.arange(b)[:, None]),
                    (seed & 0xFFFFFFFF, seed >> 32))
                tile[:, :, q - q0, k - k0] = words[k % 4]
        assert torch.equal(tile, whole[:, :, q0:q1, k0:k1])
    assert torch.equal(tfa.dropout_bits(seed, b, h, s, 20),
                       whole[..., :20])
    assert not torch.equal(tfa.dropout_bits(seed + 1, b, h, s, s), whole)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_five_sigma(rate):
    n = 8 * 12 * 50 * 50
    keep = tfa.dropout_keep_mask(3, 8, 12, 50, 50, rate)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * sigma
    assert tfa.dropout_threshold(rate) == round(rate * 2 ** 32)
    assert tfa.dropout_threshold(1.0) == 2 ** 32 - 1


# --- forward and backward against the JAX kernels at rate 0 --------------


def _bf16_dqkv_close(got, want, p, pd, qkv, g, h=H, scale=SCALE):
    bound = tfa.dqkv_bf16_bound(want, p, pd, qkv, g, n_heads=h,
                                scale=scale)
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("save", [True, False])
def test_packed_grads_match_jax_kernels(jax_fa, dtype, save):
    """Forward, p, and dqkv through kernel #3 (save) or #2 (recompute),
    against jax.grad through the JAX entry (its Pallas kernels in
    interpret mode), at rate 0."""
    import jax

    jnp, jfa = jax_fa
    qkv, mask = _inputs(seed=4)
    g = np.random.RandomState(5).randn(B, S, D).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(x):
        out = jfa.fused_attention_packed(x, jnp.asarray(mask), n_heads=H,
                                         scale=SCALE, save_probs=save)
        return jnp.sum(out.astype(jnp.float32) * g)

    want_out = jfa.fused_attention_packed(
        jnp.asarray(qkv, jd), jnp.asarray(mask), n_heads=H, scale=SCALE)
    want_dqkv = jax.grad(loss)(jnp.asarray(qkv, jd))
    bias = ((1.0 - jnp.asarray(mask, jnp.float32)) * -10000.0)[:, None, :]
    _, want_p = jfa._fwd_packed_pallas(
        jnp.asarray(qkv, jd), bias, jnp.zeros((1, 1), jnp.int32),
        scale=SCALE, rate=0.0, n_heads=H, interpret=True, save=True)

    x = torch.from_numpy(qkv).to(td).requires_grad_()
    mask_t = torch.from_numpy(mask)
    out = tfa.fused_attention_packed(x, mask_t, n_heads=H, scale=SCALE,
                                     save_probs=save)
    out.backward(torch.from_numpy(g).to(td))
    _, p, pd = tfa.attn_fwd_packed_reference(x.detach(), mask_t, n_heads=H,
                                             scale=SCALE, save=True)
    assert pd is p and p.dtype == td
    _assert_close(out.detach(), want_out, dtype)
    _assert_close(p, want_p, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dqkv),
                                   atol=1e-5, rtol=1e-5)
    else:
        _bf16_dqkv_close(x.grad, torch.from_numpy(
            np.asarray(want_dqkv, np.float32)), p, pd, x.detach(),
            torch.from_numpy(g).to(td))


def test_plain_backward_versions_match_jax_kernels(jax_fa):
    """The plain versions of #2 and #3 called directly, against the JAX
    packed backward kernels in interpret mode (fp32, rate 0)."""
    jnp, jfa = jax_fa
    qkv, mask = _inputs(seed=6)
    g = np.random.RandomState(7).randn(B, S, D).astype(np.float32)
    bias = ((1.0 - jnp.asarray(mask, jnp.float32)) * -10000.0)[:, None, :]
    seed = jnp.zeros((1, 1), jnp.int32)
    kw = dict(scale=SCALE, n_heads=H, interpret=True)
    _, jp = jfa._fwd_packed_pallas(jnp.asarray(qkv), bias, seed, rate=0.0,
                                   save=True, **kw)
    want_saved = jfa._bwd_packed_saved_pallas(jp, jp, jnp.asarray(qkv),
                                              jnp.asarray(g), **kw)
    want = jfa._bwd_packed_pallas(jnp.asarray(qkv), bias, seed,
                                  jnp.asarray(g), rate=0.0, **kw)
    t_qkv, t_mask, t_g = (torch.from_numpy(a) for a in (qkv, mask, g))
    _, p, pd = tfa.attn_fwd_packed_reference(t_qkv, t_mask, n_heads=H,
                                             scale=SCALE, save=True)
    got_saved = tfa.attn_bwd_packed_saved_reference(p, pd, t_qkv, t_g,
                                                    n_heads=H, scale=SCALE)
    got = tfa.attn_bwd_packed_reference(t_qkv, t_mask, 0, t_g, n_heads=H,
                                        scale=SCALE)
    for a, w in ((got_saved, want_saved), (got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# --- dropout on: the port's versions against each other -------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_backwards_agree_with_autograd(dtype):
    """At rate 0.2 the saved (#3) and recompute (#2) backward agree with
    each other and with torch.autograd through the plain forward with the
    same keep mask; the saved pd is the plain mask bit for bit."""
    rate, h = 0.2, H
    qkv, mask = _inputs(seed=8)
    g = torch.from_numpy(np.random.RandomState(9).randn(B, S, D)
                         .astype(np.float32))
    td = getattr(torch, dtype)
    mask_t = torch.from_numpy(mask)
    grads = {}
    for save in (True, False):
        x = torch.from_numpy(qkv).to(td).requires_grad_()
        out = tfa.fused_attention_packed(
            x, mask_t, n_heads=h, scale=SCALE, dropout_rate=rate,
            dropout_rng=torch.Generator().manual_seed(11),
            deterministic=False, save_probs=save)
        out.backward(g.to(td))
        grads[save] = (out.detach(), x.grad)
    seed = draw_seed(torch.Generator().manual_seed(11))
    x = torch.from_numpy(qkv).to(td)
    out, p, pd = tfa.attn_fwd_packed_reference(
        x, mask_t, n_heads=h, scale=SCALE, rate=rate, seed=seed, save=True)
    keep = tfa.dropout_keep_mask(seed, B, h, S, S, rate)
    live = p.float() > 0
    assert torch.equal((pd.float() > 0)[live], keep[live])
    assert torch.equal(grads[True][0], out)
    assert torch.equal(grads[False][0], out)

    # torch.autograd through the plain forward's math with this mask, fp32
    xf = torch.from_numpy(qkv).requires_grad_()
    pf = tfa._probs(xf, mask_t, h, SCALE)
    pdf = torch.where(keep, pf * tfa.inv_keep(rate), 0.0)
    v = tfa._heads(xf, h)[2]
    ctx = torch.matmul(pdf, v).permute(0, 2, 1, 3).reshape(B, S, D)
    ctx.backward(g)
    if dtype == "float32":
        for got in (grads[True][1], grads[False][1]):
            np.testing.assert_allclose(got.numpy(), xf.grad.numpy(),
                                       atol=1e-5, rtol=1e-5)
    else:
        _bf16_dqkv_close(grads[True][1], grads[False][1], p, pd, x,
                         g.to(td))


def test_dropout_output_is_unbiased():
    """E[out] over 64 seeds at rate 0.3 lies within 6 standard errors of
    the rate-0 output, elementwise."""
    qkv, mask = _inputs(seed=10)
    x, mask_t = torch.from_numpy(qkv), torch.from_numpy(mask)
    ref = tfa.attn_fwd_packed_reference(x, mask_t, n_heads=H, scale=SCALE)
    outs = torch.stack([
        tfa.attn_fwd_packed_reference(x, mask_t, n_heads=H, scale=SCALE,
                                      rate=0.3, seed=seed)
        for seed in range(64)]).double()
    stderr = outs.std(dim=0) / 8.0
    assert bool(((outs.mean(dim=0) - ref.double()).abs()
                 <= 6 * stderr + 1e-6).all())
    assert not torch.equal(outs[0], outs[1])


def test_save_policy_and_override(monkeypatch):
    monkeypatch.delenv("FUSED_ATTN_SAVE", raising=False)
    # bert-base b256 S=50 bf16 at rate 0.1: 2 · 256·12·50·50·2 B ≈ 31 MB
    assert tfa.resolve_save_probs(256, 12, 50, 0.1, 2)
    assert not tfa.resolve_save_probs(4096, 12, 64, 0.1, 2)  # ≈ 805 MB
    # exactly at the cap, then one byte past it
    assert tfa.resolve_save_probs(4, 16, 1024, 0.0, 4)
    assert not tfa.resolve_save_probs(4, 16, 1024, 0.1, 4)
    assert not tfa.resolve_save_probs(2, 2, 4, 0.1, 2, save_probs=False)
    monkeypatch.setenv("FUSED_ATTN_SAVE", "0")
    assert not tfa.resolve_save_probs(2, 2, 4, 0.1, 2)
    assert tfa.resolve_save_probs(2, 2, 4, 0.1, 2, save_probs=True)
    monkeypatch.setenv("FUSED_ATTN_SAVE", "1")
    assert tfa.resolve_save_probs(4096, 12, 64, 0.1, 2)


def test_env_override_picks_the_backward(monkeypatch):
    """FUSED_ATTN_SAVE=0 sends the backward through the recompute path;
    the gradients agree either way."""
    calls = []
    for name in ("attn_bwd_packed", "attn_bwd_packed_saved"):
        real = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name,
            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a,
                                                                     **kw))
    qkv, mask = _inputs(seed=12)
    grads = []
    for env in ("1", "0"):
        monkeypatch.setenv("FUSED_ATTN_SAVE", env)
        x = torch.from_numpy(qkv).requires_grad_()
        tfa.fused_attention_packed(x, torch.from_numpy(mask), n_heads=H,
                                   scale=SCALE).sum().backward()
        grads.append(x.grad)
    assert calls == ["attn_bwd_packed_saved", "attn_bwd_packed"]
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               atol=1e-6)


def test_backward_reach_raises_at_the_forward():
    """Past the full-H backward's reach a gradient takes the head-blocked
    tier from the forward on (#4 then #5); the forward alone keeps #1 up
    to S = 512."""
    assert tfa.max_bwd_seq_len(64) == 140
    assert tfa.max_bwd_seq_len(128) == 117
    assert tfa.bwd_smem_bytes(140, 64) <= tfa.MAX_SMEM_BYTES
    s = tfa.max_bwd_seq_len(DH) + 1
    x = torch.zeros(1, s, 3 * D, requires_grad=True)
    hb_fwd, hb_bwd = (tfa.attn_fwd_packed_hb_reference,
                      tfa.attn_bwd_packed_hb_reference)
    before = (hb_fwd.calls, hb_bwd.calls, tfa.attn_fwd_packed_reference.calls)
    tfa.fused_attention_packed(x, None, n_heads=H, scale=1.0).sum().backward()
    assert (hb_fwd.calls, hb_bwd.calls) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(x.grad).all()
    with torch.no_grad():  # the forward alone keeps its S ≤ 512 reach
        tfa.fused_attention_packed(x, None, n_heads=H, scale=1.0)
    assert tfa.attn_fwd_packed_reference.calls == before[2] + 1


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", [
    ("bfloat16", 128, 50, 12, 64),   # the serving shape
    ("bfloat16", 8, 512, 12, 64),    # the longest S the kernel takes
    ("float32", 4, 77, 12, 64),
    ("bfloat16", 3, 33, 4, 128),     # the widest head
    ("float32", 2, 5, 3, 8),         # the narrowest head
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, b, s, h, dh):
    qkv, mask = _inputs(b, s, h, dh, seed=3)
    qkv_t = torch.from_numpy(qkv).to(cuda_device, getattr(torch, dtype))
    mask_t = torch.from_numpy(mask).to(cuda_device)
    before = tfa.attn_fwd_packed_cuda.launches
    got = tfa.fused_attention_packed(qkv_t, mask_t, n_heads=h,
                                     scale=1.0 / dh ** 0.5)
    assert tfa.attn_fwd_packed_cuda.launches == before + 1
    want = tfa.attn_fwd_packed_reference(qkv_t, mask_t, n_heads=h,
                                                scale=1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.cpu().float().numpy(), dtype)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 8, 3 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tfa.attn_fwd_packed_cuda(qkv.half(), None, n_heads=1, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.attn_fwd_packed_cuda(qkv.transpose(0, 1), None, n_heads=1,
                                 scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        tfa.attn_fwd_packed_cuda(qkv, None, n_heads=16, scale=1.0)
    with pytest.raises(ValueError, match="attention_mask"):
        tfa.attn_fwd_packed_cuda(qkv, torch.ones(2, 7, device=cuda_device),
                                 n_heads=1, scale=1.0)


@pytest.mark.cuda
def test_failed_launch_raises(cuda_device, monkeypatch):
    """A launch the C side refuses (here an unknown dtype code) comes back
    as its cudaError_t and the wrapper raises; the count does not move."""
    monkeypatch.setitem(tfa._DTYPE_CODES, torch.float32, 7)
    before = tfa.attn_fwd_packed_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa.attn_fwd_packed_cuda(torch.zeros(1, 4, 3 * 64,
                                             device=cuda_device),
                                 None, n_heads=1, scale=1.0)
    assert tfa.attn_fwd_packed_cuda.launches == before


def _card_case(device, dtype, b, s, h, dh, seed):
    qkv, mask = _inputs(b, s, h, dh, seed=seed)
    g = np.random.RandomState(seed + 1).randn(b, s, h * dh).astype(
        np.float32)
    td = getattr(torch, dtype)
    return (torch.from_numpy(qkv).to(device, td),
            torch.from_numpy(mask).to(device).float(),
            torch.from_numpy(g).to(device, td))


TRAIN_SHAPES = [
    ("bfloat16", 256, 50, 12, 64),   # the training shape of the bench
    ("float32", 4, 77, 12, 64),
    ("bfloat16", 2, 140, 4, 64),     # the backward's longest S at Dh = 64
    ("float32", 3, 33, 2, 128),      # the widest head
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", TRAIN_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_training_kernels_match_plain_on_card(cuda_device, dtype, b, s, h,
                                              dh, rate):
    """#1 with dropout and save, #3 and #2 against their plain versions;
    the keep mask bit for bit; #2 against #3; same seed, same bits."""
    qkv, mask, g = _card_case(cuda_device, dtype, b, s, h, dh, seed=13)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 62 + 17
    kw = dict(n_heads=h, scale=scale)
    out, p, pd = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                          save=True, **kw)
    r_out, r_p, r_pd = tfa.attn_fwd_packed_reference(
        qkv, mask, rate=rate, seed=seed, save=True, **kw)
    for got, want in ((out, r_out), (p, r_p), (pd, r_pd)):
        _assert_close(got.cpu(), want.cpu().float().numpy(), dtype)
    if rate > 0:
        keep = tfa.dropout_keep_mask(seed, b, h, s, s, rate, cuda_device)
        live = p > 0
        assert torch.equal((pd > 0)[live], keep[live])
    else:
        assert pd is p
    saved = tfa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)
    recomputed = tfa.attn_bwd_packed_cuda(qkv, mask, seed, g, rate=rate,
                                          **kw)
    r_saved = tfa.attn_bwd_packed_saved_reference(p, pd, qkv, g, **kw)
    r_recomputed = tfa.attn_bwd_packed_reference(qkv, mask, seed, g,
                                                 rate=rate, **kw)
    torch.cuda.synchronize()
    pairs = [(saved, r_saved), (recomputed, r_recomputed),
             (recomputed, saved)]
    for got, want in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), atol=1e-5,
                                       rtol=1e-5)
        else:
            bound = tfa.dqkv_bf16_bound(want, p, pd, qkv, g, **kw)
            assert bool(((got.float() - want.float()).abs()
                         <= bound).all())
    again = tfa.attn_bwd_packed_cuda(qkv, mask, seed, g, rate=rate, **kw)
    out2, p2, pd2 = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate,
                                             seed=seed, save=True, **kw)
    assert torch.equal(again, recomputed)
    assert torch.equal(out2, out) and torch.equal(pd2, pd)
    assert torch.equal(tfa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw),
                       saved)


# The edges of the bf16 tensor-core plans (csrc/attn_full_tc.cuh): the
# register plan's longest S and the score tile's first, a ragged S = 33 at
# Dh = 40 (a padded k16 step), Dh = 8 and 128, S = 512, the backward's
# longest S at Dh = 64, 72 and 128, and a single key. Each case's batch row 0
# is masked whole.
TC_EDGES = [
    (4, 64, 12, 64),
    (4, 65, 12, 64),
    (3, 33, 4, 40),
    (5, 17, 2, 8),
    (2, 50, 4, 128),
    (2, 512, 2, 40),
    (2, 140, 4, 64),
    (2, 137, 2, 72),
    (2, 117, 2, 128),
    (3, 1, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh", TC_EDGES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_tensor_core_plans_on_card(cuda_device, b, s, h, dh, rate):
    """bf16 #1 with saved probs against its plain version (out, p, pd
    within one bf16 rounding), its keep mask bit for bit, #3 (where S is
    in its reach) within ``dqkv_bf16_bound`` of the plain backward, the
    same bits twice."""
    qkv, mask, g = _card_case(cuda_device, "bfloat16", b, s, h, dh,
                              seed=s + dh)
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    seed = 2 ** 60 + s
    out, p, pd = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                          save=True, **kw)
    want = tfa.attn_fwd_packed_reference(qkv, mask, rate=rate, seed=seed,
                                         save=True, **kw)
    for got, ref in zip((out, p, pd), want):
        _assert_close(got.cpu(), ref.cpu().float().numpy(), "bfloat16")
    if rate > 0:
        keep = tfa.dropout_keep_mask(seed, b, h, s, s, rate, cuda_device)
        live = p > 0
        assert torch.equal((pd > 0)[live], keep[live])
    again = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                     save=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (out, p, pd)))
    assert torch.equal(tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate,
                                                seed=seed, **kw), out)
    if s > tfa.max_bwd_seq_len(dh):
        return
    saved = tfa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)
    ref = tfa.attn_bwd_packed_saved_reference(p, pd, qkv, g, **kw)
    torch.cuda.synchronize()
    bound = tfa.dqkv_bf16_bound(ref, p, pd, qkv, g, **kw)
    assert bool(((saved.float() - ref.float()).abs() <= bound).all())
    assert torch.equal(tfa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw),
                       saved)


@pytest.mark.cuda
def test_training_forward_modes_share_the_output(cuda_device):
    """Saving the probs does not change the output; rate 0 with no save
    is the serving launch."""
    qkv, mask, _ = _card_case(cuda_device, "bfloat16", 8, 50, 12, 64, 14)
    kw = dict(n_heads=12, scale=0.125)
    for rate in (0.0, 0.1):
        plain = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=5, **kw)
        saved = tfa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=5,
                                         save=True, **kw)[0]
        assert torch.equal(plain, saved)


@pytest.mark.cuda
def test_autograd_launches_the_kernels(cuda_device, monkeypatch):
    qkv, mask, g = _card_case(cuda_device, "bfloat16", 4, 50, 12, 64, 15)
    counts = lambda: (tfa.attn_fwd_packed_cuda.launches,  # noqa: E731
                      tfa.attn_bwd_packed_saved_cuda.launches,
                      tfa.attn_bwd_packed_cuda.launches)
    for env, want in (("1", (1, 1, 0)), ("0", (1, 0, 1))):
        monkeypatch.setenv("FUSED_ATTN_SAVE", env)
        before = counts()
        x = qkv.clone().requires_grad_()
        out = tfa.fused_attention_packed(
            x, mask, n_heads=12, scale=0.125, dropout_rate=0.1,
            dropout_rng=torch.Generator().manual_seed(1),
            deterministic=False)
        out.backward(g)
        assert tuple(a - b for a, b in zip(counts(), before)) == want


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
