"""The port's rel attention (kernels #11-#13 and their autograd,
``ops/fused_attention.py::fused_rel_attention``) against the JAX package's
``fused_rel_attention`` and its Pallas kernels (``_fwd_rel_pallas``,
``_bwd_rel_pallas``, ``_bwd_rel_saved_pallas``, run with
``interpret=True`` on the CPU), plus the dropout contract and the entry's
checks.

On the CPU the port takes the kernels' plain versions; the tests marked
``cuda`` hold the CUDA kernels against those versions and skip without a
card (``python -m pytest --noconftest -m cuda
tests/test_torch_rel_attention.py`` on a GPU machine, which need not have
jax: the JAX side is imported only inside the CPU tests that use it).

Tolerances: fp32 1e-5 (the same math summed in another order); autograd
against ``jax.vjp`` atol/rtol 2e-5, the JAX package's own band for this
entry (``tests/test_fused_attention.py``). bf16 forward: one bf16 rounding
of a prob or an output, 2^-7 relative plus 2^-6 absolute; bf16 gradients:
``rel_grads_bf16_bound``, one ulp of every rounded pd_c and ds_c element
and of the output. With dropout on, no stream can be compared with JAX:
the port's versions are held against each other and against
``torch.autograd`` through the plain forward with the same mask.
"""

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.dropout import draw_seed

B, H, DH, Q = 2, 2, 16, 12
D = H * DH
SCALE = 1.0 / DH ** 0.5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _case(q_len=Q, k_len=Q, b=B, h=H, dh=DH, seed=0, masked=True):
    """Seeded q, k, v, g and an ebias shaped like XLNet's: a bias of O(1)
    with −1e30 on masked keys (left padding) and one row masked whole."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, q_len, h * dh).astype(np.float32)
    k, v = (rng.randn(b, k_len, h * dh).astype(np.float32) for _ in "kv")
    g = rng.randn(b, q_len, h * dh).astype(np.float32)
    eb = (rng.randn(b, h, q_len, k_len) * 0.5).astype(np.float32)
    if masked:
        eb[0, :, :, :3] -= 1e30
        eb[b - 1, h - 1, 1, :] -= 1e30
    return q, k, v, eb, g


@pytest.fixture
def jfa():
    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    return jfa


def _close(got, want, dtype):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _f32(x):
    """A torch or JAX array as an fp32 torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.asarray(x, np.float32))


def _grads_close(got, want, dtype, p, pd, tensors):
    want = [_f32(w) for w in want]
    if dtype == "float32":
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(_f32(g).numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5)
        return
    q, k, v, g = tensors
    bounds = tfa.rel_grads_bf16_bound(want, p, pd, q, k, v, g, n_heads=H,
                                      scale=SCALE)
    for name, a, w, bd in zip(("dq", "dk", "dv", "debias"), got, want,
                              bounds):
        err = (a.float() - w).abs()
        assert bool((err <= bd).all()), (name, float((err - bd).max()))


SHAPES = [(Q, Q), (Q, Q + 7), (50, 100)]   # Q = K; K > Q (mems; 50 of them)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("save", [True, False])
def test_plain_forward_matches_jax_kernel(jfa, dtype, q_len, k_len, save):
    import jax.numpy as jnp

    q, k, v, eb, _ = _case(q_len, k_len, seed=1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa._fwd_rel_pallas(
        *(jnp.asarray(x, jd) for x in (q, k, v, eb)),
        jnp.zeros((1, 1), jnp.int32), scale=SCALE, rate=0.0, n_heads=H,
        interpret=True, save=save)
    got = tfa.attn_fwd_rel_reference(
        *(torch.from_numpy(x).to(td) for x in (q, k, v, eb)), n_heads=H,
        scale=SCALE, save=save)
    if save:
        assert got[2] is got[1] and got[1].dtype == td
        _close(got[1], want[1], dtype)
        got, want = got[0], want[0]
    assert got.dtype == td and tuple(got.shape) == (B, q_len, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_len,k_len", SHAPES)
def test_plain_backwards_match_jax_kernels(jfa, dtype, q_len, k_len):
    """The plain versions of #12 and #13, called directly, against the JAX
    recompute and saved-probs rel backward kernels (rate 0): dq, dk, dv
    and the unscaled debias."""
    import jax.numpy as jnp

    q, k, v, eb, g = _case(q_len, k_len, seed=2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jeb, jg = (jnp.asarray(x, jd) for x in (q, k, v, eb, g))
    seed = jnp.zeros((1, 1), jnp.int32)
    kw = dict(scale=SCALE, n_heads=H, interpret=True)
    _, jp = jfa._fwd_rel_pallas(jq, jk, jv, jeb, seed, rate=0.0, save=True,
                                **kw)
    want_saved = jfa._bwd_rel_saved_pallas(jp, jp, jq, jk, jv, jg, **kw)
    want = jfa._bwd_rel_pallas(jq, jk, jv, jeb, seed, jg, rate=0.0, **kw)
    tq, tk, tv, teb, tg = (torch.from_numpy(x).to(td)
                           for x in (q, k, v, eb, g))
    _, p, pd = tfa.attn_fwd_rel_reference(tq, tk, tv, teb, n_heads=H,
                                          scale=SCALE, save=True)
    got_saved = tfa.attn_bwd_rel_saved_reference(p, pd, tq, tk, tv, tg,
                                                 n_heads=H, scale=SCALE)
    got = tfa.attn_bwd_rel_reference(tq, tk, tv, teb, 0, tg, n_heads=H,
                                     scale=SCALE)
    for a, w in ((got_saved, want_saved), (got, want)):
        assert [x.dtype for x in a] == [td] * 4
        _grads_close(a, w, dtype, p, pd, (tq, tk, tv, tg))


@pytest.mark.parametrize("save", [True, False])
def test_autograd_matches_jax_vjp(save):
    """fused_rel_attention's gradients for q, k, v and ebias against
    jax.value_and_grad through the JAX entry (its Pallas kernels in
    interpret mode), fp32, K = Q + 7."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.fused_attention import (
        fused_rel_attention,
    )

    arrays = _case(Q, Q + 7, seed=3)[:4]

    def loss(*xs):
        return jnp.sum(jnp.tanh(fused_rel_attention(
            *xs, n_heads=H, scale=SCALE, save_probs=save)))

    want_val, want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in arrays))
    xs = [torch.from_numpy(x).requires_grad_() for x in arrays]
    val = torch.tanh(tfa.fused_rel_attention(
        *xs, n_heads=H, scale=SCALE, save_probs=save)).sum()
    val.backward()
    # the loss sums 768 fp32 terms in another order
    np.testing.assert_allclose(float(val.detach()), float(want_val),
                               rtol=1e-5)
    for name, x, w in zip("qkve", xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


def test_fully_masked_row_is_uniform(jfa):
    """A row whose every bias is −1e30 (a query-stream row under
    perm_mask): the JAX kernel's uniform softmax, not NaN."""
    import jax.numpy as jnp

    q, k, v, eb, _ = _case(seed=4, masked=False)
    eb[1, 0, 5, :] = -1e30
    _, want_p = jfa._fwd_rel_pallas(
        *(jnp.asarray(x) for x in (q, k, v, eb)), jnp.zeros((1, 1),
                                                            jnp.int32),
        scale=SCALE, rate=0.0, n_heads=H, interpret=True, save=True)
    out, p, _ = tfa.attn_fwd_rel_reference(
        *(torch.from_numpy(x) for x in (q, k, v, eb)), n_heads=H,
        scale=SCALE, save=True)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(p[1, 0, 5].numpy(), np.full(Q, 1.0 / Q),
                               rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=1e-6)


# --- dropout on: the port's versions against each other -------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_backwards_agree_with_autograd(dtype):
    """At rate 0.2 (K = Q + 5): the recompute backward (#12) replays the
    forward's mask, the saved (#13) and recompute backward agree, and both
    agree with torch.autograd through the plain forward with the same
    keep mask, debias included."""
    rate, td = 0.2, getattr(torch, dtype)
    q, k, v, eb, g = (torch.from_numpy(x) for x in _case(Q, Q + 5, seed=5))
    grads = {}
    for save in (True, False):
        xs = [x.clone().to(td).requires_grad_() for x in (q, k, v, eb)]
        out = tfa.fused_rel_attention(
            *xs, n_heads=H, scale=SCALE, dropout_rate=rate,
            dropout_rng=torch.Generator().manual_seed(11),
            deterministic=False, save_probs=save)
        out.backward(g.to(td))
        grads[save] = (out.detach(), [x.grad for x in xs])
    seed = draw_seed(torch.Generator().manual_seed(11))
    tq, tk, tv, teb, tg = (x.to(td) for x in (q, k, v, eb, g))
    out, p, pd = tfa.attn_fwd_rel_reference(tq, tk, tv, teb, n_heads=H,
                                            scale=SCALE, rate=rate,
                                            seed=seed, save=True)
    keep = tfa.dropout_keep_mask(seed, B, H, Q, Q + 5, rate)
    live = p.float() > 0
    assert torch.equal((pd.float() > 0)[live], keep[live])
    assert torch.equal(grads[True][0], out) and torch.equal(grads[False][0],
                                                            out)

    xs = [x.clone().requires_grad_() for x in (q, k, v, eb)]
    pf = tfa._rel_probs(*xs[:2], xs[3], H, SCALE)
    pdf = torch.where(keep, pf * tfa.inv_keep(rate), 0.0)
    ctx = torch.matmul(pdf, tfa._ctx_heads(xs[2], H)).permute(
        0, 2, 1, 3).reshape(B, Q, D)
    ctx.backward(g)
    want = [x.grad for x in xs]
    if dtype == "float32":
        for got in (grads[True][1], grads[False][1]):
            _grads_close(got, want, dtype, p, pd, None)
    else:
        _grads_close(grads[True][1], grads[False][1], dtype, p, pd,
                     (tq, tk, tv, tg))


def test_dropout_keep_rate_and_unbiased_output():
    """The keep rate over the [B, H, Q, K] draws lies within 5σ of 1 −
    rate, and E[out] over 64 seeds at rate 0.3 within 6 standard errors of
    the rate-0 output, elementwise."""
    rate = 0.3
    keep = tfa.dropout_keep_mask(7, 16, 12, 50, 64, rate)
    n = keep.numel()
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * (
        rate * (1 - rate) / n) ** 0.5
    q, k, v, eb, _ = (torch.from_numpy(x)
                      for x in _case(Q, Q + 3, seed=6, masked=False))
    ref = tfa.attn_fwd_rel_reference(q, k, v, eb, n_heads=H, scale=SCALE)
    outs = torch.stack([
        tfa.attn_fwd_rel_reference(q, k, v, eb, n_heads=H, scale=SCALE,
                                   rate=rate, seed=s)
        for s in range(64)]).double()
    stderr = outs.std(dim=0) / 8.0
    assert bool(((outs.mean(dim=0) - ref.double()).abs()
                 <= 6 * stderr + 1e-6).all())
    assert not torch.equal(outs[0], outs[1])


# --- the entry's checks -------------------------------------------------------


def test_entry_picks_the_backward_and_saves_nothing_without_grad(
        monkeypatch):
    calls = []
    for name in ("attn_bwd_rel", "attn_bwd_rel_saved"):
        real = getattr(tfa, name)
        monkeypatch.setattr(
            tfa, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n)
            or _r(*a, **kw))
    arrays = [torch.from_numpy(x) for x in _case(seed=7)[:4]]
    for env in ("1", "0"):
        monkeypatch.setenv("FUSED_ATTN_SAVE", env)
        xs = [x.clone().requires_grad_() for x in arrays]
        tfa.fused_rel_attention(*xs, n_heads=H, scale=SCALE).sum().backward()
    assert calls == ["attn_bwd_rel_saved", "attn_bwd_rel"]
    with torch.no_grad():
        out = tfa.fused_rel_attention(*[x.requires_grad_() for x in arrays],
                                      n_heads=H, scale=SCALE)
    assert out.grad_fn is None
    monkeypatch.delenv("FUSED_ATTN_SAVE")
    # the policy counts the true [B, H, Q, K]
    assert tfa.resolve_save_probs(256, 12, 50, 0.1, 2, k_len=50)
    assert not tfa.resolve_save_probs(4096, 12, 32, 0.1, 2, k_len=128)
    assert tfa.resolve_save_probs(4096, 12, 32, 0.1, 2, k_len=32)


def test_entry_raises_past_the_kernels_reach():
    """Past the full-H kernels' reach (K > 512, or a backward past
    ``rel_bwd_fits``) the entry takes the head-blocked tier (#14/#15) up to
    ``HB_MAX_SEQ_LEN``; past that, where it used to raise, the
    flash-streamed tier (#16/#17) at any Q and K; never einsum math."""
    def zeros(q_len, k_len, grad=False):
        xs = [torch.zeros(1, q_len, D), torch.zeros(1, k_len, D),
              torch.zeros(1, k_len, D), torch.zeros(1, H, q_len, k_len)]
        return [x.requires_grad_(grad) for x in xs]

    def ran(*args, **kw):
        names = ("attn_fwd_rel_reference", "attn_fwd_rel_hb_reference",
                 "attn_bwd_rel_hb_reference", "attn_fwd_rel_fs_reference",
                 "attn_bwd_rel_fs_reference")
        before = [getattr(tfa, n).calls for n in names]
        out = tfa.fused_rel_attention(*args, n_heads=H, scale=1.0, **kw)
        if out.requires_grad:
            out.sum().backward()
        return [getattr(tfa, n).calls - c for n, c in zip(names, before)]

    assert ran(*zeros(4, tfa.MAX_SEQ_LEN + 1)) == [0, 1, 0, 0, 0]
    assert tfa.rel_bwd_fits(141, 141, 64) and not tfa.rel_bwd_fits(142, 142,
                                                                    64)
    assert tfa.rel_bwd_smem_bytes(50, 50, 64) == 4 * (100 * 65 + 2 * 2500)
    assert ran(*zeros(200, 200, grad=True)) == [0, 1, 1, 0, 0]
    with torch.no_grad():  # the forward alone keeps its K ≤ 512 reach
        assert ran(*zeros(200, 200, grad=True)) == [1, 0, 0, 0, 0]
    assert ran(*zeros(4, tfa.HB_MAX_SEQ_LEN + 1)) == [0, 0, 0, 1, 0]
    assert ran(*zeros(4, tfa.HB_MAX_SEQ_LEN + 1, grad=True)) == [
        0, 0, 0, 1, 1]


@pytest.mark.parametrize("kw,err,match", [
    ({"interpret": True}, ValueError, "TPU"),
    ({"nb_fwd": 2}, ValueError, "TPU"),
    ({"dropout_rate": 0.1, "deterministic": False}, ValueError,
     "requires dropout_rng"),
    ({"dropout_rate": 1.0, "deterministic": False,
      "dropout_rng": torch.Generator()}, ValueError, r"\[0, 1\)"),
])
def test_entry_refuses_bad_arguments(kw, err, match):
    xs = [torch.zeros(1, 4, D), torch.zeros(1, 5, D), torch.zeros(1, 5, D),
          torch.zeros(1, H, 4, 5)]
    with pytest.raises(err, match=match):
        tfa.fused_rel_attention(*xs, n_heads=H, scale=1.0, **kw)


def test_entry_checks_the_geometry():
    q, k = torch.zeros(1, 4, D), torch.zeros(1, 5, D)
    with pytest.raises(ValueError, match="ebias"):
        tfa.fused_rel_attention(q, k, k, torch.zeros(1, H, 4, 4), n_heads=H,
                                scale=1.0)
    with pytest.raises(ValueError, match="divisible"):
        tfa.fused_rel_attention(q, k, k, torch.zeros(1, 3, 4, 5),
                                n_heads=3, scale=1.0)
    before = tfa.attn_fwd_rel_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.attn_fwd_rel_cuda(q, k, k, torch.zeros(1, H, 4, 5), n_heads=H,
                              scale=1.0)
    assert tfa.attn_fwd_rel_cuda.launches == before


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [
    ("bfloat16", 256, 50, 50, 12, 64),   # XLNet's training shape
    ("float32", 4, 50, 77, 12, 64),      # K > Q
    ("bfloat16", 3, 33, 141, 4, 64),     # the backward's longest K at Q<K
    ("float32", 2, 17, 9, 3, 128),       # the widest head, K < Q
    # bf16 #11's and #13's tensor-core plans (csrc/attn_rel_full_tc.cuh)
    ("bfloat16", 4, 50, 100, 12, 64),    # the memory's K: #11's score tile
    ("bfloat16", 2, 50, 50, 6, 128),     # the widest head in bf16
    ("bfloat16", 2, 100, 40, 3, 64),     # Q past the register plan's tile
    ("bfloat16", 1, 2000, 8, 2, 8),      # #13 over chunks of the q rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,q_len,k_len,h,dh", CARD_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rel_kernels_match_plain_on_card(cuda_device, dtype, b, q_len,
                                         k_len, h, dh, rate):
    """#11 with save (and dropout), #13 and #12 against their plain
    versions; #11's keep mask bit for bit; #12 against #13; same seed,
    same bits."""
    td = getattr(torch, dtype)
    q, k, v, eb, g = (torch.from_numpy(x).to(cuda_device, td)
                      for x in _case(q_len, k_len, b, h, dh, seed=8))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    seed = 2 ** 62 + 3
    out, p, pd = tfa.attn_fwd_rel_cuda(q, k, v, eb, rate=rate, seed=seed,
                                       save=True, **kw)
    r = tfa.attn_fwd_rel_reference(q, k, v, eb, rate=rate, seed=seed,
                                   save=True, **kw)
    for got, want in zip((out, p, pd), r):
        _close(got.cpu(), want.cpu().float().numpy(), dtype)
    if rate > 0:
        keep = tfa.dropout_keep_mask(seed, b, h, q_len, k_len, rate,
                                     cuda_device)
        live = p > 0
        assert torch.equal((pd > 0)[live], keep[live])
    saved = tfa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw)
    recomputed = tfa.attn_bwd_rel_cuda(q, k, v, eb, seed, g, rate=rate,
                                       **kw)
    r_saved = tfa.attn_bwd_rel_saved_reference(p, pd, q, k, v, g, **kw)
    r_recomputed = tfa.attn_bwd_rel_reference(q, k, v, eb, seed, g,
                                              rate=rate, **kw)
    for got, want in ((saved, r_saved), (recomputed, r_recomputed),
                      (recomputed, saved)):
        bounds = (tfa.rel_grads_bf16_bound(want, p, pd, q, k, v, g, **kw)
                  if dtype == "bfloat16" else
                  [1e-5 + 1e-5 * w.abs() for w in want])
        for a, w, bd in zip(got, want, bounds):
            assert bool(((a.float() - w.float()).abs() <= bd).all())
    assert torch.equal(tfa.attn_bwd_rel_cuda(q, k, v, eb, seed, g, rate=rate,
                                             **kw)[3], recomputed[3])
    assert torch.equal(tfa.attn_fwd_rel_cuda(q, k, v, eb, rate=rate,
                                             seed=seed, **kw), out)


@pytest.mark.cuda
def test_rel_autograd_launches_the_kernels(cuda_device, monkeypatch):
    q, k, v, eb, g = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                      for x in _case(50, 50, 4, 12, 64, seed=9))
    counts = lambda: (tfa.attn_fwd_rel_cuda.launches,  # noqa: E731
                      tfa.attn_bwd_rel_saved_cuda.launches,
                      tfa.attn_bwd_rel_cuda.launches)
    for env, want in (("1", (1, 1, 0)), ("0", (1, 0, 1))):
        monkeypatch.setenv("FUSED_ATTN_SAVE", env)
        before = counts()
        xs = [x.clone().requires_grad_() for x in (q, k, v, eb)]
        tfa.fused_rel_attention(
            *xs, n_heads=12, scale=0.125, dropout_rate=0.1,
            dropout_rng=torch.Generator().manual_seed(1),
            deterministic=False).backward(g)
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        assert xs[3].grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_rel_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 8, 64, device=cuda_device)
    eb = torch.zeros(2, 1, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="like q"):
        tfa.attn_fwd_rel_cuda(q, q, q, eb.bfloat16(), n_heads=1, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.attn_fwd_rel_cuda(q, q, q, eb.transpose(2, 3), n_heads=1,
                              scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        tfa.attn_fwd_rel_cuda(q, q, q, torch.zeros(2, 16, 8, 8,
                                                   device=cuda_device),
                              n_heads=16, scale=1.0)


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
