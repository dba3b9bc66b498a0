"""The port's split-layout attention (kernels #8, #9, #10 and their
autograd ``FusedAttention``) against the JAX package's split-tensor
``fused_attention`` (its Pallas kernels ``_attn_fwd_kernel``,
``_attn_bwd_kernel`` and ``_attn_bwd_saved_kernel``, run in interpret mode
on the CPU), ``split_tier``, and the Philox offsets of a shard.

On the CPU the port takes the kernels' plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels against them and skip without a
card (``python -m pytest --noconftest -m cuda
tests/test_torch_split_attention.py`` on a GPU machine, which need not have
jax: the JAX side is imported only inside the tests that use it).

Tolerances: fp32 outputs 1e-5 and gradients 5e-5 (the same math summed in
another order). bf16 on the card: the forward within one bf16 rounding of
the probs and the output (2^-7 relative plus 2^-6 absolute), the gradients
within ``split_grads_bf16_bound``. With dropout on no stream compares with
JAX (off the TPU its entry routes to the einsum path and ``jax.random``):
the port's versions are held against each other, against the packed
kernels' function, and against ``torch.autograd`` through the plain
forward with the same mask.
"""

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa

B, H, S, DH = 3, 2, 12, 8
SCALE = 1.0 / DH ** 0.5
FWD_TOL, GRAD_TOL = 1e-5, 5e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _inputs(b=B, h=H, s=S, dh=DH, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, s, dh).astype(np.float32)
                  for _ in range(4))
    lengths = rng.randint(1, s + 1, b)
    lengths[0] = 0  # a fully padded row
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask, g


def _t(*arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in arrays]


@pytest.mark.parametrize("save", [True, False])
def test_split_attention_matches_jax_kernels(save):
    """Forward and the three gradients at rate 0 against the JAX entry's
    Pallas kernels (saved-probs and recompute backward), and the plain
    version each backward took."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    q, k, v, mask, g = _inputs()

    def jax_fn(q_, k_, v_):
        return jfa.fused_attention(q_, k_, v_, jnp.asarray(mask),
                                   scale=SCALE, interpret=True,
                                   save_probs=save)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, requires_grad=True)
    ref = (tfa.attn_bwd_split_saved_reference if save
           else tfa.attn_bwd_split_reference)
    before = ref.calls
    got = tfa.fused_attention(tq, tk, tv, torch.from_numpy(mask),
                              scale=SCALE, save_probs=save)
    got.backward(torch.from_numpy(g))
    assert ref.calls == before + 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_split_forward_is_the_packed_forward():
    """#8's function is #1's on the split layout: the same output and
    probs from the same q, k, v, mask and seed, dropout on."""
    q, k, v, mask, _ = _inputs(seed=1)
    tq, tk, tv, tm = _t(q, k, v, mask)
    kw = dict(scale=SCALE, rate=0.2, seed=2 ** 40 + 3, save=True)
    out, p, pd = tfa.attn_fwd_split_reference(tq, tk, tv, tm, **kw)
    qkv = tfa._pack(tq, tk, tv)
    p_out, p_p, p_pd = tfa.attn_fwd_packed_reference(qkv, tm, n_heads=H,
                                                     **kw)
    assert torch.equal(tfa._merge_heads(out), p_out)
    assert torch.equal(p, p_p) and torch.equal(pd, p_pd)


def test_shard_draws_its_slice_of_the_whole_mask():
    """The Philox offsets: a shard's keep mask (batch rows from b0, heads
    from h0) is that slice of the whole batch's mask, and the plain
    forward of a shard with its offsets gives that slice of the whole
    forward, dropout on."""
    seed, rate = 123456789, 0.3
    whole = tfa.dropout_keep_mask(seed, 4, 6, 9, 11, rate)
    shard = tfa.dropout_keep_mask(seed, 2, 3, 9, 11, rate, b0=2, h0=3)
    assert torch.equal(shard, whole[2:4, 3:6])
    assert not torch.equal(shard, whole[:2, :3])
    q, k, v, mask, _ = _inputs(b=4, h=6, seed=2)
    tq, tk, tv, tm = _t(q, k, v, mask)
    full = tfa.attn_fwd_split_reference(tq, tk, tv, tm, scale=SCALE,
                                        rate=rate, seed=seed)
    part = tfa.attn_fwd_split_reference(
        *(x[2:4, 3:6] for x in (tq, tk, tv)), tm[2:4], scale=SCALE,
        rate=rate, seed=seed, b_off=2, h_off=3)
    assert torch.equal(part, full[2:4, 3:6])


def test_tp_wrapper_takes_the_rank_offsets():
    """``fused_attention_tp`` on a rank's block draws the mask of its
    global batch rows and heads: data rank 1 of 2, model rank 1 of 3."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import Mesh

    q, k, v, mask, _ = _inputs(b=4, h=6, seed=3)
    tq, tk, tv, tm = _t(q, k, v, mask)
    kw = dict(scale=SCALE, dropout_rate=0.3, deterministic=False)
    full = tfa.fused_attention(tq, tk, tv, tm,
                               dropout_rng=torch.Generator().manual_seed(5),
                               **kw)
    mesh = Mesh(data_size=2, model_size=3, rank=4, device=torch.device("cpu"),
                backend=None)
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    part = tfa.fused_attention_tp(
        *(x[2:4, 2:4] for x in (tq, tk, tv)), tm[2:4], mesh=mesh,
        dropout_rng=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(part, full[2:4, 2:4])


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_saved_and_recompute_backward_agree_with_autograd(rate,
                                                          monkeypatch):
    """#10 and #9 (plain versions) give the same gradients from one seed,
    and both match torch.autograd through the plain forward with that
    mask."""
    q, k, v, mask, g = _inputs(seed=4)
    tm, tg = _t(mask, g)
    grads = {}
    for save in ("1", "0"):
        monkeypatch.setenv("FUSED_ATTN_SAVE", save)
        xs = _t(q, k, v, requires_grad=True)
        out = tfa.fused_attention(*xs, tm, scale=SCALE, dropout_rate=rate,
                                  dropout_rng=torch.Generator().manual_seed(9),
                                  deterministic=False)
        out.backward(tg)
        grads[save] = [x.grad for x in xs]
    seed = tfa.draw_seed(torch.Generator().manual_seed(9))
    xs = _t(q, k, v, requires_grad=True)
    tfa.attn_fwd_split_reference(*xs, tm, scale=SCALE, rate=rate,
                                 seed=seed).backward(tg)
    for a, b_, c in zip(grads["1"], grads["0"], xs):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(a, c.grad, rtol=1e-5, atol=1e-5)


def test_split_tier_and_the_reach():
    """"full" while the kernels reach (forward MAX_SEQ_LEN, backward
    max_bwd_seq_len: 140 at Dh 64, 117 at Dh 128), "einsum" past it; the
    entry raises there, before any launch."""
    assert tfa.split_tier(140, 64, True) == "full"
    assert tfa.split_tier(141, 64, True) == "einsum"
    assert tfa.split_tier(117, 128, True) == "full"
    assert tfa.split_tier(118, 128, True) == "einsum"
    assert tfa.split_tier(512, 64, False) == "full"
    assert tfa.split_tier(513, 64, False) == "einsum"
    x = torch.zeros(1, 1, 513, 8)
    before = tfa.attn_fwd_split_reference.calls
    with pytest.raises(ValueError, match="split_tier"):
        tfa.fused_attention(x, x, x, None, scale=1.0)
    assert tfa.attn_fwd_split_reference.calls == before
    y = torch.zeros(1, 1, 141, 64, requires_grad=True)
    with pytest.raises(ValueError, match="with a gradient"):
        tfa.fused_attention(y, y, y, None, scale=1.0)


def test_entry_refusals():
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="requires dropout_rng"):
        tfa.fused_attention(x, x, x, None, scale=1.0, dropout_rate=0.1,
                            deterministic=False)
    with pytest.raises(ValueError, match="one shape"):
        tfa.fused_attention(x, x[:, :1], x, None, scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.attn_fwd_split_cuda(x, x, x, None, scale=1.0)
    out = tfa.fused_attention(x, x, x, None, scale=1.0, dropout_rate=0.1,
                              deterministic=True)
    assert out.grad_fn is None and tuple(out.shape) == (1, 2, 4, 8)


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card(device, dtype, b, h, s, dh, seed):
    td = getattr(torch, dtype)
    q, k, v, mask, g = _inputs(b, h, s, dh, seed)
    return ([torch.from_numpy(x).to(device, td) for x in (q, k, v)],
            torch.from_numpy(mask).to(device).float(),
            torch.from_numpy(g).to(device, td))


def _close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,s,dh", [
    ("bfloat16", 256, 12, 50, 64),   # the training shape, all heads
    ("bfloat16", 256, 6, 50, 64),    # one rank's heads at model 2
    ("float32", 4, 12, 77, 64),
    ("bfloat16", 2, 4, 140, 64),     # the backward's longest S at Dh 64
    ("float32", 3, 2, 33, 128),      # the widest head
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_kernels_match_plain_on_card(cuda_device, dtype, b, h, s, dh,
                                           rate):
    """#8 (with saved probs, and at offsets), #10 and #9 against their
    plain versions; #9 against #10; the same bits twice."""
    (q, k, v), mask, g = _card(cuda_device, dtype, b, h, s, dh, 13)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 62 + 17
    kw = dict(scale=scale, rate=rate, seed=seed, b_off=5, h_off=h)
    out, p, pd = tfa.attn_fwd_split_cuda(q, k, v, mask, save=True, **kw)
    r_out, r_p, r_pd = tfa.attn_fwd_split_reference(q, k, v, mask,
                                                    save=True, **kw)
    for got, want in ((out, r_out), (p, r_p), (pd, r_pd)):
        _close(got, want, dtype)
    saved = tfa.attn_bwd_split_saved_cuda(p, pd, q, k, v, g, scale=scale)
    recomputed = tfa.attn_bwd_split_cuda(q, k, v, mask, seed, g,
                                         scale=scale, rate=rate, b_off=5,
                                         h_off=h)
    r_saved = tfa.attn_bwd_split_saved_reference(p, pd, q, k, v, g,
                                                 scale=scale)
    torch.cuda.synchronize()
    for got_t, want_t in ((saved, r_saved), (recomputed, r_saved)):
        if dtype == "float32":
            for got, want in zip(got_t, want_t):
                _close(got, want, dtype)
        else:
            bounds = tfa.split_grads_bf16_bound(want_t, p, pd, q, k, v, g,
                                                scale=scale)
            for got, want, bound in zip(got_t, want_t, bounds):
                assert bool(((got.float() - want.float()).abs()
                             <= bound).all())
    again = tfa.attn_bwd_split_cuda(q, k, v, mask, seed, g, scale=scale,
                                    rate=rate, b_off=5, h_off=h)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, recomputed))


@pytest.mark.cuda
def test_split_forward_gives_the_packed_kernels_bits(cuda_device):
    """#8 runs #1's row code: on the same q, k, v and seed it gives #1's
    output, p and pd bit for bit."""
    (q, k, v), mask, _ = _card(cuda_device, "bfloat16", 16, 12, 50, 64, 14)
    kw = dict(scale=0.125, rate=0.1, seed=77, save=True)
    out, p, pd = tfa.attn_fwd_split_cuda(q, k, v, mask, **kw)
    p_out, p_p, p_pd = tfa.attn_fwd_packed_cuda(tfa._pack(q, k, v), mask,
                                                n_heads=12, **kw)
    assert torch.equal(tfa._merge_heads(out), p_out)
    assert torch.equal(p, p_p) and torch.equal(pd, p_pd)


@pytest.mark.cuda
def test_split_autograd_launches_the_kernels(cuda_device, monkeypatch):
    (q, k, v), mask, g = _card(cuda_device, "bfloat16", 4, 6, 50, 64, 15)
    counts = lambda: (tfa.attn_fwd_split_cuda.launches,  # noqa: E731
                      tfa.attn_bwd_split_saved_cuda.launches,
                      tfa.attn_bwd_split_cuda.launches)
    for env, want in (("1", (1, 1, 0)), ("0", (1, 0, 1))):
        monkeypatch.setenv("FUSED_ATTN_SAVE", env)
        before = counts()
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = tfa.fused_attention(
            *xs, mask, scale=0.125, dropout_rate=0.1,
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
