"""The port's fused MAG gate (kernels #25 and #26, their plain versions and
the autograd function) against the JAX package's ``ops/mag_pallas.py`` (its
Pallas kernels run in interpret mode on the CPU), and the model with the
fused gate against the JAX model and trainer.

On the CPU the port takes the kernels' plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels against them and skip without a
card. The JAX side is imported only inside the CPU tests, so the card's
tests run with ``python -m pytest --noconftest -m cuda
tests/test_torch_mag_fused.py`` on a machine without jax.

Tolerances, those of the JAX package's own ``tests/test_mag_pallas.py``:
forward rtol and atol 1e-5; the backward (chain and products) 2e-4; the
autograd gradients against ``jax.grad`` 1e-4. The model: the bands of
``tests/test_torch_bert.py`` (fp32 logits 1e-4) and the losses of three
train steps to rtol 1e-3, as ``tests/test_torch_training.py``. On the
card, against the plain versions: fp32 output 1e-5 relative plus 1e-5
absolute (the same math summed in another order); bf16 output one bf16
rounding, 2^-7 relative plus 1e-5 absolute; the chain's fp32 outputs 2e-4.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import mag_fused as tmf
from bert_multimodal_transformer_tpu_torch.ops.mag import mag_gate

D, DV, DA = 256, 47, 74  # lane-aligned text dim, real MOSI modality dims
BETAS = (1e-3, 1.0, 1e6)


def _np_params(d=D, dv=DV, da=DA, seed=0):
    """The JAX package's init (numpy), with a non-trivial LayerNorm."""
    import jax

    from bert_multimodal_transformer_tpu.ops.mag import init_mag_params

    params = {k: np.array(v) for k, v in jax.device_get(
        init_mag_params(jax.random.PRNGKey(seed), d, dv, da)).items()}
    rng = np.random.RandomState(seed + 100)
    params["ln_gamma"] = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    params["ln_beta"] = (0.1 * rng.randn(d)).astype(np.float32)
    return params


def _inputs(shape=(3, 20), d=D, dv=DV, da=DA, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape, w).astype(np.float32)
                 for w in (d, dv, da, d))   # text, visual, acoustic, dy


def _t(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def setup():
    return _np_params(), _inputs()


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("rows", [None, 7])
def test_forward_matches_jax_kernel(setup, beta, rows):
    """mag_gate_fused (CPU: the plain #25) against the Pallas kernel in
    interpret mode, at [3, 20] rows and a ragged 7-row case."""
    from bert_multimodal_transformer_tpu.ops.mag_pallas import (
        mag_gate_fused as jax_fused,
    )

    params, (t, v, a, _) = setup
    if rows is not None:
        t, v, a = t[:1, :rows], v[:1, :rows], a[:1, :rows]
    want = np.asarray(jax_fused(params, t, v, a, beta_shift=beta,
                                interpret=True))
    got = tmf.mag_gate_fused(_t(params), *map(torch.from_numpy, (t, v, a)),
                             beta_shift=beta)
    assert got.dtype == torch.float32 and tuple(got.shape) == t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beta,rows", [(b, None) for b in BETAS]
                         + [(1.0, 5)])
def test_backward_matches_jax_kernel(setup, beta, rows):
    """The chain (plain #26) and the products against
    _mag_backward_pallas in interpret mode: dparams, dtext, dvisual and
    dacoustic."""
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.mag_pallas import (
        _mag_backward_pallas,
    )

    params, (t, v, a, dy) = setup
    if rows is not None:
        t, v, a, dy = (x[:1, :rows] for x in (t, v, a, dy))
    want = _mag_backward_pallas(params, *map(jnp.asarray, (t, v, a, dy)),
                                beta_shift=beta, interpret=True)
    got = tmf.mag_backward(_t(params), *map(torch.from_numpy, (t, v, a, dy)),
                           beta_shift=beta)
    for k in tmf.PARAM_NAMES:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def _loss_grads_torch(params, t, v, a, gate=None):
    gate = gate or tmf.mag_gate_fused
    tp = {k: torch.from_numpy(x).requires_grad_() for k, x in params.items()}
    xs = [torch.from_numpy(x).requires_grad_() for x in (t, v, a)]
    (gate(tp, *xs) ** 2).sum().backward()
    return ({k: p.grad.numpy() for k, p in tp.items()},
            *(x.grad.numpy() for x in xs))


def test_autograd_matches_jax_grad(setup):
    """MagGateFused's gradients against jax.grad of the fused JAX gate."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.mag_pallas import (
        mag_gate_fused as jax_fused,
    )

    params, (t, v, a, _) = setup

    def loss(p, tt, vv, aa):
        return jnp.sum(jax_fused(p, tt, vv, aa, interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(params, t, v, a)
    got = _loss_grads_torch(params, t, v, a)
    for k in tmf.PARAM_NAMES:
        np.testing.assert_allclose(got[0][k], np.asarray(want[0][k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_edge_semantics_match_jax_kernel():
    """The chain's edges, as the TPU kernel: a zero text row (‖t‖ = 0
    passes no gradient to t) and a row whose H_m is zero (‖H_m‖ = 0 counts
    as 1 and passes no gradient to the norm)."""
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops.mag_pallas import (
        _mag_backward_pallas,
    )

    d, dv, da = 128, 3, 5
    params = _np_params(d, dv, da, seed=2)
    t, v, a, dy = _inputs((4,), d, dv, da, seed=3)
    t[0] = 0.0
    params["b_v"][:] = 0.0
    params["b_a"][:] = 0.0
    v[1] = 0.0   # zero modality rows and zero biases: H_m = 0 on row 1
    a[1] = 0.0
    r = tmf._recompute(tmf._weights(_t(params)),
                       *map(torch.from_numpy, (t, v, a)), 1.0)
    assert float(r["hn"][1]) == 0.0 and float(r["em"][0]) == 0.0
    want = _mag_backward_pallas(params, *map(jnp.asarray, (t, v, a, dy)),
                                beta_shift=1.0, interpret=True)
    got = tmf.mag_backward(_t(params), *map(torch.from_numpy, (t, v, a, dy)),
                           beta_shift=1.0)
    assert np.isfinite(got[1].numpy()).all()
    for k in tmf.PARAM_NAMES:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_clamp_vjp_is_half_at_the_tie():
    """min(thresh, 1)'s VJP in the chain is jnp.minimum's: 1 below the
    tie, 0.5 at it, 0 above (torch.clamp's autograd would give 1 at it)."""
    import jax
    import jax.numpy as jnp

    x = np.array([0.5, 1.0, 2.0], np.float32)
    _, vjp = jax.vjp(lambda y: jnp.minimum(y, 1.0), jnp.asarray(x))
    want = np.asarray(vjp(jnp.ones(3, jnp.float32))[0])
    np.testing.assert_array_equal(want, [1.0, 0.5, 0.0])
    np.testing.assert_array_equal(
        tmf.clamp_vjp(torch.from_numpy(x)).numpy(), want)


def test_no_grad_saves_nothing_and_cpu_launches_no_kernel(setup):
    params, (t, v, a, _) = setup
    tp = {k: torch.from_numpy(x).requires_grad_() for k, x in params.items()}
    before = (tmf.mag_fwd_cuda.launches, tmf.mag_bwd_cuda.launches)
    with torch.no_grad():
        out = tmf.mag_gate_fused(tp, *map(torch.from_numpy, (t, v, a)))
    assert out.grad_fn is None
    out = tmf.mag_gate_fused(tp, *map(torch.from_numpy, (t, v, a)))
    out.sum().backward()
    assert (tmf.mag_fwd_cuda.launches, tmf.mag_bwd_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors(setup):
    params, (t, v, a, dy) = setup
    args = [torch.from_numpy(x) for x in (t, v, a)]
    with pytest.raises(ValueError, match="CUDA"):
        tmf.mag_fwd_cuda(_t(params), *args)
    with pytest.raises(ValueError, match="CUDA"):
        tmf.mag_bwd_cuda(_t(params), *args, torch.from_numpy(dy))
    assert tmf.mag_fwd_cuda.launches == tmf.mag_bwd_cuda.launches == 0


def test_shared_memory_plan():
    """The kernels take bert-large's D = 1024 with MOSI / MOSEI widths."""
    for d, dv, da in ((768, 47, 74), (1024, 47, 74), (1024, 35, 74)):
        assert tmf.smem_bytes(d, dv, da) <= tmf.MAX_SMEM_BYTES
    assert tmf.smem_bytes(768, 47, 74) == 4 * 16 * (2 * 768 + 48 + 80)
    # two blocks share an SM's 228 KB at bert-base width
    assert 2 * tmf.smem_bytes(768, 47, 74) <= 228 * 1024 - 2048


# --- bf16 #25's tensor-core plan, emulated ----------------------------------

TC_HEADER = (Path(tmf.__file__).resolve().parents[1] / "csrc" / "mag_tc.cuh")


def _planes(w):
    """The kernel's split of fp32 weights into three bf16 planes (as fp32
    values): each the bf16 rounding of what the planes before it left."""
    out, r = [], w.float()
    for _ in range(3):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _tc_products(x, w, acc=None):
    """acc + x·w as the plan sums it: bf16 activations x [N, K] against the
    three planes of w [K, D], one 16-deep step and plane at a time, each
    step's products exact (a bf16 product is exact in fp32) and added to
    the fp32 accumulator."""
    if acc is None:
        acc = torch.zeros(x.shape[0], w.shape[1])
    xd = x.double()
    planes = [p.double() for p in _planes(w)]
    for k0 in range(0, x.shape[1], 16):
        for p in planes:
            acc = acc + (xd[:, k0:k0 + 16] @ p[k0:k0 + 16]).float()
    return acc


def _block_row_sum(x):
    """Row sums [N, 1] as the cluster takes them: each 128-column block's
    sum, the blocks added in rank order."""
    blocks = [x[:, c:c + tmf.TC_COLS].sum(dim=1)
              for c in range(0, x.shape[1], tmf.TC_COLS)]
    total = torch.zeros_like(blocks[0])
    for b in blocks:
        total = total + b
    return total[:, None]


def _tc_gate(params, t, v, a, beta):
    """bf16 #25's plan in plain torch on bf16 rows: the six products on the
    split weights in the kernel's segment order, H_m rounding for rounding
    as ``displacement``, then the two-pass row sums per 128-column block
    added in block order (the cluster's), the LayerNorm; y in bf16."""
    w = {k: params[k].float() for k in tmf.PARAM_NAMES}
    pv = _tc_products(v, w["w_hv_v"], _tc_products(t, w["w_hv_t"]))
    dv_ = _tc_products(v, w["w_v"])
    pa = _tc_products(a, w["w_ha_a"], _tc_products(t, w["w_ha_t"]))
    da_ = _tc_products(a, w["w_a"])
    h_m = (torch.relu(pv + w["b_hv"]) * (dv_ + w["b_v"])
           + torch.relu(pa + w["b_ha"]) * (da_ + w["b_a"]))
    tf = t.float()
    d = tf.shape[1]
    row_sum = _block_row_sum
    em, hn = torch.sqrt(row_sum(tf * tf)), torch.sqrt(row_sum(h_m * h_m))
    hn1 = torch.where(hn == 0.0, 1.0, hn)
    alpha = torch.clamp(em / (hn1 + 1e-6) * beta, max=1.0)
    f = alpha * h_m + tf
    mu = row_sum(f) / d
    c = f - mu
    inv = torch.rsqrt(row_sum(c * c) / d + tmf.LN_EPS)
    return (c * inv * w["ln_gamma"] + w["ln_beta"]).to(torch.bfloat16)


def _tc_case(n, d, dv, da, seed):
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy(x)
              for k, x in _card_params(d, dv, da, rng).items()}
    t, v, a = (torch.from_numpy(rng.randn(n, w).astype(np.float32)).to(
        torch.bfloat16) for w in (d, dv, da))
    return params, t, v, a


def test_bf16_values_are_exact_in_the_split_format():
    """Every finite bf16 value read as fp32 is its own first plane and
    leaves nothing to the other two: the activations need no split."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    p1, p2, p3 = _planes(x)
    assert torch.equal(p1, x)
    assert not bool(p2.any()) and not bool(p3.any())


def test_three_plane_split_reconstructs_fp32():
    """Three bf16 planes hold random fp32 weights, from 1e-30 to 1e30 in
    magnitude, to 2^-24 of themselves."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(np.float32))
    got = sum(p.double() for p in _planes(w))
    gap = (got - w.double()).abs()
    assert bool((gap <= 2.0 ** -24 * w.double().abs()).all())
    # and two planes alone would not do
    two = sum(p.double() for p in _planes(w)[:2])
    assert bool(((two - w.double()).abs()
                 > 2.0 ** -24 * w.double().abs()).any())


@pytest.mark.parametrize("beta", BETAS)
def test_split_gate_matches_plain_gate(beta):
    """bf16 #25's plan (bf16 activations against the three planes, summed
    in fp32 by 16-deep step, the row sums by 128-column block) gives the
    plain ``mag_gate`` within phase 3c's bf16 bound (2^-7 relative plus
    1e-5), over two row blocks with a tail, three cluster blocks with a
    partial one, the MOSI widths off the k step, and a row whose H_m is 0
    (its visual and acoustic rows zero, b_v = b_a = 0)."""
    params, t, v, a = _tc_case(70, 300, 47, 35, seed=11)
    params["b_v"].zero_()
    params["b_a"].zero_()
    v[5] = 0.0
    a[5] = 0.0
    got = _tc_gate(params, t, v, a, beta)
    want = mag_gate(params, t, v, a, beta_shift=beta)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-5 + 2 ** -7 * want.float().abs()).all())
    r = tmf._recompute(tmf._weights(params), t.float(), v.float(),
                       a.float(), beta)
    assert float(r["h_m"][5].abs().max()) == 0.0
    assert float(r["h_m"].abs().max()) > 0.1


def _tc_header_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         TC_HEADER.read_text()).group(1))


def test_tensor_core_plan_fits_and_is_the_headers():
    """bf16 #25's shared memory (``tc_smem_bytes``) is the header's
    formula, independent of the widths (so it fits 227 KB at D = 768 and
    1024 alike), with room for two blocks an SM; its cluster is D / 128
    blocks, 6 at D = 768 and 8, the portable limit, at MAX_D = 1024."""
    names = ("kRows", "kCols", "kSlice", "kStages")
    rows, cols, slice_, stages = map(_tc_header_constant, names)
    assert (rows, cols, slice_, stages) == (tmf.TC_ROWS, tmf.TC_COLS,
                                            tmf.TC_SLICE, tmf.TC_STAGES)
    stage = rows * (slice_ + 8) * 2 + slice_ * (cols + 4) * 4
    assert tmf.tc_smem_bytes() == (stages * stage + rows * (cols + 4) * 4
                                   + 3 * rows * 2 * 4)
    assert 2 * tmf.tc_smem_bytes() <= 228 * 1024 - 2 * 1024
    assert -(-768 // cols) == 6 and -(-tmf.MAX_D // cols) == 8


# --- bf16 #26's tensor-core plan, emulated ----------------------------------


def _tc_bwd_chain(params, t, v, a, dy, beta):
    """bf16 #26's plan in plain torch on bf16 rows: #25's split products
    in its segment order, ReLU(pv), dv_, ReLU(pa), da_ (biases added), H_m
    from them rounding for rounding as ``displacement``, the five rounds
    of row sums by 128-column block in rank order (‖t‖² and ‖H_m‖², Σ f,
    Σ (f − μ)², Σ dxh and Σ dxh · x̂, Σ df · H_m), then the clamp and gate
    backward as the kernel writes them. Returns (dpv, dpa, ddv, dda,
    dt_partial, xhat), fp32."""
    w = {k: params[k].float() for k in tmf.PARAM_NAMES}
    pv = _tc_products(v, w["w_hv_v"], _tc_products(t, w["w_hv_t"]))
    dv_ = _tc_products(v, w["w_v"])
    pa = _tc_products(a, w["w_ha_a"], _tc_products(t, w["w_ha_t"]))
    da_ = _tc_products(a, w["w_a"])
    gv, dv = torch.relu(pv + w["b_hv"]), dv_ + w["b_v"]
    ga, da = torch.relu(pa + w["b_ha"]), da_ + w["b_a"]
    h_m = gv * dv + ga * da
    tf = t.float()
    d = tf.shape[1]
    row_sum = _block_row_sum
    em, hn = torch.sqrt(row_sum(tf * tf)), torch.sqrt(row_sum(h_m * h_m))
    hn1 = torch.where(hn == 0.0, 1.0, hn)
    thresh = em / (hn1 + 1e-6) * beta
    alpha = torch.clamp(thresh, max=1.0)
    f = alpha * h_m + tf
    mu = row_sum(f) / d
    inv = torch.rsqrt(row_sum((f - mu) ** 2) / d + tmf.LN_EPS)
    xhat = (f - mu) * inv
    dxh = dy.float() * w["ln_gamma"]
    m1, m2 = row_sum(dxh) / d, row_sum(dxh * xhat) / d
    df = inv * (dxh - m1 - xhat * m2)
    dthresh = row_sum(df * h_m) * tmf.clamp_vjp(thresh)
    den = hn1 + 1e-6
    dem = dthresh * beta / den
    live = (hn != 0.0).float()
    dhn = -dthresh * beta * em / (den * den) * live
    em_safe = torch.where(em == 0.0, 1.0, em)
    t_coef = (dem / em_safe) * torch.where(em == 0.0, 0.0, 1.0)
    dhm = alpha * df + (dhn / hn1) * live * h_m
    return (torch.where(gv > 0.0, dhm * dv, 0.0),
            torch.where(ga > 0.0, dhm * da, 0.0), dhm * gv, dhm * ga,
            df + t_coef * tf, xhat)


def _jax_bwd_chain(params, t, v, a, dy, beta):
    """The JAX ``_mag_bwd_kernel`` on whole rows (one block) in interpret
    mode: its six [N, D] fp32 outputs as numpy arrays."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from bert_multimodal_transformer_tpu.ops.mag_pallas import (
        _mag_bwd_kernel,
    )

    n, d = t.shape
    names = ("w_hv_v", "w_hv_t", "b_hv", "w_ha_a", "w_ha_t", "b_ha", "w_v",
             "b_v", "w_a", "b_a", "ln_gamma")
    ins = [jnp.asarray(x.float().numpy()) for x in (dy, t, v, a)]
    ins += [jnp.asarray(params[k].numpy()) for k in names]
    outs = pl.pallas_call(
        functools.partial(_mag_bwd_kernel, beta_shift=beta),
        out_shape=tuple(jax.ShapeDtypeStruct((n, d), jnp.float32)
                        for _ in range(6)),
        interpret=True)(*ins)
    return [np.array(o) for o in outs]


def _tie_beta(hn):
    """A beta for which a row with ‖t‖ = 1 and ‖H_m‖ = hn, both exact,
    sits on the clamp's tie: fp32 (1 / (hn + 1e-6)) · beta == 1."""
    q = torch.ones(()) / (torch.tensor(hn) + 1e-6)
    beta = torch.ones(()) / q
    for _ in range(4):
        if float(q * beta) == 1.0:
            return beta.item()
        beta = torch.nextafter(beta, torch.tensor(
            0.0 if float(q * beta) > 1.0 else 2.0))
    raise AssertionError("no fp32 beta puts the row on the tie")


@pytest.mark.parametrize("beta", [*BETAS, "tie"])
def test_split_backward_chain_matches_plain_and_jax(beta):
    """bf16 #26's plan emulated (``_tc_bwd_chain``) against the plain
    chain and the JAX ``_mag_bwd_kernel`` in interpret mode on the same
    bf16 rows, within phase 3c's MAG_BWD_TOL (2e-4 relative plus 2e-4),
    ReLU-tie elements (a pre-activation within 1e-5 of 0) left out as
    phase 3c leaves them out: N = 70 (two row blocks, a tail), D = 200
    (two cluster blocks, one partial), MOSI's Dv = 47 and MOSEI's Da =
    35, and a row whose H_m is 0. Under "tie" that row is t = e_3 instead,
    and b_v = e_0 with bf16-exact weights at (3, 0) make its H_m = 0.75
    e_0 in every implementation, so a beta puts it on the clamp's tie
    thresh == 1 (min's VJP 0.5, and a nonzero dalpha)."""
    params, t, v, a = _tc_case(70, 200, 47, 35, seed=13)
    dy = torch.from_numpy(np.random.RandomState(14).randn(70, 200).astype(
        np.float32)).to(torch.bfloat16)
    params["b_v"].zero_()
    params["b_a"].zero_()
    v[5] = 0.0
    a[5] = 0.0
    tie_row = beta == "tie"
    if tie_row:
        params["b_v"][0] = 1.0
        params["w_hv_t"][3, 0] = 0.5
        params["b_hv"][0] = 0.25
        t[5] = 0.0
        t[5, 3] = 1.0
        beta = _tie_beta(0.75)
    got = _tc_bwd_chain(params, t, v, a, dy, beta)
    rows = (t, v, a, dy)
    plain = tmf.mag_bwd_chain_plain(params, *rows, beta_shift=beta)
    jax_out = _jax_bwd_chain(params, *rows, beta)
    r = tmf._recompute(tmf._weights(params), t.float(), v.float(),
                       a.float(), beta)
    if tie_row:
        assert torch.equal(r["h_m"][5], 0.75 * (torch.arange(200) == 0))
        assert float(tmf.clamp_vjp(r["thresh"])[5]) == 0.5
    else:
        assert float(r["h_m"][5].abs().max()) == 0.0
    tie = (r["pv"].abs() < 1e-5) | (r["pa"].abs() < 1e-5)
    tol = 2e-4
    for name, g, p_, j in zip(("dpv", "dpa", "ddv", "dda", "dt", "xhat"),
                              got, plain, jax_out):
        assert g.dtype == torch.float32 and g.shape == (70, 200)
        for want in (p_, torch.from_numpy(j)):
            bad = ((g - want).abs() > tol + tol * want.abs()) & ~tie
            assert not bool(bad.any()), name


def test_tensor_core_backward_plan_fits_and_is_the_headers():
    """bf16 #26's shared memory (``tc_bwd_smem_bytes``) is the header's
    ``bwd_smem_bytes``: a two-stage ring, the first half's two fp32 tiles
    and five rounds of partial sums. It is independent of the widths, so
    it fits at D = 768 and 1024 alike, with room for two blocks an SM;
    once the products end, the ring's bytes hold t's and dy's bf16 slices,
    the rows' scalars and the 8 warps' partial sums."""
    rows, cols, slice_ = map(_tc_header_constant,
                             ("kRows", "kCols", "kSlice"))
    stages, rounds = map(_tc_header_constant, ("kBwdStages", "kBwdRounds"))
    assert (stages, rounds) == (tmf.TC_BWD_STAGES, tmf.TC_BWD_ROUNDS) == (
        2, 5)
    ring = stages * (rows * (slice_ + 8) * 2 + slice_ * (cols + 4) * 4)
    assert tmf.tc_bwd_smem_bytes() == (ring + 2 * rows * (cols + 4) * 4
                                       + rounds * rows * 2 * 4) == 114176
    assert "114176 bytes" in " ".join(TC_HEADER.read_text().split())
    scalars = _tc_header_constant("kScalars")
    assert 2 * rows * (cols + 8) * 2 + rows * scalars * 4 + 8 * rows * 2 * 4 \
        <= ring
    for d in (768, tmf.MAX_D):
        assert -(-d // cols) <= 8
        assert tmf.tc_bwd_smem_bytes() <= tmf.MAX_SMEM_BYTES
    # two blocks an SM: each with its 1 KB reserve within the SM's 228 KB
    assert 2 * (tmf.tc_bwd_smem_bytes() + 1024) <= 228 * 1024


# --- the model and the trainer with the fused gate --------------------------


def _model_pair(seed=0):
    import jax

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

    jmodel = jbert.MagBertForSequenceClassification(
        JBertConfig.tiny(), JMultimodalConfig(use_fused_kernel=True),
        visual_dim=5, acoustic_dim=7)
    ids, vis, ac, mask = _bert_inputs()
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids, vis,
                                        ac, mask)["params"])
    tmodel = tbert.MagBertForSequenceClassification(
        BertConfig.tiny(), MultimodalConfig(use_fused_kernel=True), 5, 7,
        device="cpu")
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


def _bert_inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (3, 10)).astype(np.int32)
    vis = rng.randn(3, 10, 5).astype(np.float32)
    ac = rng.randn(3, 10, 7).astype(np.float32)
    mask = np.ones((3, 10), np.int32)
    mask[0, 7:] = 0
    return ids, vis, ac, mask


def test_model_with_fused_gate_matches_jax(monkeypatch):
    """MagBertForSequenceClassification at BertConfig.tiny() with the
    fused gate: logits to 1e-4 against the JAX model with its fused gate,
    and the gate called once per forward."""
    from bert_multimodal_transformer_tpu_torch.models import mag as tmag

    jmodel, params, tmodel = _model_pair()
    assert tmodel.bert.MAG.use_fused_kernel
    calls = []
    real = tmag.mag_gate_fused
    monkeypatch.setattr(tmag, "mag_gate_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ids, vis, ac, mask = _bert_inputs(1)
    want = jmodel.apply({"params": params}, ids, vis, ac,
                        attention_mask=mask)
    got = tmodel(*map(torch.from_numpy, (ids, vis, ac)),
                 attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    assert calls == [1]


def test_plain_gate_model_gives_the_fused_gradients():
    """Plain gradients come from a model built with use_fused_kernel=False:
    from the same weights, its gradients equal those through the fused
    gate's backward chain to 1e-4."""
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models import bert as tbert
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    _, params, fused = _model_pair()
    plain = tbert.MagBertForSequenceClassification(
        BertConfig.tiny(), MultimodalConfig(use_fused_kernel=False), 5, 7,
        device="cpu")
    plain.load_state_dict(params_from_flax(params), strict=True)
    ids, vis, ac, mask = _bert_inputs(2)
    grads = []
    for model in (fused, plain):
        out = model(*map(torch.from_numpy, (ids, vis, ac)),
                    attention_mask=torch.from_numpy(mask))
        out.square().sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert any(".MAG." in k for k in grads[0])
    for k, want in grads[1].items():
        got = grads[0][k]
        assert (got is None) == (want is None), k
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_train_steps_with_fused_gate_match_jax_trainer():
    """Three fp32 train steps at dropout 0 through the fused gate against
    the JAX Trainer with its fused gate: losses to rtol 1e-3."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MeshConfig as JMeshConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert
    from bert_multimodal_transformer_tpu.parallel.mesh import make_mesh
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models import bert as tbert
    from bert_multimodal_transformer_tpu_torch.training import optim
    from bert_multimodal_transformer_tpu_torch.training import trainer
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    def zero_dropout(cfg):
        return dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)

    n_steps, b, s = 3, 8, 12
    jmodel = jbert.MagBertForSequenceClassification(
        zero_dropout(JBertConfig.tiny()),
        JMultimodalConfig(dropout_prob=0.0, use_fused_kernel=True),
        visual_dim=5, acoustic_dim=7)
    rng = np.random.RandomState(4)

    def batch():
        mask = (np.arange(s)[None] < rng.randint(3, s + 1, (b, 1))).astype(
            np.int32)
        return (rng.randint(1, 128, (b, s)).astype(np.int32) * mask,
                rng.randn(b, s, 5).astype(np.float32),
                rng.randn(b, s, 7).astype(np.float32), mask,
                np.zeros((b, s), np.int32),
                rng.uniform(-3, 3, b).astype(np.float32))

    batches = [batch() for _ in range(n_steps)]
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        *batches[0][:4])["params"])
    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(1e-3, n_steps), donate=False,
        mesh=make_mesh(JMeshConfig(data_parallel=1),
                       devices=jax.devices()[:1]))
    jstate = jtr.create_state_from_params(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(1))
    tmodel = tbert.MagBertForSequenceClassification(
        zero_dropout(BertConfig.tiny()),
        MultimodalConfig(dropout_prob=0.0, use_fused_kernel=True), 5, 7,
        device="cpu")
    ttr = trainer.Trainer(model=tmodel,
                          tx=optim.make_optimizer(1e-3, n_steps))
    tstate = ttr.create_state_from_params(params_from_flax(params), 1)
    jl, tl = [], []
    for bt in batches:
        jstate, loss = jtr._train_step(jstate, jtr._put_batch(bt))
        jl.append(float(jax.device_get(loss)))
        tl.append(float(ttr._train_step(tstate, ttr._put_batch(bt))))
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-6)
    assert tl[0] != tl[-1]


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(device, dtype, n_shape, d=768, dv=DV, da=DA, seed=5):
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy(x).to(device) for k, x in _card_params(
        d, dv, da, rng).items()}
    acts = [torch.from_numpy(rng.randn(*n_shape, w).astype(np.float32)).to(
        device, dtype) for w in (d, dv, da, d)]
    return params, acts


def _card_params(d, dv, da, rng):
    """torch-default (Kaiming-uniform) linears, a non-trivial LayerNorm;
    numpy only, so the card's tests need no jax."""
    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {"w_hv_v": u((dv, d), dv + d), "w_hv_t": u((d, d), dv + d),
            "b_hv": u((d,), dv + d), "w_ha_a": u((da, d), da + d),
            "w_ha_t": u((d, d), da + d), "b_ha": u((d,), da + d),
            "w_v": u((dv, d), dv), "b_v": u((d,), dv),
            "w_a": u((da, d), da), "b_a": u((d,), da),
            "ln_gamma": (1 + 0.1 * rng.randn(d)).astype(np.float32),
            "ln_beta": (0.1 * rng.randn(d)).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,d,dv,da", [
    ("bfloat16", (256, 50), 768, 47, 74),   # N = 12800, MOSI
    ("float32", (256, 50), 768, 47, 74),
    ("bfloat16", (3, 33), 768, 35, 74),     # ragged, MOSEI
    ("float32", (2, 9), 1024, 47, 74),      # bert-large width
    ("float32", (1, 5), 32, 3, 2),          # narrow, D not a multiple of 4
    ("bfloat16", (2, 7), 100, 47, 74),      # one block, a partial warp
    ("bfloat16", (2, 50), 1024, 47, 74),    # bert-large: a cluster of 8
    ("bfloat16", (9, 11), 768, 35, 74),     # N = 99, off the 64-row block
])
@pytest.mark.parametrize("beta", BETAS)
def test_kernels_match_plain_on_card(cuda_device, dtype, shape, d, dv, da,
                                     beta):
    params, (t, v, a, dy) = _card_case(cuda_device, getattr(torch, dtype),
                                       shape, d, dv, da)
    before = (tmf.mag_fwd_cuda.launches, tmf.mag_bwd_cuda.launches)
    got = tmf.mag_fwd_cuda(params, t, v, a, beta_shift=beta)
    want = mag_gate(params, t, v, a, beta_shift=beta)
    rows = [x.reshape(-1, x.shape[-1]) for x in (t, v, a, dy)]
    chain = tmf.mag_bwd_cuda(params, *rows, beta_shift=beta)
    chain_ref = tmf.mag_bwd_chain_plain(params, *rows, beta_shift=beta)
    torch.cuda.synchronize()
    assert (tmf.mag_fwd_cuda.launches, tmf.mag_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert bool((err <= 1e-5 + 1e-5 * want.abs()).all())
    else:
        assert bool((err <= 1e-5 + 2 ** -7 * want.float().abs()).all())
    pv = tmf._recompute(tmf._weights(params), *(x.float() for x in rows[:3]),
                        beta)
    # a pre-activation within rounding of 0 may take the other side of the
    # ReLU in the other summation order; those elements are left out
    tie = (pv["pv"].abs() < 1e-5) | (pv["pa"].abs() < 1e-5)
    for g, w in zip(chain, chain_ref):
        bad = ((g - w).abs() > 2e-4 + 2e-4 * w.abs()) & ~tie
        assert not bool(bad.any())


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    params, (t, v, a, dy) = _card_case(cuda_device, torch.float32, (2, 4),
                                       d=64, dv=3, da=5)
    with pytest.raises(ValueError, match="dtype"):
        tmf.mag_fwd_cuda(params, t.half(), v.half(), a.half())
    with pytest.raises(ValueError, match="contiguous"):
        tmf.mag_fwd_cuda(params, t.transpose(0, 1), v, a)
    with pytest.raises(ValueError, match="bfloat16 tensor|float32 tensor"):
        tmf.mag_fwd_cuda(params, t, v.bfloat16(), a)
    with pytest.raises(ValueError, match="param w_hv_t"):
        tmf.mag_fwd_cuda({**params, "w_hv_t": params["w_hv_t"].T}, t, v, a)
    big, _ = _card_case(cuda_device, torch.float32, (1, 1), d=1032, dv=1,
                        da=1)
    with pytest.raises(ValueError, match="D=1032"):
        tmf.mag_fwd_cuda(big, torch.zeros(1, 1032, device=cuda_device),
                         torch.zeros(1, 1, device=cuda_device),
                         torch.zeros(1, 1, device=cuda_device))


@pytest.mark.cuda
def test_autograd_launches_both_kernels(cuda_device):
    params, (t, v, a, _) = _card_case(cuda_device, torch.bfloat16, (4, 50))
    params = {k: p.requires_grad_() for k, p in params.items()}
    before = (tmf.mag_fwd_cuda.launches, tmf.mag_bwd_cuda.launches)
    t.requires_grad_()
    tmf.mag_gate_fused(params, t, v, a).float().square().sum().backward()
    assert (tmf.mag_fwd_cuda.launches - before[0],
            tmf.mag_bwd_cuda.launches - before[1]) == (1, 1)
    assert t.grad.dtype == torch.bfloat16 and v.grad is None
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d,dv,da", [
    ((1, 1), 768, 47, 74),       # one row: one row block, mostly empty
    ((1, 15), 768, 47, 74),
    ((9, 11), 768, 35, 74),      # N = 99 off the 64-row block, MOSEI
    ((48, 50), 768, 47, 74),     # N = 2400, the driver's training batch
    ((2, 50), 1024, 47, 74),     # bert-large: a cluster of 8
    ((3, 33), 1024, 35, 74),
    ((2, 7), 100, 47, 74),       # D off the 8-wide copies, one block
])
@pytest.mark.parametrize("beta", BETAS)
def test_bf16_tensor_core_gate_on_card(cuda_device, shape, d, dv, da,
                                       beta):
    """bf16 #25 on the tensor cores (three weight planes, a cluster a row
    block) against the plain gate within one bf16 rounding (2^-7
    relative plus 1e-5), with a row whose H_m is 0; the same bits
    twice."""
    params, (t, v, a, _) = _card_case(cuda_device, torch.bfloat16, shape, d,
                                      dv, da, seed=sum(shape) + d)
    params["b_v"].zero_()
    params["b_a"].zero_()
    v.view(-1, dv)[0] = 0.0
    a.view(-1, da)[0] = 0.0
    got = tmf.mag_fwd_cuda(params, t, v, a, beta_shift=beta)
    again = tmf.mag_fwd_cuda(params, t, v, a, beta_shift=beta)
    want = mag_gate(params, t, v, a, beta_shift=beta)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-5 + 2 ** -7 * want.float().abs()).all())
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d,dv,da", [
    ((1, 1), 768, 47, 74),
    ((9, 11), 768, 35, 74),      # N = 99 off the 64-row block, MOSEI
    ((48, 50), 768, 47, 74),     # N = 2400, the driver's training batch
    ((3, 33), 1024, 35, 74),     # bert-large: a cluster of 8
    ((2, 7), 100, 47, 74),       # D off the 8-wide copies, one block
])
@pytest.mark.parametrize("beta", BETAS)
def test_bf16_tensor_core_backward_on_card(cuda_device, shape, d, dv, da,
                                           beta):
    """bf16 #26 on the tensor cores against the plain chain within 2e-4
    (ReLU-tie elements left out), with a row whose H_m is 0; the same
    bits twice, and one launch a call."""
    params, (t, v, a, dy) = _card_case(cuda_device, torch.bfloat16, shape,
                                       d, dv, da, seed=sum(shape) + d + 1)
    params["b_v"].zero_()
    params["b_a"].zero_()
    v.view(-1, dv)[0] = 0.0
    a.view(-1, da)[0] = 0.0
    rows = [x.reshape(-1, x.shape[-1]) for x in (t, v, a, dy)]
    before = tmf.mag_bwd_cuda.launches
    got = tmf.mag_bwd_cuda(params, *rows, beta_shift=beta)
    again = tmf.mag_bwd_cuda(params, *rows, beta_shift=beta)
    want = tmf.mag_bwd_chain_plain(params, *rows, beta_shift=beta)
    torch.cuda.synchronize()
    assert tmf.mag_bwd_cuda.launches == before + 2
    r = tmf._recompute(tmf._weights(params), *(x.float() for x in rows[:3]),
                       beta)
    tie = (r["pv"].abs() < 1e-5) | (r["pa"].abs() < 1e-5)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert bool(torch.isfinite(g).all())
        bad = ((g - w).abs() > 2e-4 + 2e-4 * w.abs()) & ~tie
        assert not bool(bad.any())


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
