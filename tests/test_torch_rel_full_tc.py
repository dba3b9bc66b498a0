"""The bf16 tensor-core plans of the rel full-H attention kernels #11 (the
forward), #13 (the saved-probs backward) and #12 (the recompute backward:
#11's probs again, then #13's phases), ``csrc/attn_rel_full_tc.cuh``,
emulated in plain torch on the CPU and held against the kernels' plain
versions, plus the plans' shared-memory sizes over the whole reach.

The kernels themselves run only on a card (the tests marked ``cuda`` in
tests/test_torch_rel_attention.py hold them against the plain versions,
and those at the end of this file hold bf16 #12 at its plan's edges).
What the CPU can hold is each plan's arithmetic: bf16 operands, products
summed in fp32 over 16-deep ``mma.sync`` steps, s = (dot · scale) + ebias
in fp32, the row sums in the plan's lane order (the register plan up to
K = 64 and the backward: a lane's keys in order, then the quad's xor tree;
the score-tile forward past K = 64: lane-strided, then the warp's xor
tree), p = e / sum, the keep bits handed out by the register plan's lane
pairs, PV from the dropped probs rounded to bf16; the backward's debias
= bf16(ds) beside ds_c = bf16(ds · scale). Geometry: B=2, H=2, (Q, K) =
(50, 50), (33, 57) and (50, 100) at Dh=16 (one k16 step) and Dh=40 (a
padded one), batch row 0 masked whole (−1e30 on every key). Tolerances as
tests/test_torch_rel_attention.py: the forward within one bf16 rounding
(2^-7 relative plus 2^-6 absolute) of ``attn_fwd_rel_reference``, the
masked rows exactly uniform; the backward within ``rel_grads_bf16_bound``
of ``attn_bwd_rel_saved_reference`` (#12's, on the fp32 p and pd its
plan rebuilds, of ``attn_bwd_rel_reference``), debias included; the keep
mask bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.kernels import MAX_SMEM_BYTES
from test_torch_full_tc import (  # #1's and #3's plan pieces
    _lane_pair_draws,
    _mma_abt,
    _pad_keys,
    _quad_sum,
    _rows16,
    _warp_sum,
)

H = 2
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6
HEADER = (Path(tfa.__file__).resolve().parents[1] / "csrc"
          / "attn_rel_full_tc.cuh")
SHAPES = [(50, 50), (33, 57), (50, 100)]


def _case(q_len, k_len, dh, seed):
    """Seeded bf16 q, g [2, Q, H·Dh], k, v [2, K, H·Dh] and an ebias
    [2, H, Q, K] of O(1), batch row 0 masked whole, row 1's first keys
    masked (left padding)."""
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(2, q_len, H * dh).astype(np.float32) for _ in "qg")
    k, v = (rng.randn(2, k_len, H * dh).astype(np.float32) for _ in "kv")
    eb = (rng.randn(2, H, q_len, k_len) * 0.5).astype(np.float32)
    eb[0] = -1e30
    eb[1, :, :, :k_len // 4] -= 1e30
    return tuple(torch.from_numpy(x).to(torch.bfloat16)
                 for x in (q, k, v, eb, g))


def _probs_plan(q, k, eb, scale, rate, seed):
    """p and pd (fp32) as bf16 #11's plans build them (the register plan
    to K = 64: quad order, lane-pair bits; past it the score tile's
    whole-row order), and the keep mask they apply; #12 rebuilds the
    same."""
    qh, kh = (tfa._ctx_heads(x, H) for x in (q, k))
    b, _, q_len, _ = qh.shape
    k_len = kh.shape[2]
    reg = k_len <= tfa.REL_TC_REG_MAX_K
    sc = _mma_abt(qh, kh) * scale + eb.float()
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    total = (_quad_sum(_pad_keys(e, _rows16(k_len))) if reg
             else _warp_sum(e))
    p = e / total[..., None]
    keep = torch.ones_like(p, dtype=torch.bool)
    if rate > 0.0:
        bits = tfa.dropout_bits(seed, b, H, _rows16(q_len), _rows16(k_len))
        if reg:
            bits = _lane_pair_draws(bits)
        keep = bits[..., :q_len, :k_len] >= tfa.dropout_threshold(rate)
    pd = torch.where(keep, p * tfa.inv_keep(rate), 0.0) if rate > 0 else p
    return p, pd, keep


def _fwd_plan(q, k, v, eb, scale, rate, seed):
    """bf16 #11's plan in plain torch: returns (out, p, pd) as the kernel
    writes them, and the keep mask the plan applied."""
    p, pd, keep = _probs_plan(q, k, eb, scale, rate, seed)
    out = _mma_abt(pd.to(torch.bfloat16),
                   tfa._ctx_heads(v, H).transpose(-1, -2))
    out = tfa._merge_heads(out.to(torch.bfloat16))
    return (out, p.to(torch.bfloat16), pd.to(torch.bfloat16)), keep


def _bwd_plan(p, pd, q, k, v, g, scale):
    """bf16 #13's phases in plain torch: (dq, dk, dv, debias) from p and pd
    (#13 reads them rounded to bf16, #12 rebuilds them in fp32); dV from
    pd_c = bf16(pd)."""
    qh, kh, vh, gh = (tfa._ctx_heads(x, H) for x in (q, k, v, g))
    k_len = kh.shape[2]
    t = pd.float() * _mma_abt(gh, vh)
    total = _quad_sum(_pad_keys(t, _rows16(k_len)))
    ds = t - p.float() * total[..., None]
    ds_c = (ds * scale).to(torch.bfloat16)
    dq = _mma_abt(ds_c, kh.transpose(-1, -2))
    dk = _mma_abt(ds_c.transpose(-1, -2), qh.transpose(-1, -2))
    dv = _mma_abt(pd.to(torch.bfloat16).transpose(-1, -2),
                  gh.transpose(-1, -2))
    return (*(tfa._merge_heads(x.to(torch.bfloat16)) for x in (dq, dk, dv)),
            ds.to(torch.bfloat16))


def _close(got, want):
    got, want = got.float(), want.float()
    assert bool(((got - want).abs()
                 <= BF16_ATOL + BF16_RTOL * want.abs()).all())


@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("dh", [16, 40])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_plan_matches_the_plain_forward(q_len, k_len, dh, rate):
    """bf16 #11's plan (the register plan at K = 50 and 57, #14's score
    tile at K = 100) gives the plain forward's out, p and pd within one
    bf16 rounding, the rows masked whole come out uniform, and the lane
    pairs hand out the stream's keep mask bit for bit."""
    q, k, v, eb, _ = _case(q_len, k_len, dh, seed=q_len + k_len + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 61 + 33
    got, keep = _fwd_plan(q, k, v, eb, scale, rate, seed)
    want = tfa.attn_fwd_rel_reference(q, k, v, eb, n_heads=H, scale=scale,
                                      rate=rate, seed=seed, save=True)
    for x, y in zip(got, want):
        _close(x, y)
    uniform = torch.full_like(got[1][0], 1.0 / k_len)
    assert torch.equal(got[1][0], uniform)
    assert torch.equal(want[1][0], uniform)
    if rate > 0:
        assert torch.equal(keep, tfa.dropout_keep_mask(seed, 2, H, q_len,
                                                       k_len, rate))
        live = got[1] > 0
        assert torch.equal((got[2] > 0)[live], keep[live])


@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("dh", [16, 40])
def test_backward_plan_matches_the_plain_backward(q_len, k_len, dh):
    """bf16 #13's plan, on the plain forward's saved p and pd at rate 0.1,
    gives the plain backward's dq, dk, dv and unscaled debias within
    ``rel_grads_bf16_bound``."""
    q, k, v, eb, g = _case(q_len, k_len, dh, seed=2 * q_len + k_len + dh)
    scale = 1.0 / dh ** 0.5
    _, p, pd = tfa.attn_fwd_rel_reference(q, k, v, eb, n_heads=H,
                                          scale=scale, rate=0.1, seed=7,
                                          save=True)
    got = _bwd_plan(p, pd, q, k, v, g, scale)
    want = tfa.attn_bwd_rel_saved_reference(p, pd, q, k, v, g, n_heads=H,
                                            scale=scale)
    bounds = tfa.rel_grads_bf16_bound(want, p, pd, q, k, v, g, n_heads=H,
                                      scale=scale)
    for a, w, bd in zip(got, want, bounds):
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    assert float(want[1].abs().max()) > 1e-3
    assert float(want[3].abs().max()) > 1e-3


def _header_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text()).group(1))


def _q_reach(k_len, dh):
    """The longest Q that ``rel_bwd_fits`` admits at (K, Dh) (0: none):
    its plan is linear in Q."""
    q = (MAX_SMEM_BYTES // 4 - k_len * (dh + 1)) // (dh + 1 + 2 * k_len)
    while q > 0 and not tfa.rel_bwd_fits(q, k_len, dh):
        q -= 1
    assert not tfa.rel_bwd_fits(q + 1, k_len, dh)
    return max(q, 0)


def test_plans_fit_every_reachable_shape():
    """Every (Q, K, Dh) that ``rel_tier`` sends to the full tier fits its
    bf16 plan: the forward at every K ≤ ``MAX_SEQ_LEN`` (its plan grows
    with Q only up to a 64-row tile), the backward over ``rel_bwd_fits``
    (K ≤ 512) with a query chunk of 16 rows or more, all of Q in one chunk
    but for Q > 944 at K ≤ 21. The header's constants are Python's."""
    assert _header_constant("kRegMaxK") == tfa.REL_TC_REG_MAX_K
    assert _header_constant("kMaxK") == tfa.MAX_SEQ_LEN
    assert _header_constant("kRegQTile") == 64
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for k_len in range(1, tfa.MAX_SEQ_LEN + 1):
            assert tfa.rel_full_tc_fwd_smem_bytes(64, k_len, dh) <= (
                MAX_SMEM_BYTES)
            reach = _q_reach(k_len, dh)
            if reach == 0:
                continue
            # one chunk holds every Q up to the last that fits whole; past
            # it the chunk stays the same (the plan no longer grows with Q)
            whole = reach
            while whole and tfa.rel_full_tc_bwd_smem_bytes(
                    _rows16(whole), k_len, dh) > MAX_SMEM_BYTES:
                whole -= 1
            assert tfa.rel_full_tc_bwd_q_chunk(whole, k_len, dh) == (
                _rows16(whole))
            for q_len in {whole + 1, reach} - {reach + 1}:
                if q_len > whole:
                    assert k_len <= 21 and q_len > 944
                    qc = tfa.rel_full_tc_bwd_q_chunk(q_len, k_len, dh)
                    assert 16 <= qc < q_len
                    assert tfa.rel_full_tc_bwd_smem_bytes(
                        qc, k_len, dh, multi=True) <= MAX_SMEM_BYTES
    assert tfa.rel_full_tc_fwd_smem_bytes(50, 50, 64) == 27648
    assert tfa.rel_full_tc_fwd_smem_bytes(200, 50, 64) == (64 + 128) * 72 * 2
    assert tfa.rel_full_tc_fwd_smem_bytes(50, 100, 64) == (
        tfa.rel_hb_fwd_smem_bytes(100, 64))
    assert tfa.rel_full_tc_bwd_smem_bytes(64, 50, 64) == 36864
    assert tfa.rel_full_tc_bwd_q_chunk(2000, 8, 8) == 1600


@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("dh", [16, 40])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_recompute_plan_matches_the_plain_backward(q_len, k_len, dh, rate):
    """bf16 #12's plan (p and the keep mask rebuilt by #11's register plan
    at K = 50 and 57, by #14's score-tile order at K = 100; then #13's
    phases on the fp32 p and pd) gives the plain recompute backward's dq,
    dk, dv and unscaled debias within ``rel_grads_bf16_bound``, Q ≠ K
    included."""
    q, k, v, eb, g = _case(q_len, k_len, dh, seed=3 * q_len + k_len + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 59 + 7
    p, pd, _ = _probs_plan(q, k, eb, scale, rate, seed)
    got = _bwd_plan(p, pd, q, k, v, g, scale)
    want = tfa.attn_bwd_rel_reference(q, k, v, eb, seed, g, n_heads=H,
                                      scale=scale, rate=rate)
    _, p_r, pd_r = tfa.attn_fwd_rel_reference(q, k, v, eb, n_heads=H,
                                              scale=scale, rate=rate,
                                              seed=seed, save=True)
    bounds = tfa.rel_grads_bf16_bound(want, p_r, pd_r, q, k, v, g,
                                      n_heads=H, scale=scale)
    for a, w, bd in zip(got, want, bounds):
        assert a.shape == w.shape
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    assert float(want[1].abs().max()) > 1e-3
    assert float(want[3].abs().max()) > 1e-3


def test_recompute_plan_fits_every_reachable_shape():
    """bf16 #12's plan (the fp32 probs tile beside #13's staging) takes
    every (Q, K, Dh) that ``rel_bwd_fits`` admits with a query chunk of 16
    rows or more; its four-warp build's blocks an SM (every shape with Q,
    K ≤ 64 at Dh ≤ 64) fit the SM's 228 KB, 1 KB reserved each; the sizes
    in the header's notes are Python's."""
    blocks = _header_constant("kRcSmallBlocks")
    assert _header_constant("kRcSmallThreads") == 4 * 32
    assert blocks * (tfa.rel_full_tc_bwd_smem_bytes(
        64, 64, 64, recompute=True) + 1024) <= 228 * 1024
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for k_len in range(1, tfa.MAX_SEQ_LEN + 1):
            reach = _q_reach(k_len, dh)
            for q_len in {1, (reach + 1) // 2, reach} if reach else ():
                qc = tfa.rel_full_tc_bwd_q_chunk(q_len, k_len, dh,
                                                 recompute=True)
                assert qc >= 16 and qc % 16 == 0
                assert tfa.rel_full_tc_bwd_smem_bytes(
                    qc, k_len, dh, multi=qc < q_len,
                    recompute=True) <= MAX_SMEM_BYTES
    assert tfa.rel_full_tc_bwd_smem_bytes(64, 50, 64, recompute=True) == (
        45056)
    assert tfa.rel_full_tc_bwd_smem_bytes(64, 100, 64, recompute=True) == (
        70400)
    assert tfa.rel_full_tc_bwd_q_chunk(141, 141, 64, recompute=True) == 144
    assert tfa.rel_full_tc_bwd_q_chunk(2000, 8, 8, recompute=True) == 1296


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 #12's edges, as chip_smoke.py's REL_TC_EDGES (B, Q, K, H, Dh): the
# serving shape, the memory's K = 100 (the score tile), Q = 33 at K = 141
# (odd K, two d(pd) passes), Dh = 128 in both probs plans; and the plan's
# own: K = 64 and 65, Q = K = 141 (the reach, 8 warps), Q = 77 at K = 57,
# Dh = 40, Q = 2000 at K = 8, Dh = 8 (query chunks).
RC_EDGES = [
    (4, 50, 50, 12, 64),
    (4, 50, 100, 12, 64),
    (2, 33, 141, 12, 64),
    (2, 50, 50, 6, 128),
    (2, 50, 100, 6, 128),
    (3, 64, 64, 4, 64),
    (3, 50, 65, 4, 64),
    (2, 141, 141, 2, 64),
    (3, 77, 57, 4, 40),
    (2, 2000, 8, 2, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,q_len,k_len,h,dh", RC_EDGES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_recompute_kernel_on_card(cuda_device, b, q_len, k_len, h, dh,
                                  rate):
    """bf16 #12 against its plain version and against #13 on the plain
    forward's saved probs, within ``rel_grads_bf16_bound`` (a query row
    masked whole, the ragged rows of ``_card_case``), the same bits
    twice."""
    q, k, v, eb, g = (x.to(cuda_device) for x in _card_case(
        b, q_len, k_len, h, dh))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    seed = 2 ** 60 + q_len + k_len
    got = tfa.attn_bwd_rel_cuda(q, k, v, eb, seed, g, rate=rate, **kw)
    want = tfa.attn_bwd_rel_reference(q, k, v, eb, seed, g, rate=rate, **kw)
    _, p, pd = tfa.attn_fwd_rel_reference(q, k, v, eb, rate=rate, seed=seed,
                                          save=True, **kw)
    saved = tfa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw)
    bounds = tfa.rel_grads_bf16_bound(want, p, pd, q, k, v, g, **kw)
    for ref in (want, saved):
        for a, w, bd in zip(got, ref, bounds):
            assert bool(torch.isfinite(a).all())
            assert bool(((a.float() - w.float()).abs() <= bd).all())
    again = tfa.attn_bwd_rel_cuda(q, k, v, eb, seed, g, rate=rate, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def _card_case(b, q_len, k_len, h, dh):
    """bf16 q, g [B, Q, h·Dh], k, v [B, K, h·Dh] and an O(1) ebias
    [B, h, Q, K]: batch row 0's query row 1 masked whole, each row's first
    keys masked from a seeded length on (left padding)."""
    rng = np.random.RandomState(q_len * 13 + k_len + dh)
    q, g = (rng.randn(b, q_len, h * dh).astype(np.float32) for _ in "qg")
    k, v = (rng.randn(b, k_len, h * dh).astype(np.float32) for _ in "kv")
    eb = (rng.randn(b, h, q_len, k_len) * 0.5).astype(np.float32)
    pad = rng.randint(0, k_len // 2 + 1, size=b)
    for i in range(b):
        eb[i, :, :, :pad[i]] -= 1e30
    eb[0, 0, min(1, q_len - 1)] = -1e30
    return tuple(torch.from_numpy(x).to(torch.bfloat16)
                 for x in (q, k, v, eb, g))
