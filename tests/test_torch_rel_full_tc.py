"""The bf16 tensor-core plans of the rel full-H attention kernels #11 (the
forward) and #13 (the saved-probs backward), ``csrc/attn_rel_full_tc.cuh``,
emulated in plain torch on the CPU and held against the kernels' plain
versions, plus the plans' shared-memory sizes over the whole reach.

The kernels themselves run only on a card (the tests marked ``cuda`` in
tests/test_torch_rel_attention.py hold them against the plain versions).
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
of ``attn_bwd_rel_saved_reference``, debias included; the keep mask bit
for bit.
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


def _fwd_plan(q, k, v, eb, scale, rate, seed):
    """bf16 #11's plan in plain torch: returns (out, p, pd) as the kernel
    writes them, and the keep mask the plan applied."""
    qh, kh, vh = (tfa._ctx_heads(x, H) for x in (q, k, v))
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
    out = _mma_abt(pd.to(torch.bfloat16), vh.transpose(-1, -2))
    out = tfa._merge_heads(out.to(torch.bfloat16))
    return (out, p.to(torch.bfloat16), pd.to(torch.bfloat16)), keep


def _bwd_plan(p, pd, q, k, v, g, scale):
    """bf16 #13's plan in plain torch: (dq, dk, dv, debias)."""
    qh, kh, vh, gh = (tfa._ctx_heads(x, H) for x in (q, k, v, g))
    k_len = kh.shape[2]
    t = pd.float() * _mma_abt(gh, vh)
    total = _quad_sum(_pad_keys(t, _rows16(k_len)))
    ds = t - p.float() * total[..., None]
    ds_c = (ds * scale).to(torch.bfloat16)
    dq = _mma_abt(ds_c, kh.transpose(-1, -2))
    dk = _mma_abt(ds_c.transpose(-1, -2), qh.transpose(-1, -2))
    dv = _mma_abt(pd.transpose(-1, -2), gh.transpose(-1, -2))
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
