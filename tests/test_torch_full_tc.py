"""The bf16 tensor-core plans of the full-H attention kernels #1/#8 (the
forward) and #3/#10 (the saved-probs backward), ``csrc/attn_full_tc.cuh``,
emulated in plain torch on the CPU and held against the kernels' plain
versions, plus the plans' shared-memory sizes.

The kernels themselves run only on a card (the tests marked ``cuda`` in
tests/test_torch_fused_attention.py hold them against the plain
versions). What the CPU can hold is each plan's arithmetic: bf16 operands,
products summed in fp32 over 16-deep ``mma.sync`` steps, the row sums in
the plan's lane order (the register plan: a lane's keys in order, then the
quad's xor tree; the shared-memory plan past S = 64: lane-strided, then the
warp's xor tree), p = e / sum, the keep bit handed out by the register
plan's lane pairs, PV from the dropped probs rounded to bf16. Geometry: B=2,
H=2, Dh=16 (one k16 step) and Dh=40 (a padded one), one batch row masked
whole. Tolerances as tests/test_torch_fused_attention.py: the forward
within one bf16 rounding (2^-7 relative plus 2^-6 absolute) of
``attn_fwd_packed_reference``; the backward within ``dqkv_bf16_bound`` of
``attn_bwd_packed_saved_reference``; the keep mask bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.ops.kernels import MAX_SMEM_BYTES

H = 2
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6
HEADER = (Path(tfa.__file__).resolve().parents[1] / "csrc"
          / "attn_full_tc.cuh")


def _case(s, dh, seed):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(2, s, 3 * H * dh).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, s, H * dh).astype(np.float32))
    mask = np.ones((2, s), np.int32)
    mask[0] = 0                               # a batch row masked whole
    mask[1, 2 * s // 3:] = 0
    return (qkv.to(torch.bfloat16), torch.from_numpy(mask).float(),
            g.to(torch.bfloat16))


def _rows16(s):
    return -(-s // 16) * 16


def _pad_keys(x, n):
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _mma_abt(a, b):
    """a [.., M, K] · b [.., N, K]ᵀ for bf16 a, b: each 16-deep step summed
    exactly (a bf16 product is exact in fp32), the steps added in fp32."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c in range(0, a.shape[-1], 16):
        acc = acc + torch.matmul(a[..., c:c + 16].double(),
                                 b[..., c:c + 16].double().transpose(
                                     -1, -2)).float()
    return acc


def _quad_sum(x):
    """Σ over the last axis (16-padded keys) in the register plan's order:
    lane t4 adds its keys 8t + 2·t4 + u in order (t, u), then the quad's
    xor tree ((l0 + l1) + (l2 + l3))."""
    lead, n = x.shape[:-1], x.shape[-1]
    lanes = x.reshape(*lead, n // 8, 4, 2).movedim(-2, 0).reshape(
        4, *lead, n // 4)
    acc = torch.zeros((4,) + tuple(lead))
    for i in range(n // 4):
        acc = acc + lanes[..., i]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _warp_sum(x):
    """Σ over the last axis in the shared-memory plan's order (#4's
    whole-row softmax): lane l adds keys l, l + 32, ..., then the warp's
    xor tree (16, 8, 4, 2, 1)."""
    n = x.shape[-1]
    x = _pad_keys(x, -(-n // 32) * 32)
    lanes = x.reshape(*x.shape[:-1], -1, 32)
    acc = torch.zeros(lanes.shape[:-2] + (32,))
    for u in range(lanes.shape[-2]):
        acc = acc + lanes[..., u, :]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ o]
    return acc[..., 0]


def _lane_pair_draws(bits):
    """The draws the register plan hands each element (``keep_words``):
    for slab m0, n8 key tile t and lane L (rows q_lo = m0 + L / 4 and
    q_lo + 8, keys 8t + 2·(L % 4) + {0, 1}) lane L draws the Philox block
    of key group (8t + 4·((L % 4) >> 1)) >> 2 at row q_lo (L even) or
    q_lo + 8 (L odd), sends word z, w (even) or x, y (odd) to lane L ^ 1
    and keeps the two words of its own keys. bits: the stream's draws
    [B, H, Q16, K16] (row q, key k: word k & 3 of block (k >> 2, q); S16
    both here, Q and K rounded up to 16 in the rel plan's)."""
    b, h, qp, kp = bits.shape
    words = bits.reshape(b, h, qp, kp // 4, 4)
    lane = torch.arange(32)
    odd, t4, g = lane & 1, lane & 3, lane >> 2
    out = torch.zeros_like(bits)
    for m0 in range(0, qp, 16):
        for t in range(kp // 8):
            k4 = (8 * t + 4 * (t4 >> 1)) >> 2
            own = words[:, :, m0 + g + 8 * odd, k4, :]    # [b, h, 32, 4]
            sent = torch.where(odd.bool()[:, None], own[..., 0:2],
                               own[..., 2:4])
            got = sent[:, :, lane ^ 1, :]
            wd = torch.where(odd.bool()[:, None],
                             torch.cat([got, own[..., 2:4]], -1),
                             torch.cat([own[..., 0:2], got], -1))
            for e in range(4):
                q = m0 + g + 8 * (e >> 1)
                k = 8 * t + 2 * t4 + (e & 1)
                out[:, :, q, k] = wd[..., e]
    return out


def _fwd_plan(qkv, mask, scale, rate, seed):
    """bf16 #1's plan in plain torch: returns (out, p, pd) as the kernel
    writes them, and the keep mask the plan applied."""
    q, k, v = tfa._heads(qkv, H)
    b, _, s, _ = q.shape
    reg = s <= tfa.FULL_TC_REG_MAX_SEQ_LEN
    sc = (_mma_abt(q, k) * scale
          + tfa._bias(mask, b, s, qkv.device)[:, None, None, :])
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    total = _quad_sum(_pad_keys(e, _rows16(s))) if reg else _warp_sum(e)
    p = e / total[..., None]
    keep = torch.ones_like(p, dtype=torch.bool)
    if rate > 0.0:
        sp = _rows16(s)
        bits = tfa.dropout_bits(seed, b, H, sp, sp)
        if reg:
            bits = _lane_pair_draws(bits)
        keep = bits[..., :s, :s] >= tfa.dropout_threshold(rate)
    pd = torch.where(keep, p * tfa.inv_keep(rate), 0.0) if rate > 0 else p
    out = _mma_abt(pd.to(torch.bfloat16), v.transpose(-1, -2))
    out = out.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, -1)
    return (out, p.to(torch.bfloat16), pd.to(torch.bfloat16)), keep


def _bwd_plan(p, pd, qkv, g, scale):
    """bf16 #3's plan in plain torch: dqkv [B, S, 3·D]."""
    q, k, v = tfa._heads(qkv, H)
    gh = tfa._ctx_heads(g, H)
    s = q.shape[2]
    t = pd.float() * _mma_abt(gh, v)
    total = _quad_sum(_pad_keys(t, _rows16(s)))
    ds_c = ((t - p.float() * total[..., None]) * scale).to(torch.bfloat16)
    dq = _mma_abt(ds_c, k.transpose(-1, -2))
    dk = _mma_abt(ds_c.transpose(-1, -2), q.transpose(-1, -2))
    dv = _mma_abt(pd.transpose(-1, -2), gh.transpose(-1, -2))
    return tfa._pack(*(x.to(torch.bfloat16) for x in (dq, dk, dv)))


def _close(got, want):
    got, want = got.float(), want.float()
    assert bool(((got - want).abs()
                 <= BF16_ATOL + BF16_RTOL * want.abs()).all())


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40), (140, 16)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_plan_matches_the_plain_forward(s, dh, rate):
    """bf16 #1's plan (the register plan at S=50 and 33, #4's score tile at
    S=140) gives the plain forward's out, p and pd within one bf16
    rounding, and the lane pairs hand out the stream's keep mask bit for
    bit."""
    qkv, mask, _ = _case(s, dh, seed=s + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 61 + 33
    got, keep = _fwd_plan(qkv, mask, scale, rate, seed)
    want = tfa.attn_fwd_packed_reference(qkv, mask, n_heads=H, scale=scale,
                                         rate=rate, seed=seed, save=True)
    for x, y in zip(got, want):
        _close(x, y)
    if rate > 0:
        assert torch.equal(keep, tfa.dropout_keep_mask(seed, 2, H, s, s,
                                                       rate))
        live = got[1] > 0
        assert torch.equal((got[2] > 0)[live], keep[live])


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40), (140, 16)])
def test_backward_plan_matches_the_plain_backward(s, dh):
    """bf16 #3's plan, on the plain forward's saved p and pd at rate 0.1,
    gives the plain backward's dqkv within ``dqkv_bf16_bound``."""
    qkv, mask, g = _case(s, dh, seed=2 * s + dh)
    scale = 1.0 / dh ** 0.5
    _, p, pd = tfa.attn_fwd_packed_reference(
        qkv, mask, n_heads=H, scale=scale, rate=0.1, seed=7, save=True)
    got = _bwd_plan(p, pd, qkv, g, scale)
    want = tfa.attn_bwd_packed_saved_reference(p, pd, qkv, g, n_heads=H,
                                               scale=scale)
    bound = tfa.dqkv_bf16_bound(want, p, pd, qkv, g, n_heads=H, scale=scale)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    assert float(want[1].abs().max()) > 1e-3


def _header_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text()).group(1))


def test_plans_fit_every_reachable_shape():
    """Every S the wrappers take fits its bf16 plan at every head width:
    the forward up to ``MAX_SEQ_LEN``, the backward up to
    ``max_bwd_seq_len`` (the fp32 plan's reach, which bf16 keeps), whose
    S rounded up to 16 the backward's builds hold (their n8 key tiles in
    the header); the register plan's reach is the header's."""
    assert _header_constant("kRegMaxS") == tfa.FULL_TC_REG_MAX_SEQ_LEN
    tiles = {64: _header_constant("kBwdTiles64"),
             128: _header_constant("kBwdTiles128")}
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for s in range(1, tfa.MAX_SEQ_LEN + 1):
            assert tfa.full_tc_fwd_smem_bytes(s, dh) <= MAX_SMEM_BYTES
        reach = tfa.max_bwd_seq_len(dh)
        for s in range(1, reach + 1):
            assert tfa.full_tc_bwd_smem_bytes(s, dh) <= MAX_SMEM_BYTES
        assert _rows16(reach) // 8 <= tiles[64 if dh <= 64 else 128]
    assert tfa.full_tc_fwd_smem_bytes(50, 64) == 27904
    assert tfa.full_tc_bwd_smem_bytes(50, 64) == 55296
    assert tfa.full_tc_fwd_smem_bytes(65, 64) == tfa.hb_fwd_smem_bytes(65, 64)
