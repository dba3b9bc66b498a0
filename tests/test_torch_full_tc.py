"""The bf16 tensor-core plans of the full-H attention kernels #1/#8 (the
forward), #3/#10 (the saved-probs backward) and #9/#2 (the recompute
backward), ``csrc/attn_full_tc.cuh``, emulated in plain torch on the CPU
and held against the kernels' plain versions, plus the plans'
shared-memory sizes.

The kernels themselves run only on a card (the tests marked ``cuda`` in
tests/test_torch_fused_attention.py hold them against the plain
versions). What the CPU can hold is each plan's arithmetic: bf16 operands,
products summed in fp32 over 16-deep ``mma.sync`` steps, the row sums in
the plan's lane order (the register plan: a lane's keys in order, then the
quad's xor tree; the shared-memory plan past S = 64: lane-strided, then the
warp's xor tree), p = e / sum, the keep bit handed out by the register
plan's lane pairs, PV from the dropped probs rounded to bf16; the
recompute backward rebuilds p and the keep mask with the forward's plan
(at a shard's offsets for #9), then runs #3's arithmetic on them in fp32.
Geometry: B=2, H=2, Dh=16 (one k16 step) and Dh=40 (a padded one), one
batch row masked whole. Tolerances as tests/test_torch_fused_attention.py:
the forward within one bf16 rounding (2^-7 relative plus 2^-6 absolute) of
``attn_fwd_packed_reference``; the backwards within ``dqkv_bf16_bound``
(``split_grads_bf16_bound``) of ``attn_bwd_packed_saved_reference``,
``attn_bwd_packed_reference`` and ``attn_bwd_split_reference``; the keep
mask bit for bit. The tests marked ``cuda`` hold bf16 #9 and #2 on the card
at the plan's edges.
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


def _probs_plan(q, k, mask, scale, rate, seed, b_off=0, h_off=0):
    """p (fp32) and pd as #1's plans build them from q, k [B, H, S, Dh]
    (the register plan to S = 64: quad order, lane-pair bits; past it the
    score tile's whole-row order), the keep mask at the Philox counter's
    (b + b_off, h + h_off); #2/#9 rebuild the same."""
    b, h, s, _ = q.shape
    reg = s <= tfa.FULL_TC_REG_MAX_SEQ_LEN
    sc = (_mma_abt(q, k) * scale
          + tfa._bias(mask, b, s, q.device)[:, None, None, :])
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    total = _quad_sum(_pad_keys(e, _rows16(s))) if reg else _warp_sum(e)
    p = e / total[..., None]
    keep = torch.ones_like(p, dtype=torch.bool)
    if rate > 0.0:
        sp = _rows16(s)
        bits = tfa.dropout_bits(seed, b, h, sp, sp, b0=b_off, h0=h_off)
        if reg:
            bits = _lane_pair_draws(bits)
        keep = bits[..., :s, :s] >= tfa.dropout_threshold(rate)
    pd = torch.where(keep, p * tfa.inv_keep(rate), 0.0) if rate > 0 else p
    return p, pd, keep


def _fwd_plan(qkv, mask, scale, rate, seed):
    """bf16 #1's plan in plain torch: returns (out, p, pd) as the kernel
    writes them, and the keep mask the plan applied."""
    q, k, v = tfa._heads(qkv, H)
    b, _, s, _ = q.shape
    p, pd, keep = _probs_plan(q, k, mask, scale, rate, seed)
    out = _mma_abt(pd.to(torch.bfloat16), v.transpose(-1, -2))
    out = out.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, -1)
    return (out, p.to(torch.bfloat16), pd.to(torch.bfloat16)), keep


def _vjp_plan(p, pd, q, k, v, gh, scale):
    """#3's phases in plain torch on q, k, v, g [B, H, S, Dh] from p and pd
    (fp32 values: #3 reads them rounded, #2/#9 rebuild them): (dq, dk, dv)
    in bf16."""
    s = q.shape[2]
    t = pd.float() * _mma_abt(gh, v)
    total = _quad_sum(_pad_keys(t, _rows16(s)))
    ds_c = ((t - p.float() * total[..., None]) * scale).to(torch.bfloat16)
    dq = _mma_abt(ds_c, k.transpose(-1, -2))
    dk = _mma_abt(ds_c.transpose(-1, -2), q.transpose(-1, -2))
    dv = _mma_abt(pd.to(torch.bfloat16).transpose(-1, -2),
                  gh.transpose(-1, -2))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _bwd_plan(p, pd, qkv, g, scale):
    """bf16 #3's plan in plain torch: dqkv [B, S, 3·D]."""
    return tfa._pack(*_vjp_plan(p, pd, *tfa._heads(qkv, H),
                                tfa._ctx_heads(g, H), scale))


def _rc_bwd_plan(q, k, v, mask, gh, scale, rate, seed, b_off=0, h_off=0):
    """bf16 #9's (and, at no offset, #2's) plan in plain torch: p rebuilt
    by #1's plan, the keep mask replayed at the offsets, then #3's phases
    on the fp32 p and pd. Returns (dq, dk, dv)."""
    p, pd, _ = _probs_plan(q, k, mask, scale, rate, seed, b_off, h_off)
    return _vjp_plan(p, pd, q, k, v, gh, scale)


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


@pytest.mark.parametrize("s,dh", [(50, 16), (33, 40), (140, 16)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["split", "packed"])
def test_recompute_plan_matches_the_plain_backward(s, dh, rate, layout):
    """bf16 #9's plan (p rebuilt by #1's register plan at S = 50 and 33, by
    the score tile's order at S = 140; the keep mask replayed at a shard's
    offsets) gives ``attn_bwd_split_reference``'s dq, dk, dv within
    ``split_grads_bf16_bound``; at no offset, on the packed layout, #2's
    ``attn_bwd_packed_reference``'s dqkv within ``dqkv_bf16_bound``."""
    qkv, mask, g = _case(s, dh, seed=3 * s + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 58 + 11
    q, k, v = tfa._heads(qkv, H)
    gh = tfa._ctx_heads(g, H)
    off = dict(b_off=5, h_off=H) if layout == "split" else {}
    got = _rc_bwd_plan(q, k, v, mask, gh, scale, rate, seed, **off)
    if layout == "split":
        want = tfa.attn_bwd_split_reference(q, k, v, mask, seed, gh,
                                            scale=scale, rate=rate, **off)
        _, p, pd = tfa.attn_fwd_split_reference(q, k, v, mask, scale=scale,
                                                rate=rate, seed=seed,
                                                save=True, **off)
        bounds = tfa.split_grads_bf16_bound(want, p, pd, q, k, v, gh,
                                            scale=scale)
    else:
        got = (tfa._pack(*got),)
        want = (tfa.attn_bwd_packed_reference(qkv, mask, seed, g, n_heads=H,
                                              scale=scale, rate=rate),)
        _, p, pd = tfa.attn_fwd_packed_reference(qkv, mask, n_heads=H,
                                                 scale=scale, rate=rate,
                                                 seed=seed, save=True)
        bounds = (tfa.dqkv_bf16_bound(want[0], p, pd, qkv, g, n_heads=H,
                                      scale=scale),)
    for a, w, bd in zip(got, want, bounds):
        assert a.shape == w.shape
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    assert float(want[0].abs().max()) > 1e-3


def test_recompute_plan_fits_every_reachable_shape():
    """bf16 #2/#9's plan fits every S up to ``max_bwd_seq_len`` at every
    head width (the reach ``split_tier`` and ``packed_tier`` keep), its
    block of S16 / 16 warps within the header's most, and the blocks an SM
    of its S ≤ 64 build within the SM's shared memory; the sizes in the
    header's notes are Python's."""
    most = _header_constant("kMaxBwdRcWarps")
    assert _header_constant("kRcTiles") == 8
    widest = 0
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        reach = tfa.max_bwd_seq_len(dh)
        for s in range(1, reach + 1):
            assert tfa.full_tc_bwd_recompute_smem_bytes(s, dh) <= (
                MAX_SMEM_BYTES)
        widest = max(widest, _rows16(reach) // 16)
        assert tfa.split_tier(reach, dh, True) == "full"
        assert tfa.split_tier(reach + 1, dh, True) != "full"
    assert widest == most
    # the S ≤ 64 build's blocks an SM fit its 228 KB (1 KB reserved each)
    blocks = _header_constant("kRcSmallBlocks")
    assert blocks * (tfa.full_tc_bwd_recompute_smem_bytes(64, 64)
                     + 1024) <= 228 * 1024
    assert tfa.full_tc_bwd_recompute_smem_bytes(50, 64) == 45312
    assert tfa.full_tc_bwd_recompute_smem_bytes(140, 64) == 171072
    assert tfa.full_tc_bwd_recompute_smem_bytes(117, 128) == 172544


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The edges of bf16 #2/#9's plan: the register plan's last S and the score
# tile's first, S = 33 at Dh = 40 (a padded k16 step), Dh = 8, 72 and 128,
# the reach at Dh = 64, 72, 128 and Dh = 8 (eleven warps), one key.
RC_EDGES = [
    (4, 64, 6, 64),
    (4, 65, 6, 64),
    (3, 33, 4, 40),
    (5, 17, 2, 8),
    (2, 50, 4, 128),
    (2, 140, 4, 64),
    (2, 137, 2, 72),
    (2, 117, 2, 128),
    (2, 165, 2, 8),
    (3, 1, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh", RC_EDGES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_recompute_kernels_on_card(cuda_device, b, s, h, dh, rate):
    """bf16 #9 at a shard's offsets and #2 against their plain versions
    within ``split_grads_bf16_bound`` / ``dqkv_bf16_bound`` (batch row 0
    masked whole), #2 against #9 bit for bit on the same q, k, v, the same
    bits twice."""
    qkv, mask, g = (x.to(cuda_device) for x in _case_at(b, s, h, dh))
    scale, seed = 1.0 / dh ** 0.5, 2 ** 57 + s
    q, k, v = (x.contiguous() for x in tfa._heads(qkv, h))
    gh = tfa._ctx_heads(g, h).contiguous()
    kw = dict(scale=scale, rate=rate)
    got = tfa.attn_bwd_split_cuda(q, k, v, mask, seed, gh, b_off=3, h_off=h,
                                  **kw)
    want = tfa.attn_bwd_split_reference(q, k, v, mask, seed, gh, b_off=3,
                                        h_off=h, **kw)
    _, p, pd = tfa.attn_fwd_split_reference(q, k, v, mask, seed=seed,
                                            save=True, b_off=3, h_off=h,
                                            **kw)
    for a, w, bd in zip(got, want, tfa.split_grads_bf16_bound(
            want, p, pd, q, k, v, gh, scale=scale)):
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    packed = tfa.attn_bwd_packed_cuda(qkv, mask, seed, g, n_heads=h, **kw)
    ref = tfa.attn_bwd_packed_reference(qkv, mask, seed, g, n_heads=h, **kw)
    _, p, pd = tfa.attn_fwd_packed_reference(qkv, mask, n_heads=h, seed=seed,
                                             save=True, **kw)
    bound = tfa.dqkv_bf16_bound(ref, p, pd, qkv, g, n_heads=h, scale=scale)
    assert bool(((packed.float() - ref.float()).abs() <= bound).all())
    split = tfa.attn_bwd_split_cuda(q, k, v, mask, seed, gh, **kw)
    assert torch.equal(tfa._pack(*split), packed)
    again = tfa.attn_bwd_packed_cuda(qkv, mask, seed, g, n_heads=h, **kw)
    assert torch.equal(again, packed)


@pytest.mark.cuda
def test_recompute_fp32_twins_give_the_same_bits(cuda_device):
    """fp32 #2 and #9 keep common.cuh's shared CUDA-core code: the same
    bits on the same q, k, v."""
    qkv, mask, g = (x.to(cuda_device, torch.float32)
                    for x in _case_at(3, 77, 4, 64))
    q, k, v = (x.contiguous() for x in tfa._heads(qkv, 4))
    gh = tfa._ctx_heads(g, 4).contiguous()
    kw = dict(scale=0.125, rate=0.1)
    split = tfa.attn_bwd_split_cuda(q, k, v, mask, 9, gh, **kw)
    packed = tfa.attn_bwd_packed_cuda(qkv, mask, 9, g, n_heads=4, **kw)
    assert torch.equal(tfa._pack(*split), packed)


def _case_at(b, s, h, dh):
    """bf16 qkv [B, S, 3·h·dh], a mask with batch row 0 masked whole and
    ragged rows after it, g [B, S, h·dh]."""
    rng = np.random.RandomState(s * 7 + dh)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * dh).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, s, h * dh).astype(np.float32))
    mask = (np.arange(s)[None, :] < rng.randint(1, s + 1, (b, 1))).astype(
        np.float32)
    mask[0] = 0
    return (qkv.to(torch.bfloat16), torch.from_numpy(mask),
            g.to(torch.bfloat16))


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
