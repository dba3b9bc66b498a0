"""The bf16 tensor-core plans of the full-H ingredients rel kernels #20
(the forward), #21 (the recompute backward) and #22 (the backward from the
saved probs), ``csrc/attn_relik_full_tc.cuh``, emulated in plain torch on
the CPU and
held against the kernels' plain versions, plus the plans' shared-memory
sizes over the whole reach.

The kernels themselves run only on a card (the tests marked ``cuda`` in
tests/test_torch_relik_attention.py hold them against the plain versions).
What the CPU can hold is each plan's arithmetic: bf16 operands, products
summed in fp32 over 16-deep ``mma.sync`` steps; bd as the wide product
rr · r-windowᵀ read on its diagonal (each element the dot of rr_q with
r[Q − q + k], in the same 16-deep steps); s = ((ac · scale + bd) + ed ·
segd) + maskb in fp32; the row sums in the plan's lane order (K ≤ 64: a
lane's keys in order, then the quad's xor tree; past it lane-strided, then
the warp's xor tree); p = e / sum; the keep bits handed out by the lane
pairs; PV from the dropped probs rounded to bf16. The backward (#21 on
those p and pd, #22 on the saved bf16 ones, pd_c the saved pd): t = pd ⊙
(g · vᵀ), Σ_k t and ded = Σ_k ds · segd in the quad's lane order, ds_c =
bf16(ds · scale), ds_u = bf16(ds), pd_c = bf16(pd); drr from the skewed
S′[q][(15 − q mod 16) + k] in 16-column steps, the dr rows from S′ᵀ · rr
a 16-row slab at a time, then summed over the batch rows in order.
Geometry: B=2, H=2, (Q, K) = (50, 50), (33, 57) and (50, 100) at Dh=16
(one k16 step) and Dh=40 (a padded one), batch row 0 masked whole (−1e30
on every key), rates 0 and 0.1. Tolerances: the forward within one bf16
rounding (2^-7 relative plus 2^-6 absolute) of
``attn_fwd_relik_reference``, the masked rows exactly uniform; the
backwards within ``relik_full_grads_bf16_bound`` of
``attn_bwd_relik_reference`` and ``attn_bwd_relik_saved_reference``; the
keep mask bit for bit. The tests marked ``cuda`` hold bf16 #22 against #21
on the card.
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
          / "attn_relik_full_tc.cuh")
SHAPES = [(50, 50), (33, 57), (50, 100)]
NAMES = ("rw", "rr", "r", "k", "v", "ed", "segd", "maskb")


def _case(q_len, k_len, dh, seed):
    """Seeded bf16 ingredients as the model feeds #20 (rw, rr scaled, r
    [Q + K + 3, D], k, v, ed scaled, a 0/1 segd, maskb −1e30 on every key
    of batch row 0 and on row 1's first K/4 keys) and a context gradient."""
    rng = np.random.RandomState(seed)
    d, sc = H * dh, 1.0 / dh ** 0.5
    maskb = np.zeros((2, q_len, k_len))
    maskb[0] = -1e30
    maskb[1, :, :k_len // 4] = -1e30
    x = dict(rw=rng.randn(2, q_len, d), rr=rng.randn(2, q_len, d) * sc,
             r=rng.randn(q_len + k_len + 3, d), k=rng.randn(2, k_len, d),
             v=rng.randn(2, k_len, d), ed=rng.randn(2, H, q_len) * sc,
             segd=rng.randint(0, 2, (2, q_len, k_len)), maskb=maskb,
             g=rng.randn(2, q_len, d))
    return {n: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for n, a in x.items()}


def _scores(x, scale):
    """The scores as both plans build them (``relik_scores``)."""
    rwh, rrh, kh = (tfa._ctx_heads(x[n], H) for n in ("rw", "rr", "k"))
    q_len, k_len, p_len = rwh.shape[2], kh.shape[2], x["r"].shape[0]
    rh = x["r"].reshape(p_len, H, -1).permute(1, 0, 2)[None]
    bd = _mma_abt(rrh, rh.expand(2, -1, -1, -1))          # rr · r, [B,H,Q,P]
    bd = torch.gather(bd, 3, tfa._shift_index(q_len, k_len, "cpu").expand(
        2, H, q_len, k_len))
    return (((_mma_abt(rwh, kh) * scale + bd)
             + x["ed"].float()[..., None] * x["segd"].float()[:, None])
            + x["maskb"].float()[:, None])


def _probs(x, scale, rate, seed):
    """p (fp32) and the keep mask the plans apply: K ≤ 64 #20's register
    plan (quad order, lane-pair bits; #21 runs the same), past it the score
    tile's whole-row softmax (warp order)."""
    s = _scores(x, scale)
    q_len, k_len = s.shape[2], s.shape[3]
    reg = k_len <= tfa.REL_TC_REG_MAX_K
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    total = (_quad_sum(_pad_keys(e, _rows16(k_len))) if reg
             else _warp_sum(e))
    p = e / total[..., None]
    keep = torch.ones_like(p, dtype=torch.bool)
    if rate > 0.0:
        bits = tfa.dropout_bits(seed, 2, H, _rows16(q_len), _rows16(k_len))
        if reg:
            bits = _lane_pair_draws(bits)
        keep = bits[..., :q_len, :k_len] >= tfa.dropout_threshold(rate)
    return p, keep


def _fwd_plan(x, scale, rate, seed):
    """bf16 #20's plans in plain torch: (out, p, pd) as the kernel writes
    them, and the keep mask."""
    p, keep = _probs(x, scale, rate, seed)
    pd = torch.where(keep, p * tfa.inv_keep(rate), 0.0) if rate > 0 else p
    out = _mma_abt(pd.to(torch.bfloat16),
                   tfa._ctx_heads(x["v"], H).transpose(-1, -2))
    out = tfa._merge_heads(out.to(torch.bfloat16))
    return (out, p.to(torch.bfloat16), pd.to(torch.bfloat16)), keep


def _skewed_steps(ds_u, rows, q_len, k_len):
    """Σ over k of ds_u[.., q, k] · rows[.., q, k, :] in S′'s 16-column
    steps (column (15 − q mod 16) + k), each step exact, the steps added in
    fp32: drr's order."""
    col = (15 - torch.arange(q_len) % 16)[:, None] + torch.arange(k_len)
    prod = ds_u.double()[..., None] * rows.double()
    out = torch.zeros(prod.shape[:3] + prod.shape[-1:])
    for step in range(int(col.max()) // 16 + 1):
        m = (col // 16 == step).double()[..., None]
        out = out + (prod * m).sum(dim=3).float()
    return out


def _bwd_plan(x, scale, rate, seed, saved=None):
    """bf16 #21's plan in plain torch (with ``saved`` = (p, pd) in bf16,
    #22's: no recompute, p and pd read from them): (drw, drr, dr, dk, dv,
    ded), dr in fp32."""
    rwh, rrh, kh, vh, gh = (tfa._ctx_heads(x[n], H)
                            for n in ("rw", "rr", "k", "v", "g"))
    q_len, k_len, p_len = rwh.shape[2], kh.shape[2], x["r"].shape[0]
    kp = _rows16(k_len)
    if saved is None:
        p, keep = _probs(x, scale, rate, seed)
        pd = (torch.where(keep, p * tfa.inv_keep(rate), 0.0) if rate > 0
              else p)
    else:
        p, pd = (a.float() for a in saved)
    t = pd * _mma_abt(gh, vh)
    ds = t - p * _quad_sum(_pad_keys(t, kp))[..., None]
    ded = _quad_sum(_pad_keys(ds * x["segd"].float()[:, None], kp))
    ds_c, ds_u = (ds * scale).to(torch.bfloat16), ds.to(torch.bfloat16)
    drw = _mma_abt(ds_c, kh.transpose(-1, -2))
    dk = _mma_abt(ds_c.transpose(-1, -2), rwh.transpose(-1, -2))
    dv = _mma_abt(pd.to(torch.bfloat16).transpose(-1, -2),
                  gh.transpose(-1, -2))
    rh = x["r"].reshape(p_len, H, -1).permute(1, 0, 2)      # [H, P, Dh]
    pos = (q_len - torch.arange(q_len)[:, None]
           + torch.arange(k_len)[None, :])                  # r[Q − q + k]
    drr = _skewed_steps(ds_u, rh[:, pos][None], q_len, k_len)
    # the dr rows: S′ᵀ · rr a 16-row slab at a time, then Σ over b in order
    z = torch.zeros(2, H, q_len, p_len, dtype=torch.float64)
    z.scatter_(3, tfa._shift_index(q_len, k_len, "cpu").expand(
        2, H, q_len, k_len), ds_u.double())
    ws = torch.zeros(2, H, p_len, rh.shape[-1])
    for s0 in range(0, q_len, 16):
        ws = ws + torch.einsum("bhqp,bhqf->bhpf", z[:, :, s0:s0 + 16],
                               rrh[:, :, s0:s0 + 16].double()).float()
    dr = ws[0]
    for b in range(1, 2):
        dr = dr + ws[b]
    dr = dr.permute(1, 0, 2).reshape(p_len, -1)
    return (*(tfa._merge_heads(a.to(torch.bfloat16)) for a in (drw, drr)),
            dr, *(tfa._merge_heads(a.to(torch.bfloat16)) for a in (dk, dv)),
            ded.to(torch.bfloat16))


def _close(got, want):
    got, want = got.float(), want.float()
    assert bool(((got - want).abs()
                 <= BF16_ATOL + BF16_RTOL * want.abs()).all())


@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("dh", [16, 40])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_plan_matches_the_plain_forward(q_len, k_len, dh, rate):
    """bf16 #20's plan (the register plan at K = 50 and 57, the score tile
    at K = 100) gives the plain forward's out, p and pd within one bf16
    rounding, the batch row masked whole comes out uniform, and the lane
    pairs hand out the stream's keep mask bit for bit."""
    x = _case(q_len, k_len, dh, seed=q_len + k_len + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 61 + 33
    got, keep = _fwd_plan(x, scale, rate, seed)
    want = tfa.attn_fwd_relik_reference(*(x[n] for n in NAMES), n_heads=H,
                                        scale=scale, rate=rate, seed=seed,
                                        save=True)
    for a, w in zip(got, want):
        _close(a, w)
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
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_plan_matches_the_plain_backward(q_len, k_len, dh, rate):
    """bf16 #21's plan (the probs recomputed by #20's plan, the mask
    replayed) gives the plain backward's drw, drr, dr, dk, dv and ded
    within ``relik_full_grads_bf16_bound``."""
    x = _case(q_len, k_len, dh, seed=2 * q_len + k_len + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 59 + 7
    ins = [x[n] for n in NAMES]
    got = _bwd_plan(x, scale, rate, seed)
    want = tfa.attn_bwd_relik_reference(*ins, seed, x["g"], n_heads=H,
                                        scale=scale, rate=rate)
    _, p, pd = tfa.attn_fwd_relik_reference(*ins, n_heads=H, scale=scale,
                                            rate=rate, seed=seed, save=True)
    bounds = tfa.relik_full_grads_bf16_bound(want, p, pd, *ins[:5],
                                             x["segd"], x["g"], n_heads=H,
                                             scale=scale)
    for a, w, bd in zip(got, want, bounds):
        assert a.shape == w.shape
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    for part in (1, 2, 5):       # drr, dr and ded are not all zero
        assert float(want[part].abs().max()) > 1e-3


@pytest.mark.parametrize("q_len,k_len", SHAPES)
@pytest.mark.parametrize("dh", [16, 40])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_saved_backward_plan_matches_the_plain_backward(q_len, k_len, dh,
                                                        rate):
    """bf16 #22's plan (#21's phases 1-2 on the plain forward's saved bf16
    p and pd) gives ``attn_bwd_relik_saved_reference``'s drw, drr, dr, dk,
    dv and ded within ``relik_full_grads_bf16_bound``."""
    x = _case(q_len, k_len, dh, seed=3 * q_len + k_len + dh)
    scale, seed = 1.0 / dh ** 0.5, 2 ** 57 + 3
    ins = [x[n] for n in NAMES]
    _, p, pd = tfa.attn_fwd_relik_reference(*ins, n_heads=H, scale=scale,
                                            rate=rate, seed=seed, save=True)
    got = _bwd_plan(x, scale, rate, seed, saved=(p, pd))
    saved_in = (p, pd, *ins[:5], x["segd"], x["g"])
    want = tfa.attn_bwd_relik_saved_reference(*saved_in, n_heads=H,
                                              scale=scale)
    bounds = tfa.relik_full_grads_bf16_bound(want, p, pd, *ins[:5],
                                             x["segd"], x["g"], n_heads=H,
                                             scale=scale)
    for a, w, bd in zip(got, want, bounds):
        assert a.shape == w.shape
        assert bool(((a.float() - w.float()).abs() <= bd).all())
    for part in (1, 2, 5):       # drr, dr and ded are not all zero
        assert float(want[part].abs().max()) > 1e-3


def _header_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text()).group(1))


def _q_reach(k_len, dh):
    """The longest Q that ``relik_bwd_fits`` admits at (K, Dh) (0: none):
    its plan is linear in Q."""
    per_q = 4 * (3 * (dh + 1) + 3 * k_len)
    q = (MAX_SMEM_BYTES - 4 * (2 * k_len - 1) * (dh + 1)) // per_q
    while q > 0 and not tfa.relik_bwd_fits(q, k_len, dh):
        q -= 1
    assert not tfa.relik_bwd_fits(q + 1, k_len, dh)
    return max(q, 0)


def test_plans_fit_every_reachable_shape():
    """Every (Q, K, Dh) that ``rel_tier`` sends to "ik_full" fits the bf16
    plans: the forward at every K ≤ ``MAX_SEQ_LEN`` (its plan grows with Q
    only up to a 64-row tile), the backwards (#21, and #22 on the same
    plan) over ``relik_bwd_fits`` with a query chunk of 16 rows or more
    (all of Q in one chunk wherever that fits). The header's constants are
    Python's."""
    assert _header_constant("kMaxK") == tfa.MAX_SEQ_LEN
    assert _header_constant("kSmemQTile") == 32
    assert _header_constant("kKBlock") == 64
    for dh in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for k_len in range(1, tfa.MAX_SEQ_LEN + 1):
            assert tfa.relik_full_tc_fwd_smem_bytes(64, k_len, dh) <= (
                MAX_SMEM_BYTES)
            reach = _q_reach(k_len, dh)
            if reach == 0:
                continue
            assert tfa.rel_tier(reach, k_len, dh, True, True,
                                inkernel=True) == "ik_full"
            whole = reach
            while whole and tfa.relik_full_tc_bwd_smem_bytes(
                    _rows16(whole), k_len, dh) > MAX_SMEM_BYTES:
                whole -= 1
            if whole:
                assert tfa.relik_full_tc_bwd_q_chunk(whole, k_len, dh) == (
                    _rows16(whole))
            if whole < reach:
                qc = tfa.relik_full_tc_bwd_q_chunk(reach, k_len, dh)
                assert 16 <= qc < reach
                assert tfa.relik_full_tc_bwd_smem_bytes(
                    qc, k_len, dh, multi=True) <= MAX_SMEM_BYTES
    assert tfa.relik_full_tc_fwd_smem_bytes(50, 50, 64) == 55296
    assert tfa.relik_full_tc_fwd_smem_bytes(50, 100, 64) == 72192
    assert tfa.relik_full_tc_fwd_smem_bytes(50, 512, 128) == 170496
    assert tfa.relik_full_tc_bwd_smem_bytes(64, 50, 64) == 83968
    assert tfa.relik_full_tc_bwd_q_chunk(1000, 8, 8) == 640


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_len,k_len,dh", [
    (50, 50, 64),      # the training shape
    (50, 100, 64),     # --mem_len 50
    (33, 57, 40),      # K odd (2-byte prob loads), a padded k16 step
    (95, 95, 64),      # the reach at Dh = 64
    (1000, 8, 8),      # two query chunks
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_saved_backward_matches_the_recompute_on_card(cuda_device, q_len,
                                                      k_len, dh, rate):
    """bf16 #22 on #20's saved probs against #21 on the same inputs within
    ``relik_full_grads_bf16_bound`` (p and pd read rounded against
    recomputed), and against its plain version; the same bits twice."""
    x = {n: a.to(cuda_device) for n, a in _case(q_len, k_len, dh,
                                                seed=q_len + dh).items()}
    ins = [x[n] for n in NAMES]
    kw = dict(n_heads=H, scale=1.0 / dh ** 0.5)
    seed = 2 ** 56 + 1
    _, p, pd = tfa.attn_fwd_relik_cuda(*ins, rate=rate, seed=seed, save=True,
                                       **kw)
    saved_in = (p, pd, *ins[:5], x["segd"], x["g"])
    got = tfa.attn_bwd_relik_saved_cuda(*saved_in, **kw)
    for ref in (tfa.attn_bwd_relik_cuda(*ins, seed, x["g"], rate=rate, **kw),
                tfa.attn_bwd_relik_saved_reference(*saved_in, **kw)):
        bounds = tfa.relik_full_grads_bf16_bound(ref, p, pd, *ins[:5],
                                                 x["segd"], x["g"], **kw)
        for a, w, bd in zip(got, ref, bounds):
            assert bool(((a.float() - w.float()).abs() <= bd).all())
    again = tfa.attn_bwd_relik_saved_cuda(*saved_in, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


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
