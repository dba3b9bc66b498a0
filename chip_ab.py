#!/usr/bin/env python3
"""Time the full-H attention kernels of two checkouts of the PyTorch port
in alternating rounds on one NVIDIA GPU: #1 serving (bf16 B=128 S=50), #1
at the driver's S=512 evaluation (B=48), #1 with dropout and saved probs
and #3 at the bench's training shape (B=256 S=50, rate 0.1), their
split-layout twins #8, #8′ and #10, and #4 (whose bf16 kernel #1 runs past
S=64) at B=48 S=512; the rel kernels #11 serving (bf16 B=128 Q=K=50), #11
with dropout and saved probs and #13 at XLNet's training shape (B=256
Q=K=50, rate 0.1) and at the memory's (``--mem_len 50``: Q=50, K=100),
and #14 (whose bf16 plan #11 runs past K=64) at B=48 Q=K=512; the full-H
ingredients kernels (``rel_bias_impl="inkernel"``) #20 serving (bf16
B=128 Q=K=50), #20 with dropout and saved probs, #22 (from those probs)
and #21 at B=256 (rate 0.1; #22 and #21 also at rate 0) and at the
memory's Q=50, K=100; the recompute backwards #9 (split layout, B=256 S=50
at H=12 and one rank's H=6) and #2 (packed), rates 0.1 and 0; the rel
recompute backward #12 (bf16 B=256 Q=K=50 at rates 0.1 and 0, and Q=50
K=100); the QKV-projection kernels #18 serving (bf16 B=128 S=50 rate 0)
and training (B=256 rate 0.1, saved probs), and #19 (B=256 rate 0.1,
re-projecting from x: the call's two launches, and its (head, batch row)
pass alone); the fused MAG gate's forward #25 and backward chain #26
(bf16, D=768, MOSI's 47/74, N = 2400, 6400 and 12800).

    python3 chip_ab.py A_DIR B_DIR [C_DIR ...] [--iters N] [--cases RE]
        [--grad-gap-seeds S ...] [--xlnet] [--xlnet-impl auto|inkernel]

Each checkout builds its own kernels (under its ``build/``, both builds
started together). Then rounds A, B, B, A (A, B, C, C, B, A for three),
each a process of its own that
imports the package from its checkout and times every case with CUDA
events after a warm-up. Prints each round's per-call ms, then one JSON
object with both checkouts' means by case and the card's name and power
limit (nvidia-smi), and each checkout's agreement with the plain
versions at the bench's shapes (the share of elements whose bits differ,
the largest difference), and whether fp32 #11/#13, bf16 #14, fp32
#20/#21, fp32 #20/#22, fp32 #9 and #2, fp32 #12, fp32 #18/#19, bf16 #3
and #10, #25 and #26 in both dtypes, and the rel family's mask-drawing
kernels (#11/#12, #20/#21, #23/#24) in both dtypes at counter offsets
(0, 0) give the same bits in every checkout (digests). ``--cases`` times
only the cases
whose names match the regular expression. With
``--grad-gap-seeds``, each
checkout also runs ``chip_smoke.py``'s phase-4b dropout-0 check at those
seeds and reports its first-step gradient gaps (fused against einsum).
With ``--xlnet``,
rounds A, B, B, A of the MAG-XLNet end to end at xlnet-base-cased width
follow: one B=256 S=50 training step's device time, busy share and the
full-H rel kernels' share (torch.profiler), training examples/s over 10
steps and ``predict_split`` examples/s at batch 128, under
``--xlnet-impl``'s ``rel_bias_impl`` (auto: #11/#13; inkernel: #20/#22).
Exits non-zero without a card.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

H, DH = 12, 64
# name: (B, S, rate, what)
CASES = {
    "#1 bf16 B=128 S=50 rate 0": (128, 50, 0.0, "fwd"),
    "#1 bf16 B=48 S=512 rate 0": (48, 512, 0.0, "fwd"),
    "#4 bf16 B=48 S=512 rate 0": (48, 512, 0.0, "hb_fwd"),
    "#4' bf16 B=48 S=512 rate 0.1": (48, 512, 0.1, "hb_fwd"),
    "#1' bf16 B=256 S=50 rate 0.1 saved probs": (256, 50, 0.1, "fwd_save"),
    "#3 bf16 B=256 S=50": (256, 50, 0.1, "bwd"),
    "#8 bf16 B=128 S=50 H=12 rate 0": (128, 50, 0.0, "split_fwd"),
    "#8' bf16 B=256 S=50 H=12 rate 0.1 saved probs": (256, 50, 0.1,
                                                       "split_fwd_save"),
    "#10 bf16 B=256 S=50 H=12": (256, 50, 0.1, "split_bwd"),
    "#2 bf16 B=256 S=50 rate 0.1": (256, 50, 0.1, "bwd_rc"),
    "#2 bf16 B=256 S=50 rate 0": (256, 50, 0.0, "bwd_rc"),
}
# name: (B, S, H, rate): #9 (the recompute backward of a TP rank)
SPLIT_RC_CASES = {
    "#9 bf16 B=256 S=50 H=12 rate 0.1": (256, 50, 12, 0.1),
    "#9 bf16 B=256 S=50 H=12 rate 0": (256, 50, 12, 0.0),
    "#9 bf16 B=256 S=50 H=6 rate 0.1": (256, 50, 6, 0.1),
}
# name: (B, Q, K, rate, what)
REL_CASES = {
    "#11 bf16 B=128 Q=K=50 rate 0": (128, 50, 50, 0.0, "rel_fwd"),
    "#11' bf16 B=256 Q=K=50 rate 0.1 saved probs": (256, 50, 50, 0.1,
                                                     "rel_fwd_save"),
    "#13 bf16 B=256 Q=K=50": (256, 50, 50, 0.1, "rel_bwd"),
    "#11' bf16 B=256 Q=50 K=100 rate 0.1 saved probs": (256, 50, 100, 0.1,
                                                         "rel_fwd_save"),
    "#13 bf16 B=256 Q=50 K=100": (256, 50, 100, 0.1, "rel_bwd"),
    "#14 bf16 B=48 Q=K=512 rate 0": (48, 512, 512, 0.0, "rel_hb_fwd"),
    "#14' bf16 B=48 Q=K=512 rate 0.1": (48, 512, 512, 0.1, "rel_hb_fwd"),
    "#12 bf16 B=256 Q=K=50 rate 0.1": (256, 50, 50, 0.1, "rel_bwd_rc"),
    "#12 bf16 B=256 Q=K=50 rate 0": (256, 50, 50, 0.0, "rel_bwd_rc"),
    "#12 bf16 B=256 Q=50 K=100 rate 0.1": (256, 50, 100, 0.1, "rel_bwd_rc"),
}
# name: (B, S, rate, what): #18 and #19 (qkv_fusion) at bert-base width
QKVPROJ_CASES = {
    "#18 bf16 B=128 S=50 rate 0": (128, 50, 0.0, "fwd"),
    "#18' bf16 B=256 S=50 rate 0.1 saved probs": (256, 50, 0.1, "fwd_save"),
    "#19 bf16 B=256 S=50 rate 0.1 re-projecting": (256, 50, 0.1, "bwd"),
    "#19 head pass bf16 B=256 S=50 rate 0.1 re-projecting": (256, 50, 0.1,
                                                              "bwd_heads"),
    "#19 bf16 B=256 S=50 rate 0.1 from the saved qkv": (256, 50, 0.1,
                                                        "bwd_saved"),
    "#19 bf16 B=256 S=50 rate 0 re-projecting": (256, 50, 0.0, "bwd"),
    "#19 dx launch bf16 B=256 S=50": (256, 50, 0.1, "bwd_dx"),
}
# name: (N rows, what): #25, the fused MAG gate forward, and #26, its
# backward chain, bf16 at bert-base width with MOSI's modality widths (the
# driver's train and eval batches and the bench's, times S=50)
MAG_CASES = {
    "#25 bf16 N=2400": (2400, "fwd"),
    "#25 bf16 N=6400": (6400, "fwd"),
    "#25 bf16 N=12800": (12800, "fwd"),
    "#26 bf16 N=2400": (2400, "bwd"),
    "#26 bf16 N=6400": (6400, "bwd"),
    "#26 bf16 N=12800": (12800, "bwd"),
}
# name: (B, Q, K, rate, what)
RELIK_CASES = {
    "#20 bf16 B=128 Q=K=50 rate 0": (128, 50, 50, 0.0, "relik_fwd"),
    "#20' bf16 B=256 Q=K=50 rate 0.1 saved probs": (256, 50, 50, 0.1,
                                                     "relik_fwd_save"),
    "#22 bf16 B=256 Q=K=50 rate 0.1": (256, 50, 50, 0.1,
                                        "relik_bwd_saved"),
    "#22 bf16 B=256 Q=K=50 rate 0": (256, 50, 50, 0.0, "relik_bwd_saved"),
    "#22 bf16 B=256 Q=50 K=100 rate 0.1": (256, 50, 100, 0.1,
                                           "relik_bwd_saved"),
    "#21 bf16 B=256 Q=K=50 rate 0.1": (256, 50, 50, 0.1, "relik_bwd"),
    "#21 bf16 B=256 Q=K=50 rate 0": (256, 50, 50, 0.0, "relik_bwd"),
    "#20' bf16 B=256 Q=50 K=100 rate 0.1 saved probs": (256, 50, 100, 0.1,
                                                         "relik_fwd_save"),
    "#21 bf16 B=256 Q=50 K=100 rate 0.1": (256, 50, 100, 0.1, "relik_bwd"),
}


# Kernel-name substrings of the full-H rel kernels in either checkout: the
# CUDA-core kernels and the tensor-core plans.
REL_KERNELS = (("#11", ("attn_fwd_rel_kernel", "attn_fwd_rel_tc_")),
               ("#13", ("attn_bwd_rel_saved_kernel",
                        "attn_bwd_rel_saved_tc_")),
               ("#20", ("attn_fwd_relik_kernel", "attn_fwd_relik_tc_")),
               ("#22", ("attn_bwd_relik_saved_kernel",
                        "attn_bwd_relik_saved_tc_")),
               ("#21", ("attn_bwd_relik_kernel", "attn_bwd_relik_tc_")))


def _rel_inputs(torch, rng, b, q_len, k_len, dtype=None):
    """Seeded q, g [B, Q, D], k, v [B, K, D] and an ebias [B, H, Q, K] of
    O(1) with −1e30 on a ragged run of leading keys (left padding)."""
    dtype = dtype or torch.bfloat16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dtype)

    q, k, v, g = (t(b, q_len, H * DH), t(b, k_len, H * DH),
                  t(b, k_len, H * DH), t(b, q_len, H * DH))
    ebias = t(b, H, q_len, k_len)
    pads = rng.integers(0, k_len // 2, size=b)
    masked = torch.from_numpy(np.arange(k_len)[None, :] < pads[:, None])
    ebias = ebias.masked_fill(masked.to("cuda")[:, None, None, :], -1e30)
    return q, k, v, ebias, g


def _rel_call(fa, torch, rng, b, q_len, k_len, rate, what):
    """The rel case's kernel call on seeded inputs."""
    q, k, v, ebias, g = _rel_inputs(torch, rng, b, q_len, k_len)
    kw = dict(n_heads=H, scale=DH ** -0.5)
    if what == "rel_fwd":
        return lambda: fa.attn_fwd_rel_cuda(q, k, v, ebias, **kw)
    if what == "rel_hb_fwd":
        return lambda: fa.attn_fwd_rel_hb_cuda(q, k, v, ebias, rate=rate,
                                               seed=7, **kw)
    drop = dict(rate=rate, seed=7, save=True)
    if what == "rel_fwd_save":
        return lambda: fa.attn_fwd_rel_cuda(q, k, v, ebias, **drop, **kw)
    if what == "rel_bwd_rc":
        return lambda: fa.attn_bwd_rel_cuda(q, k, v, ebias, 7, g, rate=rate,
                                            **kw)
    _, p, pd = fa.attn_fwd_rel_cuda(q, k, v, ebias, **drop, **kw)
    return lambda: fa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw)


def _qkvproj_inputs(torch, rng, b, s, dtype=None):
    """Seeded x, g [B, S, D], the packed weight as the model holds it
    ([3D, D], N(0, 1/D)) handed over as its [D, 3D] view, the bias and a
    ragged mask."""
    dtype = dtype or torch.bfloat16
    d = H * DH

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)) * scale).to("cuda", dtype)

    x, g = t(b, s, d), t(b, s, d)
    w = t(3 * d, d, scale=d ** -0.5).t()
    b3 = t(3 * d, scale=0.1)
    lengths = rng.integers(1, s + 1, size=b)
    mask = torch.from_numpy(
        (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)).cuda()
    return x, w, b3, mask, g


def _qkvproj_call(fa, torch, rng, b, s, rate, what):
    """The QKV-projection case's call on seeded inputs: #18, #19 (its two
    launches) or #19's (head, batch row) pass alone."""
    x, w, b3, mask, g = _qkvproj_inputs(torch, rng, b, s)
    kw = dict(n_heads=H, scale=DH ** -0.5)
    if what == "fwd":
        return lambda: fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **kw)
    drop = dict(rate=rate, seed=7, save=True)
    if what == "fwd_save":
        return lambda: fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **drop, **kw)
    _, _, p, pd = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **drop, **kw)
    if what == "bwd":
        return lambda: fa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g,
                                                recompute=True, **kw)
    if what == "bwd_saved":
        _, qkv, p, pd = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask,
                                                 emit_qkv=True, **drop, **kw)
        return lambda: fa.attn_bwd_qkvproj_cuda(p, pd, qkv, w, b3, g,
                                                recompute=False, **kw)
    w_rows = w.t().contiguous()
    dqkv = torch.empty((b, s, 3 * H * DH), dtype=x.dtype, device=x.device)
    if what == "bwd_dx":
        dqkv.copy_(fa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g,
                                            recompute=True, **kw)[0])
        dx = torch.empty_like(x)
        return lambda: fa._launch("attn_bwd_qkvproj_dx", dqkv.data_ptr(),
                                  w_rows.data_ptr(), dx.data_ptr(), b * s,
                                  H * DH, 1, device=x.device)
    args = (p.data_ptr(), pd.data_ptr(), x.data_ptr(), w_rows.data_ptr(),
            b3.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, s, H, DH,
            DH ** -0.5, 1, 1)
    return lambda: fa._launch("attn_bwd_qkvproj_heads", *args,
                              device=x.device)


def _mag_inputs(torch, rng, n, dtype=None, d=H * DH, dv=47, da=74):
    """The gate's fp32 params (torch-default linears, a LayerNorm away from
    1 and 0) and seeded rows t [N, D], v [N, Dv], a [N, Da], dy [N, D]."""
    dtype = dtype or torch.bfloat16

    def u(shape, fan_in):
        bound = fan_in ** -0.5
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(
            np.float32)).cuda()

    params = {"w_hv_v": u((dv, d), dv + d), "w_hv_t": u((d, d), dv + d),
              "b_hv": u((d,), dv + d), "w_ha_a": u((da, d), da + d),
              "w_ha_t": u((d, d), da + d), "b_ha": u((d,), da + d),
              "w_v": u((dv, d), dv), "b_v": u((d,), dv),
              "w_a": u((da, d), da), "b_a": u((d,), da),
              "ln_gamma": 1 + u((d,), 100), "ln_beta": u((d,), 100)}
    acts = [torch.from_numpy(rng.standard_normal((n, w), dtype=np.float32))
            .to("cuda", dtype) for w in (d, dv, da, d)]
    return params, acts


def _mag_call(mf, torch, rng, n, what):
    params, (t, v, a, dy) = _mag_inputs(torch, rng, n)
    if what == "fwd":
        return lambda: mf.mag_fwd_cuda(params, t, v, a)
    return lambda: mf.mag_bwd_cuda(params, t, v, a, dy)


def _relik_inputs(torch, rng, b, q_len, k_len, dtype=None):
    """Seeded ingredients rw, rr (scaled) [B, Q, D], r [Q + K, D], k, v
    [B, K, D], ed (scaled) [B, H, Q], a 0/1 segd and a maskb with −1e30 on
    a ragged run of leading keys [B, Q, K], and g [B, Q, D]."""
    dtype = dtype or torch.bfloat16

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)) * scale).to("cuda", dtype)

    d = H * DH
    pads = rng.integers(0, k_len // 2, size=b)
    masked = np.arange(k_len)[None, None, :] < pads[:, None, None]
    maskb = np.ascontiguousarray(np.broadcast_to(-1e30 * masked,
                                                 (b, q_len, k_len)))
    return dict(
        rw=t(b, q_len, d), rr=t(b, q_len, d, scale=DH ** -0.5),
        r=t(q_len + k_len, d), k=t(b, k_len, d), v=t(b, k_len, d),
        ed=t(b, H, q_len, scale=DH ** -0.5),
        segd=torch.from_numpy(rng.integers(0, 2, (b, q_len, k_len)).astype(
            np.float32)).to("cuda", dtype),
        maskb=torch.from_numpy(maskb.astype(np.float32)).to("cuda", dtype),
        g=t(b, q_len, d))


RELIK = ("rw", "rr", "r", "k", "v", "ed", "segd", "maskb")


def _relik_call(fa, torch, rng, b, q_len, k_len, rate, what):
    """The ingredients case's kernel call on seeded inputs."""
    x = _relik_inputs(torch, rng, b, q_len, k_len)
    ins = [x[n] for n in RELIK]
    kw = dict(n_heads=H, scale=DH ** -0.5)
    if what == "relik_fwd":
        return lambda: fa.attn_fwd_relik_cuda(*ins, **kw)
    if what == "relik_fwd_save":
        return lambda: fa.attn_fwd_relik_cuda(*ins, rate=rate, seed=7,
                                              save=True, **kw)
    if what == "relik_bwd_saved":
        _, p, pd = fa.attn_fwd_relik_cuda(*ins, rate=rate, seed=7, save=True,
                                          **kw)
        saved_in = (p, pd, *ins[:5], x["segd"], x["g"])
        return lambda: fa.attn_bwd_relik_saved_cuda(*saved_in, **kw)
    return lambda: fa.attn_bwd_relik_cuda(*ins, 7, x["g"], rate=rate, **kw)


def _call(fa, torch, rng, b, s, rate, what):
    """The case's kernel call on seeded inputs (a ragged mask)."""
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(
        (b, s, H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
    lengths = rng.integers(1, s + 1, size=b)
    mask = torch.from_numpy(
        (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)).cuda()
    kw = dict(n_heads=H, scale=DH ** -0.5)
    drop = dict(rate=rate, seed=7, save=True)
    if what == "fwd":
        return lambda: fa.attn_fwd_packed_cuda(qkv, mask, **kw)
    if what == "fwd_save":
        return lambda: fa.attn_fwd_packed_cuda(qkv, mask, **drop, **kw)
    if what == "hb_fwd":
        return lambda: fa.attn_fwd_packed_hb_cuda(qkv, mask, rate=rate,
                                                  seed=7, **kw)
    if what == "bwd":
        _, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, **drop, **kw)
        return lambda: fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)
    if what == "bwd_rc":
        return lambda: fa.attn_bwd_packed_cuda(qkv, mask, 7, g, rate=rate,
                                               **kw)
    q, k, v = (x.contiguous() for x in fa._heads(qkv, H))
    if what == "split_fwd":
        return lambda: fa.attn_fwd_split_cuda(q, k, v, mask, scale=DH ** -0.5)
    if what == "split_fwd_save":
        return lambda: fa.attn_fwd_split_cuda(q, k, v, mask,
                                              scale=DH ** -0.5, **drop)
    _, p, pd = fa.attn_fwd_split_cuda(q, k, v, mask, scale=DH ** -0.5, **drop)
    gh = fa._ctx_heads(g, H).contiguous()
    return lambda: fa.attn_bwd_split_saved_cuda(p, pd, q, k, v, gh,
                                                scale=DH ** -0.5)


def _split_rc_call(fa, torch, rng, b, s, h, rate):
    """#9 on seeded q, k, v, g [B, H, S, Dh] and a ragged mask, at the
    offsets of a data-rank-1, model-rank-1 shard where H < 12."""
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (b, h, s, DH), dtype=np.float32)).to("cuda", torch.bfloat16)
        for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b)
    mask = torch.from_numpy(
        (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)).cuda()
    offs = dict(b_off=b, h_off=h) if h < H else {}
    return lambda: fa.attn_bwd_split_cuda(q, k, v, mask, 7, g,
                                          scale=DH ** -0.5, rate=rate,
                                          **offs)


def worker(iters, cases):
    """One round in the current directory's checkout: prints {case: ms}
    for the cases whose names match ``cases``."""
    sys.path.insert(0, os.getcwd())
    import torch

    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf

    rng = np.random.default_rng(0)
    out = {}
    calls = [(name, lambda c=case: _call(fa, torch, rng, *c))
             for name, case in CASES.items()]
    calls += [(name, lambda c=case: _rel_call(fa, torch, rng, *c))
              for name, case in REL_CASES.items()]
    calls += [(name, lambda c=case: _relik_call(fa, torch, rng, *c))
              for name, case in RELIK_CASES.items()]
    calls += [(name, lambda c=case: _split_rc_call(fa, torch, rng, *c))
              for name, case in SPLIT_RC_CASES.items()]
    calls += [(name, lambda c=case: _qkvproj_call(fa, torch, rng, *c))
              for name, case in QKVPROJ_CASES.items()]
    calls += [(name, lambda c=case: _mag_call(mf, torch, rng, *c))
              for name, case in MAG_CASES.items()]
    for name, make in calls:
        if not re.search(cases, name):
            continue
        fn = make()
        for _ in range(5):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / iters
    print(json.dumps(out))


def agreement():
    """In the current directory's checkout: for #1 (serving; rate 0.1 with
    saved probs) and #3 at the bench's shapes, the share of elements whose
    bits differ from the plain version on the same inputs, and the largest
    difference; prints {case: {tensor: [share, max |Δ|]}}."""
    sys.path.insert(0, os.getcwd())
    import torch

    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    out = {}

    def diff(got, want):
        d = (got.float() - want.float()).abs()
        return [float((got != want).double().mean()), float(d.max())]

    for b, rate in ((128, 0.0), (256, 0.1)):
        qkv = torch.from_numpy(rng.standard_normal(
            (b, 50, 3 * H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal(
            (b, 50, H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
        lengths = rng.integers(1, 51, size=b)
        mask = torch.from_numpy((np.arange(50)[None, :] < lengths[:, None])
                                .astype(np.float32)).cuda()
        kw = dict(n_heads=H, scale=DH ** -0.5, rate=rate, seed=7, save=True)
        got = fa.attn_fwd_packed_cuda(qkv, mask, **kw)
        want = fa.attn_fwd_packed_reference(qkv, mask, **kw)
        case = {n: diff(x, y) for n, x, y in zip(("out", "p", "pd"), got,
                                                 want)}
        kw = dict(n_heads=H, scale=DH ** -0.5)
        case["dqkv"] = diff(
            fa.attn_bwd_packed_saved_cuda(got[1], got[2], qkv, g, **kw),
            fa.attn_bwd_packed_saved_reference(got[1], got[2], qkv, g, **kw))
        out[f"bf16 B={b} S=50 rate {rate}"] = case
    for b, k_len, rate in ((128, 50, 0.0), (256, 50, 0.1), (64, 100, 0.1)):
        q, k, v, ebias, g = _rel_inputs(torch, rng, b, 50, k_len)
        kw = dict(n_heads=H, scale=DH ** -0.5, rate=rate, seed=7, save=True)
        got = fa.attn_fwd_rel_cuda(q, k, v, ebias, **kw)
        want = fa.attn_fwd_rel_reference(q, k, v, ebias, **kw)
        case = {n: diff(x, y) for n, x, y in zip(("out", "p", "pd"), got,
                                                 want)}
        kw = dict(n_heads=H, scale=DH ** -0.5)
        for n, x, y in zip(
                ("dq", "dk", "dv", "debias"),
                fa.attn_bwd_rel_saved_cuda(got[1], got[2], q, k, v, g, **kw),
                fa.attn_bwd_rel_saved_reference(got[1], got[2], q, k, v, g,
                                                **kw)):
            case[n] = diff(x, y)
        out[f"rel bf16 B={b} Q=50 K={k_len} rate {rate}"] = case
    # the digests of fp32 #11 (saved probs, rate 0.1) and #13, and of bf16
    # #14 at rate 0.1: equal digests are the same bits
    def digest(*xs):
        h = hashlib.sha256()
        for x in xs:
            h.update(x.cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    q, k, v, ebias, g = _rel_inputs(torch, rng, 4, 50, 77, torch.float32)
    kw = dict(n_heads=H, scale=DH ** -0.5)
    fwd = fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=0.1, seed=7, save=True,
                               **kw)
    bwd = fa.attn_bwd_rel_saved_cuda(fwd[1], fwd[2], q, k, v, g, **kw)
    out["digest fp32 #11/#13 B=4 Q=50 K=77"] = digest(*fwd, *bwd)
    q, k, v, ebias, g = _rel_inputs(torch, rng, 2, 512, 512)
    out["digest bf16 #14 B=2 Q=K=512 rate 0.1"] = digest(
        fa.attn_fwd_rel_hb_cuda(q, k, v, ebias, rate=0.1, seed=7, **kw))
    # fp32 #20 (saved probs, rate 0.1) and #21 keep their CUDA-core kernels
    x = _relik_inputs(torch, rng, 4, 50, 77, torch.float32)
    ins = [x[n] for n in RELIK]
    fwd = fa.attn_fwd_relik_cuda(*ins, rate=0.1, seed=7, save=True, **kw)
    out["digest fp32 #20/#21 B=4 Q=50 K=77"] = digest(
        *fwd, *fa.attn_bwd_relik_cuda(*ins, 7, x["g"], rate=0.1, **kw))
    # fp32 #22 from #20's saved probs, and fp32 #9 (at a shard's offsets)
    # and #2 keep their CUDA-core kernels
    out["digest fp32 #20/#22 B=4 Q=50 K=77"] = digest(
        *fwd, *fa.attn_bwd_relik_saved_cuda(fwd[1], fwd[2], *ins[:5],
                                            x["segd"], x["g"], **kw))
    qkv = torch.from_numpy(rng.standard_normal(
        (4, 77, 3 * H * DH), dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(
        (4, 77, H * DH), dtype=np.float32)).cuda()
    mask = torch.from_numpy((np.arange(77)[None, :] < np.array(
        [[0], [30], [60], [77]])).astype(np.float32)).cuda()
    q, k, v = (t.contiguous() for t in fa._heads(qkv, H))
    gh = fa._ctx_heads(g, H).contiguous()
    out["digest fp32 #9 B=4 S=77 H=12 rate 0.1 offsets (4, 12)"] = digest(
        *fa.attn_bwd_split_cuda(q, k, v, mask, 7, gh, scale=DH ** -0.5,
                                rate=0.1, b_off=4, h_off=12))
    out["digest fp32 #2 B=4 S=77 H=12 rate 0.1"] = digest(
        fa.attn_bwd_packed_cuda(qkv, mask, 7, g, rate=0.1, **kw))
    # fp32 #12 and fp32 #18/#19 keep their CUDA-core kernels
    q, k, v, ebias, g = _rel_inputs(torch, rng, 4, 50, 77, torch.float32)
    out["digest fp32 #12 B=4 Q=50 K=77 rate 0.1"] = digest(
        *fa.attn_bwd_rel_cuda(q, k, v, ebias, 7, g, rate=0.1, **kw))
    x, w, b3, mask, g = _qkvproj_inputs(torch, rng, 4, 77, torch.float32)
    fwd = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, rate=0.1, seed=7,
                                   save=True, emit_qkv=True, **kw)
    out["digest fp32 #18/#19 B=4 S=77 rate 0.1"] = digest(
        *fwd, *fa.attn_bwd_qkvproj_cuda(fwd[2], fwd[3], x, w, b3, g,
                                        recompute=True, **kw),
        *fa.attn_bwd_qkvproj_cuda(fwd[2], fwd[3], fwd[1], w, b3, g,
                                  recompute=False, **kw))
    # bf16 #3 and #10 (whose phases bf16 #19 now runs too) at the bench's
    # shape and past S = 64
    for b, s in ((64, 50), (4, 140)):
        qkv = torch.from_numpy(rng.standard_normal(
            (b, s, 3 * H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal(
            (b, s, H * DH), dtype=np.float32)).to("cuda", torch.bfloat16)
        mask = torch.from_numpy((np.arange(s)[None, :] < rng.integers(
            1, s + 1, size=b)[:, None]).astype(np.float32)).cuda()
        _, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, rate=0.1, seed=7,
                                           save=True, **kw)
        out[f"digest bf16 #3 B={b} S={s} rate 0.1"] = digest(
            fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw))
        q, k, v = (t.contiguous() for t in fa._heads(qkv, H))
        gh = fa._ctx_heads(g, H).contiguous()
        out[f"digest bf16 #10 B={b} S={s} rate 0.1"] = digest(
            *fa.attn_bwd_split_saved_cuda(p, pd, q, k, v, gh,
                                          scale=DH ** -0.5))
    # fp32 #25 and #26 run their CUDA-core kernels, bf16 #25 and #26 the
    # tensor-core plan of mag_tc.cuh
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf

    for dtype in (torch.float32, torch.bfloat16):
        params, (t, v, a, dy) = _mag_inputs(torch, rng, 999, dtype)
        name = "fp32" if dtype == torch.float32 else "bf16"
        out[f"digest {name} #25 N=999"] = digest(
            mf.mag_fwd_cuda(params, t, v, a))
        out[f"digest {name} #26 N=999"] = digest(
            *mf.mag_bwd_cuda(params, t, v, a, dy))
    # the rel family's mask-drawing kernels at counter offsets (0, 0), bf16
    # (the tensor-core plans) and fp32, rate 0.1: #11 (saved probs) and #12,
    # #20 (saved probs) and #21, #23 and #24
    for dtype in (torch.bfloat16, torch.float32):
        name = "fp32" if dtype == torch.float32 else "bf16"
        q, k, v, ebias, g = _rel_inputs(torch, rng, 4, 50, 77, dtype)
        out[f"digest {name} #11/#12 B=4 Q=50 K=77 rate 0.1"] = digest(
            *fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=0.1, seed=7,
                                  save=True, **kw),
            *fa.attn_bwd_rel_cuda(q, k, v, ebias, 7, g, rate=0.1, **kw))
        for (q_len, k_len), fwd, bwd, tags in (
                ((50, 77), fa.attn_fwd_relik_cuda, fa.attn_bwd_relik_cuda,
                 "#20/#21"),
                ((128, 128), fa.attn_fwd_relik_fs_cuda,
                 fa.attn_bwd_relik_fs_cuda, "#23/#24")):
            x = _relik_inputs(torch, rng, 2, q_len, k_len, dtype)
            ins = [x[n] for n in RELIK]
            if tags == "#20/#21":
                got = (*fwd(*ins, rate=0.1, seed=7, save=True, **kw),
                       *bwd(*ins, 7, x["g"], rate=0.1, **kw))
            else:
                o, lse = fwd(*ins, rate=0.1, seed=7, **kw)
                got = (o, lse, *bwd(*ins, 7, o, lse, x["g"], rate=0.1,
                                    **kw))
            out[f"digest {name} {tags} B=2 Q={q_len} K={k_len} rate "
                "0.1"] = digest(*got)
    print(json.dumps(out))


def xlnet_e2e(iters, impl):
    """In the current directory's checkout: MAG-XLNet (xlnet-base-cased,
    bf16, fused attention, ``rel_bias_impl`` ``impl``, MOSI dims, random
    weights) end to end: one B=256 S=50 training step under torch.profiler
    (device ms, busy share, the full-H rel kernels' ms: #11 and #13 under
    auto, #20 and #22 under inkernel), training examples/s over ``iters``
    steps after 3 warm-up
    (CUDA-synchronised wall), and ``predict_split`` examples/s over 685
    examples at batch 128 (the median of 5 passes); prints them as JSON."""
    import time

    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    import dataclasses

    rng = np.random.default_rng(3)
    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                              rel_bias_impl=impl)
    mm = MultimodalConfig(injection_index=1)
    model = cs._xlnet(cfg, mm, "fused", 10)
    state = Trainer(model=model, tx=make_optimizer(1e-5, iters + 8, 0.1)
                    ).create_state_from_params(None, 0)
    step = make_train_step()
    batch = cs._device_batch(cs.make_xlnet_split(
        rng, cs.BENCH_BATCH, cs.S_SERVE, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple())
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch)
    torch.cuda.synchronize()
    train = iters * cs.BENCH_BATCH / (time.perf_counter() - t0)
    prof = device_time_by_kernel(lambda: step(state, batch), 1)
    rel = {tag: sum(ms for name, _, ms in prof["kernels"]
                    if any(k in name for k in keys))
           for tag, keys in REL_KERNELS}
    rel = {tag: ms for tag, ms in rel.items() if ms > 0}
    split = cs.make_xlnet_split(rng, cs.N_TEST, cs.S_SERVE, cfg.vocab_size,
                                ds.visual_dim, ds.acoustic_dim)
    predictor = Predictor(model, batch_size=cs.BATCH)
    predictor.predict_split(split)
    serve = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict_split(split)
        serve.append(cs.N_TEST / (time.perf_counter() - t0))
    print(json.dumps({
        "step_device_ms": prof["device_ms"],
        "step_busy": prof["device_ms"] / prof["wall_ms"],
        "step_rel_ms": rel, "train_ex_s": train,
        "serve_ex_s": float(np.median(serve))}))


def grad_gaps(seeds):
    """In the current directory's checkout: ``chip_smoke.py``'s phase-4b
    dropout-0 check (bert-base, one epoch of ``Trainer.train``, then the
    first step's gradients of the fused branch, saved probs and recompute,
    against the einsum branch, leaf by leaf) at each seed; prints {seed:
    {branch: worst ‖g − g_einsum‖ / ‖g_einsum‖}}."""
    import contextlib
    import dataclasses
    import io
    import re
    import types

    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # read the gaps, whatever they are; the planted fault (1.0) still fails
    chip_smoke.GRAD_GAP_TOL = 0.5
    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused")
    model_args = (cfg, MultimodalConfig(), ds.visual_dim, ds.acoustic_dim)
    out = {}
    for seed in seeds:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            chip_smoke.train_path(types.SimpleNamespace(seed=seed),
                                  np.random.default_rng(seed), fa,
                                  model_args, "")
        out[seed] = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"step-1 gradients, (fused, \w+ ?\w*) vs einsum: worst pieces "
            r"\S+ ([0-9.e+-]+)", log.getvalue())}
    print(json.dumps(out))


def _run(tree, args):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {' '.join(args)} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--cases", default="",
                        help="time only the cases whose names match this "
                             "regular expression")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--build", action="store_true")
    parser.add_argument("--grad-gap-seeds", type=int, nargs="*",
                        help="also compare, per checkout, phase 4b's "
                             "dropout-0 first-step gradients (fused vs "
                             "einsum) at these seeds")
    parser.add_argument("--grad-gap-worker", action="store_true")
    parser.add_argument("--agreement-worker", action="store_true")
    parser.add_argument("--xlnet", action="store_true",
                        help="also time MAG-XLNet end to end per checkout")
    parser.add_argument("--xlnet-impl", default="auto",
                        choices=("auto", "inkernel"),
                        help="the XLNet end-to-end rounds' rel_bias_impl")
    parser.add_argument("--xlnet-worker", action="store_true")
    args = parser.parse_args()
    if args.agreement_worker:
        agreement()
        return 0
    if args.xlnet_worker:
        xlnet_e2e(10, args.xlnet_impl)
        return 0
    if args.grad_gap_worker:
        grad_gaps(args.grad_gap_seeds)
        return 0
    if args.build:
        sys.path.insert(0, os.getcwd())
        from bert_multimodal_transformer_tpu_torch.ops import kernels

        print(kernels.build_kernels())
        return 0
    if args.worker:
        worker(args.iters, args.cases)
        return 0
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("chip_ab: needs a CUDA device and two checkouts or more",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    builds = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--build"], cwd=tree,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree in args.trees]
    for tree, proc in zip(args.trees, builds):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{tree}: build failed:\n{out}")
    rounds = {tree: [] for tree in args.trees}
    for tree in [*args.trees, *reversed(args.trees)]:
        times = json.loads(_run(tree, ["--worker", "--iters",
                                       str(args.iters), "--cases",
                                       args.cases]).splitlines()[-1])
        rounds[tree].append(times)
        print(f"{tree}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in times.items()))
    result = {"card": card, "iters": args.iters, "ms": {
        tree: {name: [r[name] for r in rs]
               for name in [*CASES, *REL_CASES, *RELIK_CASES,
                            *SPLIT_RC_CASES, *QKVPROJ_CASES, *MAG_CASES]
               if name in rs[0]}
        for tree, rs in rounds.items()}}
    result["agreement"] = {tree: json.loads(_run(
        tree, ["--agreement-worker"]).splitlines()[-1])
        for tree in args.trees}
    print(f"bits differing from the plain versions [share, max |Δ|]: "
          f"{result['agreement']}")
    result["same_bits"] = {
        name: len({a[name] for a in result["agreement"].values()}) == 1
        for name in result["agreement"][args.trees[0]]
        if name.startswith("digest")}
    print(f"the same bits in every checkout: {result['same_bits']}")
    if args.xlnet:
        e2e = {tree: [] for tree in args.trees}
        for tree in [*args.trees, *reversed(args.trees)]:
            e2e[tree].append(json.loads(_run(
                tree, ["--xlnet-worker", "--xlnet-impl",
                       args.xlnet_impl]).splitlines()[-1]))
            print(f"{tree} MAG-XLNet end to end ({args.xlnet_impl}): "
                  f"{e2e[tree][-1]}")
        result["xlnet"] = e2e
    if args.grad_gap_seeds:
        result["grad_gaps"] = {tree: json.loads(_run(tree, [
            "--grad-gap-worker", "--grad-gap-seeds",
            *map(str, args.grad_gap_seeds)]).splitlines()[-1])
            for tree in args.trees}
        print(f"grad gaps: {result['grad_gaps']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
