#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), CUDA version.
2. Build: compile ``csrc/*.cu`` with nvcc (into ``build/torch_kernels/``).
3. Kernel against its plain PyTorch version on the card, on seeded ragged
   masks with one fully padded row: bf16 at B=128 S=50 (the serving
   shape), bf16 at B=8 S=512, fp32 at B=4 S=77; then both timed at the
   serving shape.
4. Main path: ``MagBertForSequenceClassification`` at bert-base width with
   MOSI modality dims, bf16 compute, ``attention_impl="fused"``, random
   weights from a seeded generator. ``Predictor.score_split`` over a
   685-example split (the MOSI test split's size) at batch 128, then
   ``predict_requests`` over 4 requests of 256. Checks: the kernel ran
   once per layer per batch, every prediction is finite, and the fused
   predictions agree with the same weights on ``attention_impl="einsum"``.
5. Profile: one batch's serial latency, its device time by kernel and
   the card's busy share (torch.profiler).
6. The result: a JSON line for the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

S_SERVE = 50
BATCH = 128
N_TEST = 685          # MOSI test split size
N_REQUESTS, REQUEST_SIZE = 4, 256
# bf16 kernel vs plain: both round the probs and the output to bf16 once,
# from fp32 sums taken in different orders. A rounding that lands the
# other way moves a prob by one bf16 ulp (2^-8 relative) and the output by
# one ulp of its magnitude, so the bound is 2^-7 relative plus 2^-6
# absolute for outputs near zero (Σ |Δp|·|v| with |v| ≲ 4).
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6
# fp32: the same math in fp32, summed in a different order.
FP32_ATOL = 1e-5
# fused vs einsum predictions: the two branches do the same attention math
# but sum in different orders; a bf16 rounding flip in any of the 12 layers
# moves a logit by a few ulps of the activations (2^-8 relative). A wrong
# kernel moves logits by their own scale (≈ 0.4 at this init).
PRED_ATOL = 5e-2


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _ragged_mask(rng, b, s):
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0            # one fully padded row
    lengths[-1] = s           # one full row
    return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)


def _time_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(rng, fa, dtype_name, b, s, h=12, dh=64):
    """Kernel vs plain version on one seeded case; returns max abs err."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh
    qkv = torch.from_numpy(
        rng.standard_normal((b, s, 3 * d), dtype=np.float32)).to(
        "cuda", dtype)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    scale = 1.0 / dh ** 0.5
    out = fa.attn_fwd_packed_cuda(qkv, mask, n_heads=h, scale=scale)
    ref = fa.fused_attention_packed_reference(qkv, mask, n_heads=h,
                                              scale=scale)
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    if dtype_name == "bf16":
        bad = err > BF16_ATOL + BF16_RTOL * ref.abs()
    else:
        bad = err > FP32_ATOL
    print(f"kernel vs plain {dtype_name} B={b} S={s} H={h} Dh={dh}: "
          f"max_abs_err={max_err:.3e} finite={bool(torch.isfinite(out).all())}")
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(
            f"kernel disagrees with plain version ({dtype_name} B={b} "
            f"S={s}): max_abs_err={max_err}, {int(bad.sum())} elements "
            "out of tolerance")
    return max_err, (qkv, mask, scale, h)


def make_split(rng, n, s, vocab, dv, da):
    """A seeded PackedSplit shaped like the BERT packing: [CLS] tokens
    [SEP], right padding, zero modality rows on specials and padding."""
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        PackedSplit,
    )

    lengths = rng.integers(3, s + 1, size=n)
    real = np.arange(s)[None, :] < lengths[:, None]
    ids = rng.integers(1000, vocab, size=(n, s)).astype(np.int32)
    ids[:, 0] = 101
    ids[np.arange(n), lengths - 1] = 102
    ids[~real] = 0
    inner = real.copy()
    inner[:, 0] = False
    inner[np.arange(n), lengths - 1] = False
    vis = rng.standard_normal((n, s, dv), dtype=np.float32) * inner[..., None]
    ac = rng.standard_normal((n, s, da), dtype=np.float32) * inner[..., None]
    labels = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
    return PackedSplit(ids, vis.astype(np.float32), ac.astype(np.float32),
                       real.astype(np.int32), np.zeros((n, s), np.int32),
                       labels)


def profile_batch(predictor, split, card, iters=5):
    """Serial latency of one batch, then its device time by kernel."""
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    batch = split.take(np.arange(BATCH)).as_tuple()[:5]

    def one_batch():
        predictor.fetch(predictor.submit(*batch))

    one_batch()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        one_batch()
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"one batch of {BATCH}, submit to fetch, on {card}: median "
          f"{np.median(lat):.3f} ms, max {max(lat):.3f} ms (20 runs)")
    prof = device_time_by_kernel(one_batch, iters)
    print(f"profile of {iters} batches: wall {prof['wall_ms'] / iters:.3f} "
          f"ms/batch, device {prof['device_ms'] / iters:.3f} ms/batch, "
          f"busy {prof['device_ms'] / prof['wall_ms']:.1%}")
    for name, calls, ms in prof["kernels"][:25]:
        print(f"  {ms / iters:9.4f} ms/batch {calls / iters:7.1f} "
              f"calls/batch  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor
    from bert_multimodal_transformer_tpu_torch.utils.seeding import (
        set_random_seed,
    )

    # fp32 products in full fp32, so the fp32 comparison means what it says
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Device
    card = _card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    # 2. Build
    t0 = time.perf_counter()
    lib_path = fa.build_kernels()
    fa.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    print(lib_path.with_suffix(".log").read_text().strip())

    # 3. Kernel against plain, on the card
    rng = np.random.default_rng(args.seed)
    serve_err, serve_case = check_kernel(rng, fa, "bf16", BATCH, S_SERVE)
    check_kernel(rng, fa, "bf16", 8, 512)
    check_kernel(rng, fa, "fp32", 4, 77)
    qkv, mask, scale, h = serve_case

    def run_kernel():
        fa.attn_fwd_packed_cuda(qkv, mask, n_heads=h, scale=scale)

    def run_plain():
        fa.fused_attention_packed_reference(qkv, mask, n_heads=h,
                                            scale=scale)

    for fn in (run_plain, run_kernel):
        _time_ms(fn, 10)  # warm-up
    rounds = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        rounds[name].append(_time_ms(
            run_kernel if name == "kernel" else run_plain, 100))
    kernel_ms = float(np.mean(rounds["kernel"]))
    plain_ms = float(np.mean(rounds["plain"]))
    print(f"attn_fwd_packed bf16 B={BATCH} S={S_SERVE} H=12 Dh=64 on "
          f"{card}: kernel {rounds['kernel']} ms, plain {rounds['plain']} "
          "ms per call")

    # 4. Main path
    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused")
    gen = set_random_seed(args.seed, device="cuda")
    model = MagBertForSequenceClassification(
        cfg, MultimodalConfig(), ds.visual_dim, ds.acoustic_dim,
        torch.bfloat16, device="cuda", generator=gen)
    split = make_split(rng, N_TEST, S_SERVE, cfg.vocab_size, ds.visual_dim,
                       ds.acoustic_dim)
    requests = [make_split(rng, REQUEST_SIZE, S_SERVE, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim).as_tuple()[:5]
                for _ in range(N_REQUESTS)]
    predictor = Predictor(model, batch_size=BATCH)
    predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
    torch.cuda.synchronize()

    fa.attn_fwd_packed_cuda.launches = 0
    t0 = time.perf_counter()
    preds = predictor.predict_split(split)
    t1 = time.perf_counter()
    served = list(predictor.predict_requests(requests))
    t2 = time.perf_counter()
    launches = fa.attn_fwd_packed_cuda.launches

    scores = predictor.score_split(split)
    n_batches = len(BatchIterator(split, BATCH, shuffle=False,
                                  drop_remainder=False)) + N_REQUESTS
    want = cfg.num_hidden_layers * n_batches
    print(f"kernel launches in the main path: {launches} "
          f"(= {cfg.num_hidden_layers} layers x {n_batches} batches: "
          f"{launches == want})")
    if launches != want:
        raise AssertionError(f"expected {want} kernel launches, got "
                             f"{launches}")
    if preds.shape != (N_TEST,) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}, "
                             f"finite={np.isfinite(preds).all()}")
    for out in served:
        if out.shape != (REQUEST_SIZE,) or not np.isfinite(out).all():
            raise AssertionError(f"bad request predictions {out.shape}")
    if set(scores) != {"acc", "mae", "corr", "f_score"}:
        raise AssertionError(f"bad scores {scores}")
    print(f"scores (random weights): {scores}")

    model_e = MagBertForSequenceClassification(
        dataclasses.replace(cfg, attention_impl="einsum"), MultimodalConfig(),
        ds.visual_dim, ds.acoustic_dim, torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed + 1))
    model_e.load_state_dict(model.state_dict())
    preds_e = Predictor(model_e, batch_size=BATCH).predict_split(split)
    pred_err = float(np.abs(preds - preds_e).max())
    print(f"fused vs einsum predictions: max_abs_diff={pred_err:.3e} "
          f"(tolerance {PRED_ATOL}), |pred| max {np.abs(preds_e).max():.3f}")
    if not pred_err <= PRED_ATOL:
        raise AssertionError(f"fused and einsum predictions differ by "
                             f"{pred_err} > {PRED_ATOL}")

    split_eps = N_TEST / (t1 - t0)
    req_eps = N_REQUESTS * REQUEST_SIZE / (t2 - t1)
    print(f"serving on {card}: predict_split {split_eps:.1f} examples/s "
          f"({N_TEST} examples, batch {BATCH}, S={S_SERVE}, bf16), "
          f"predict_requests {req_eps:.1f} examples/s "
          f"({N_REQUESTS} x {REQUEST_SIZE})")
    # One pass over the split lasts ~0.1 s, so host noise moves it; five
    # more passes give a median and a spread.
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict_split(split)
        reps.append(N_TEST / (time.perf_counter() - t0))
    print(f"predict_split over 5 more passes on {card}: median "
          f"{np.median(reps):.1f} examples/s, min {min(reps):.1f}, max "
          f"{max(reps):.1f}")

    # 5. Profile
    profile_batch(predictor, split, card)

    # 6. Result
    print(json.dumps({"kernels": [{
        "name": "attn_fwd_packed",
        "route": "cuda",
        "source": "bert_multimodal_transformer_tpu_torch/csrc/"
                  "attn_fwd_packed.cu",
        "replaces": "bert_multimodal_transformer_tpu/ops/"
                    "fused_attention.py:996",
        "launches": launches,
        "max_abs_err": serve_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
