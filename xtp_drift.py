#!/usr/bin/env python3
"""The two-rank bf16 MAG-XLNet TP step against one card's own bf16 drift.

    python3 xtp_drift.py [--seeds 0 1 2]

For each seed, on one NVIDIA GPU with two tensor-parallel ranks sharing it
over gloo (``chip_smoke.py`` phase 6l's head-sharded step: xlnet-base-cased,
MOSI dims, fused attention, B=48 S=50, dropout 0, lr 1e-5), every rank
runs the same first train step three ways from the same weights and batch:

* one card in fp32 (the reference),
* one card in bf16,
* its shard of the two-rank head-sharded model in bf16,

and reads, leaf by leaf with phase 6l's scale measure (``_grad_gap``: max
|got − want| over max |want|, on the rank's chunk of the leaf):

* ``gap``: the two-rank bf16 gradient against the one-card bf16 one (what
  phase 6l holds at ``XTP_GRAD_TOL["bf16"]``);
* ``drift``: the one-card bf16 gradient against the one-card fp32 one;
* ``err``: the two-rank bf16 gradient against the one-card fp32 one.

A gap within the one card's drift is bf16 rounding: the sharded step then
moves a gradient no further than one card's bf16 step moves it from fp32.
An ``err`` far past ``drift`` would say the sharded step is less accurate
than one card's, a fault. The script prints one JSON line per seed (the
leaf of the worst gap, and every leaf whose gap passes its drift) and a
summary line; it exits non-zero without a card.
"""

import argparse
import json
import sys
import time

import chip_smoke as cs


def drift_rank(rank, seeds):
    """Every seed's three first-step gradients on this rank, and the
    per-leaf gap, drift and err of this rank's chunks."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.parallel import tp
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig(data_parallel=-1,
                                model_parallel=cs.TP_RANKS))
    out = {}
    for seed in seeds:
        _, g32 = cs.xlnet_tp_steps(None, seed, "fp32", 0.0, n_steps=1)
        _, g16 = cs.xlnet_tp_steps(None, seed, "bf16", 0.0, n_steps=1)
        _, gtp = cs.xlnet_tp_steps(mesh, seed, "bf16", 0.0, n_steps=1)

        def chunk(name, full):
            return tp.shard_tensor(full, tp.tp_pspec_for_path(
                name, shard_attention=True), mesh)

        leaves = {}
        for name, ref in g32.items():
            if name not in gtp or name not in g16:
                continue
            r32, r16 = chunk(name, ref), chunk(name, g16[name])
            leaves[name] = {"gap": cs._grad_gap(gtp[name], r16),
                            "drift": cs._grad_gap(r16, r32),
                            "err": cs._grad_gap(gtp[name], r32)}
        out[seed] = leaves
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("xtp_drift: no CUDA device visible", file=sys.stderr)
        return 1
    from bert_multimodal_transformer_tpu_torch.ops import kernels as tk
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    card = cs._card()
    print(card)
    t0 = time.perf_counter()
    tk.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ranks = run_ranks(drift_rank, cs.TP_RANKS, (args.seeds,),
                      timeout_s=1500)
    print(f"{len(args.seeds)} seeds x 3 steps on {cs.TP_RANKS} ranks: "
          f"{time.perf_counter() - t0:.2f} s")
    summary = []
    for seed in args.seeds:
        leaves = {f"rank {r}: {name}": v for r, out in enumerate(ranks)
                  for name, v in out[seed].items()}
        worst = max(leaves, key=lambda k: leaves[k]["gap"])
        past = sorted((k for k, v in leaves.items()
                       if v["gap"] > v["drift"]),
                      key=lambda k: -leaves[k]["gap"] / leaves[k]["drift"])
        row = {"seed": seed, "card": card,
               "worst_gap_leaf": worst, **leaves[worst],
               "max_gap": max(v["gap"] for v in leaves.values()),
               "max_drift": max(v["drift"] for v in leaves.values()),
               "max_err": max(v["err"] for v in leaves.values()),
               "max_gap_over_drift": max(
                   v["gap"] / max(v["drift"], 1e-30)
                   for v in leaves.values()),
               "max_err_over_drift": max(
                   v["err"] / max(v["drift"], 1e-30)
                   for v in leaves.values()),
               "leaves": len(leaves),
               "leaves_past_drift": {k: leaves[k] for k in past[:8]},
               "n_past": len(past)}
        summary.append(row)
        print(json.dumps(row))
    within = all(r["gap"] <= r["drift"] for r in summary)
    print(json.dumps({"xtp_drift": {
        "seeds": args.seeds, "card": card,
        "worst_gap_within_its_drift": within,
        "max_gap": max(r["max_gap"] for r in summary),
        "max_drift": max(r["max_drift"] for r in summary)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
