"""CLI driver (port of the JAX package's ``driver.py``): the same flags and
defaults, plus ``--device``, and its single-device training path for both
model families (MAG-BERT, and MAG-XLNet with ``--model
xlnet-base-cased``): seed, data (``--synthetic`` or ``--data_pickle``),
model config, optimizer, ``Trainer.train`` with the ``MetricLogger``, and
the same printed lines.

``--device`` (default ``cuda``) is where the model and the batches live:
on a card the fused attention and MAG-gate kernels run; without one the
driver exits non-zero unless the caller passes ``--device cpu``, where
the kernels' plain versions run.

Checkpoints (``utils/checkpoint.py``): ``--checkpoint_dir`` saves the
training state at every epoch's end (and every ``--save_every_steps``
optimizer steps) with a resume meta beside it; ``--resume`` continues an
interrupted run where it stopped, bit for bit, adopting its seed;
``--predict_only`` scores the test split with the latest checkpoint's
params (``serving.py::Predictor.from_checkpoint``) and prints one JSON
line; ``--pretrained_checkpoint`` warm-starts the encoder from a local HF
``pytorch_model.bin`` / ``model.safetensors`` and ``--export_hf`` writes
the trained encoder back in HF names (``utils/convert.py``).
``--export_serving PATH`` writes the trained forward as a portable serving
artifact after training (``serving.py::export_forward``, a
``torch.export`` program that ``torch`` alone loads), ``--remat`` (with
``--remat_policy``) rematerializes the encoder layers
(``models/remat.py``), and ``--vocab *.model`` tokenizes XLNet's text with
SentencePiece (``data/tokenization.py``). Flags whose
port has not landed yet exit
with status 2 and a message naming their ROADMAP item; none is ignored
silently. Flag combinations the JAX driver refuses (``FAMILY_ERRORS``, and
its tensor-parallel guards) exit with status 2 and its message, as does
``--compiler_options`` (XLA's options, which no torch call takes).
``--attention_impl flash`` (MAG-BERT) runs the flash-streamed kernels
#6/#7 where the JAX model takes its flash kernel (S a multiple of 128, no
prob dropout: evaluation, or training at a zero dropout), einsum
elsewhere.

A driver process owns its local devices, as the JAX driver's does: it
runs one rank a visible card, and at least the pipe × model block of
``--pipeline_parallel`` × ``--model_parallel`` ranks, which then share the
card (or the CPU with ``--device cpu``) over gloo
(``parallel/multiprocess.py::local_rank_count``); the data axis takes the
rest. One rank trains here; more are started with ``torch.multiprocessing``
spawn (``parallel/mesh.py::run_ranks``, under a timeout), NCCL when each
has a card of its own. ``--model_parallel N`` (MAG-BERT and MAG-XLNet)
splits the FFN over the model axis and, with ``--tp_shard_attention``, the
attention heads too; rank 0 prints the lines. ``run`` returns each rank's
exit status, epoch records, kernel launch counts and backend beside the
exit status. ``--num_processes P --process_id p --coordinator_address
host:port`` trains over P driver processes started by the caller, one
process group over all their ranks (``parallel/multiprocess.py``): each
process loads only its rows of every global batch, and only global rank 0
prints, logs and writes checkpoints and exports.
``--pipeline_parallel P`` (with ``--pp_microbatches``, both families)
trains on a (data, pipe, model) mesh of data × P × max(1, N) ranks
(``parallel/pp.py``, ``parallel/pp_xlnet.py``: the GPipe schedule over P
stages), P × max(1, N) when there are fewer cards, sharing them over
gloo. ``--fsdp`` stores the params and AdamW's moments sharded over the
data axis (``parallel/fsdp.py``); the data axis has the cards left over
(one on a card of its own, where nothing is split). ``--predict_only``
serves a checkpoint of any of them on the model layout, in one process
(or the model ranks of ``--model_parallel``).

Usage:
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --model bert-base-uncased --dataset mosi --synthetic \\
        --use_fused_mag --attention_impl fused
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --model xlnet-base-cased --dataset mosi --synthetic \\
        --attention_impl fused
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --dataset mosi --synthetic --model_parallel 2 \\
        --tp_shard_attention --attention_impl fused
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --model xlnet-base-cased --dataset mosi --synthetic \\
        --model_parallel 2 --tp_shard_attention --attention_impl fused
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --dataset mosi --synthetic --attention_impl flash \\
        --max_seq_length 512
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --dataset mosi --synthetic --attention_impl fused --qkv_fusion
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --dataset mosi --synthetic --checkpoint_dir ckpt \\
        --save_every_steps 100 [--resume]
    python -m bert_multimodal_transformer_tpu_torch.driver \\
        --dataset mosi --synthetic --num_processes 2 --process_id 0 \\
        --coordinator_address 127.0.0.1:8476 &   # and --process_id 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

from bert_multimodal_transformer_tpu_torch.utils.seeding import parse_seed


def _xlnet(a) -> bool:
    return a.model.startswith("xlnet")


# The JAX driver's refusals of flags that do not apply to a model family,
# or not without another flag: (test on the parsed args, its message).
FAMILY_ERRORS = (
    (lambda a: _xlnet(a) and a.attention_impl == "flash",
     "--attention_impl flash is not available for the XLNet family "
     "(rel-attention needs the ebias-streamed fused kernel); use einsum or "
     "fused"),
    (lambda a: (_xlnet(a) and a.rel_bias_impl == "inkernel"
                and a.attention_impl != "fused"),
     "--rel_bias_impl inkernel requires --attention_impl fused (the einsum "
     "path has no score-bias kernel to select)"),
    (lambda a: not _xlnet(a) and a.rel_bias_impl == "inkernel",
     "--rel_bias_impl inkernel applies only to the XLNet family's fused "
     "rel-attention"),
    (lambda a: _xlnet(a) and (a.qkv_fusion or a.qkv_residual),
     "--qkv_fusion/--qkv_residual apply only to the BERT family's packed "
     "fused attention"),
    (lambda a: not _xlnet(a) and a.mem_len,
     "--mem_len is XLNet segment recurrence (Transformer-XL memory, "
     "xlnet.py:81-91); the BERT family has no memory mechanism"),
    (lambda a: not _xlnet(a) and a.qkv_residual and not a.qkv_fusion,
     "--qkv_residual requires --qkv_fusion (it picks that path's backward "
     "variant)"),
    (lambda a: (not _xlnet(a) and a.qkv_fusion
                and (a.attention_impl != "fused" or a.tp_shard_attention)),
     "--qkv_fusion requires --attention_impl fused and is unavailable with "
     "--tp_shard_attention"),
)

# (flag as the user writes it, test on the parsed args, ROADMAP item).
UNPORTED = (
    ("--rng_impl threefry2x32 with --pipeline_parallel > 1",
     lambda a: a.rng_impl == "threefry2x32" and a.pipeline_parallel > 1,
     "A.5.1"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # Reference flags (multimodal_driver.py:35-57):
    p.add_argument("--dataset", type=str, choices=["mosi", "mosei"],
                   default="mosi")
    p.add_argument("--max_seq_length", type=int, default=50)
    p.add_argument("--train_batch_size", type=int, default=48)
    p.add_argument("--dev_batch_size", type=int, default=128)
    p.add_argument("--test_batch_size", type=int, default=128)
    p.add_argument("--n_epochs", type=int, default=40)
    p.add_argument("--beta_shift", type=float, default=1.0)
    p.add_argument("--dropout_prob", type=float, default=0.5)
    p.add_argument("--model", type=str,
                   choices=["bert-base-uncased", "bert-large-uncased",
                            "xlnet-base-cased"],
                   default="bert-base-uncased")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--gradient_accumulation_step", type=int, default=1)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--seed", type=parse_seed, default="random")
    # Extras of the JAX driver, same names and defaults:
    p.add_argument("--data_pickle", type=str, default=None,
                   help="Path to {mosi,mosei}.pkl in the documented format")
    p.add_argument("--vocab", type=str, default=None,
                   help="Local vocab.txt (BERT), or a SentencePiece "
                        "spiece.model or word list (XLNet)")
    p.add_argument("--pretrained_checkpoint", type=str, default=None,
                   help="Local HF pytorch_model.bin or model.safetensors "
                        "(or a directory holding one) to warm-start the "
                        "encoder from; MAG and the classifier keep their "
                        "fresh init")
    p.add_argument("--synthetic", action="store_true",
                   help="Generate synthetic data (offline smoke/dev mode)")
    p.add_argument("--synthetic_sizes", type=int, nargs=3,
                   default=[256, 64, 64], metavar=("TRAIN", "DEV", "TEST"))
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_fused_mag", action="store_true",
                   help="MAG gate through the fused gate kernels "
                        "(ops/mag_fused.py)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Save the training state (params, optimizer "
                        "moments, step, generator) here at every epoch's "
                        "end, with a resume meta and metrics.jsonl "
                        "(utils/checkpoint.py)")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run from --checkpoint_dir "
                        "toward the same --n_epochs total. With a resume "
                        "meta present (written by this driver), training "
                        "continues exactly where it stopped, mid-epoch "
                        "included, reproducing the uninterrupted run's "
                        "parameters bit for bit (pass the SAME --n_epochs "
                        "as the interrupted run: the LR schedule spans the "
                        "planned total step count)")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="Also checkpoint every N optimizer steps "
                        "(preemption-safe mid-epoch resume; requires "
                        "--checkpoint_dir). 0 = epoch-end saves only")
    p.add_argument("--qkv_fusion", action="store_true",
                   help="With --attention_impl fused (BERT): the QKV "
                        "projection inside the attention kernels "
                        "(ops/fused_attention.py::fused_attention_qkvproj)")
    p.add_argument("--qkv_residual", action="store_true",
                   help="With --qkv_fusion: keep the projection for the "
                        "backward instead of recomputing it there")
    p.add_argument("--max_steps", type=int, default=0,
                   help="Stop this run after N optimizer steps (0 = no "
                        "limit); with --save_every_steps, a later --resume "
                        "continues exactly where it stopped")
    p.add_argument("--export_hf", type=str, default=None,
                   help="After training, export the encoder weights in HF "
                        "names at this path: a torch .bin, or safetensors "
                        "when the path ends in .safetensors (reverse of "
                        "--pretrained_checkpoint; MAG and classifier "
                        "params are not exported)")
    p.add_argument("--export_serving", type=str, default=None,
                   help="After training, export the deterministic forward "
                        "(weights captured) as a torch.export program at "
                        "this path, loadable for inference without this "
                        "package's model code (serving.py; symbolic batch "
                        "dim, portable einsum attention). A '.json' "
                        "sidecar records the calling convention")
    p.add_argument("--predict_only", action="store_true",
                   help="Skip training: restore --checkpoint_dir's latest "
                        "params and print the test metrics as one JSON "
                        "line (inference/serving mode)")
    p.add_argument("--tiny", action="store_true",
                   help="Tiny model geometry (smoke tests)")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize the encoder layers: recompute each "
                        "layer's activations in the backward "
                        "(models/remat.py)")
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "dots"],
                   help="With --remat (BERT): full recompute (lowest "
                        "memory) or save the matmul outputs (faster "
                        "backward)")
    p.add_argument("--use_zero", action="store_true",
                   help="Include exactly-zero labels in test metrics "
                        "(reference test_score_model use_zero flag)")
    p.add_argument("--attention_impl", type=str, default="einsum",
                   choices=["einsum", "fused", "flash"],
                   help="Attention backend: einsum = plain PyTorch; fused "
                        "= the packed attention kernels "
                        "(ops/fused_attention.py); flash (BERT) = the "
                        "flash-streamed kernels without prob dropout where "
                        "S %% 128 == 0 (ops/attention.py::flash_attention), "
                        "einsum elsewhere")
    p.add_argument("--rel_bias_impl", type=str, default="auto",
                   choices=["auto", "stream", "inkernel"],
                   help="XLNet only: auto = the ingredients kernels "
                        "past the full-H reach, stream = an assembled bias "
                        "(head-blocked to 640, flash-streamed past it), "
                        "inkernel = the ingredients kernels at every length "
                        "(full-H while they reach)")
    p.add_argument("--mem_len", type=int, default=0,
                   help="XLNet segment recurrence: carry Transformer-XL "
                        "memory of this many positions across the batch "
                        "stream (K = seq + mem_len in every layer). XLNet "
                        "family only")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Model (tensor-parallel) mesh axis size: splits "
                        "the FFN Megatron-style over the 'model' axis "
                        "(parallel/tp.py); the data axis gets the rest of "
                        "the cards. MAG-BERT and MAG-XLNet")
    p.add_argument("--tp_shard_attention", action="store_true",
                   help="With --model_parallel > 1: also head-shard "
                        "attention over the model axis (einsum, or fused "
                        "through the split-layout kernels; needs n_head "
                        "%% mp == 0)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="Pipeline-parallel stage count: encoder layers "
                        "split into N stages over a 'pipe' mesh axis, "
                        "GPipe microbatch schedule, activations passed "
                        "between neighbouring stages (parallel/pp.py BERT, "
                        "parallel/pp_xlnet.py XLNet); data axis gets the "
                        "remaining cards; needs layer count %% N == 0")
    p.add_argument("--pp_microbatches", type=int, default=4,
                   help="With --pipeline_parallel > 1: microbatches per "
                        "step (the pipeline's accumulation factor; the "
                        "per-data-shard batch must divide by it)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: store params + optimizer moments "
                        "sharded over the data axis, gathered for each "
                        "step (parallel/fsdp.py). Composes with "
                        "--model_parallel; not with --pipeline_parallel")
    p.add_argument("--rng_impl", type=str, default="rbg",
                   choices=["threefry2x32", "rbg"],
                   help="rbg: the card's own dropout streams (Philox in "
                        "the attention kernel, torch generators "
                        "elsewhere). threefry2x32: the JAX package's "
                        "stream, replayed: init params and every hidden, "
                        "MAG and einsum-attention dropout mask as the JAX "
                        "driver draws them (kernel T on the card), the "
                        "fused kernels' Philox seeded with JAX's draw; "
                        "not with --pipeline_parallel (ROADMAP A.5.1)")
    p.add_argument("--wire_dtype", type=str, default=None,
                   choices=[None, "bfloat16", "float16"],
                   help="--predict_only: cast the modality features to "
                        "this dtype on the host before the device "
                        "transfer (halves the request payload; bfloat16 "
                        "is lossless for a bf16-compute model: "
                        "serving.Predictor wire_dtype)")
    p.add_argument("--compiler_options", type=str, default=None,
                   help="XLA compiler options of the JAX driver: refused "
                        "here (no torch counterpart)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="Multi-process training (one driver process per "
                        "host, each owning its local cards; "
                        "parallel/multiprocess.py): start this many "
                        "processes, each with its own --process_id; every "
                        "process feeds only its rows of each global batch "
                        "and all ranks join one process group")
    p.add_argument("--process_id", type=int, default=0,
                   help="This process's index in [0, --num_processes)")
    p.add_argument("--coordinator_address", type=str,
                   default="127.0.0.1:8476",
                   help="host:port where process 0 serves the process "
                        "group's store (with --num_processes > 1)")
    # The port's own:
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Where the model runs: cuda (the kernels; exits "
                        "non-zero without a card) or cpu (their plain "
                        "versions)")
    return p


def _tp_guards(args) -> list:
    """The JAX driver's refusals of tensor-parallel flags."""
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        XLNetConfig,
    )

    errors = []
    if args.model_parallel < 1:
        errors.append(f"--model_parallel must be >= 1, got "
                      f"{args.model_parallel}")
    if _xlnet(args) and args.mem_len and (args.pipeline_parallel > 1
                                          or args.fsdp
                                          or args.model_parallel > 1):
        errors.append("--mem_len runs on the data-parallel trainer (mems "
                      "shard over the batch axis)")
    if args.pipeline_parallel > 1:
        # the JAX driver's refusals, the first that applies
        if args.tp_shard_attention:
            errors.append("--pipeline_parallel does not compose with "
                          "--tp_shard_attention (attention stays replicated "
                          "inside pipeline stages; --model_parallel gives "
                          "the Megatron FFN split)")
        elif args.fsdp:
            errors.append("--fsdp does not compose with --pipeline_parallel "
                          "(the pipeline trainer owns its stage-sharded "
                          "state layout)")
        elif args.remat:
            errors.append("--remat is not applied by the pipeline trainer "
                          "(parallel/pp.py builds the stage layers "
                          "directly); drop one of the flags")
    if args.tp_shard_attention:
        if args.model_parallel <= 1:
            errors.append("--tp_shard_attention requires --model_parallel"
                          " > 1")
        if args.attention_impl == "flash":
            errors.append("--tp_shard_attention supports einsum and fused "
                          "attention, not flash")
        if _xlnet(args):
            n_head = (XLNetConfig.tiny() if args.tiny
                      else XLNetConfig.xlnet_base_cased()).n_head
        else:
            n_head = (BertConfig.tiny() if args.tiny
                      else BertConfig.bert_large_uncased()
                      if args.model == "bert-large-uncased"
                      else BertConfig.bert_base_uncased()
                      ).num_attention_heads
        if args.model_parallel > 1 and n_head % args.model_parallel:
            errors.append(f"--tp_shard_attention needs n_head ({n_head}) "
                          f"divisible by --model_parallel "
                          f"({args.model_parallel})")
    if args.pipeline_parallel > 1 and args.gradient_accumulation_step != 1:
        errors.append("--gradient_accumulation_step is superseded by "
                      "--pp_microbatches under --pipeline_parallel")
    return errors


def _multiprocess_guards(args) -> list:
    """The JAX driver's refusals under ``--num_processes > 1``, checked
    before any process group starts (the first of its checks that
    applies)."""
    bad = [f for f, cond in (
        ("--pipeline_parallel", args.pipeline_parallel > 1),
        ("--tp_shard_attention", args.tp_shard_attention),
        ("--mem_len", bool(args.mem_len)),
        ("--predict_only", args.predict_only),
    ) if cond]
    if bad:
        return ["--num_processes > 1 composes with the data-parallel "
                "trainer, --fsdp (ZeRO-3 over the cross-process data axis) "
                "and --model_parallel (Megatron FFN, model axis "
                f"intra-process); not with {' '.join(bad)}"]
    if not 0 <= args.process_id < args.num_processes:
        return [f"--process_id {args.process_id} outside "
                f"[0, {args.num_processes})"]
    for flag, b in (("--train_batch_size",
                     args.train_batch_size * args.gradient_accumulation_step),
                    ("--dev_batch_size", args.dev_batch_size),
                    ("--test_batch_size", args.test_batch_size)):
        if b % args.num_processes != 0:
            return [f"{flag} (global {b}) must divide by --num_processes "
                    f"{args.num_processes} (each process feeds an equal "
                    "row-block)"]
    return []


def _use_pp(args) -> bool:
    """A pipelined run (``--predict_only`` serves the model layout)."""
    return args.pipeline_parallel > 1 and not args.predict_only


def _checkpoint_guard(args):
    """The JAX driver's refusals of the checkpoint flags, checked before
    anything is built (the JAX driver checks them after its model): the
    first that applies, or None. A missing ``--pretrained_checkpoint`` and
    an ``--export_hf`` path in a directory that does not exist fail in the
    JAX driver with the exception of the file's ``torch.load`` (at start)
    and ``torch.save`` (after training); here they are refused up front
    with the same text."""
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        checkpoint_file,
    )

    if args.pretrained_checkpoint:
        try:
            checkpoint_file(args.pretrained_checkpoint)
        except FileNotFoundError as e:
            return f"--pretrained_checkpoint: {e}"
    if args.predict_only:
        if not args.checkpoint_dir:
            return "--predict_only requires --checkpoint_dir"
        if CheckpointManager(args.checkpoint_dir).latest_step() is None:
            return f"no checkpoint under {args.checkpoint_dir}"
        return None
    if args.save_every_steps and not args.checkpoint_dir:
        return "--save_every_steps requires --checkpoint_dir"
    if args.checkpoint_dir and not args.resume:
        latest = CheckpointManager(args.checkpoint_dir).latest_step()
        if latest is not None:
            # a fresh run into a directory holding another run's
            # checkpoints would let the save dedup skip saves and publish
            # a resume meta naming the OLD run's parameters
            return (f"--checkpoint_dir {args.checkpoint_dir} already "
                    f"contains checkpoints (latest step {latest}); pass "
                    "--resume to continue that run or use a fresh "
                    "directory")
    if args.export_hf:
        parent = os.path.dirname(args.export_hf)
        if parent and not os.path.isdir(parent):
            return f"--export_hf: Parent directory {parent} does not exist."
    return None


def _rank_main(rank: int, args, devices) -> dict:
    """One rank of a multi-rank run, its process group joined
    (``parallel/multiprocess.py::initialize``): the mesh over ``devices``
    (every global rank's, of which this rank reads its own), then the
    training. ``--num_processes``: this process feeds only its rows."""
    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        make_mesh,
        make_pp_mesh,
    )

    if _use_pp(args):
        mp = max(1, args.model_parallel)
        mesh = make_pp_mesh(
            args.pipeline_parallel, model_parallel=mp, devices=devices,
            data_parallel=len(devices) // (args.pipeline_parallel * mp))
    else:
        mesh = make_mesh(MeshConfig(data_parallel=-1,
                                    model_parallel=args.model_parallel),
                         devices, num_processes=args.num_processes)
    rc, summary = _train(args, mesh)
    return _rank_result(rc, summary, mesh)


def _rank_result(rc, summary, mesh) -> dict:
    from bert_multimodal_transformer_tpu_torch.ops import launch_counts

    return {"rc": rc, "history": summary["history"] if summary else None,
            "launches": launch_counts(), "backend": mesh.backend}


def local_ranks(args, n_cards: int) -> int:
    """The ranks this driver process runs (``parallel/multiprocess.py::
    local_rank_count``: one a card, at least the pipe × model block)."""
    from bert_multimodal_transformer_tpu_torch.parallel.multiprocess import (
        local_rank_count,
    )

    pipe = args.pipeline_parallel if _use_pp(args) else 1
    return local_rank_count(n_cards, pipe, args.model_parallel)


def _run_ranks(args, timeout_s: float):
    """Train on this process's ranks: here when it runs one rank alone,
    else spawned (``parallel/mesh.py::run_ranks``)."""
    import torch
    import torch.distributed as dist

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        mesh_shape,
        placement,
        run_ranks,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.multiprocess import (
        initialize,
    )

    mp = args.model_parallel
    n_cards = torch.cuda.device_count() if args.device == "cuda" else 0
    world = local_ranks(args, n_cards)
    nproc = args.num_processes
    if nproc == 1 and world == 1:
        return _train(args, None)[0], []
    if nproc > 1 and world % mp:
        # each process holds whole data rows: its ranks hold the model axis
        print(f"error: --model_parallel {mp} must divide the {world} local "
              "devices per process", file=sys.stderr)
        return 2, []
    if _use_pp(args):
        # the JAX driver's pipe x model block, data over the rest
        need = args.pipeline_parallel * max(1, mp)
        if world % need:
            print(f"error: --pipeline_parallel {args.pipeline_parallel} "
                  f"x --model_parallel {max(1, mp)} does not divide the "
                  f"{world} devices", file=sys.stderr)
            return 2, []
        data, micro = world // need, args.pp_microbatches
    else:
        try:
            data, _ = mesh_shape(MeshConfig(data_parallel=-1,
                                            model_parallel=mp), world)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2, []
        micro = args.gradient_accumulation_step
    data *= nproc
    if args.train_batch_size % (data * micro):
        print(f"error: --train_batch_size {args.train_batch_size} does not "
              f"split over {micro} micro-batches x {data} data ranks",
              file=sys.stderr)
        return 2, []
    local = placement(world) if args.device == "cuda" else ["cpu"] * world
    coordinator = args.coordinator_address if nproc > 1 else None
    if world > 1:
        ranks = run_ranks(_rank_main, world, (args, local * nproc),
                          timeout_s=timeout_s, devices=local,
                          coordinator_address=coordinator,
                          num_processes=nproc, process_id=args.process_id)
        return max(r["rc"] for r in ranks), ranks
    # one rank of several processes: here, joined as run_ranks joins one
    initialize(coordinator, nproc, args.process_id, device=local[0],
               timeout_s=timeout_s)
    try:
        ranks = [_rank_main(0, args, local * nproc)]
    finally:
        dist.destroy_process_group()
    return ranks[0]["rc"], ranks


def run(argv=None, rank_timeout_s: float = 3600.0):
    """``main`` returning (exit status, each of this process's ranks'
    {"rc", "history", "launches", "backend"} when it runs ranks of a
    process group, else []). The ranks are stopped after
    ``rank_timeout_s`` seconds."""
    args = build_parser().parse_args(argv)
    refused = [msg for test, msg in FAMILY_ERRORS if test(args)]
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=sys.stderr)
        return 2, []
    unported = [(flag, item) for flag, test, item in UNPORTED if test(args)]
    if unported:
        for flag, item in unported:
            print(f"error: {flag} is not ported to the PyTorch driver yet "
                  f"(ROADMAP {item})", file=sys.stderr)
        return 2, []
    if args.compiler_options is not None:
        from bert_multimodal_transformer_tpu_torch.training.trainer import (
            COMPILER_OPTIONS_REFUSAL,
        )

        print(f"error: --{COMPILER_OPTIONS_REFUSAL}", file=sys.stderr)
        return 2, []
    refused = _tp_guards(args)
    if args.num_processes > 1 and not refused:
        # the JAX driver checks these before anything else of the run
        refused = _multiprocess_guards(args)
        ckpt_refusal = None if refused else _checkpoint_guard(args)
    else:
        ckpt_refusal = _checkpoint_guard(args)
    if ckpt_refusal is not None:
        refused.append(ckpt_refusal)
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=sys.stderr)
        return 2, []
    if args.resume and args.checkpoint_dir:
        # exact continuation requires the interrupted run's seed (data
        # shuffle, synthetic data, init and dropout streams derive from it)
        meta = _read_resume_meta(
            os.path.join(args.checkpoint_dir, "resume_meta.json"))
        if meta is not None and "seed" in meta and meta["seed"] != args.seed:
            print(f"Resume: adopting the interrupted run's seed "
                  f"{meta['seed']} (was {args.seed})")
            args.seed = meta["seed"]

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no CUDA device is visible; pass "
              "--device cpu to run the kernels' plain versions on the CPU",
              file=sys.stderr)
        return 2, []
    return _run_ranks(args, rank_timeout_s)


def main(argv=None) -> int:
    return run(argv)[0]


def _train(args, mesh):
    """The training run of ``main`` on this process's place: one device
    (``mesh`` None) or a rank of the mesh, or its test scoring under
    ``--predict_only``. Returns (exit status, the trainer's summary or
    None)."""
    import torch
    import torch.distributed as dist

    device = mesh.device if mesh is not None else torch.device(args.device)
    is_main = mesh is None or mesh.rank == 0

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
        dtype_from_str,
    )
    from bert_multimodal_transformer_tpu_torch.data import synthetic
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        set_up_data_loaders,
    )
    from bert_multimodal_transformer_tpu_torch.data.tokenization import (
        SimpleUnigramTokenizer,
        WordPieceTokenizer,
        get_tokenizer,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.parallel import tp as tp_lib
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )
    from bert_multimodal_transformer_tpu_torch.utils import (
        convert as convert_lib,
    )
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )
    from bert_multimodal_transformer_tpu_torch.utils.logging import (
        MetricLogger,
    )
    from bert_multimodal_transformer_tpu_torch.utils.seeding import (
        set_random_seed,
    )

    ds = DatasetConfig.from_name(args.dataset)
    is_xlnet = _xlnet(args)
    set_random_seed(args.seed)
    if is_main:
        print(f"Seed: {args.seed}")

    # ---- data -----------------------------------------------------------
    loader_kw = dict(
        model_family="xlnet" if is_xlnet else "bert",
        max_seq_length=args.max_seq_length,
        train_batch_size=args.train_batch_size,
        dev_batch_size=args.dev_batch_size,
        test_batch_size=args.test_batch_size, n_epochs=args.n_epochs,
        gradient_accumulation_step=args.gradient_accumulation_step,
        seed=args.seed, num_processes=args.num_processes,
        process_id=args.process_id)
    if args.synthetic:
        tokenizer = (SimpleUnigramTokenizer if is_xlnet
                     else WordPieceTokenizer).from_wordlist(
                         synthetic.vocabulary())
    elif args.data_pickle is None:
        print("error: provide --data_pickle or --synthetic", file=sys.stderr)
        return 2, None
    else:
        tokenizer = get_tokenizer(args.model, args.vocab)
    vocab_size = getattr(tokenizer, "vocab_size", 30522)
    if isinstance(tokenizer, WordPieceTokenizer):
        # the native C++ tokenize/align path where g++ builds it, as the
        # JAX driver takes it (the same ids; data/native.py)
        from bert_multimodal_transformer_tpu_torch.data import native

        if native.available():
            tokenizer = native.NativeWordPieceTokenizer(tokenizer)
    if args.synthetic:
        data = synthetic.make_dataset(
            visual_dim=ds.visual_dim, acoustic_dim=ds.acoustic_dim,
            n_train=args.synthetic_sizes[0], n_dev=args.synthetic_sizes[1],
            n_test=args.synthetic_sizes[2], seed=args.seed)
        with tempfile.TemporaryDirectory() as tmp:
            pickle_path = os.path.join(tmp, f"{args.dataset}.pkl")
            synthetic.write_pickle(pickle_path, data)
            train_it, dev_it, test_it, num_steps = set_up_data_loaders(
                pickle_path, tokenizer, **loader_kw)
    else:
        train_it, dev_it, test_it, num_steps = set_up_data_loaders(
            args.data_pickle, tokenizer, **loader_kw)

    # ---- model ----------------------------------------------------------
    mm = MultimodalConfig(beta_shift=args.beta_shift,
                          dropout_prob=args.dropout_prob,
                          injection_index=1 if is_xlnet else 0,
                          use_fused_kernel=args.use_fused_mag)
    if is_xlnet:
        cfg = (XLNetConfig.tiny(vocab_size) if args.tiny
               else XLNetConfig.xlnet_base_cased())
        model_cls = MagXLNetForSequenceClassification
        remat = (args.remat,)
    else:
        cfg = (BertConfig.tiny(vocab_size) if args.tiny else
               (BertConfig.bert_large_uncased()
                if args.model == "bert-large-uncased"
                else BertConfig.bert_base_uncased()))
        if args.max_seq_length > cfg.max_position_embeddings:
            # a longer position table rather than indices past its end
            cfg = dataclasses.replace(
                cfg, max_position_embeddings=args.max_seq_length)
        model_cls = MagBertForSequenceClassification
        remat = (args.remat, args.remat_policy)
    if args.synthetic and not args.tiny:
        # the synthetic tokenizer's vocabulary, the model's geometry
        cfg = dataclasses.replace(cfg, vocab_size=max(vocab_size, 128))
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    if args.qkv_fusion:
        cfg = dataclasses.replace(cfg, qkv_fusion=True,
                                  qkv_residual=args.qkv_residual)
    if args.tp_shard_attention:
        cfg = dataclasses.replace(cfg, tp_attention_mesh=mesh)
    if is_xlnet:
        cfg = dataclasses.replace(cfg, rel_bias_impl=args.rel_bias_impl)
        if args.mem_len:
            # segment recurrence: K = mem_len + qlen in every layer
            cfg = dataclasses.replace(cfg, mem_len=args.mem_len)
    model = model_cls(
        cfg, mm, ds.visual_dim, ds.acoustic_dim,
        dtype_from_str(args.compute_dtype), *remat, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))

    # ---- training -------------------------------------------------------
    tx = make_optimizer(
        learning_rate=args.learning_rate, num_train_steps=max(num_steps, 1),
        warmup_proportion=args.warmup_proportion)
    if _use_pp(args):
        from bert_multimodal_transformer_tpu_torch.parallel.pp import (
            PipelineTrainer,
        )
        from bert_multimodal_transformer_tpu_torch.parallel.pp_xlnet import (
            XLNetPipelineTrainer,
        )

        trainer = (XLNetPipelineTrainer if is_xlnet else PipelineTrainer)(
            model=model, tx=tx, mesh=mesh, n_micro=args.pp_microbatches)
    else:
        trainer = Trainer(model=model, tx=tx, mesh=mesh,
                          grad_accum=args.gradient_accumulation_step,
                          tp_shard_attention=args.tp_shard_attention,
                          fsdp=args.fsdp, mem_len=args.mem_len or None,
                          multiprocess=args.num_processes > 1,
                          rng_impl=args.rng_impl)
    # The JAX driver draws its init sample from the train loader, which
    # takes the first epoch's shuffle; drawing it here too keeps the
    # training data order the same for the same seed.
    next(iter(train_it))
    state = trainer.init_state(args.seed)
    if args.pretrained_checkpoint:
        # a [512, D] position table into a longer one raises here
        convert_lib.load_pretrained_into_model(
            model, args.pretrained_checkpoint,
            family="xlnet" if is_xlnet else "bert")

    if args.predict_only:
        return _predict_only(args, model, test_it.split, mesh, is_main), None

    ckpt = None
    start_epoch, start_batch, initial_history = 0, 0, None
    meta_path = (os.path.join(args.checkpoint_dir, "resume_meta.json")
                 if args.checkpoint_dir else None)
    jsonl_path = (os.path.join(args.checkpoint_dir, "metrics.jsonl")
                  if args.checkpoint_dir else None)
    if args.checkpoint_dir:
        # run() refused a fresh run into a directory with checkpoints
        ckpt = CheckpointManager(args.checkpoint_dir)
        if args.resume:
            meta = _read_resume_meta(meta_path)
            if meta is not None:
                # exact continuation: restore the state the meta names
                # (params before the optimizer's moments), replay the data
                # order, carry the completed epochs
                try:
                    state = ckpt.restore(state, meta["state_step"])
                except ValueError as e:  # the other --rng_impl's stream
                    print(f"error: {e}", file=sys.stderr)
                    return 2, None
                start_epoch = meta["start_epoch"]
                start_batch = meta["start_batch"]
                train_it.restore_position(meta["iter_shuffles_to_burn"])
                initial_history = _read_epoch_history(jsonl_path,
                                                      before=start_epoch)
                if is_main:
                    print(f"Resuming at epoch {start_epoch}, batch "
                          f"{start_batch} (step {meta['state_step']})")
            else:
                # checkpoints without a meta: a warm resume of the state
                try:
                    state = ckpt.restore_latest(state) or state
                except ValueError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2, None

    logger = (MetricLogger(project="MAG", config=vars(args),
                           jsonl_path=jsonl_path) if is_main else None)

    def _save(st, *, step, next_epoch, next_batch, burn):
        # save the state BEFORE publishing the meta that names it (the
        # directory holds no foreign checkpoints, so a matching latest step
        # is this run's own earlier save). Every rank takes part in the
        # save; rank 0 writes it and publishes the meta. Rank 0's view of
        # the directory decides for every rank, so all of them agree even
        # where the hosts do not share it.
        fresh = [ckpt.latest_step() != step]
        if mesh is not None and mesh.size > 1:
            dist.broadcast_object_list(fresh, src=0)
        if fresh[0]:
            ckpt.save(st, step=step)
        if is_main:
            _write_resume_meta(meta_path, {
                "state_step": step, "start_epoch": next_epoch,
                "start_batch": next_batch, "iter_shuffles_to_burn": burn,
                "seed": args.seed})

    def save_epoch(st, epoch_i):
        if ckpt is not None:
            # resume into the next epoch with a fresh shuffle
            _save(st, step=st.step, next_epoch=epoch_i + 1, next_batch=0,
                  burn=train_it.shuffles_done)

    step_callback = None
    if ckpt is not None and args.save_every_steps > 0:
        def step_callback(st, epoch_i, bi):
            if st.step % args.save_every_steps == 0:
                # resume mid-epoch: replay the current epoch's shuffle
                # (the last one drawn), skip the batches already trained
                _save(st, step=st.step, next_epoch=epoch_i,
                      next_batch=bi + 1, burn=train_it.shuffles_done - 1)

    state, summary = trainer.train(
        state, train_it, dev_it, test_it, args.n_epochs, logger=logger,
        epoch_callback=save_epoch, use_zero=args.use_zero,
        start_epoch=start_epoch, start_batch=start_batch,
        initial_history=initial_history, step_callback=step_callback,
        max_steps=args.max_steps or None)
    if ckpt is not None:
        ckpt.close()
    if args.export_hf or args.export_serving:
        # every rank gathers; a pipelined run from the pipeline layout
        full = (trainer.model_params(state) if _use_pp(args)
                else tp_lib.full_state_dict(model))
    if args.export_hf and is_main:
        export = (convert_lib.export_xlnet_state_dict(full, cfg.n_layer)
                  if is_xlnet else convert_lib.export_bert_state_dict(
                      full, cfg.num_hidden_layers))
        convert_lib.save_hf_state_dict(export, args.export_hf)
        print(f"Exported HF-format weights to {args.export_hf}")
    if args.export_serving and is_main:
        from bert_multimodal_transformer_tpu_torch import serving

        # the full-size weights into an unsharded copy (serving.py)
        program = serving.export_forward(
            model, full, seq_len=args.max_seq_length,
            visual_dim=ds.visual_dim, acoustic_dim=ds.acoustic_dim,
            platforms=("cuda", "cpu"))
        serving.save_artifact(
            args.export_serving, program,
            meta={"family": "xlnet" if is_xlnet else "bert",
                  "model": args.model, "dataset": args.dataset})
        print(f"Exported serving artifact to {args.export_serving}")
    if logger is not None:
        logger.finish()
    return 0, summary


def _predict_only(args, model, test_split, mesh, is_main: bool) -> int:
    """``--predict_only``: the latest checkpoint's params into ``model``,
    the test split scored, one JSON line of ``test_*`` metrics."""
    from bert_multimodal_transformer_tpu_torch.config import dtype_from_str
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    if args.wire_dtype == "float16" and is_main:
        # fp16's max finite value is 65504: unnormalized visual/acoustic
        # features beyond it overflow to inf on the wire. Only bf16 (the
        # exponent range of fp32) is lossless for a bf16-compute model.
        print("warning: --wire_dtype float16 overflows to inf above "
              "65504; it is NOT lossless on unnormalized features — "
              "use bfloat16 unless your features are bounded",
              file=sys.stderr)
    predictor = Predictor.from_checkpoint(
        model, args.checkpoint_dir, batch_size=args.test_batch_size,
        wire_dtype=(dtype_from_str(args.wire_dtype) if args.wire_dtype
                    else None),
        mem_len=args.mem_len or None, mesh=mesh)
    scores = predictor.score_split(test_split, use_zero=args.use_zero)
    if is_main:
        print(json.dumps({"test_" + k: v for k, v in scores.items()}))
    return 0


def _write_resume_meta(path: str, meta: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)  # atomic: never a half-written meta


def _read_resume_meta(path):
    if path is None or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_epoch_history(jsonl_path, *, before: int):
    """The completed epochs' records from metrics.jsonl (appended across
    runs), so a resumed run's best_valid_loss/best_test_acc stay right."""
    if jsonl_path is None or not os.path.exists(jsonl_path):
        return None
    by_epoch = {}
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("epoch") is not None and rec["epoch"] < before:
                # the latest run's record wins (restarts may repeat epochs)
                by_epoch[rec["epoch"]] = rec
    return [by_epoch[e] for e in sorted(by_epoch)] or None


if __name__ == "__main__":
    sys.exit(main())
