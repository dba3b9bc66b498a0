"""CLI driver (port of the JAX package's ``driver.py``): the same flags and
defaults, plus ``--device``, and its single-device training path for both
model families (MAG-BERT, and MAG-XLNet with ``--model
xlnet-base-cased``): seed, data (``--synthetic`` or ``--data_pickle``),
model config, optimizer, ``Trainer.train`` with the ``MetricLogger``, and
the same printed lines.

``--device`` (default ``cuda``) is where the model and the batches live:
on a card the fused attention and MAG-gate kernels run; without one the
driver exits non-zero unless the caller passes ``--device cpu``, where
the kernels' plain versions run. Flags whose port has not landed yet exit
with status 2 and a message naming their ROADMAP item; none is ignored
silently. Flag combinations the JAX driver refuses (``FAMILY_ERRORS``, and
its tensor-parallel guards) exit with status 2 and its message.

``--model_parallel N`` (MAG-BERT) starts data × N ranks with
``torch.multiprocessing`` spawn (``parallel/mesh.py::run_ranks``, under
a timeout): N ranks when there are fewer than N cards (ranks
share a card, over gloo), else one rank per card (N must divide their
count; NCCL); on the CPU with ``--device cpu``. Each rank runs the same
training on its (data, model) place of the mesh, with the FFN split over
the model axis and, with ``--tp_shard_attention``, the attention heads
too; rank 0 prints the lines. ``run`` returns each rank's exit status,
epoch records, kernel launch counts and backend beside the exit status.

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
        --dataset mosi --synthetic --attention_impl fused --qkv_fusion
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ("--vocab *.model (SentencePiece)",
     lambda a: _xlnet(a) and (a.vocab or "").endswith(".model"), "A.15"),
    ("--checkpoint_dir", lambda a: a.checkpoint_dir is not None, "A.6"),
    ("--resume", lambda a: a.resume, "A.6"),
    ("--save_every_steps", lambda a: a.save_every_steps != 0, "A.6"),
    ("--predict_only", lambda a: a.predict_only, "A.6"),
    ("--pretrained_checkpoint",
     lambda a: a.pretrained_checkpoint is not None, "A.6"),
    ("--export_hf", lambda a: a.export_hf is not None, "A.6"),
    ("--export_serving", lambda a: a.export_serving is not None, "A.9"),
    ("--model_parallel (XLNet)",
     lambda a: _xlnet(a) and a.model_parallel != 1, "A.10"),
    ("--tp_shard_attention (XLNet)",
     lambda a: _xlnet(a) and a.tp_shard_attention, "A.10"),
    ("--fsdp", lambda a: a.fsdp, "A.10"),
    ("--pipeline_parallel", lambda a: a.pipeline_parallel != 1, "A.10"),
    ("--num_processes", lambda a: a.num_processes != 1, "A.10"),
    ("--compiler_options", lambda a: a.compiler_options is not None,
     "A.10"),
    ("--remat", lambda a: a.remat, "A.14"),
    ("--attention_impl flash", lambda a: a.attention_impl == "flash",
     "A.2"),
    ("--rng_impl threefry2x32", lambda a: a.rng_impl == "threefry2x32",
     "A.5"),
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
                   help="Local vocab.txt (BERT) or word list (XLNet; a "
                        "SentencePiece .model is not ported yet, ROADMAP "
                        "A.15)")
    p.add_argument("--pretrained_checkpoint", type=str, default=None,
                   help="Local HF pytorch_model.bin to warm-start "
                        "(not ported yet: ROADMAP A.6)")
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
                   help="not ported yet (ROADMAP A.6)")
    p.add_argument("--resume", action="store_true",
                   help="not ported yet (ROADMAP A.6)")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="not ported yet (ROADMAP A.6)")
    p.add_argument("--qkv_fusion", action="store_true",
                   help="With --attention_impl fused (BERT): the QKV "
                        "projection inside the attention kernels "
                        "(ops/fused_attention.py::fused_attention_qkvproj)")
    p.add_argument("--qkv_residual", action="store_true",
                   help="With --qkv_fusion: keep the projection for the "
                        "backward instead of recomputing it there")
    p.add_argument("--max_steps", type=int, default=0,
                   help="Stop this run after N optimizer steps (0 = no "
                        "limit)")
    p.add_argument("--export_hf", type=str, default=None,
                   help="not ported yet (ROADMAP A.6)")
    p.add_argument("--export_serving", type=str, default=None,
                   help="not ported yet (ROADMAP A.9)")
    p.add_argument("--predict_only", action="store_true",
                   help="not ported yet (ROADMAP A.6)")
    p.add_argument("--tiny", action="store_true",
                   help="Tiny model geometry (smoke tests)")
    p.add_argument("--remat", action="store_true",
                   help="not ported yet (ROADMAP A.14)")
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "dots"],
                   help="With --remat (not ported yet, ROADMAP A.14)")
    p.add_argument("--use_zero", action="store_true",
                   help="Include exactly-zero labels in test metrics "
                        "(reference test_score_model use_zero flag)")
    p.add_argument("--attention_impl", type=str, default="einsum",
                   choices=["einsum", "fused", "flash"],
                   help="Attention backend: einsum = plain PyTorch; fused "
                        "= the packed attention kernels "
                        "(ops/fused_attention.py); flash is not ported "
                        "yet (ROADMAP A.2)")
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
                        "the cards. MAG-BERT (XLNet: ROADMAP A.10)")
    p.add_argument("--tp_shard_attention", action="store_true",
                   help="With --model_parallel > 1: also head-shard "
                        "attention over the model axis (einsum, or fused "
                        "through the split-layout kernels; needs n_head "
                        "%% mp == 0)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="not ported yet above 1 (ROADMAP A.10)")
    p.add_argument("--pp_microbatches", type=int, default=4,
                   help="With --pipeline_parallel (not ported yet, "
                        "ROADMAP A.10)")
    p.add_argument("--fsdp", action="store_true",
                   help="not ported yet (ROADMAP A.10)")
    p.add_argument("--rng_impl", type=str, default="rbg",
                   choices=["threefry2x32", "rbg"],
                   help="rbg: the card's own dropout streams (Philox in "
                        "the attention kernel, torch generators "
                        "elsewhere); threefry2x32, the JAX package's "
                        "portable stream, is not ported yet (ROADMAP A.5)")
    p.add_argument("--wire_dtype", type=str, default=None,
                   choices=[None, "bfloat16", "float16"],
                   help="With --predict_only (not ported yet, ROADMAP "
                        "A.6)")
    p.add_argument("--compiler_options", type=str, default=None,
                   help="not ported yet (ROADMAP A.10)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="not ported yet above 1 (ROADMAP A.10)")
    p.add_argument("--process_id", type=int, default=0,
                   help="With --num_processes (not ported yet, ROADMAP "
                        "A.10)")
    p.add_argument("--coordinator_address", type=str,
                   default="127.0.0.1:8476",
                   help="With --num_processes (not ported yet, ROADMAP "
                        "A.10)")
    # The port's own:
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Where the model runs: cuda (the kernels; exits "
                        "non-zero without a card) or cpu (their plain "
                        "versions)")
    return p


def _tp_guards(args) -> list:
    """The JAX driver's refusals of tensor-parallel flags."""
    from bert_multimodal_transformer_tpu_torch.config import BertConfig

    errors = []
    if args.model_parallel < 1:
        errors.append(f"--model_parallel must be >= 1, got "
                      f"{args.model_parallel}")
    if args.tp_shard_attention:
        if args.model_parallel <= 1:
            errors.append("--tp_shard_attention requires --model_parallel"
                          " > 1")
        n_head = (BertConfig.tiny() if args.tiny
                  else BertConfig.bert_large_uncased()
                  if args.model == "bert-large-uncased"
                  else BertConfig.bert_base_uncased()).num_attention_heads
        if args.model_parallel > 1 and n_head % args.model_parallel:
            errors.append(f"--tp_shard_attention needs n_head ({n_head}) "
                          f"divisible by --model_parallel "
                          f"({args.model_parallel})")
    return errors


def _rank_main(rank: int, args, devices) -> dict:
    """One rank of a multi-rank run: the mesh, then the training."""
    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import launch_counts
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=-1,
                                model_parallel=args.model_parallel),
                     devices)
    rc, summary = _train(args, mesh)
    return {"rc": rc, "history": summary["history"] if summary else None,
            "launches": launch_counts(), "backend": mesh.backend}


def _run_ranks(args, timeout_s: float):
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        mesh_shape,
        placement,
        run_ranks,
    )

    mp = args.model_parallel
    n_cards = torch.cuda.device_count() if args.device == "cuda" else 0
    world = n_cards if n_cards >= mp else mp
    try:
        data, _ = mesh_shape(MeshConfig(data_parallel=-1, model_parallel=mp),
                             world)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, []
    if args.train_batch_size % (data * args.gradient_accumulation_step):
        print(f"error: --train_batch_size {args.train_batch_size} does not "
              f"split over {args.gradient_accumulation_step} micro-batches "
              f"x {data} data ranks", file=sys.stderr)
        return 2, []
    devices = (placement(world) if args.device == "cuda"
               else ["cpu"] * world)
    ranks = run_ranks(_rank_main, world, (args, devices),
                      timeout_s=timeout_s, devices=devices)
    return max(r["rc"] for r in ranks), ranks


def run(argv=None, rank_timeout_s: float = 3600.0):
    """``main`` returning (exit status, each rank's {"rc", "history",
    "launches", "backend"} under ``--model_parallel`` > 1, else []). The
    ranks are stopped after ``rank_timeout_s`` seconds."""
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
    refused = _tp_guards(args)
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=sys.stderr)
        return 2, []

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no CUDA device is visible; pass "
              "--device cpu to run the kernels' plain versions on the CPU",
              file=sys.stderr)
        return 2, []
    if args.model_parallel > 1:
        return _run_ranks(args, rank_timeout_s)
    return _train(args, None)[0], []


def main(argv=None) -> int:
    return run(argv)[0]


def _train(args, mesh):
    """The training run of ``main`` on this process's place: one device
    (``mesh`` None) or a rank of the mesh. Returns (exit status, the
    trainer's summary or None)."""
    import torch

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
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
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
        seed=args.seed)
    if args.synthetic:
        data = synthetic.make_dataset(
            visual_dim=ds.visual_dim, acoustic_dim=ds.acoustic_dim,
            n_train=args.synthetic_sizes[0], n_dev=args.synthetic_sizes[1],
            n_test=args.synthetic_sizes[2], seed=args.seed)
        tokenizer = (SimpleUnigramTokenizer if is_xlnet
                     else WordPieceTokenizer).from_wordlist(
                         synthetic.vocabulary())
        with tempfile.TemporaryDirectory() as tmp:
            pickle_path = os.path.join(tmp, f"{args.dataset}.pkl")
            synthetic.write_pickle(pickle_path, data)
            train_it, dev_it, test_it, num_steps = set_up_data_loaders(
                pickle_path, tokenizer, **loader_kw)
    else:
        if args.data_pickle is None:
            print("error: provide --data_pickle or --synthetic",
                  file=sys.stderr)
            return 2, None
        tokenizer = get_tokenizer(args.model, args.vocab)
        train_it, dev_it, test_it, num_steps = set_up_data_loaders(
            args.data_pickle, tokenizer, **loader_kw)

    # ---- model ----------------------------------------------------------
    mm = MultimodalConfig(beta_shift=args.beta_shift,
                          dropout_prob=args.dropout_prob,
                          injection_index=1 if is_xlnet else 0,
                          use_fused_kernel=args.use_fused_mag)
    vocab_size = getattr(tokenizer, "vocab_size", 30522)
    if is_xlnet:
        cfg = (XLNetConfig.tiny(vocab_size) if args.tiny
               else XLNetConfig.xlnet_base_cased())
        model_cls = MagXLNetForSequenceClassification
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
        dtype_from_str(args.compute_dtype), device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))

    # ---- training -------------------------------------------------------
    tx = make_optimizer(
        learning_rate=args.learning_rate, num_train_steps=max(num_steps, 1),
        warmup_proportion=args.warmup_proportion)
    trainer = Trainer(model=model, tx=tx, mesh=mesh,
                      grad_accum=args.gradient_accumulation_step,
                      tp_shard_attention=args.tp_shard_attention,
                      mem_len=args.mem_len or None)
    # The JAX driver draws its init sample from the train loader, which
    # takes the first epoch's shuffle; drawing it here too keeps the
    # training data order the same for the same seed.
    next(iter(train_it))
    state = trainer.init_state(args.seed)
    logger = MetricLogger(project="MAG", config=vars(args)) if is_main \
        else None
    _, summary = trainer.train(state, train_it, dev_it, test_it,
                               args.n_epochs, logger=logger,
                               use_zero=args.use_zero,
                               max_steps=args.max_steps or None)
    if logger is not None:
        logger.finish()
    return 0, summary


if __name__ == "__main__":
    sys.exit(main())
