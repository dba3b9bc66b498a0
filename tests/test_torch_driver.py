"""The port's CLI driver and its data path against the JAX package's: the
parser's flags and defaults, the synthetic data, the tokenizer and the
loaders' batches bit for bit, then ``driver.main`` end to end on the CPU at
``--tiny`` (the fused MAG gate and fused attention through their plain
versions), every flag that is not ported yet exiting with status 2, and the
JAX driver's refusals of the checkpoint flags (ROADMAP A.6, ported: the
runs themselves are ``tests/test_torch_resume.py``).
"""

import argparse

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.data import pipeline as tpipe
from bert_multimodal_transformer_tpu_torch.data import synthetic as tsyn
from bert_multimodal_transformer_tpu_torch.data import tokenization as ttok
from bert_multimodal_transformer_tpu_torch.ops import mag_fused as tmf
from bert_multimodal_transformer_tpu_torch.utils import logging as tlog

RECORD_KEYS = {"epoch", "train_loss", "valid_loss", "test_acc", "test_mae",
               "test_corr", "test_f_score", "best_valid_loss",
               "best_test_acc", "epoch_seconds"}


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_has_the_jax_drivers_flags_and_defaults():
    from bert_multimodal_transformer_tpu import driver as jdriver

    jacts, tacts = _actions(jdriver.build_parser()), _actions(
        tdriver.build_parser())
    assert set(tacts) == set(jacts) | {"device"}
    for dest, j in jacts.items():
        t = tacts[dest]
        assert (t.option_strings, t.default, t.choices, t.nargs, t.const,
                type(t)) == (j.option_strings, j.default, j.choices,
                             j.nargs, j.const, type(j)), dest
        assert getattr(t.type, "__name__", t.type) == getattr(
            j.type, "__name__", j.type), dest
    jargs = vars(jdriver.build_parser().parse_args([]))
    targs = vars(tdriver.build_parser().parse_args([]))
    assert 0 <= targs.pop("seed") <= 9999
    jargs.pop("seed")
    assert targs.pop("device") == "cuda"
    assert targs == jargs


def test_synthetic_data_matches_jax_package():
    from bert_multimodal_transformer_tpu.data import synthetic as jsyn

    kw = dict(visual_dim=35, acoustic_dim=74, n_train=6, n_dev=3,
              n_test=2, seed=7)
    want, got = jsyn.make_dataset(**kw), tsyn.make_dataset(**kw)
    assert tsyn.vocabulary() == jsyn.vocabulary()
    assert set(got) == set(want) == {"train", "dev", "test"}
    for split in want:
        assert len(got[split]) == len(want[split])
        for (gx, gl, gs), (wx, wl, ws) in zip(got[split], want[split]):
            assert gx[0] == wx[0] and gs == ws
            for g, w in ((gx[1], wx[1]), (gx[2], wx[2]), (gl, wl)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


TEXTS = ["Hello, World!", "naïve Café  déjà-vu", "don't stop 123abc",
         "北京 is big", "unaffable \t tabs\nand lines", "x" * 120]


def test_tokenizer_matches_jax_package(tmp_path):
    from bert_multimodal_transformer_tpu.data import tokenization as jtok

    words = tsyn.vocabulary() + ["hello", "world", "cafe", "un", "##aff",
                                 "##able", "##s", "don", "'", "t"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                "[MASK]"] + words) + "\n")
    pairs = [(jtok.get_tokenizer("bert-base-uncased", str(vocab)),
              ttok.get_tokenizer("bert-base-uncased", str(vocab))),
             (jtok.WordPieceTokenizer.from_wordlist(words),
              ttok.WordPieceTokenizer.from_wordlist(words))]
    words_file = tmp_path / "words.txt"
    words_file.write_text("\n".join(words) + "\n")
    pairs += [(jtok.get_tokenizer("xlnet-base-cased", str(words_file)),
               ttok.get_tokenizer("xlnet-base-cased", str(words_file))),
              (jtok.SimpleUnigramTokenizer.from_wordlist(words, True),
               ttok.SimpleUnigramTokenizer.from_wordlist(words, True))]
    for j, t in pairs:
        assert t.vocab == j.vocab and t.vocab_size == j.vocab_size
        assert t.pad_token_id == j.pad_token_id
        for text in TEXTS:
            assert t.tokenize(text) == j.tokenize(text), text
            assert (t.convert_tokens_to_ids(t.tokenize(text))
                    == j.convert_tokens_to_ids(j.tokenize(text)))
    # a SentencePiece .model (ported, ROADMAP A.15): a hand-built one
    # (tests/test_torch_sentencepiece.py holds the readers in full)
    from bert_multimodal_transformer_tpu.data import (
        sentencepiece_native as jsp,
    )

    spiece = tmp_path / "spiece.model"
    spiece.write_bytes(jsp.serialize_model_proto(
        [("<unk>", 0.0, jsp.TYPE_UNKNOWN), ("<cls>", 0.0, jsp.TYPE_CONTROL),
         ("<sep>", 0.0, jsp.TYPE_CONTROL), ("<pad>", 0.0, jsp.TYPE_CONTROL),
         ("▁hello", -1.0, jsp.TYPE_NORMAL), ("▁", -3.0, jsp.TYPE_NORMAL),
         ("a", -2.0, jsp.TYPE_NORMAL), ("b", -2.0, jsp.TYPE_NORMAL)]))
    j = jtok.get_tokenizer("xlnet-base-cased", str(spiece))
    t = ttok.get_tokenizer("xlnet-base-cased", str(spiece))
    assert isinstance(t, ttok.SentencePieceTokenizer)
    assert t.pad_token_id == j.pad_token_id
    for text in TEXTS:
        assert t.tokenize(text) == j.tokenize(text), text
        assert (t.convert_tokens_to_ids(t.tokenize(text) + ["<cls>"])
                == j.convert_tokens_to_ids(j.tokenize(text) + ["<cls>"]))


def _loaders_match_jax(tmp_path, family, tok):
    """set_up_data_loaders on the same pickle, tokenizer vocabulary and
    seed: the same step count and the same batches (two shuffled train
    epochs, dev and test with their padded tails)."""
    from bert_multimodal_transformer_tpu.data import pipeline as jpipe
    from bert_multimodal_transformer_tpu.data import tokenization as jtok

    path = tmp_path / "mosi.pkl"
    tsyn.write_pickle(str(path), tsyn.make_dataset(n_train=21, n_dev=7,
                                                   n_test=5, seed=3))
    kw = dict(model_family=family, max_seq_length=16, train_batch_size=4,
              dev_batch_size=3, test_batch_size=2, n_epochs=2,
              gradient_accumulation_step=2, seed=11)
    jl = jpipe.set_up_data_loaders(
        str(path), getattr(jtok, tok).from_wordlist(tsyn.vocabulary()),
        **kw)
    tl = tpipe.set_up_data_loaders(
        str(path), getattr(ttok, tok).from_wordlist(tsyn.vocabulary()),
        **kw)
    assert tl[3] == jl[3]
    for j_it, t_it, epochs in zip(jl[:3], tl[:3], (2, 1, 1)):
        assert len(t_it) == len(j_it)
        for _ in range(epochs):
            for (jb, jv), (tb, tv) in zip(j_it, t_it, strict=True):
                np.testing.assert_array_equal(tv, jv)
                for g, w in zip(tb, jb, strict=True):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def test_loaders_match_jax_package_bit_for_bit(tmp_path):
    _loaders_match_jax(tmp_path, "bert", "WordPieceTokenizer")


def test_xlnet_loaders_match_jax_package_bit_for_bit(tmp_path):
    """The XLNet packing (left padding, <sep> <cls> last, segments 0/2/3)
    with the word-list unigram tokenizer."""
    _loaders_match_jax(tmp_path, "xlnet", "SimpleUnigramTokenizer")


def test_convert_to_features_matches_the_per_example_path():
    """convert_to_features against align_modalities + prepare_bert_input
    (the port's and the JAX package's), truncation at S − 2 included."""
    from bert_multimodal_transformer_tpu.data import pipeline as jpipe

    tok = ttok.WordPieceTokenizer.from_wordlist(tsyn.vocabulary())
    examples = tsyn.make_dataset(n_train=5, n_dev=1, n_test=1,
                                 seed=4)["train"]
    s = 12   # shorter than the longest examples: truncation is exercised
    packed = tpipe.convert_to_features(examples, s, tok)
    for i, ((words, vis, ac), label, _) in enumerate(examples):
        for mod in (tpipe, jpipe):
            tokens, v, a = mod.align_modalities(words, vis, ac, tok)
            tokens, v, a = tokens[:s - 2], v[:s - 2], a[:s - 2]
            ids, v, a, mask, seg = mod.prepare_bert_input(tokens, v, a, tok,
                                                          s)
            np.testing.assert_array_equal(packed.input_ids[i], ids)
            np.testing.assert_array_equal(packed.input_mask[i], mask)
            np.testing.assert_array_equal(packed.segment_ids[i], seg)
            np.testing.assert_array_equal(packed.visual[i],
                                          v.astype(np.float32))
            np.testing.assert_array_equal(packed.acoustic[i],
                                          a.astype(np.float32))
        assert packed.label_ids[i] == np.float32(label.reshape(()))
    xtok = ttok.SimpleUnigramTokenizer.from_wordlist(tsyn.vocabulary())
    packed = tpipe.convert_to_features(examples, s, xtok,
                                       model_family="xlnet")
    for i, ((words, vis, ac), _, _) in enumerate(examples):
        for mod in (tpipe, jpipe):
            tokens, v, a = mod.align_modalities(words, vis, ac, xtok)
            tokens, v, a = tokens[:s - 2], v[:s - 2], a[:s - 2]
            ids, v, a, mask, seg = mod.prepare_xlnet_input(tokens, v, a,
                                                           xtok, s)
            np.testing.assert_array_equal(packed.input_ids[i], ids)
            np.testing.assert_array_equal(packed.input_mask[i], mask)
            np.testing.assert_array_equal(packed.segment_ids[i], seg)
            np.testing.assert_array_equal(packed.visual[i],
                                          v.astype(np.float32))
    with pytest.raises(ValueError, match="model_family"):
        tpipe.convert_to_features(examples, s, tok, model_family="gpt")


def test_driver_trains_with_the_fused_gate_on_cpu(monkeypatch, capsys):
    """driver.main at --tiny with --use_fused_mag --attention_impl fused
    --device cpu: returns 0, logs the JAX trainer's record keys once per
    epoch, and runs the gate through the fused path (its plain versions
    on the CPU) once per forward and once per train step backward."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    records, calls = [], {"fwd": 0, "bwd": 0}
    real_log = tlog.MetricLogger.log
    monkeypatch.setattr(tlog.MetricLogger, "log",
                        lambda self, r: records.append(dict(r))
                        or real_log(self, r))
    real_fwd, real_bwd = tmf.mag_ops.mag_gate, tmf.mag_bwd_chain_plain

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(tmf.mag_ops, "mag_gate", fwd)
    monkeypatch.setattr(tmf, "mag_bwd_chain_plain", bwd)
    rc = tdriver.main([
        "--model", "bert-base-uncased", "--dataset", "mosi", "--tiny",
        "--synthetic", "--synthetic_sizes", "32", "8", "8", "--n_epochs",
        "1", "--train_batch_size", "8", "--use_fused_mag",
        "--attention_impl", "fused", "--compute_dtype", "float32",
        "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Seed: 3" in out and "epoch:0, train_loss:" in out
    assert len(records) == 1 and set(records[0]) == RECORD_KEYS
    assert np.isfinite(records[0]["train_loss"])
    # 4 train batches; dev and test one batch each
    assert calls == {"fwd": 6, "bwd": 4}


def _xlnet_driver_on_cpu(monkeypatch, capsys, family, extra=()):
    """driver.main --model xlnet-base-cased --tiny --attention_impl fused
    --device cpu (plus ``extra``): asserts it returns 0, prints the JAX
    driver's lines and logs one record with the JAX trainer's keys and a
    finite loss; returns the calls of the ``family`` kernels' plain
    versions (attn_fwd_{family}, attn_bwd_{family}_saved, attn_bwd_{family}
    _reference)."""
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as tfa,
    )

    monkeypatch.setenv("WANDB_MODE", "disabled")
    records, calls = [], {"fwd": 0, "bwd_saved": 0, "bwd": 0}
    real_log = tlog.MetricLogger.log
    monkeypatch.setattr(tlog.MetricLogger, "log",
                        lambda self, r: records.append(dict(r))
                        or real_log(self, r))
    for key, name in (("fwd", f"attn_fwd_{family}_reference"),
                      ("bwd_saved", f"attn_bwd_{family}_saved_reference"),
                      ("bwd", f"attn_bwd_{family}_reference")):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _k=key, _r=real, **kw:
                            calls.__setitem__(_k, calls[_k] + 1)
                            or _r(*a, **kw))
    rc = tdriver.main([
        "--model", "xlnet-base-cased", "--dataset", "mosi", "--tiny",
        "--synthetic", "--synthetic_sizes", "32", "8", "8", "--n_epochs",
        "1", "--train_batch_size", "8", "--attention_impl", "fused",
        "--seed", "3", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Seed: 3" in out and "epoch:0, train_loss:" in out
    assert len(records) == 1 and set(records[0]) == RECORD_KEYS
    assert np.isfinite(records[0]["train_loss"])
    return calls


def test_xlnet_driver_trains_fused_on_cpu(monkeypatch, capsys):
    """The rel attention (its plain versions on the CPU) runs once per
    layer and forward, the saved-probs backward once per layer and train
    step."""
    calls = _xlnet_driver_on_cpu(monkeypatch, capsys, "rel")
    # 2 layers x (4 train + 1 dev + 1 test batches); 2 x 4 train steps
    assert calls == {"fwd": 12, "bwd_saved": 8, "bwd": 0}


def test_xlnet_driver_trains_inkernel_on_cpu(monkeypatch, capsys):
    """``--rel_bias_impl inkernel`` trains and evaluates (the JAX
    ``tests/test_driver.py`` end-to-end run): the full-H ingredients
    kernels' plain versions, #20 once per layer and forward, #22 once per
    layer and train step."""
    calls = _xlnet_driver_on_cpu(monkeypatch, capsys, "relik",
                                 ["--rel_bias_impl", "inkernel"])
    assert calls == {"fwd": 12, "bwd_saved": 8, "bwd": 0}


@pytest.mark.parametrize("argv,says", [
    (["--attention_impl", "flash"], "not available for the XLNet family"),
    (["--rel_bias_impl", "inkernel"], "requires --attention_impl fused"),
    (["--qkv_fusion"], "apply only to the BERT family"),
    (["--qkv_residual", "--attention_impl", "fused"],
     "apply only to the BERT family"),
])
def test_xlnet_family_refusals_match_the_jax_driver(argv, says, capsys):
    """The JAX driver's XLNet exits: status 2 with its message, before any
    data or model is built."""
    rc = tdriver.main(["--model", "xlnet-base-cased", *argv, "--synthetic",
                       "--tiny", "--device", "cpu"])
    assert rc == 2 and says in capsys.readouterr().err


def test_driver_trains_qkv_fusion_on_cpu(monkeypatch, capsys):
    """``--attention_impl fused --qkv_fusion --qkv_residual`` trains and
    evaluates (the JAX ``tests/test_driver.py`` run): #18's plain version
    once per layer and forward, #19's once per layer and train step, and
    no packed attention."""
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as tfa,
    )

    monkeypatch.setenv("WANDB_MODE", "disabled")
    fns = (tfa.attn_fwd_qkvproj_reference, tfa.attn_bwd_qkvproj_reference,
           tfa.attn_fwd_packed_reference, tfa.attn_bwd_packed_saved_reference)
    before = [f.calls for f in fns]
    rc = tdriver.main([
        "--model", "bert-base-uncased", "--dataset", "mosi", "--tiny",
        "--synthetic", "--synthetic_sizes", "32", "8", "8", "--n_epochs",
        "1", "--train_batch_size", "8", "--attention_impl", "fused",
        "--qkv_fusion", "--qkv_residual", "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Seed: 3" in out and "epoch:0, train_loss:" in out
    # 2 layers x (4 train + 1 dev + 1 test batches); 2 x 4 train steps
    assert [f.calls - n for f, n in zip(fns, before)] == [12, 8, 0, 0]


@pytest.mark.parametrize("argv,says", [
    (["--qkv_residual", "--attention_impl", "fused"],
     "--qkv_residual requires --qkv_fusion (it picks that path's backward "
     "variant)"),
    (["--qkv_fusion"],
     "--qkv_fusion requires --attention_impl fused and is unavailable with "
     "--tp_shard_attention"),
    (["--qkv_fusion", "--attention_impl", "fused", "--model_parallel", "2",
      "--tp_shard_attention"],
     "--qkv_fusion requires --attention_impl fused and is unavailable with "
     "--tp_shard_attention"),
])
def test_qkv_fusion_refusals_match_the_jax_driver(argv, says, capsys):
    """The JAX driver's three BERT exits for the QKV-fusion flags: status 2
    with its message, before any data or model is built."""
    rc = tdriver.main(["--model", "bert-base-uncased", *argv, "--synthetic",
                       "--tiny", "--device", "cpu"])
    assert rc == 2 and says in capsys.readouterr().err


def test_bert_refuses_rel_bias_inkernel(capsys):
    rc = tdriver.main(["--rel_bias_impl", "inkernel", "--synthetic",
                       "--tiny", "--device", "cpu"])
    assert rc == 2
    assert "only to the XLNet family" in capsys.readouterr().err


def test_driver_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tdriver.main(["--synthetic", "--tiny"])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err


def test_driver_requires_data_source(capsys):
    rc = tdriver.main(["--device", "cpu"])
    assert rc == 2
    assert "--data_pickle or --synthetic" in capsys.readouterr().err


def _a6_refusal(argv, tmp):
    """The JAX driver's refusal of a checkpoint-flag case (the paths under
    ``tmp``), as the port must print it. A missing
    ``--pretrained_checkpoint`` and an ``--export_hf`` path in a missing
    directory fail in the JAX driver with the exception its ``torch.load``
    and ``torch.save`` raise; the port says the same up front."""
    from bert_multimodal_transformer_tpu.utils.convert import (
        load_torch_state_dict,
    )

    flag = argv[0]
    if flag == "--save_every_steps":
        return "error: --save_every_steps requires --checkpoint_dir"
    if flag == "--predict_only":
        return "error: --predict_only requires --checkpoint_dir"
    if argv[-1] == "--predict_only":
        return f"error: no checkpoint under {tmp}/empty"
    if flag == "--checkpoint_dir":
        return (f"error: --checkpoint_dir {tmp}/full already contains "
                "checkpoints (latest step 4); pass --resume to continue that "
                "run or use a fresh directory")
    if flag == "--pretrained_checkpoint":
        with pytest.raises(FileNotFoundError) as e:
            load_torch_state_dict(argv[1])
        return f"error: --pretrained_checkpoint: {e.value}"
    with pytest.raises(RuntimeError) as e:
        torch.save({}, argv[1])
    return f"error: --export_hf: {e.value}"


def _saved_checkpoint(directory):
    """A checkpoint at step 4 in ``directory`` (of a one-Linear state)."""
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        TrainState,
    )
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    model = torch.nn.Linear(2, 2)
    state = TrainState(step=4, model=model,
                       optimizer=make_optimizer(1e-3, 8)(
                           model.named_parameters()),
                       generator=torch.Generator())
    CheckpointManager(directory).save(state, step=4)


@pytest.mark.parametrize("argv,item", [
    (["--checkpoint_dir", "{tmp}/full"], "A.6"),
    (["--checkpoint_dir", "{tmp}/empty", "--predict_only"], "A.6"),
    (["--save_every_steps", "5"], "A.6"),
    (["--predict_only"], "A.6"),
    (["--pretrained_checkpoint", "{tmp}/model.bin"], "A.6"),
    (["--export_hf", "{tmp}/no_dir/out.bin"], "A.6"),
    (["--model_parallel", "2", "--model", "xlnet-base-cased", "--n_epochs",
      "1", "--synthetic_sizes", "8", "8", "8", "--train_batch_size", "8"],
     "A.10 ported"),
    (["--fsdp", "--n_epochs", "1", "--synthetic_sizes", "8", "8", "8",
      "--train_batch_size", "8"], "A.10 ported"),
    (["--pipeline_parallel", "2", "--pp_microbatches", "2", "--n_epochs",
      "1", "--synthetic_sizes", "8", "8", "8", "--train_batch_size", "8"],
     "A.10 ported"),
    (["--num_processes", "2", "--pipeline_parallel", "2"], "A.10.4 JAX"),
    (["--tp_shard_attention", "--model", "xlnet-base-cased"], "A.10 JAX"),
    (["--compiler_options", "{}"], "A.10.6"),
    (["--mem_len", "4"], "A.8"),
    (["--attention_impl", "flash", "--max_seq_length", "128", "--n_epochs",
      "1", "--synthetic_sizes", "8", "8", "8", "--train_batch_size", "8"],
     "A.2 ported"),
    (["--rng_impl", "threefry2x32", "--n_epochs", "1", "--synthetic_sizes",
      "8", "8", "8", "--train_batch_size", "8"], "A.5 ported"),
    (["--rng_impl", "threefry2x32", "--pipeline_parallel", "2"], "A.5.1"),
], ids=[  # the ids each case had while the table held --vocab *.model,
    # --export_serving and --remat
    *(f"argv{i}-A.6" for i in range(1, 7)),
    *(f"argv{i}-A.10" for i in range(8, 14)), "argv14-A.8", "argv16-A.2",
    "argv17-A.5", "argv18-A.5.1"])
def test_unported_flag_exits_2_naming_its_item(argv, item, capsys,
                                               tmp_path):
    """A flag whose item is open exits 2 naming it. ``--mem_len`` (A.8) is
    ported: on the default model, MAG-BERT, it exits 2 with the JAX
    driver's family refusal and names no item (the XLNet run is
    ``tests/test_torch_mems.py``). ``--model_parallel`` and
    ``--tp_shard_attention`` are ported for both families
    (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_xlnet_tp.py``): XLNet's ``--model_parallel 2`` (the
    FFN split) trains on two CPU ranks and exits 0, and
    ``--tp_shard_attention`` without it exits 2 with the JAX driver's
    refusal. ``--fsdp`` (A.10.2) and ``--pipeline_parallel`` (A.10.3) are
    ported: ``--fsdp`` trains in one process (a data axis of one) and
    ``--pipeline_parallel 2`` on two CPU ranks, both exiting 0
    (``tests/test_torch_fsdp.py``,
    ``tests/test_torch_pipeline_parallel.py``). ``--attention_impl
    flash`` (A.2) is ported: at S=128 it trains and exits 0
    (``tests/test_torch_flash.py``). ``--compiler_options``
    (A.10.6) are XLA's: they exit 2 saying that no torch counterpart
    exists, naming no item. ``--num_processes`` (A.10.4) is ported
    (``tests/test_torch_multiprocess.py``): with ``--pipeline_parallel``
    it exits 2 with the JAX driver's refusal (a bare ``--num_processes 2``
    would wait for its second process). The checkpoint flags (A.6) are ported: their
    cases are the JAX driver's refusals of them, each exiting 2 with its
    message (``_a6_refusal``) before anything is built. ``--vocab *.model``
    (A.15), ``--export_serving`` (A.9) and ``--remat`` (A.14) are ported
    (``tests/test_torch_sentencepiece.py``, ``tests/test_torch_export.py``,
    ``tests/test_torch_remat.py``). ``--rng_impl threefry2x32`` (A.5's RNG
    half) is ported: it trains and exits 0 (its losses against the JAX
    driver's: ``tests/test_torch_threefry_driver.py``); with
    ``--pipeline_parallel`` it exits 2 naming A.5.1."""
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    if item == "A.6" and argv[0] == "--checkpoint_dir":
        (tmp_path / "empty").mkdir()
        _saved_checkpoint(str(tmp_path / "full"))
    rc = tdriver.main(argv + ["--synthetic", "--tiny", "--device", "cpu"])
    err = capsys.readouterr().err
    if item.endswith("ported"):
        assert rc == 0, err
        return
    assert rc == 2
    if item == "A.6":
        assert err.strip() == _a6_refusal(argv, tmp_path)
        assert "ROADMAP" not in err
        return
    if item == "A.8":
        assert "--mem_len is XLNet segment recurrence" in err
        assert "the BERT family has no memory mechanism" in err
        assert "ROADMAP" not in err
        return
    if item == "A.10 JAX":
        assert "--tp_shard_attention requires --model_parallel > 1" in err
        assert "ROADMAP" not in err
        return
    if item == "A.10.4 JAX":
        assert ("--num_processes > 1 composes with the data-parallel "
                "trainer" in err and "not with --pipeline_parallel" in err)
        assert "ROADMAP" not in err
        return
    if item == "A.10.6":
        assert ("--compiler_options are XLA compiler options" in err
                and "no counterpart" in err and "ROADMAP" not in err)
        return
    assert f"{argv[0]}" in err and f"ROADMAP {item}" in err


def test_unported_flags_table_covers_the_parser():
    """Every flag the table names exists in the parser."""
    dests = {a.option_strings[0] for a in _actions(
        tdriver.build_parser()).values()}
    for flag, _, _ in tdriver.UNPORTED:
        assert flag.split()[0] in dests, flag


TINY_RUN = ["--synthetic", "--tiny", "--device", "cpu", "--n_epochs", "1",
            "--train_batch_size", "8", "--synthetic_sizes", "16", "8", "8",
            "--seed", "3"]


@pytest.mark.parametrize("argv,n_ranks", [
    (["--pipeline_parallel", "2", "--pp_microbatches", "2"], 2),
    (["--pipeline_parallel", "2", "--pp_microbatches", "2", "--model",
      "xlnet-base-cased"], 2),
    (["--pipeline_parallel", "2", "--pp_microbatches", "2",
      "--model_parallel", "2", "--attention_impl", "fused"], 4),
    (["--fsdp", "--model_parallel", "2", "--tp_shard_attention",
      "--attention_impl", "fused"], 2),
], ids=["pp-bert", "pp-xlnet", "pp-tp-bert", "fsdp-tp-bert"])
def test_driver_pipeline_and_fsdp_train_on_cpu(argv, n_ranks):
    """``--pipeline_parallel 2`` (both families, and PP×TP) and ``--fsdp``
    over the model ranks of ``--model_parallel 2`` train one epoch on CPU
    ranks: exit 0, finite losses, the same record on every rank."""
    rc, ranks = tdriver.run(TINY_RUN + argv, rank_timeout_s=240)
    assert rc == 0 and len(ranks) == n_ranks
    (rec,) = ranks[0]["history"]
    assert all(np.isfinite(rec[k]) for k in ("train_loss", "valid_loss"))
    for r in ranks[1:]:
        assert r["history"][0]["train_loss"] == rec["train_loss"]
        assert r["history"][0]["valid_loss"] == rec["valid_loss"]


def test_driver_fsdp_trains_in_one_process(capsys):
    """``--fsdp`` with one data rank trains in one process (nothing to
    split, as the JAX trainer on a data axis of one) and prints finite
    losses."""
    rc = tdriver.main(TINY_RUN + ["--fsdp"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(x for x in out.splitlines() if x.startswith("epoch:0"))
    loss = float(line.split("train_loss:")[1].split(",")[0])
    assert np.isfinite(loss)


@pytest.mark.parametrize("argv,says", [
    (["--pipeline_parallel", "2", "--model_parallel", "2",
      "--tp_shard_attention"],
     "--pipeline_parallel does not compose with --tp_shard_attention "
     "(attention stays replicated inside pipeline stages; --model_parallel "
     "gives the Megatron FFN split)"),
    (["--pipeline_parallel", "2", "--fsdp"],
     "--fsdp does not compose with --pipeline_parallel (the pipeline "
     "trainer owns its stage-sharded state layout)"),
    (["--pipeline_parallel", "2", "--remat"],
     "--remat is not applied by the pipeline trainer (parallel/pp.py "
     "builds the stage layers directly); drop one of the flags"),
    (["--pipeline_parallel", "2", "--gradient_accumulation_step", "2"],
     "--gradient_accumulation_step is superseded by --pp_microbatches "
     "under --pipeline_parallel"),
    (["--model", "xlnet-base-cased", "--mem_len", "4", "--fsdp"],
     "--mem_len runs on the data-parallel trainer (mems shard over the "
     "batch axis)"),
    (["--model", "xlnet-base-cased", "--mem_len", "4",
      "--pipeline_parallel", "2"],
     "--mem_len runs on the data-parallel trainer (mems shard over the "
     "batch axis)"),
], ids=["pp-tp_shard_attention", "pp-fsdp", "pp-remat", "pp-grad_accum",
        "fsdp-mem_len", "pp-mem_len"])
def test_pp_and_fsdp_refusals_carry_the_jax_words(argv, says, capsys):
    """Each composition the JAX driver refuses exits 2 with its message
    (``driver.py:388-413``, ``:553-557`` of the JAX package), which the
    JAX driver's source holds word for word."""
    import inspect

    from bert_multimodal_transformer_tpu import driver as jdriver

    assert " ".join(says.split()) in " ".join(
        inspect.getsource(jdriver).replace('"\n', "").replace(
            '" "', "").replace('"', "").split())
    rc = tdriver.main(argv + ["--synthetic", "--tiny", "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"error: {says}" in err
    assert "ROADMAP" not in err


def test_predict_only_serves_a_pipelined_checkpoint(tmp_path, capsys):
    """A ``--pipeline_parallel 2`` run's checkpoint (the pipeline layout)
    serves through ``--predict_only`` on the model layout, with or without
    the pipeline flag, and gives the same metrics either way."""
    ckpt = str(tmp_path / "ckpt")
    rc, _ = tdriver.run(TINY_RUN + ["--pipeline_parallel", "2",
                                    "--pp_microbatches", "2",
                                    "--checkpoint_dir", ckpt],
                        rank_timeout_s=240)
    assert rc == 0
    capsys.readouterr()
    lines = []
    for extra in ([], ["--pipeline_parallel", "2"]):
        assert tdriver.main(["--synthetic", "--tiny", "--device", "cpu",
                             "--seed", "3", "--predict_only",
                             "--checkpoint_dir", ckpt] + extra) == 0
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    import json

    got = [json.loads(x) for x in lines]
    assert got[0] == got[1]
    assert np.isfinite(got[0]["test_mae"])


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
