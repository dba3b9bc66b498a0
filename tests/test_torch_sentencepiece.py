"""The port's SentencePiece reader (``data/sentencepiece_native.py``) and
``SentencePieceTokenizer`` against the JAX package's, on hand-built
``ModelProto`` files (no ``spiece.model`` is downloaded): the same bytes
from both serializers, the same pieces and ids from both readers and
tokenizers, specials included, then the port's driver through
``--vocab <fixture>.model --model xlnet-base-cased``.
"""

import numpy as np
import pytest

from bert_multimodal_transformer_tpu.data import sentencepiece_native as jsp
from bert_multimodal_transformer_tpu.data import tokenization as jtok
from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.data import (
    sentencepiece_native as tsp,
)
from bert_multimodal_transformer_tpu_torch.data import synthetic as tsyn
from bert_multimodal_transformer_tpu_torch.data import tokenization as ttok

TEXTS = ["hello ab", "abc", "cd", "abxyz", "hello  ab\tcd ", "", "   ",
         "ab🙂", "x<sym>y", "ﬁx", "ａｂ ① ﬁ", "Q hello", "<0x41>",
         "unaffable don't", "北京 ab"]


def _base(sp):
    return [
        ("<unk>", 0.0, sp.TYPE_UNKNOWN),
        ("<s>", 0.0, sp.TYPE_CONTROL),
        ("</s>", 0.0, sp.TYPE_CONTROL),
        ("<cls>", 0.0, sp.TYPE_CONTROL),
        ("<sep>", 0.0, sp.TYPE_CONTROL),
        ("<pad>", 0.0, sp.TYPE_CONTROL),
        ("▁ab", -1.0, sp.TYPE_NORMAL),
        ("▁a", -2.0, sp.TYPE_NORMAL),
        ("b", -1.5, sp.TYPE_NORMAL),
        ("▁c", -1.0, sp.TYPE_NORMAL),
        ("d", -1.0, sp.TYPE_NORMAL),
        ("▁abc", -5.0, sp.TYPE_NORMAL),
        ("c", -1.0, sp.TYPE_NORMAL),
        ("▁hello", -1.0, sp.TYPE_NORMAL),
        ("▁", -3.0, sp.TYPE_NORMAL),
    ]


def _fixture(sp, kind):
    """(pieces, normalizer spec or None) of fixture ``kind`` built with
    module ``sp``'s helpers."""
    pieces = _base(sp)
    if kind == "base":
        return pieces, None
    if kind == "no_specials":
        # <cls>, <sep>, <pad> missing: the tokenizer appends their ids
        return [p for p in pieces if p[0] not in ("<cls>", "<sep>",
                                                  "<pad>")], None
    if kind == "byte_fallback":
        return pieces + [(f"<0x{i:02X}>", -6.0, sp.TYPE_BYTE)
                         for i in range(256)], None
    if kind == "user_defined":
        return pieces + [("<sym>", 0.0, sp.TYPE_USER_DEFINED),
                         ("ﬁx", 0.0, sp.TYPE_USER_DEFINED)], None
    rules = sp.build_nmt_nfkc_rules(max_cp=0x100)
    rules["Q"] = "ab"   # a rule only the charsmap knows
    return pieces, {"name": "nmt_nfkc",
                    "precompiled_charsmap": sp.build_precompiled_charsmap(
                        rules)}


KINDS = ("base", "no_specials", "byte_fallback", "user_defined", "charsmap")


def _model_file(tmp_path, kind) -> str:
    pieces, spec = _fixture(jsp, kind)
    path = tmp_path / f"{kind}.model"
    path.write_bytes(jsp.serialize_model_proto(pieces, normalizer_spec=spec))
    return str(path)


@pytest.mark.parametrize("kind", KINDS)
def test_serializer_and_parsers_match_jax(kind):
    jpieces, jspec = _fixture(jsp, kind)
    tpieces, tspec = _fixture(tsp, kind)
    assert tpieces == jpieces and tspec == jspec
    blob = jsp.serialize_model_proto(jpieces, normalizer_spec=jspec)
    assert tsp.serialize_model_proto(tpieces, normalizer_spec=tspec) == blob
    assert tsp.parse_model_proto(blob) == jsp.parse_model_proto(blob)
    assert (tsp.parse_normalizer_spec(blob)
            == jsp.parse_normalizer_spec(blob))


@pytest.mark.parametrize("kind", KINDS)
def test_reader_pieces_and_ids_match_jax(tmp_path, kind):
    path = _model_file(tmp_path, kind)
    jreader = jsp.PurePythonSentencePiece().Load(path)
    treader = tsp.PurePythonSentencePiece().Load(path)
    assert treader.GetPieceSize() == jreader.GetPieceSize()
    assert treader.unk_id() == jreader.unk_id()
    for text in TEXTS:
        pieces = treader.EncodeAsPieces(text)
        assert pieces == jreader.EncodeAsPieces(text), text
        assert ([treader.PieceToId(p) for p in pieces]
                == [jreader.PieceToId(p) for p in pieces]), text
    for i in range(treader.GetPieceSize()):
        assert treader.IdToPiece(i) == jreader.IdToPiece(i)


@pytest.mark.parametrize("kind", KINDS)
def test_tokenizer_matches_jax_specials_included(tmp_path, kind):
    path = _model_file(tmp_path, kind)
    jt, tt = jtok.SentencePieceTokenizer(path), ttok.SentencePieceTokenizer(
        path)
    assert isinstance(tt.sp, tsp.PurePythonSentencePiece)
    assert tt.pad_token_id == jt.pad_token_id
    specials = [tt.cls_token, tt.sep_token, tt.pad_token, tt.unk_token]
    for text in TEXTS:
        tokens = tt.tokenize(text)
        assert tokens == jt.tokenize(text), text
        assert (tt.convert_tokens_to_ids(tokens + specials)
                == jt.convert_tokens_to_ids(tokens + specials)), text
    if kind == "no_specials":
        # appended after the vocabulary, in the order sep, cls, pad
        n = tt.sp.GetPieceSize()
        assert tt.convert_tokens_to_ids(["<sep>", "<cls>", "<pad>"]) == [
            n, n + 1, n + 2]
    else:
        assert tt.convert_tokens_to_ids(["<cls>", "<sep>", "<pad>"]) == [
            3, 4, 5]


def test_get_tokenizer_takes_a_model_file(tmp_path):
    path = _model_file(tmp_path, "base")
    tok = ttok.get_tokenizer("xlnet-base-cased", path)
    assert isinstance(tok, ttok.SentencePieceTokenizer)
    assert tok.tokenize("ab cd") == ["▁ab", "▁c", "d"]
    assert tok.tokenize("ab cd") == jtok.get_tokenizer(
        "xlnet-base-cased", path).tokenize("ab cd")


def test_driver_runs_with_a_spiece_model(tmp_path, capsys):
    """``--vocab <fixture>.model --model xlnet-base-cased`` on a data
    pickle: the SentencePiece tokenizer packs the text and the run trains
    (the synthetic words fall mostly on the fixture's unknown piece)."""
    vocab = _model_file(tmp_path, "base")
    data = tsyn.make_dataset(visual_dim=47, acoustic_dim=74, n_train=8,
                             n_dev=4, n_test=4, seed=1)
    pickle_path = str(tmp_path / "mosi.pkl")
    tsyn.write_pickle(pickle_path, data)
    rc = tdriver.main(["--model", "xlnet-base-cased", "--vocab", vocab,
                       "--data_pickle", pickle_path, "--tiny", "--device",
                       "cpu", "--n_epochs", "1", "--train_batch_size", "4",
                       "--max_seq_length", "16", "--seed", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    line = [x for x in out.splitlines() if x.startswith("epoch:0")]
    assert len(line) == 1
    loss = float(line[0].split("train_loss:")[1].split(",")[0])
    assert np.isfinite(loss)


def test_reader_remat_and_export_ops_import_no_jax():
    """The SentencePiece reader, remat and the custom ops pull in neither
    jax, flax nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import bert_multimodal_transformer_tpu_torch.data."
        "sentencepiece_native\n"
        "import bert_multimodal_transformer_tpu_torch.models.remat\n"
        "import bert_multimodal_transformer_tpu_torch.ops.export_ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'bert_multimodal_transformer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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
