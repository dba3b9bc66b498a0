"""The port's native C++ WordPiece tokenizer (``data/native.py`` over its
own copy of ``data/_native/magdata.cc``) against the JAX package's native
tokenizer and the Python tokenizer, on the CPU.

* The token ids and word indices equal the JAX native tokenizer's and the
  Python reference's, exactly, on the inputs of
  ``tests/test_native_and_utils.py`` and on words that take the Python
  fallback (non-ASCII and control characters);
* the port's loaders give the same packed split through the native
  tokenizer as through the Python one;
* the library builds into ``build/native/`` under a name keyed by the
  source, not beside the source;
* the port's driver takes the native tokenizer for WordPiece, as the JAX
  driver does.
"""

import numpy as np
import pytest

from bert_multimodal_transformer_tpu.data import native as jnative
from bert_multimodal_transformer_tpu.data.tokenization import (
    WordPieceTokenizer as JWordPieceTokenizer,
)
from bert_multimodal_transformer_tpu_torch.data import native, synthetic
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    convert_to_features,
)
from bert_multimodal_transformer_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
)

DV, DA, S = 3, 4, 12
CASES = [
    ["good", "bad", "goodly"],
    ["Hello,", "WORLD!"],
    ["unsplittable-token", "movie"],
    ["a"],
    [""],
    ["great", "zzzqqq"],
    ["café", "naïve", "good"],      # non-ASCII: the Python path
    ["tab\there", "bell\x07", "ok"],  # control characters: the Python path
]


@pytest.fixture(scope="module")
def tokenizers():
    if not native.available():
        pytest.skip("g++ cannot build the native library here")
    py_tok = WordPieceTokenizer.from_wordlist(synthetic.vocabulary())
    return py_tok, native.NativeWordPieceTokenizer(py_tok)


def _python_ids(tok, words):
    ids, inv = [], []
    for i, w in enumerate(words):
        pieces = tok.tokenize(w)
        ids.extend(tok.convert_tokens_to_ids(pieces))
        inv.extend([i] * len(pieces))
    return ids, inv


@pytest.mark.parametrize("words", CASES, ids=[f"case{i}" for i in
                                              range(len(CASES))])
def test_native_ids_equal_the_jax_native_and_python_ids(tokenizers, words):
    py_tok, nat = tokenizers
    got = nat.tokenize_words_to_ids(words)
    assert got == _python_ids(py_tok, words)
    jtok = JWordPieceTokenizer.from_wordlist(synthetic.vocabulary())
    want = (jnative.NativeWordPieceTokenizer(jtok).tokenize_words_to_ids(words)
            if jnative.available() else _python_ids(jtok, words))
    assert got == want


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_native_pipeline_matches_the_python_pipeline(tokenizers, family):
    py_tok, nat = tokenizers
    data = synthetic.make_dataset(visual_dim=DV, acoustic_dim=DA,
                                  n_train=16, n_dev=2, n_test=2, seed=7)
    a = convert_to_features(data["train"], S, py_tok, family)
    b = convert_to_features(data["train"], S, nat, family)
    for name in ("input_ids", "input_mask", "segment_ids", "visual",
                 "acoustic", "label_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_library_builds_under_build_native(tokenizers):
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert native.build() == str(path)


def test_driver_takes_the_native_tokenizer(tokenizers, monkeypatch, capsys):
    """The port's driver wraps its WordPiece tokenizer in the native one,
    as the JAX driver (``driver.py:353-359``) does."""
    from bert_multimodal_transformer_tpu_torch import driver
    from bert_multimodal_transformer_tpu_torch.data import pipeline

    seen = []
    real = pipeline.set_up_data_loaders

    def spy(path, tokenizer, **kw):
        seen.append(type(tokenizer).__name__)
        return real(path, tokenizer, **kw)

    monkeypatch.setattr(pipeline, "set_up_data_loaders", spy)
    rc = driver.main(["--synthetic", "--tiny", "--device", "cpu",
                      "--n_epochs", "1", "--train_batch_size", "8",
                      "--synthetic_sizes", "8", "8", "8"])
    assert rc == 0, capsys.readouterr().err
    assert seen == ["NativeWordPieceTokenizer"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
