"""Tokenizers: a copy of the JAX package's ``data/tokenization.py`` for the
BERT family (``BasicTokenizer``, ``WordPieceTokenizer``), XLNet's
SentencePiece tokenizer over a ``.model`` file
(``SentencePieceTokenizer``) and its word-list stand-in
(``SimpleUnigramTokenizer``), with ``get_tokenizer``. The port cannot
import that package, whose ``__init__`` pulls in jax (ROADMAP A.12); the
tests hold the two equal.

The pipeline uses a tokenizer through three APIs: per-word
``tokenize(word)``, ``convert_tokens_to_ids(tokens)`` and the cls/sep/pad
special tokens; modality alignment depends on per-word subword counts.
Vocabularies are always local files or in-memory lists.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
            123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting + optional lowercasing and
    accent stripping (the BERT "basic" pre-tokenizer)."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._tokenize_cjk(text)
        # NFC normalization, matching the installed HF BertTokenizer
        # (transformers 4.x bugfix: the same character in composed vs
        # decomposed codepoints must tokenize identically — load-bearing
        # for cased models, where no NFD accent-strip follows to
        # reconcile the two forms). Cross-validated byte-for-byte against
        # transformers.BertTokenizer in tests/test_tokenizer_hf_parity.py.
        text = unicodedata.normalize("NFC", text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        return (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        )

    def _tokenize_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if self._is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)


class WordPieceTokenizer:
    """BERT-style WordPiece tokenizer (uncased by default).

    API surface used by the data pipeline — ``tokenize``,
    ``convert_tokens_to_ids``, ``cls_token``, ``sep_token``,
    ``pad_token_id`` — mirrors what the reference consumes from HF
    (multimodal_driver.py:91,144-145,154,179).
    """

    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    unk_token = "[UNK]"
    mask_token = "[MASK]"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.max_chars_per_word = max_chars_per_word
        for tok in (self.cls_token, self.sep_token, self.pad_token,
                    self.unk_token):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing special token {tok!r}")

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def from_wordlist(cls, words: Iterable[str],
                      do_lower_case: bool = True) -> "WordPieceTokenizer":
        """Build a small test vocab: special tokens + whole words +
        single-character and ##-suffix pieces so every word tokenizes."""
        vocab: Dict[str, int] = {}

        def add(tok):
            if tok not in vocab:
                vocab[tok] = len(vocab)

        for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
            add(t)
        chars = set()
        for w in words:
            w = w.lower() if do_lower_case else w
            add(w)
            chars.update(w)
        for ch in sorted(chars):
            add(ch)
            add("##" + ch)
        return cls(vocab, do_lower_case=do_lower_case)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]


class SimpleUnigramTokenizer:
    """Greedy longest-match unigram tokenizer with XLNet's special tokens
    (<cls>, <sep>, <pad>; <cls> goes last in packing): the offline stand-in
    for SentencePiece when no ``.model`` file is at hand."""

    cls_token = "<cls>"
    sep_token = "<sep>"
    pad_token = "<pad>"
    unk_token = "<unk>"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = False):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        for tok in (self.cls_token, self.sep_token, self.pad_token,
                    self.unk_token):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing special token {tok!r}")

    @classmethod
    def from_wordlist(cls, words: Iterable[str],
                      do_lower_case: bool = False
                      ) -> "SimpleUnigramTokenizer":
        vocab: Dict[str, int] = {}

        def add(tok):
            if tok not in vocab:
                vocab[tok] = len(vocab)

        for t in ("<unk>", "<sep>", "<pad>", "<cls>", "<mask>"):
            add(t)
        chars = set()
        for w in words:
            w = w.lower() if do_lower_case else w
            add("▁" + w)  # SentencePiece word-start marker
            chars.update(w)
        for ch in sorted(chars):
            add(ch)
            add("▁" + ch)
        return cls(vocab, do_lower_case=do_lower_case)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
        out: List[str] = []
        for word in text.split():
            out.extend(self._greedy("▁" + word))
        return out

    def _greedy(self, piece: str) -> List[str]:
        tokens: List[str] = []
        start = 0
        n = len(piece)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = piece[start:end]
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                tokens.append(self.unk_token)
                start += 1
            else:
                tokens.append(cur)
                start = end
        return tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]


class SentencePieceTokenizer:
    """XLNet tokenizer over a SentencePiece ``.model`` file: the
    ``sentencepiece`` wheel when it is installed, else the native unigram
    reader (``data/sentencepiece_native.py``: the proto reader and the
    Viterbi segmentation)."""

    cls_token = "<cls>"
    sep_token = "<sep>"
    pad_token = "<pad>"
    unk_token = "<unk>"

    def __init__(self, model_path: str, do_lower_case: bool = False):
        try:
            import sentencepiece as spm

            self.sp = spm.SentencePieceProcessor()
        except ImportError:
            from bert_multimodal_transformer_tpu_torch.data import (
                sentencepiece_native,
            )

            self.sp = sentencepiece_native.PurePythonSentencePiece()
        self.sp.Load(model_path)
        self.do_lower_case = do_lower_case
        # A stock xlnet spiece.model holds the specials (<cls>=3, <sep>=4,
        # <pad>=5): their in-vocab ids keep every id < vocab_size and on the
        # pretrained embedding rows. Only a special the model lacks gets an
        # id appended after the vocabulary.
        self._special = {}
        next_id = self.sp.GetPieceSize()
        for tok in (self.sep_token, self.cls_token, self.pad_token):
            piece_id = self.sp.PieceToId(tok)
            if piece_id == self.sp.unk_id() and tok != self.unk_token:
                self._special[tok] = next_id
                next_id += 1
            else:
                self._special[tok] = piece_id

    @property
    def pad_token_id(self) -> int:
        return self._special[self.pad_token]

    def tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
        return list(self.sp.EncodeAsPieces(text))

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self._special[t] if t in self._special
                else self.sp.PieceToId(t) for t in tokens]


def get_tokenizer(model: str, vocab_path: Optional[str] = None):
    """Model-name dispatch (the JAX package's ``get_tokenizer``), from local
    files only. XLNet takes a SentencePiece ``.model``
    (``SentencePieceTokenizer``) or a word-list file
    (``SimpleUnigramTokenizer``)."""
    if model.startswith("bert"):
        if vocab_path is None:
            raise ValueError(
                "BERT tokenizer needs a local vocab.txt (no network access)")
        lower = "uncased" in model
        return WordPieceTokenizer.from_vocab_file(vocab_path,
                                                  do_lower_case=lower)
    if model.startswith("xlnet"):
        if vocab_path is None:
            raise ValueError(
                "XLNet tokenizer needs a local spiece.model or vocab list")
        if vocab_path.endswith(".model"):
            return SentencePieceTokenizer(vocab_path)
        with open(vocab_path, encoding="utf-8") as f:
            words = [w.strip() for w in f if w.strip()]
        return SimpleUnigramTokenizer.from_wordlist(words)
    raise ValueError(
        f"Expected a bert-* or xlnet-* model name, got {model!r}")
