"""ctypes binding for the native (C++) WordPiece tokenizer (port of the JAX
package's ``data/native.py``, with its own copy of the source,
``data/_native/magdata.cc``).

The native tokenizer runs the reference's per-word tokenize/inversions hot
loop (multimodal_driver.py:89-103) in C++; the pure-Python
``WordPieceTokenizer`` (``data/tokenization.py``) is the behavioural
reference and the fallback where the library cannot be built. The library
is built with g++ at first use into ``build/native/`` at the repository's
root (ignored by git), named by a hash of the source and the flags, so a
fresh checkout builds from the source alone and a changed source builds
anew; the build goes to a temporary name and is renamed into place, so
processes that build at once do not see a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

_SRC = Path(__file__).resolve().parent / "_native" / "magdata.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libmagdata_{digest.hexdigest()[:16]}.so"


def build() -> Optional[str]:
    """Compile the library with g++ unless a build of the same source
    exists. Returns its path, or None where the build fails (the callers
    fall back to Python)."""
    path = library_path()
    if path.exists():
        return str(path)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    except Exception:
        tmp.unlink(missing_ok=True)
        return None
    return str(path)


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.mag_tokenizer_new.restype = ctypes.c_void_p
    lib.mag_tokenizer_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.mag_tokenizer_free.argtypes = [ctypes.c_void_p]
    lib.mag_tokenize_words.restype = ctypes.c_int
    lib.mag_tokenize_words.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


class NativeWordPieceTokenizer:
    """WordPiece with the word-level API the data pipeline uses, run in
    C++. Wraps a Python ``WordPieceTokenizer`` for its vocabulary and
    special tokens; ``tokenize_words_to_ids`` runs natively."""

    def __init__(self, py_tokenizer):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.py = py_tokenizer
        self.vocab = py_tokenizer.vocab
        self.cls_token = py_tokenizer.cls_token
        self.sep_token = py_tokenizer.sep_token
        self.pad_token_id = py_tokenizer.pad_token_id
        self.vocab_size = py_tokenizer.vocab_size

        tokens = [None] * len(self.vocab)
        for tok, i in self.vocab.items():
            tokens[i] = tok.encode("utf-8")
        arr = (ctypes.c_char_p * len(tokens))(*tokens)
        unk_id = self.vocab[py_tokenizer.unk_token]
        self._handle = lib.mag_tokenizer_new(
            arr, len(tokens), unk_id,
            1 if py_tokenizer.basic.do_lower_case else 0)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and getattr(self, "_lib", None) is not None:
            self._lib.mag_tokenizer_free(handle)
            self._handle = None

    def tokenize(self, text: str) -> List[str]:
        return self.py.tokenize(text)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return self.py.convert_tokens_to_ids(tokens)

    def tokenize_words_to_ids(
        self, words: Sequence[str]
    ) -> Tuple[List[int], List[int]]:
        """A word list → (token_ids, word_indices); the word indices are
        the reference's ``inversions`` for the modality alignment.

        The C++ code takes the printable-ASCII path only (no accent
        stripping, unicode punctuation or control-character cleaning), so
        a list with any non-ASCII byte or ASCII control character (which
        the Python ``_clean`` removes, and an embedded NUL would cut at the
        ctypes char* boundary) goes through the Python tokenizer: the ids
        are the same on every input, built or not."""
        if any(ord(c) > 127 or ord(c) < 32 or ord(c) == 127
               for w in words for c in w):
            ids: List[int] = []
            inv: List[int] = []
            for w_idx, word in enumerate(words):
                pieces = self.py.tokenize(word)
                ids.extend(self.py.convert_tokens_to_ids(pieces))
                inv.extend([w_idx] * len(pieces))
            return ids, inv
        enc = [w.encode("utf-8") for w in words]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        cap = max(64, 8 * sum(len(w) for w in words) + 8 * len(words))
        while True:
            ids = (ctypes.c_int * cap)()
            inv = (ctypes.c_int * cap)()
            n = self._lib.mag_tokenize_words(
                self._handle, arr, len(enc), ids, inv, cap)
            if n >= 0:
                return list(ids[:n]), list(inv[:n])
            cap *= 2
