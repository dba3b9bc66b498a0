"""Pure-Python SentencePiece unigram inference (zero dependencies): a copy
of the JAX package's ``data/sentencepiece_native.py``, which the port
cannot import (that package's ``__init__`` pulls in jax, ROADMAP A.12);
``tests/test_torch_sentencepiece.py`` holds the two equal.

The reference's XLNet path tokenizes with HF ``XLNetTokenizer``, which wraps
the SentencePiece C++ library over ``spiece.model``
(multimodal_driver.py:208-218). The package depends on neither the wheel
nor a model file, so this module implements the inference half natively:

  * a protobuf wire-format reader for ``ModelProto`` (pieces + scores +
    types) — no protoc/protobuf dependency, just varint/length-delimited
    scanning of the serialized file;
  * Viterbi segmentation over the unigram log-probabilities (the exact
    algorithm SentencePiece uses at encode time for model_type=unigram),
    with the standard character-level <unk> fallback
    (score = min_score − 10) and consecutive-unknown merging;
  * ``PurePythonSentencePiece`` mirroring the subset of the
    ``sentencepiece.SentencePieceProcessor`` API the tokenizer layer uses
    (EncodeAsPieces / PieceToId / IdToPiece / GetPieceSize / unk_id), so
    ``SentencePieceTokenizer`` works with a real ``spiece.model`` and no
    extra packages.

Piece types (all handled; cross-validated against the HF ``tokenizers``
Rust Unigram — the port of sentencepiece inference — in
tests/test_sentencepiece_native.py):

  * NORMAL — trie-matched with its trained log-prob score;
  * UNKNOWN / CONTROL / UNUSED — never matched from raw text;
  * USER_DEFINED — always segmented as one piece: matched with score
    ``len(piece) * max_score - 0.1`` (sentencepiece unigram_model.cc
    ``PopulateNodes``: "User defined symbol receives extra bonus to
    always be selected"), and protected verbatim from normalization
    (sentencepiece normalizer.cc's PrefixMatcher over user-defined
    symbols);
  * BYTE — byte fallback: when the model carries all 256 ``<0xNN>``
    pieces (the invariant ``--byte_fallback`` training guarantees),
    unknown spans are emitted as their UTF-8 bytes' pieces instead of
    one merged unk piece.

Normalization is EXACT for real model files: when the model's
``NormalizerSpec`` carries a ``precompiled_charsmap`` (every stock
``spiece.model``, e.g. xlnet-base-cased's nmt_nfkc, does), this module
decodes it — the ``[uint32 trie_size][darts-clone double-array trie]
[NUL-delimited replacement blob]`` layout of sentencepiece's
normalizer.cc ``DecodePrecompiledCharsMap`` — and applies the same
longest-prefix-match rewrite loop as ``Normalizer::Normalize``
(heading/trailing-space removal, dummy prefix, ▁ escaping, invalid-UTF-8
→ U+FFFD, user-defined-symbol protection), honoring the spec's
``add_dummy_prefix`` / ``remove_extra_whitespaces`` /
``escape_whitespaces`` flags. A darts-clone *builder*
(``build_precompiled_charsmap``) exists so tests can construct charsmap
fixtures and cross-validate this decoder against the HF ``tokenizers``
Rust ``Precompiled`` normalizer (the Rust port of the same format), and
so fixture models can embed a realistic nmt_nfkc-style map
(``build_nmt_nfkc_rules``). Only when a model file carries NO charsmap
(hand-built fixtures) does the engine fall back to the documented
NFKC-based approximation.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Tuple

SPIECE_UNDERLINE = "▁"  # ▁

# sentencepiece.proto ModelProto.SentencePiece.Type values
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6

_UNK_PENALTY = 10.0  # kUnkPenalty in sentencepiece's unigram model


def _parse_byte_piece(piece: str) -> "int | None":
    """TYPE_BYTE pieces are spelled ``<0xNN>`` (uppercase hex); returns the
    byte value, or None for a malformed surface."""
    if (len(piece) == 6 and piece.startswith("<0x")
            and piece.endswith(">")):
        try:
            return int(piece[3:5], 16)
        except ValueError:
            return None
    return None


# --------------------------------------------------------------------------
# protobuf wire-format scanning
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            # keep the fail-loudly contract: a file cut mid-varint must
            # raise the same ValueError class as other truncations
            raise ValueError("truncated message: varint runs past the end")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _scan_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    value is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if pos > n:
            # a truncated file (interrupted copy) must fail loudly, not
            # load as a smaller vocabulary (the real sentencepiece lib
            # rejects such files too)
            raise ValueError(
                f"truncated message: field {field} extends past the "
                f"buffer ({pos} > {n})")
        yield field, wire, val


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto → [(piece, score, type)], in id order.

    ModelProto field 1 = repeated SentencePiece {piece=1 (string),
    score=2 (float), type=3 (enum, default NORMAL)}.
    """
    pieces: List[Tuple[str, float, int]] = []
    for field, wire, val in _scan_fields(data):
        if field == 1 and wire == 2:
            piece, score, ptype = "", 0.0, TYPE_NORMAL
            for f2, w2, v2 in _scan_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    if not pieces:
        raise ValueError("no pieces found — not a SentencePiece model?")
    return pieces


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize_model_proto(
        pieces: List[Tuple[str, float, int]],
        normalizer_spec: "dict | None" = None) -> bytes:
    """Inverse of parse_model_proto (used to build test fixtures and to
    export native vocabularies as real .model files). ``normalizer_spec``
    optionally embeds a ModelProto.normalizer_spec (field 3) with the keys
    of DEFAULT_NORMALIZER_SPEC — fixture models built with a
    ``precompiled_charsmap`` exercise the exact-normalizer path."""
    varint = _varint
    blob = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += b"\x0a" + varint(len(pb)) + pb          # field 1, wire 2
        body += b"\x15" + struct.pack("<f", score)      # field 2, wire 5
        if ptype != TYPE_NORMAL:
            body += b"\x18" + varint(ptype)             # field 3, wire 0
        blob += b"\x0a" + varint(len(body)) + bytes(body)
    if normalizer_spec is not None:
        spec = dict(DEFAULT_NORMALIZER_SPEC)
        spec.update(normalizer_spec)
        body = bytearray()
        nb = spec["name"].encode("utf-8")
        body += b"\x0a" + varint(len(nb)) + nb          # name = 1, wire 2
        cm = spec["precompiled_charsmap"]
        if cm:
            body += b"\x12" + varint(len(cm)) + cm      # charsmap = 2
        # proto2 defaults for the three bools are true — always write
        # them so a False round-trips
        body += b"\x18" + varint(int(spec["add_dummy_prefix"]))
        body += b"\x20" + varint(int(spec["remove_extra_whitespaces"]))
        body += b"\x28" + varint(int(spec["escape_whitespaces"]))
        blob += b"\x1a" + varint(len(body)) + bytes(body)   # field 3
    return bytes(blob)


# --------------------------------------------------------------------------
# NormalizerSpec + precompiled charsmap (exact nmt_nfkc)
# --------------------------------------------------------------------------

DEFAULT_NORMALIZER_SPEC = {
    "name": "",
    "precompiled_charsmap": b"",
    # sentencepiece_model.proto NormalizerSpec defaults (proto2)
    "add_dummy_prefix": True,
    "remove_extra_whitespaces": True,
    "escape_whitespaces": True,
}


def parse_normalizer_spec(data: bytes) -> dict:
    """ModelProto field 3 = NormalizerSpec {name=1 (string),
    precompiled_charsmap=2 (bytes), add_dummy_prefix=3,
    remove_extra_whitespaces=4, escape_whitespaces=5 (bools, default
    true)}. Returns DEFAULT_NORMALIZER_SPEC values for absent fields."""
    spec = dict(DEFAULT_NORMALIZER_SPEC)
    for field, wire, val in _scan_fields(data):
        if field == 3 and wire == 2:
            for f2, w2, v2 in _scan_fields(val):
                if f2 == 1 and w2 == 2:
                    spec["name"] = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    spec["precompiled_charsmap"] = v2
                elif f2 == 3 and w2 == 0:
                    spec["add_dummy_prefix"] = bool(v2)
                elif f2 == 4 and w2 == 0:
                    spec["remove_extra_whitespaces"] = bool(v2)
                elif f2 == 5 and w2 == 0:
                    spec["escape_whitespaces"] = bool(v2)
    return spec


# darts-clone DoubleArrayUnit accessors (darts.h): bits 0-7 label,
# bit 8 has_leaf, bit 9 offset-extension, bits 10-30 offset payload,
# bit 31 marks a value unit (and participates in label() so value units
# never match a byte).

def _unit_offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


def _darts_common_prefix_search(units, key: bytes,
                                pos: int = 0) -> List[Tuple[int, int]]:
    """darts-clone commonPrefixSearch over ``key[pos:]`` — returns
    [(value, matched_length)] in increasing length order (the longest
    rule is the last entry, as Normalizer::NormalizePrefix selects)."""
    results: List[Tuple[int, int]] = []
    n_units = len(units)
    node_pos = 0
    unit = units[0]
    node_pos ^= _unit_offset(unit)
    for i in range(pos, len(key)):
        c = key[i]
        node_pos ^= c
        if node_pos >= n_units:
            return results
        unit = units[node_pos]
        if (unit & 0x800000FF) != c:
            return results
        node_pos ^= _unit_offset(unit)
        if (unit >> 8) & 1:
            if node_pos >= n_units:
                return results
            results.append((units[node_pos] & 0x7FFFFFFF, i - pos + 1))
    return results


def build_darts(items: List[Tuple[bytes, int]]) -> List[int]:
    """Build a darts-clone-compatible double array from (key, value)
    pairs (values < 2^31). Correctness relies on the standard
    double-array invariant that every node's base is unique, so a unit
    at position ``base ^ c`` with label ``c`` can only belong to the one
    node owning ``base``. Used to construct charsmap fixtures; real
    models ship a trie built by sentencepiece itself."""
    root: dict = {}
    for key, val in sorted(items):
        if not key:
            raise ValueError("darts keys must be non-empty")
        if not (0 <= val < (1 << 31)):
            raise ValueError("darts values must fit 31 bits")
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[None] = val

    size = 1024
    units = [0] * size
    used = [False] * size
    used[0] = True
    used_bases = set()
    base_start = 1  # persistent scan start; bases only accumulate

    def grow(upto: int):
        nonlocal size
        while upto >= size:
            units.extend([0] * size)
            used.extend([False] * size)
            size *= 2

    from collections import deque
    queue = deque([(root, 0)])
    while queue:
        node, upos = queue.popleft()
        labels = sorted(k for k in node if k is not None)
        has_value = None in node
        slots = ([0] if has_value else []) + labels
        if not slots:
            continue
        base = base_start
        while True:
            if base not in used_bases:
                grow(base | 0xFF)
                ok = True
                for s in slots:
                    p = base ^ s
                    if p == 0 or used[p]:
                        ok = False
                        break
                if ok:
                    break
            base += 1
            if base == base_start + 1 and base - 1 in used_bases:
                base_start = base
        used_bases.add(base)
        units[upos] |= _encode_darts_offset(upos ^ base)
        if has_value:
            used[base] = True
            units[base] = 0x80000000 | node[None]
        for c in labels:
            p = base ^ c
            used[p] = True
            child = node[c]
            units[p] = c | ((1 << 8) if None in child else 0)
            queue.append((child, p))
    # trim to the last used unit (keep index 0)
    last = max(i for i, u in enumerate(used) if u)
    return units[:last + 1]


def _encode_darts_offset(o: int) -> int:
    if o < (1 << 21):
        return o << 10
    if o % 256 == 0 and (o >> 8) < (1 << 21):
        return ((o >> 8) << 10) | (1 << 9)
    raise ValueError(f"darts offset {o} not encodable")


def build_precompiled_charsmap(rules: Dict[str, str]) -> bytes:
    """{source → replacement} → the blob layout of normalizer.cc
    DecodePrecompiledCharsMap: [uint32 LE trie size][darts double array]
    [NUL-delimited replacement strings] (trie values are byte offsets
    into the replacement section)."""
    normalized = bytearray()
    offsets: Dict[bytes, int] = {}
    items: List[Tuple[bytes, int]] = []
    for key in sorted(rules):
        kb = key.encode("utf-8")
        rb = rules[key].encode("utf-8")
        off = offsets.get(rb)
        if off is None:
            off = len(normalized)
            offsets[rb] = off
            normalized += rb + b"\0"
        items.append((kb, off))
    units = build_darts(items)
    trie_blob = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie_blob)) + trie_blob + bytes(normalized)


def _decode_utf8_char(data: bytes, pos: int) -> Tuple[int, bool]:
    """(length, is_valid) of the UTF-8 char at ``data[pos:]`` with
    sentencepiece string_util.h DecodeUTF8's exact validity rules
    (no overlongs, no surrogates, ≤ U+10FFFF; invalid → length 1)."""
    b0 = data[pos]
    n = len(data) - pos
    if b0 < 0x80:
        return 1, True

    def trail(k):
        return pos + k < len(data) and (data[pos + k] & 0xC0) == 0x80

    if n >= 2 and (b0 & 0xE0) == 0xC0:
        cp = ((b0 & 0x1F) << 6) | (data[pos + 1] & 0x3F)
        if trail(1) and cp >= 0x80:
            return 2, True
    elif n >= 3 and (b0 & 0xF0) == 0xE0:
        cp = (((b0 & 0x0F) << 12) | ((data[pos + 1] & 0x3F) << 6)
              | (data[pos + 2] & 0x3F))
        if (trail(1) and trail(2) and cp >= 0x800
                and not (0xD800 <= cp < 0xE000)):
            return 3, True
    elif n >= 4 and (b0 & 0xF8) == 0xF0:
        cp = (((b0 & 0x07) << 18) | ((data[pos + 1] & 0x3F) << 12)
              | ((data[pos + 2] & 0x3F) << 6) | (data[pos + 3] & 0x3F))
        if (trail(1) and trail(2) and trail(3)
                and 0x10000 <= cp <= 0x10FFFF):
            return 4, True
    return 1, False


_SPACE_SYMBOL_B = SPIECE_UNDERLINE.encode("utf-8")  # b"\xe2\x96\x81"
_REPLACEMENT_CHAR_B = b"\xef\xbf\xbd"               # U+FFFD


class PrecompiledNormalizer:
    """Exact port of sentencepiece normalizer.cc over a decoded
    precompiled charsmap: longest-prefix rewrite with single-character
    passthrough, invalid-UTF-8 → U+FFFD (consuming one byte),
    user-defined-symbol protection (PrefixMatcher semantics), heading/
    trailing space removal, dummy prefix, and ▁ escaping per the
    NormalizerSpec flags."""

    def __init__(self, blob: bytes):
        if len(blob) <= 4:
            raise ValueError("Blob for normalization rule is broken.")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if trie_size >= len(blob) - 4 + 1 or trie_size % 4 != 0:
            raise ValueError("Blob for normalization rule is broken.")
        n_units = trie_size // 4
        self._units = list(struct.unpack(f"<{n_units}I",
                                         blob[4:4 + trie_size]))
        self._normalized = blob[4 + trie_size:]

    def _replacement(self, value: int) -> bytes:
        end = self._normalized.find(b"\0", value)
        if end == -1:
            end = len(self._normalized)
        return self._normalized[value:end]

    def normalize_prefix(self, data: bytes, pos: int,
                         user_defined: "List[bytes] | None" = None,
                         ) -> Tuple[bytes, int]:
        """Normalizer::NormalizePrefix: (replacement, consumed bytes)."""
        if user_defined:
            for ud in user_defined:  # longest-first
                if data.startswith(ud, pos):
                    return data[pos:pos + len(ud)], len(ud)
        results = _darts_common_prefix_search(self._units, data, pos)
        if results:
            value, length = results[-1]  # longest rule
            return self._replacement(value), length
        length, valid = _decode_utf8_char(data, pos)
        if not valid:
            return _REPLACEMENT_CHAR_B, 1
        return data[pos:pos + length], length

    def normalize(self, text: str,
                  user_defined: "List[str] | None" = None,
                  add_dummy_prefix: bool = True,
                  remove_extra_whitespaces: bool = True,
                  escape_whitespaces: bool = True) -> str:
        data = text.encode("utf-8")
        ud = ([p.encode("utf-8") for p in user_defined]
              if user_defined else None)
        pos = 0
        n = len(data)
        # ignores heading space (pieces whose replacement is exactly " ")
        if remove_extra_whitespaces:
            while pos < n:
                rep, consumed = self.normalize_prefix(data, pos, ud)
                if rep != b" ":
                    break
                pos += consumed
        if pos >= n:
            return ""
        out = bytearray()
        if add_dummy_prefix:
            out += _SPACE_SYMBOL_B if escape_whitespaces else b" "
        is_prev_space = remove_extra_whitespaces
        while pos < n:
            rep, consumed = self.normalize_prefix(data, pos, ud)
            sp = rep
            # removes heading spaces in the piece if the previous piece
            # ended with whitespace
            if is_prev_space:
                sp = sp.lstrip(b" ") if sp.startswith(b" ") else sp
            if sp:
                if escape_whitespaces and b" " in sp:
                    out += sp.replace(b" ", _SPACE_SYMBOL_B)
                else:
                    out += sp
                is_prev_space = sp.endswith(b" ")
            pos += consumed
            if not remove_extra_whitespaces:
                is_prev_space = False
        if remove_extra_whitespaces:
            space = _SPACE_SYMBOL_B if escape_whitespaces else b" "
            while out.endswith(space):
                del out[len(out) - len(space):]
        return out.decode("utf-8")


def build_nmt_nfkc_rules(max_cp: int = 0x110000) -> Dict[str, str]:
    """Single-codepoint nmt_nfkc rule map: NFKC folds (via unicodedata)
    plus sentencepiece builder.cc BuildNmtNfkcMap's NMT-specific
    overrides (extra whitespace codepoints → " ", C0/C1 controls → "",
    U+FF5E kept verbatim). Training-side utility for realistic fixtures
    and for models that carry no charsmap — real model files embed the
    exact map sentencepiece built (including its multi-codepoint
    recomposition keys, which this generator does not enumerate), and
    the decoder above honors that embedded map byte-for-byte."""
    import unicodedata as ud
    rules: Dict[str, str] = {}
    for cp in range(max_cp):
        if 0xD800 <= cp < 0xE000:
            continue
        ch = chr(cp)
        norm = ud.normalize("NFKC", ch)
        if norm != ch:
            rules[ch] = norm
    for cp in (0x0009, 0x000A, 0x000C, 0x000D, 0x1680, 0x200B, 0x200C,
               0x200D, 0x200E, 0x200F, 0x2028, 0x2029, 0x2581, 0xFEFF,
               0xFFFD):
        if cp < max_cp:
            rules[chr(cp)] = " "
    controls = (list(range(0x0001, 0x0009)) + [0x000B]
                + list(range(0x000E, 0x0020)) + [0x007F]
                + list(range(0x0080, 0x00A0)))
    for cp in controls:
        if cp < max_cp:
            rules[chr(cp)] = ""
    # FULL-WIDTH TILDE is deliberately NOT normalized (builder.cc:
    # full/half-width tildes are used differently in Japanese)
    rules.pop("～", None)
    return rules


# --------------------------------------------------------------------------
# unigram Viterbi encoder
# --------------------------------------------------------------------------

class PurePythonSentencePiece:
    """Drop-in for the ``sentencepiece.SentencePieceProcessor`` API subset
    used by ``SentencePieceTokenizer``."""

    def __init__(self):
        self._pieces: List[Tuple[str, float, int]] = []
        self._ids: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        self._max_len = 1
        self._unk_id = 0
        self._unk_score = 0.0
        self._user_defined: List[str] = []
        self._byte_to_piece: Dict[int, str] = {}
        self._byte_fallback = False
        self._normalizer_spec = dict(DEFAULT_NORMALIZER_SPEC)
        self._precompiled: "PrecompiledNormalizer | None" = None

    def Load(self, path: str) -> "PurePythonSentencePiece":
        with open(path, "rb") as f:
            self.LoadFromSerializedProto(f.read())
        return self

    def LoadFromSerializedProto(self, data: bytes):
        self._pieces = parse_model_proto(data)
        self._normalizer_spec = parse_normalizer_spec(data)
        charsmap = self._normalizer_spec["precompiled_charsmap"]
        self._precompiled = (PrecompiledNormalizer(charsmap)
                             if charsmap else None)
        self._ids = {}
        self._scores = {}
        self._user_defined = []
        self._byte_to_piece = {}
        self._max_len = 1
        # min/max over NORMAL pieces only, exactly as unigram_model.cc's
        # constructor computes min_score_/max_score_ (CONTROL/UNKNOWN/
        # BYTE/USER_DEFINED scores don't shape the unk penalty or the
        # user-defined bonus)
        min_score = 0.0
        max_score = 0.0
        have_normal = False
        unk_id = None
        for i, (piece, score, ptype) in enumerate(self._pieces):
            if piece not in self._ids:
                self._ids[piece] = i
            if ptype == TYPE_UNKNOWN and unk_id is None:
                unk_id = i
            if ptype == TYPE_NORMAL:
                self._scores[piece] = score
                self._max_len = max(self._max_len, len(piece))
                if have_normal:
                    min_score = min(min_score, score)
                    max_score = max(max_score, score)
                else:
                    min_score = max_score = score
                    have_normal = True
            elif ptype == TYPE_BYTE:
                b = _parse_byte_piece(piece)
                if b is not None and b not in self._byte_to_piece:
                    self._byte_to_piece[b] = piece
        # USER_DEFINED second pass (the bonus needs max_score): always
        # segmented as one piece — score = len*max_score − 0.1
        # (unigram_model.cc PopulateNodes: "User defined symbol receives
        # extra bonus to always be selected")
        for piece, score, ptype in self._pieces:
            if ptype == TYPE_USER_DEFINED:
                self._scores[piece] = len(piece) * max_score - 0.1
                self._max_len = max(self._max_len, len(piece))
                self._user_defined.append(piece)
        # longest-first for the normalizer's verbatim prefix matching
        self._user_defined.sort(key=len, reverse=True)
        # byte fallback requires the full byte alphabet — the invariant
        # --byte_fallback training guarantees; a partial set can't cover
        # arbitrary unknown spans, so it stays off (merged-unk pieces)
        self._byte_fallback = len(self._byte_to_piece) == 256
        self._unk_id = unk_id if unk_id is not None else 0
        self._unk_score = min_score - _UNK_PENALTY
        return self

    # -- API surface -------------------------------------------------------

    def GetPieceSize(self) -> int:
        return len(self._pieces)

    def unk_id(self) -> int:
        return self._unk_id

    def PieceToId(self, piece: str) -> int:
        return self._ids.get(piece, self._unk_id)

    def IdToPiece(self, idx: int) -> str:
        return self._pieces[idx][0]

    def EncodeAsPieces(self, text: str) -> List[str]:
        norm = self._normalize(text)
        if not norm:
            return []
        return self._viterbi(norm)

    # -- internals ---------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self._precompiled is not None:
            # exact path: the model ships its own charsmap (every stock
            # spiece.model does) — decode it and run normalizer.cc's
            # algorithm byte-for-byte, honoring the spec flags
            spec = self._normalizer_spec
            return self._precompiled.normalize(
                text,
                user_defined=self._user_defined,
                add_dummy_prefix=spec["add_dummy_prefix"],
                remove_extra_whitespaces=spec["remove_extra_whitespaces"],
                escape_whitespaces=spec["escape_whitespaces"])
        return self._normalize_approx(text)

    def _normalize_approx(self, text: str) -> str:
        """Approximate nmt_nfkc for models carrying NO charsmap
        (hand-built fixtures): NFKC, drop control chars, collapse
        whitespace; then escape spaces as ▁ with a dummy prefix
        (add_dummy_prefix=True, SentencePiece's default and XLNet's).

        USER_DEFINED symbol occurrences pass through VERBATIM — the real
        normalizer protects them with a PrefixMatcher (normalizer.cc) so
        e.g. an NFKC-altering symbol like "ﬁx" still reaches the trie as
        written. (Symbols containing whitespace are not protected from
        the collapse step — sentencepiece forbids those at training
        time.)"""
        if self._user_defined:
            segs = self._split_user_defined(text)
        else:
            segs = [(text, False)]
        parts = []
        for seg, verbatim in segs:
            if verbatim:
                parts.append(seg)
                continue
            seg = unicodedata.normalize("NFKC", seg)
            out = []
            for ch in seg:
                if ch in ("\t", "\n", "\r") or unicodedata.category(ch) in (
                        "Cc", "Cf"):
                    out.append(" ")
                else:
                    out.append(ch)
            parts.append("".join(out))
        collapsed = " ".join("".join(parts).split())
        if not collapsed:
            return ""
        return SPIECE_UNDERLINE + collapsed.replace(" ", SPIECE_UNDERLINE)

    def _split_user_defined(self, text: str) -> List[Tuple[str, bool]]:
        """Segment text into (chunk, is_user_defined_symbol); symbols are
        matched longest-first on the RAW (pre-normalization) text."""
        segs: List[Tuple[str, bool]] = []
        i = 0
        n = len(text)
        plain_start = 0
        while i < n:
            match = None
            for p in self._user_defined:  # longest-first
                if text.startswith(p, i):
                    match = p
                    break
            if match is None:
                i += 1
                continue
            if plain_start < i:
                segs.append((text[plain_start:i], False))
            segs.append((match, True))
            i += len(match)
            plain_start = i
        if plain_start < n:
            segs.append((text[plain_start:], False))
        return segs

    def _viterbi(self, s: str) -> List[str]:
        n = len(s)
        NEG = float("-inf")
        # best[i] = (score, start_of_last_piece, piece_or_None-for-unk)
        best_score = [NEG] * (n + 1)
        back: List[Tuple[int, str | None]] = [(0, None)] * (n + 1)
        best_score[0] = 0.0
        scores = self._scores
        max_len = self._max_len
        for i in range(n):
            base = best_score[i]
            if base == NEG:
                continue
            hi = min(max_len, n - i)
            for ln in range(1, hi + 1):
                sub = s[i:i + ln]
                sc = scores.get(sub)
                if sc is not None and base + sc > best_score[i + ln]:
                    best_score[i + ln] = base + sc
                    back[i + ln] = (i, sub)
            # character-level unknown fallback keeps the lattice connected
            if base + self._unk_score > best_score[i + 1]:
                best_score[i + 1] = base + self._unk_score
                back[i + 1] = (i, None)
        # backtrack
        rev: List[Tuple[str, bool]] = []  # (piece, is_unk)
        pos = n
        while pos > 0:
            start, piece = back[pos]
            if piece is None:
                rev.append((s[start:pos], True))
            else:
                rev.append((piece, False))
            pos = start
        rev.reverse()
        # merge consecutive unknowns (SentencePiece emits one piece per
        # maximal unknown run) — or, under byte fallback, expand the run
        # into its UTF-8 bytes' <0xNN> pieces (cross-validated against
        # the HF tokenizers Rust Unigram with byte_fallback=True)
        out: List[str] = []
        run = ""

        def flush(run: str):
            if not run:
                return
            if self._byte_fallback:
                for b in run.encode("utf-8"):
                    out.append(self._byte_to_piece[b])
            else:
                out.append(run)

        for piece, is_unk in rev:
            if is_unk:
                run += piece
            else:
                flush(run)
                run = ""
                out.append(piece)
        flush(run)
        return out
