"""Host-side data pipeline: a numpy-only copy of the JAX package's
``data/pipeline.py`` (the port cannot import that package, whose
``__init__`` pulls in jax, and does not edit it). The port keeps its own
copy, and the tests hold it equal to the original (ROADMAP A.12).

Per-example word→subword alignment with modality replication, BERT
right-padded and XLNet left-padded packing, the split packed once into
contiguous fixed-shape numpy arrays, and the batch iterators: every batch
is exactly [B, max_seq_length, ·]; the ragged last batch is padded and
masked so every example is used.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PackedSplit:
    """One split packed to fixed shapes.

    input_ids/input_mask/segment_ids: [N, S] int32
    visual: [N, S, Dv] float32; acoustic: [N, S, Da] float32
    label_ids: [N] float32
    """

    input_ids: np.ndarray
    visual: np.ndarray
    acoustic: np.ndarray
    input_mask: np.ndarray
    segment_ids: np.ndarray
    label_ids: np.ndarray

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def take(self, idx: np.ndarray) -> "PackedSplit":
        return PackedSplit(*(getattr(self, f.name)[idx]
                             for f in dataclasses.fields(self)))

    def as_tuple(self):
        return (self.input_ids, self.visual, self.acoustic, self.input_mask,
                self.segment_ids, self.label_ids)


def align_modalities(
    words: Sequence[str],
    visual: np.ndarray,
    acoustic: np.ndarray,
    tokenizer,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Tokenize word-by-word and replicate each word's visual/acoustic row
    for every subword piece (reference multimodal_driver.py:89-106); with
    ``prepare_bert_input``, the per-example form of ``convert_to_features``,
    which the tests hold it against."""
    tokens: List[str] = []
    inversions: List[int] = []
    for idx, word in enumerate(words):
        pieces = tokenizer.tokenize(word)
        tokens.extend(pieces)
        inversions.extend([idx] * len(pieces))
    assert len(tokens) == len(inversions)
    if inversions:
        inv = np.asarray(inversions, np.int64)
        visual = np.asarray(visual)[inv]
        acoustic = np.asarray(acoustic)[inv]
    else:
        visual = np.zeros((0, np.asarray(visual).shape[-1]))
        acoustic = np.zeros((0, np.asarray(acoustic).shape[-1]))
    return tokens, visual, acoustic


def prepare_bert_input(tokens, visual, acoustic, tokenizer, max_seq_length):
    """[CLS] tokens [SEP], zero modality rows for specials, right-pad with
    zeros (reference multimodal_driver.py:143-173). The per-example form
    of ``convert_to_features``, which the tests hold it against."""
    dv, da = visual.shape[-1], acoustic.shape[-1]
    visual = np.concatenate([np.zeros((1, dv)), visual, np.zeros((1, dv))])
    acoustic = np.concatenate([np.zeros((1, da)), acoustic,
                               np.zeros((1, da))])
    cls_id, sep_id = tokenizer.convert_tokens_to_ids(
        [tokenizer.cls_token, tokenizer.sep_token])
    input_ids = ([cls_id] + tokenizer.convert_tokens_to_ids(list(tokens))
                 + [sep_id])
    n = len(input_ids)
    pad = max_seq_length - n
    input_ids = input_ids + [0] * pad
    input_mask = [1] * n + [0] * pad
    segment_ids = [0] * max_seq_length
    visual = np.concatenate([visual, np.zeros((pad, dv))])
    acoustic = np.concatenate([acoustic, np.zeros((pad, da))])
    return input_ids, visual, acoustic, input_mask, segment_ids


def prepare_xlnet_input(tokens, visual, acoustic, tokenizer, max_seq_length):
    """tokens <sep> <cls> (cls last), segments 0…0,2, LEFT-pad: ids with
    pad_token_id, mask 0, segments 3, leading zero modality rows
    (reference multimodal_driver.py:176-205). The per-example form of
    ``convert_to_features``' XLNet packing, which the tests hold it
    against."""
    dv, da = visual.shape[-1], acoustic.shape[-1]
    visual = np.concatenate([visual, np.zeros((2, dv))])
    acoustic = np.concatenate([acoustic, np.zeros((2, da))])
    sep_id, cls_id = tokenizer.convert_tokens_to_ids(
        [tokenizer.sep_token, tokenizer.cls_token])
    input_ids = tokenizer.convert_tokens_to_ids(list(tokens)) + [sep_id,
                                                                 cls_id]
    n = len(input_ids)
    segment_ids = [0] * (n - 1) + [2]
    pad = max_seq_length - n
    input_ids = [tokenizer.pad_token_id] * pad + input_ids
    input_mask = [0] * pad + [1] * n
    segment_ids = [3] * pad + segment_ids
    visual = np.concatenate([np.zeros((pad, dv)), visual])
    acoustic = np.concatenate([np.zeros((pad, da)), acoustic])
    return input_ids, visual, acoustic, input_mask, segment_ids


def convert_to_features(
    examples: Sequence[Any],
    max_seq_length: int,
    tokenizer,
    model_family: str = "bert",
    visual_dim: Optional[int] = None,
    acoustic_dim: Optional[int] = None,
) -> PackedSplit:
    """Pack a list of ((words, visual, acoustic), label, segment) examples —
    the documented pickle layout (reference README.md:134-149) — into a
    PackedSplit. Mirrors convert_to_features (multimodal_driver.py:82-140),
    including truncation to max_seq_length−2 before the two specials;
    ``model_family`` "bert" or "xlnet" picks the packing."""
    if model_family not in ("bert", "xlnet"):
        raise ValueError(f"unknown model_family {model_family!r} "
                         "(bert | xlnet)")
    n = len(examples)
    s = max_seq_length
    if visual_dim is None:
        visual_dim = (np.asarray(examples[0][0][1]).shape[-1]
                      if examples else 0)
    if acoustic_dim is None:
        acoustic_dim = (np.asarray(examples[0][0][2]).shape[-1]
                        if examples else 0)

    # Preallocate the packed buffers and write each example's rows in
    # place — the reference's per-example list/concat assembly
    # (multimodal_driver.py:130-140, 143-205) is the startup hot loop.
    out_ids = np.zeros((n, s), np.int32)
    out_vis = np.zeros((n, s, visual_dim), np.float32)
    out_ac = np.zeros((n, s, acoustic_dim), np.float32)
    out_mask = np.zeros((n, s), np.int32)
    out_seg = np.zeros((n, s), np.int32)
    out_lab = np.zeros((n,), np.float32)
    is_bert = model_family == "bert"
    cls_id, sep_id = tokenizer.convert_tokens_to_ids(
        [tokenizer.cls_token, tokenizer.sep_token])
    if not is_bert:
        out_ids[:] = tokenizer.pad_token_id
        out_seg[:] = 3

    # the native (C++) tokenize/align path when the tokenizer has it
    # (data/native.py)
    native = hasattr(tokenizer, "tokenize_words_to_ids")
    for i, example in enumerate(examples):
        (words, visual, acoustic), label_id, _segment = example
        if native:
            token_ids, inversions = tokenizer.tokenize_words_to_ids(
                list(words))
        else:
            token_ids = []
            inversions = []
            for w_idx, word in enumerate(words):
                pieces = tokenizer.tokenize(word)
                token_ids.extend(tokenizer.convert_tokens_to_ids(pieces))
                inversions.extend([w_idx] * len(pieces))
        inv = np.asarray(inversions, np.int64)
        if len(token_ids) > s - 2:
            token_ids = token_ids[: s - 2]
            inv = inv[: s - 2]
        m = len(token_ids)
        visual = np.asarray(visual, np.float32)
        acoustic = np.asarray(acoustic, np.float32)
        if is_bert:
            # [CLS] tokens [SEP], zero modality rows for the specials,
            # right-pad (reference multimodal_driver.py:143-173)
            out_ids[i, 0] = cls_id
            out_ids[i, 1:m + 1] = token_ids
            out_ids[i, m + 1] = sep_id
            out_mask[i, : m + 2] = 1
            out_vis[i, 1:m + 1] = visual[inv]
            out_ac[i, 1:m + 1] = acoustic[inv]
        else:
            # tokens <sep> <cls> (cls last), segments 0…0,2, LEFT-pad ids
            # with pad_id, segments with 3 (multimodal_driver.py:176-205)
            pad = s - (m + 2)
            out_ids[i, pad:pad + m] = token_ids
            out_ids[i, -2] = sep_id
            out_ids[i, -1] = cls_id
            out_mask[i, pad:] = 1
            out_seg[i, pad:-1] = 0
            out_seg[i, -1] = 2
            out_vis[i, pad:pad + m] = visual[inv]
            out_ac[i, pad:pad + m] = acoustic[inv]
        out_lab[i] = np.float32(np.asarray(label_id).reshape(()))

    return PackedSplit(
        input_ids=out_ids, visual=out_vis, acoustic=out_ac,
        input_mask=out_mask, segment_ids=out_seg, label_ids=out_lab,
    )


def load_pickle_splits(path: str) -> Dict[str, list]:
    """Load the {train/dev/test: [examples]} pickle the reference consumes
    (multimodal_driver.py:249-255)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    for split in ("train", "dev", "test"):
        if split not in data:
            raise ValueError(f"dataset pickle missing split {split!r}")
    return data


class BatchIterator:
    """Fixed-shape minibatch iterator over a PackedSplit.

    ``drop_remainder=True`` (training): shuffled epochs of exactly-B batches.
    ``drop_remainder=False`` (eval): the last batch is zero-padded to B and
    comes with a per-example validity mask so every example is scored.
    """

    def __init__(self, split: PackedSplit, batch_size: int, *,
                 shuffle: bool, drop_remainder: bool,
                 seed: int = 0):
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._shuffles_done = 0

    @property
    def shuffles_done(self) -> int:
        """Number of epoch shuffles drawn so far (the resume position)."""
        return self._shuffles_done

    def restore_position(self, shuffles_done: int) -> None:
        """Fast-forward a fresh iterator to where an uninterrupted run
        would be after starting ``shuffles_done`` epochs."""
        self._rng = np.random.RandomState(self._seed)
        dummy = np.arange(len(self.split))
        for _ in range(int(shuffles_done)):
            self._rng.shuffle(dummy)
        self._shuffles_done = int(shuffles_done)

    def __len__(self) -> int:
        n = len(self.split)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[tuple, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0
                  ) -> Iterator[Tuple[tuple, np.ndarray]]:
        """Iterate one epoch, skipping the first ``start_batch`` batches
        without materializing them. The epoch shuffle is still drawn."""
        n = len(self.split)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
            self._shuffles_done += 1
        b = self.batch_size
        n_full = n // b
        for i in range(start_batch, n_full):
            idx = order[i * b:(i + 1) * b]
            yield self.split.take(idx).as_tuple(), np.ones(b, bool)
        rem = n - n_full * b
        if rem and not self.drop_remainder and start_batch <= n_full:
            idx = order[n_full * b:]
            batch = self.split.take(idx)
            padded = tuple(
                np.concatenate(
                    [arr, np.zeros((b - rem,) + arr.shape[1:], arr.dtype)])
                for arr in batch.as_tuple())
            valid = np.zeros(b, bool)
            valid[:rem] = True
            yield padded, valid


def set_up_data_loaders(
    pickle_path: str,
    tokenizer,
    *,
    model_family: str,
    max_seq_length: int,
    train_batch_size: int,
    dev_batch_size: int,
    test_batch_size: int,
    n_epochs: int,
    gradient_accumulation_step: int = 1,
    seed: int = 0,
    num_processes: int = 1,
    process_id: int = 0,
) -> Tuple[BatchIterator, BatchIterator, BatchIterator, int]:
    """End-to-end split setup mirroring set_up_data_loader
    (multimodal_driver.py:249-286), including the optimizer-step count.

    ``num_processes > 1``: every process converts the full splits
    identically (same pickle, same determinism) but the returned
    iterators are per-process views yielding only this process's rows of
    each global batch (``parallel/multiprocess.py::ShardedBatchIterator``;
    the train view takes its share of each of the
    ``gradient_accumulation_step`` micro-batches)."""
    data = load_pickle_splits(pickle_path)
    splits = {
        name: convert_to_features(data[name], max_seq_length, tokenizer,
                                  model_family)
        for name in ("train", "dev", "test")
    }
    # Reference semantics (multimodal_driver.py:261-267,375-386):
    # the optimizer steps once per `gradient_accumulation_step` loader
    # batches of size `train_batch_size`, i.e. effective batch = B*N.
    # The trainer splits the micro-batches *inside* one step, so
    # the loader yields B*N rows per step and the reference's
    # optimizer-step count formula carries over unchanged.
    num_train_optimization_steps = int(
        len(splits["train"]) / train_batch_size
        / gradient_accumulation_step) * n_epochs
    # drop_remainder=False: the reference trains on the ragged final batch
    # (multimodal_driver.py:269-279,358-386); the Trainer routes it through
    # the masked step (zero-padded to shape, masked-mean loss — same math,
    # fixed shapes). MOSI-scale effect of dropping it instead would be
    # ~33/1281 examples (2.6%) untrained per epoch.

    if num_processes > 1:
        from bert_multimodal_transformer_tpu_torch.parallel.multiprocess \
            import ShardedBatchIterator

        def _make(split, bs, shuffle, s=0, accum=1):
            return ShardedBatchIterator(
                split, bs, shuffle=shuffle, drop_remainder=False, seed=s,
                num_processes=num_processes, process_id=process_id,
                grad_accum=accum)
    else:
        def _make(split, bs, shuffle, s=0, accum=1):
            return BatchIterator(split, bs, shuffle=shuffle,
                                 drop_remainder=False, seed=s)

    train_it = _make(splits["train"],
                     train_batch_size * gradient_accumulation_step,
                     True, s=seed, accum=gradient_accumulation_step)
    dev_it = _make(splits["dev"], dev_batch_size, False)
    test_it = _make(splits["test"], test_batch_size, False)
    return train_it, dev_it, test_it, num_train_optimization_steps
