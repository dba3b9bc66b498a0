"""Fixed-shape split and batching: a numpy-only copy of ``PackedSplit`` and
``BatchIterator`` from the JAX package's ``data/pipeline.py`` (the port
cannot import that package, whose ``__init__`` pulls in jax). ROADMAP A.12
moves the shared modules to one package; until then the tests hold this
copy equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

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
