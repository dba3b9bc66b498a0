"""Synthetic MOSI/MOSEI-format data: a numpy copy of the JAX package's
``data/synthetic.py`` (the port cannot import that package, whose
``__init__`` pulls in jax, and does not edit it). The port keeps its own
copy, and the tests hold the two equal (ROADMAP A.12).

No dataset pickles ship with the repository, so the driver's
``--synthetic`` mode and the tests generate data in the documented layout

    {split: [((words, visual, acoustic), label, segment), ...]}

with per-example len(words) == len(visual) == len(acoustic). The labels
are learnable: a fixed random projection of the mean visual/acoustic
features plus a word-sentiment term.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

WORDS = [
    "good", "bad", "great", "terrible", "fine", "awful", "love", "hate",
    "movie", "film", "actor", "story", "plot", "scene", "music", "really",
    "very", "not", "quite", "somewhat", "amazing", "boring", "funny", "sad",
]

_SENTIMENT = {
    "good": 1.0, "great": 2.0, "amazing": 3.0, "love": 2.5, "funny": 1.5,
    "fine": 0.5, "bad": -1.0, "terrible": -2.0, "awful": -2.5, "hate": -2.0,
    "boring": -1.5, "sad": -1.0,
}


def make_example(rng: np.random.RandomState, visual_dim: int,
                 acoustic_dim: int, min_words: int = 4,
                 max_words: int = 20,
                 w_vis: Optional[np.ndarray] = None,
                 w_ac: Optional[np.ndarray] = None):
    n = rng.randint(min_words, max_words + 1)
    words = [WORDS[rng.randint(len(WORDS))] for _ in range(n)]
    visual = rng.randn(n, visual_dim).astype(np.float32)
    acoustic = rng.randn(n, acoustic_dim).astype(np.float32)
    label = float(np.mean([_SENTIMENT.get(w, 0.0) for w in words]))
    if w_vis is not None:
        label += float(visual.mean(0) @ w_vis)
    if w_ac is not None:
        label += float(acoustic.mean(0) @ w_ac)
    label = float(np.clip(label, -3.0, 3.0))
    segment = f"synthetic_{rng.randint(1 << 30)}"
    return (words, visual, acoustic), np.array([[label]], np.float32), segment


def make_dataset(
    *,
    visual_dim: int = 47,
    acoustic_dim: int = 74,
    n_train: int = 64,
    n_dev: int = 16,
    n_test: int = 16,
    seed: int = 0,
    multimodal_signal: bool = True,
) -> Dict[str, list]:
    rng = np.random.RandomState(seed)
    w_vis = w_ac = None
    if multimodal_signal:
        w_vis = (rng.randn(visual_dim) / np.sqrt(visual_dim)).astype(
            np.float32) * 0.5
        w_ac = (rng.randn(acoustic_dim) / np.sqrt(acoustic_dim)).astype(
            np.float32) * 0.5
    out = {}
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        out[split] = [
            make_example(rng, visual_dim, acoustic_dim, w_vis=w_vis,
                         w_ac=w_ac)
            for _ in range(n)
        ]
    return out


def write_pickle(path: str, data: Dict[str, list]) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f)


def vocabulary() -> List[str]:
    return list(WORDS)
