"""Dataset validation: a numpy copy of the JAX package's ``data/validate.py``
(the port cannot import that package, whose ``__init__`` pulls in jax).
The tests hold the two equal (ROADMAP A.12).

The programmatic form of the reference's ``examine.ipynb`` validate()
cell: every example has ``len(words) == len(visual) == len(acoustic)``
and the modality dims, and the splits' sizes are reported. A library call
or a command:

    python -m bert_multimodal_transformer_tpu_torch.data.validate \\
        datasets/mosi.pkl [visual_dim acoustic_dim]
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    load_pickle_splits,
)


class ValidationError(ValueError):
    pass


def validate_example(example, idx: int, split: str,
                     visual_dim: Optional[int],
                     acoustic_dim: Optional[int]):
    """Check one ((words, visual, acoustic), label, segment) example;
    returns its (visual dim, acoustic dim)."""
    try:
        (words, visual, acoustic), label, segment = example
    except (TypeError, ValueError) as e:
        raise ValidationError(
            f"{split}[{idx}]: not a ((words, visual, acoustic), label, "
            f"segment) triple: {e}") from e
    visual = np.asarray(visual)
    acoustic = np.asarray(acoustic)
    n = len(words)
    if visual.ndim != 2 or acoustic.ndim != 2:
        raise ValidationError(
            f"{split}[{idx}]: modality arrays must be 2-D, got "
            f"visual {visual.shape}, acoustic {acoustic.shape}")
    if not (n == visual.shape[0] == acoustic.shape[0]):
        raise ValidationError(
            f"{split}[{idx}]: misaligned lengths words={n} "
            f"visual={visual.shape[0]} acoustic={acoustic.shape[0]}")
    if visual_dim is not None and visual.shape[1] != visual_dim:
        raise ValidationError(
            f"{split}[{idx}]: visual dim {visual.shape[1]} != {visual_dim}")
    if acoustic_dim is not None and acoustic.shape[1] != acoustic_dim:
        raise ValidationError(
            f"{split}[{idx}]: acoustic dim {acoustic.shape[1]} != "
            f"{acoustic_dim}")
    if not np.isfinite(visual).all() or not np.isfinite(acoustic).all():
        raise ValidationError(f"{split}[{idx}]: non-finite modality values")
    return visual.shape[1], acoustic.shape[1]


def validate(data: Dict[str, list], visual_dim: Optional[int] = None,
             acoustic_dim: Optional[int] = None) -> Dict[str, int]:
    """Validate all splits; returns {split: size}. Dims are inferred from
    the first example when not given and must then be consistent."""
    sizes = {}
    for split in ("train", "dev", "test"):
        examples = data[split]
        for i, ex in enumerate(examples):
            dv, da = validate_example(ex, i, split, visual_dim, acoustic_dim)
            if visual_dim is None:
                visual_dim = dv
            if acoustic_dim is None:
                acoustic_dim = da
        sizes[split] = len(examples)
    return sizes


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: validate.py <dataset.pkl> [visual_dim acoustic_dim]",
              file=sys.stderr)
        return 2
    data = load_pickle_splits(argv[0])
    dims = (int(argv[1]), int(argv[2])) if len(argv) >= 3 else (None, None)
    try:
        sizes = validate(data, *dims)
    except ValidationError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    for split, n in sizes.items():
        print(f"{split}: {n} examples")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
