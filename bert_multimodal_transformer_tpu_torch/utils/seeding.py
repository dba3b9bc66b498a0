"""Seeding (port of ``utils/seeding.py``): the ``seed`` argparse type (int
0-9999 or "random"), the bool type, and a ``set_random_seed`` that seeds
the host RNGs and returns an explicit ``torch.Generator``."""

from __future__ import annotations

import os
import random
from typing import Union

import numpy as np
import torch


def parse_seed(s: Union[str, int]) -> int:
    """"random" → randint(0, 9999); otherwise int in [0, 9999]."""
    if isinstance(s, int):
        return s
    if s == "random":
        return random.randint(0, 9999)
    value = int(s)
    if not 0 <= value <= 9999:
        raise ValueError(f"seed must be in [0, 9999], got {value}")
    return value


def str2bool(v: Union[str, bool]) -> bool:
    """argparse bool type."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Boolean value expected, got {v!r}")


def set_random_seed(seed: int, device=None) -> torch.Generator:
    """Seed the host RNGs and return a ``torch.Generator`` on ``device``
    seeded with ``seed``, to be passed wherever params are initialized.
    The JAX function returns ``PRNGKey(seed)`` instead; under
    ``--rng_impl threefry2x32`` the port's ``Trainer.init_state(seed)``
    derives that key (``utils/jax_random.py::PRNGKey``)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
