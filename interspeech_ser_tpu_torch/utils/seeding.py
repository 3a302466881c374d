"""Deterministic seeding across python / numpy / torch.

Port of ``interspeech_ser_tpu/utils/seeding.py`` without jax: the host
samplers draw from an isolated numpy ``Generator`` (PCG64), so one seed
draws the same batches in both packages; dropout draws from a seeded
``torch.Generator`` that the engine owns.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_deterministic(seed: int = 42, *, verbose: bool = True) -> None:
    """Seed the python, numpy and torch global RNGs."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if verbose:
        print(f"Random seed set to: {seed}")


def numpy_generator(seed: int) -> np.random.Generator:
    """Fresh, isolated numpy Generator (used by host-side samplers)."""
    return np.random.Generator(np.random.PCG64(seed))
