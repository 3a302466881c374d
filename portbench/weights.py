"""Seeded random weights, made on the device in one call.

Every cell's weights come from ``--seed``: one ``torch.rand`` over all the
parameters from a ``torch.Generator`` on the card, cut into the leaves of
``shapes`` in order and scaled by a rule of the leaf's name and shape:
a LayerNorm's weight 1 +- 0.1, a bias or LayerNorm bias +- 0.1, any other
leaf uniform with variance 1 / fan_in (fan_in: the product of its shape
after the first dimension). The program and the reference are handed the
same tensors; a reference that runs after the program's state is freed
makes them again from the same seed.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of ``--seed``."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _is_norm_weight(name: str) -> bool:
    return name.endswith(".weight") and "norm" in name.rsplit(".", 2)[-2]


def make(shapes: Dict[str, tuple], seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):  # scaled in place: views of one buffer
        if _is_norm_weight(name):
            part.mul_(0.1).add_(1.0)
        elif len(shape) == 1:
            part.mul_(0.1)
        else:
            part.mul_((3.0 / int(torch.Size(shape[1:]).numel())) ** 0.5)
        out[name] = part.view(shape).to(dtype)
    return out
