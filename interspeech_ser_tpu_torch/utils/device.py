"""Device choice for the port's entry points: the card unless asked otherwise.

The counterpart of the JAX package's platform choice (``JAX_PLATFORMS``):
every entry point takes ``device`` (``--device`` on the CLIs), ``cuda`` by
default. Without a card the default raises rather than falling back to the
CPU, so a run never hides which device it used.
"""

from __future__ import annotations

from typing import Union

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is False. "
            "Pass device='cpu' (--device cpu) to run on the CPU."
        )
    return device
