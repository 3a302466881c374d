"""Torch-format ``.pt`` I/O for per-utterance features and state dicts.

Port of ``interspeech_ser_tpu/utils/ptio.py``: the inter-stage contract is
one ``[T, D]`` float32 tensor per utterance. ``torch.save`` of a view writes
the view's whole storage, so :func:`save_tensor` saves a compact clone; the
write is atomic (tmp + rename), so a resumed extraction can trust any file
that exists.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def save_tensor(t, path: str) -> None:
    t = torch.as_tensor(t).detach().cpu().clone()
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(t, tmp)
    os.replace(tmp, path)


def load_tensor(path: str) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).detach().numpy()


def save_state_dict(sd: Dict[str, torch.Tensor], path: str) -> None:
    """CPU copies of ``sd``'s tensors, written atomically (tmp + rename)."""
    sd = {k: v.detach().cpu().clone() for k, v in sd.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(sd, tmp)
    os.replace(tmp, path)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
