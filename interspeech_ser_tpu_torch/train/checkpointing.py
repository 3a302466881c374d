"""Full training-state checkpoint and resume.

Port of ``interspeech_ser_tpu/train/checkpointing.py`` without orbax: one
file, ``<model_path>/train_state.pt``, written with ``torch.save`` after
every epoch (tmp + rename, so a crash never leaves half a file). It holds
the model, the optimizer, the finished epoch, the best-metric record, the
sampler's numpy RNG state and the dropout generator's state, so a resumed
fit continues the run it replaces draw for draw. ``fit(resume=True)``
(``--resume`` on the train CLI) reads it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STATE_FILE = "train_state.pt"


def save_train_state(
    model_path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    epoch: int,
    best: Dict[str, Any],
    np_rng: np.random.Generator,
    generator: torch.Generator,
) -> None:
    path = os.path.join(model_path, STATE_FILE)
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "epoch": epoch,
        "best": dict(best),
        "np_rng_state": np_rng.bit_generator.state,
        "torch_generator_state": generator.get_state(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_state(
    model_path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    np_rng: np.random.Generator,
    generator: torch.Generator,
) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Restore everything in place -> (finished epoch, best record), or None
    when the model path holds no state file."""
    path = os.path.join(model_path, STATE_FILE)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    np_rng.bit_generator.state = state["np_rng_state"]
    generator.set_state(state["torch_generator_state"])
    return state["epoch"], state["best"]
