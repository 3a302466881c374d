"""Device choice for the port's entry points: the card unless asked otherwise.

The counterpart of the JAX package's platform choice (``JAX_PLATFORMS``):
every entry point takes ``device`` (``--device`` on the CLIs), ``cuda`` by
default. Without a card the default raises rather than falling back to the
CPU, so a run never hides which device it used.

Multi-device runs are one process a rank (``torchrun --nproc_per_node N -m
interspeech_ser_tpu_torch.<cli> ...``). ``init_distributed`` joins the
process group the ``torchrun`` environment describes; ``resolve_device``
then gives each rank its own card, ``cuda:{LOCAL_RANK}`` (modulo the cards
there are, so that ranks may share one). ``pick_backend`` chooses NCCL when
every local rank has a card of its own, gloo when ranks share a card or run
on the CPU, and says which and why.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DEVICES = ("cuda", "cpu")


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a bare ``cuda`` in a process group is
    the rank's card. No card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is False. "
            "Pass device='cpu' (--device cpu) to run on the CPU."
        )
    if device.type == "cuda" and device.index is None and distributed():
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def pick_backend(device: Union[str, torch.device] = "cuda", local_world: Optional[int] = None) -> tuple:
    """-> (backend, why): NCCL when each of the ``local_world`` ranks on this
    host has a card of its own, else gloo (ranks that share a card, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    local_world = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", f"{local_world} local rank(s) on {cards} card(s): one card a rank"
    return "gloo", f"{local_world} local ranks share {cards} card(s)"


def init_distributed(device: Union[str, torch.device] = "cuda", init_method: str = "env://",
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_world: Optional[int] = None) -> bool:
    """Join the process group when the run has more than one rank (the
    ``torchrun`` environment: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``; or ``rank`` / ``world_size`` with an
    ``init_method`` such as ``file://`` or ``tcp://localhost:<port>``) ->
    whether a group is up. Prints the backend and why, on every rank."""
    if distributed():
        return True
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size <= 1:
        return False
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    backend, why = pick_backend(device, local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(device)  # raises
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    print(f"[dist] rank {rank}/{world_size}: backend {backend} ({why})", flush=True)
    return True


def teardown() -> None:
    """Leave the process group, if one is up."""
    if distributed():
        dist.destroy_process_group()


def is_main() -> bool:
    """Rank 0 (or no process group): the rank that writes files and logs."""
    return not distributed() or dist.get_rank() == 0
