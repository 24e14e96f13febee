"""Device selection and the process group for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; the default is the card.

    Raises when a CUDA device is asked for and none is present: the port
    never falls back to the CPU on its own. Pass ``device="cpu"`` for the
    plain PyTorch path (the tests do).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def process_index_and_count():
    """(rank, world size) of the ``torch.distributed`` process group, or
    (0, 1) without one (the counterpart of ``jax.process_index()`` and
    ``jax.process_count()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
