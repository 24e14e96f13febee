"""Device selection for the port's entry points."""

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
