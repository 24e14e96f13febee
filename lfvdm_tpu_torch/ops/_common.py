"""Checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh: DType


def _check_impl(impl: str):
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def _use_kernel(device: torch.device) -> bool:
    """CPU tensors take the plain version; CUDA tensors the kernel."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise RuntimeError(f"no kernel for device {device}")


def _check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
