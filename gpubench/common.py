"""Small helpers shared by the entries: seeds derived from the run's seed,
device synchronisation, float32 without TF32 for the reference, and the
comparison numbers."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 62-bit seed derived from the run's ``seed`` and ``tags``: one
    stream per purpose (weights, inputs, noise, samples)."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 30) ^ int(state[1])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def full_f32():
    """float32 matrix products and convolutions without TF32 (PyTorch's
    cuDNN default allows it), as the reference is defined."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got − want|| / ||want|| over every element, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def worst_leaf_gap(got: dict, want: dict, names) -> float:
    """The largest gap |‖got_l‖ − ‖want_l‖| over the leaves ``names``,
    each measured against the larger of ‖want_l‖ and the median leaf's
    ‖want‖ (some leaves are all but zero)."""
    if not names:
        return 0.0
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)
