"""Deterministic RNG scoping for host-side randomness (a copy of
lfvdm_tpu/utils/rng.py).

The reference swaps the python/torch/cuda/numpy RNG states around its
visualisation blocks so in-training sampling is reproducible. The port's
device randomness is already explicit (a ``torch.Generator`` per stream), so
this scopes the host's global python and numpy generators (the vis batch's
mask sampling).
"""

from __future__ import annotations

import random
from functools import wraps

import numpy as np


class RNG:
    """Context manager: seed python+numpy RNG inside, restore state outside.

    >>> with RNG(0):
    ...     ...  # deterministic block
    """

    def __init__(self, seed: int):
        self.seed = seed
        self._py_state = None
        self._np_state = None

    def __enter__(self):
        self._py_state = random.getstate()
        self._np_state = np.random.get_state()
        random.seed(self.seed)
        np.random.seed(self.seed)
        return self

    def __exit__(self, *exc):
        random.setstate(self._py_state)
        np.random.set_state(self._np_state)
        return False


def rng_decorator(seed: int):
    def decorator(fn):
        @wraps(fn)
        def wrapped(*args, **kwargs):
            with RNG(seed):
                return fn(*args, **kwargs)

        return wrapped

    return decorator


def set_random_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
