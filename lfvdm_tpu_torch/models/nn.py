"""NN primitives of the video U-Net (counterpart of lfvdm_tpu/models/nn.py).

* Parameters are f32; ``Linear`` and ``Conv2d`` cast their input, weight and
  bias to a compute dtype, as a Flax ``Dense``/``Conv`` with ``dtype=`` does.
* ``GroupNorm32`` computes its statistics and the normalisation in f32 and
  casts back (or emits f32 for the output head). Given per-channel sums
  (``channel_sums``, or the skip projection's kernel), it forms the group
  statistics from them instead of reading its input again. Inside
  ``saved_group_stats()`` (a rematerialised block whose remat policy saves
  them, ``models/unet.py`` ``remat_policy``) it takes its (N, G) statistics
  from an op that returns them alone, so that the policy can keep them.
  ``GroupNorm32.silu`` runs the norm, a scale-shift and SiLU: as one
  ``group_norm_silu`` call (``ops/groupnorm.py``) with ``fused``, which the
  U-Net asks for on the card where no gradient is taken, else as the module
  then ``scale_shift_silu``.
* Initialisation is torch's default (uniform ±1/√fan_in for weights and
  biases), drawn from an explicit ``torch.Generator`` by ``init_parameters``;
  "zero modules" start at zero. Construction itself draws nothing.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import group_affine, group_norm_plain, group_norm_silu, scale_shift_silu


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings, [cos | sin] order. (N,) -> (N, dim) f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


_STATS = threading.local()  # .saved: inside saved_group_stats() on this thread


@contextlib.contextmanager
def saved_group_stats():
    """Inside, on this thread, ``GroupNorm32`` without ``precomputed_sums``
    computes its group statistics with ``torch.var_mean`` (an op whose
    outputs are the f32 (N, G) variance and mean alone) and applies the
    affine folded into them, as ``lfvdm_tpu/models/nn.py`` ``GroupNorm32``
    does under its ``gn_stats`` checkpoint names. ``F.group_norm`` returns
    its statistics fused with the whole activation, so a remat policy could
    not save them without saving the activation. ``models/unet.py`` runs a
    rematerialised block's forward and recompute inside this under the
    ``gn_stats`` and ``dots`` policies."""
    before = getattr(_STATS, "saved", False)
    _STATS.saved = True
    try:
        yield
    finally:
        _STATS.saved = before


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over (N, C, *) with f32 statistics.

    ``groups = 32`` when it divides C, else gcd(32, C). The output has the
    input's dtype unless ``out_dtype`` is given (the output head emits f32).
    """

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 out_dtype: Optional[torch.dtype] = None):
        g = groups if channels % groups == 0 else math.gcd(groups, channels)
        super().__init__(g, channels, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor, precomputed_sums=None) -> torch.Tensor:
        """``precomputed_sums``: optional per-(sample, channel) f32 (Σx, Σx²),
        each (N, C), taken where x's parts were produced. The group variance
        is then the unanchored E[x²] − E[x]² (lfvdm_tpu ``GroupNorm32``), and
        gradients flow through the sums."""
        G = self.num_groups
        if precomputed_sums is None and getattr(_STATS, "saved", False):
            N = x.shape[0]
            g_var, g_mean = torch.var_mean(x.float().reshape(N, G, -1), dim=2, keepdim=True,
                                           correction=0)  # (N, G, 1) each
            return group_affine(x, G, self.weight, self.bias, self.eps, g_mean, g_var,
                                self.out_dtype)
        return group_norm_plain(x, G, self.weight, self.bias, self.eps, self.out_dtype,
                                precomputed_sums)

    def silu(self, x: torch.Tensor, *, sums=None, scale=None, shift=None,
             fused: bool = True) -> torch.Tensor:
        """silu(this norm of x · (1 + scale) + shift). ``fused``: as one
        ``group_norm_silu`` call (``ops/groupnorm.py``), the chain in one pass
        on the card, for forwards that take no gradient; otherwise this
        module's forward, then ``scale_shift_silu``."""
        if fused:
            return group_norm_silu(x, self.weight, self.bias, scale=scale, shift=shift,
                                   sums=sums, groups=self.num_groups, eps=self.eps,
                                   out_dtype=self.out_dtype)
        return scale_shift_silu(self(x, precomputed_sums=sums), scale, shift)


def channel_sums(x: torch.Tensor):
    """Per-(sample, channel) f32 (Σx, Σx²) over every axis after the channel
    axis of an (N, C, ...) tensor: the ``precomputed_sums`` of ``GroupNorm32``."""
    dims = tuple(range(2, x.ndim))
    return x.sum(dim=dims, dtype=torch.float32), x.float().square().sum(dim=dims)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; ``zero=True`` makes a zero module."""

    def __init__(self, in_features: int, out_features: int, *, dtype=torch.float32,
                 zero: bool = False):
        self.compute_dtype = dtype
        self.zero = zero
        super().__init__(in_features, out_features)

    def reset_parameters(self):
        _zero_(self)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) computing in ``dtype``; ``zero=True`` makes a zero module."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, dtype=torch.float32, zero: bool = False):
        self.compute_dtype = dtype
        self.zero = zero
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)

    def reset_parameters(self):
        _zero_(self)

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _zero_(module):
    with torch.no_grad():
        module.weight.zero_()
        module.bias.zero_()


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default init for every ``Linear``/``Conv2d`` below ``module``,
    drawn from ``generator`` (a CPU generator; values are then copied to the
    parameters' device). Zero modules stay zero; GroupNorm stays (1, 0)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Linear, Conv2d)) and not m.zero:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    vals = torch.empty(p.shape, dtype=torch.float32).uniform_(
                        -bound, bound, generator=generator)
                    p.copy_(vals)
    return module
