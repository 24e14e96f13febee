"""NN primitives of the video U-Net (counterpart of lfvdm_tpu/models/nn.py).

* Parameters are f32; ``Linear`` and ``Conv2d`` cast their input, weight and
  bias to a compute dtype, as a Flax ``Dense``/``Conv`` with ``dtype=`` does.
* ``GroupNorm32`` computes its statistics and the normalisation in f32 and
  casts back (or emits f32 for the output head). Given per-channel sums
  (``channel_sums``, or the skip projection's kernel), it forms the group
  statistics from them instead of reading its input again.
* Initialisation is torch's default (uniform ±1/√fan_in for weights and
  biases), drawn from an explicit ``torch.Generator`` by ``init_parameters``;
  "zero modules" start at zero. Construction itself draws nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
        if precomputed_sums is None:
            y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
            return y.to(self.out_dtype or x.dtype)
        N, C = x.shape[:2]
        G = self.num_groups
        n_red = x[0, 0].numel() * (C // G)
        s1, s2 = precomputed_sums
        g_mean = s1.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red  # (N, G, 1)
        g_var = (s2.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red
                 - g_mean.square()).clamp(min=0.0)
        # per-channel affine y = x·mul + add, broadcast from the groups
        mul = torch.rsqrt(g_var + self.eps) * self.weight.reshape(G, C // G)
        add = self.bias.reshape(G, C // G) - g_mean * mul
        bshape = (N, C) + (1,) * (x.ndim - 2)
        mul, add = mul.reshape(bshape), add.reshape(bshape)
        # add + x·mul in f32 in one pass over x (x is promoted as it is read)
        y = torch.addcmul(add, x, mul)
        return y.to(self.out_dtype or x.dtype)


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
