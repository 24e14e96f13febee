"""I3D (Inflated Inception-v1, Kinetics-400) for FVD features (counterpart of
lfvdm_tpu/evals/i3d.py, the TF-Hub ``deepmind/i3d-kinetics-400/1`` graph).

The 400-d logits are the FVD feature vector. The layout inside is NCDHW.
Every convolution and max pool is TF-"SAME" padded, which is asymmetric: the
pads are computed per dimension from the input size, and for an even total
the extra one goes after (``Conv3d_1a_7x7`` at 224 px pads (2, 3)).
PyTorch's symmetric ``padding=`` would give the same output shape with
shifted values, so each layer ``F.pad``s explicitly: with 0 before a
convolution, with -inf before a max pool (as ``flax.linen.max_pool`` pads).
BatchNorm is TF slim's: beta only, eps 1e-3, frozen moments.

Weights: the JAX package's flat ``.npz`` (keys as the repo's
``scripts/convert_i3d.py::tf_var_to_flax`` writes them, such as
``params/Mixed_3b/Branch_0/Conv3d_0a_1x1/conv_3d/kernel``), from a path or
from ``$LFVDM_I3D_WEIGHTS``; ``utils.convert.i3d_state_dict_from_jax`` maps
it onto this module's names (the same path with ``.`` for ``/``). Without
weights the backbone is a seeded random one, and FVD values mean nothing
against published scores.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import split_rows
from torch import nn


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]):
    """``F.pad``'s argument (last dimension first) for TF "SAME" padding of
    the trailing ``len(sizes)`` dimensions."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def max_pool_3d(x: torch.Tensor, window, strides) -> torch.Tensor:
    x = F.pad(x, same_pads(x.shape[2:], window, strides), value=-math.inf)
    return F.max_pool3d(x, window, strides)


class Unit3D(nn.Module):
    """Conv3d (no bias when BatchNorm follows) + frozen BatchNorm (beta only)
    + optional ReLU. Parameters ``weight`` (out, in, kt, kh, kw), ``bias``
    (without BatchNorm) or ``beta``; buffers ``moving_mean`` and
    ``moving_variance``."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), strides=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.use_bn, self.activation = use_bn, activation
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel))
        if use_bn:
            self.beta = nn.Parameter(torch.zeros(cout))
            self.register_buffer("moving_mean", torch.zeros(cout))
            self.register_buffer("moving_variance", torch.ones(cout))
        else:
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.strides))
        x = F.conv3d(x, self.weight, None if self.use_bn else self.bias, self.strides)
        if self.use_bn:
            shape = (1, -1, 1, 1, 1)
            x = ((x - self.moving_mean.view(shape)) * torch.rsqrt(self.moving_variance.view(shape)
                                                                  + 1e-3)
                 + self.beta.view(shape))
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four-branch Inception-v1 block, inflated to 3D; its units sit at the
    TF graph's names (``Branch_1.Conv3d_0b_3x3``)."""

    def __init__(self, cin, b0, b1a, b1b, b2a, b2b, b3):
        super().__init__()
        self.Branch_0 = nn.ModuleDict({"Conv3d_0a_1x1": Unit3D(cin, b0)})
        self.Branch_1 = nn.ModuleDict({"Conv3d_0a_1x1": Unit3D(cin, b1a),
                                       "Conv3d_0b_3x3": Unit3D(b1a, b1b, (3, 3, 3))})
        self.Branch_2 = nn.ModuleDict({"Conv3d_0a_1x1": Unit3D(cin, b2a),
                                       "Conv3d_0b_3x3": Unit3D(b2a, b2b, (3, 3, 3))})
        self.Branch_3 = nn.ModuleDict({"Conv3d_0b_1x1": Unit3D(cin, b3)})
        self.out_channels = b0 + b1b + b2b + b3

    def forward(self, x):
        br0 = self.Branch_0["Conv3d_0a_1x1"](x)
        br1 = self.Branch_1["Conv3d_0b_3x3"](self.Branch_1["Conv3d_0a_1x1"](x))
        br2 = self.Branch_2["Conv3d_0b_3x3"](self.Branch_2["Conv3d_0a_1x1"](x))
        br3 = self.Branch_3["Conv3d_0b_1x1"](max_pool_3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([br0, br1, br2, br3], dim=1)


# (b0, b1a, b1b, b2a, b2b, b3) per mixed block — Inception-v1 table.
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


class I3D(nn.Module):
    """Full I3D: (B, 3, T, H, W) in [-1, 1] -> (B, 400) kinetics logits
    (time-averaged)."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, widths in _MIXED.items():
            block = InceptionBlock(cin, *widths)
            self.add_module(name, block)
            cin = block.out_channels
        self.Logits = nn.ModuleDict({"Conv3d_0c_1x1": Unit3D(cin, num_classes, use_bn=False,
                                                             activation=False)})

    def seeded_init(self, seed: int = 0):
        """A random backbone from ``torch.Generator().manual_seed(seed)``:
        each kernel normal with variance 2/fan_in (He's, which keeps the
        activations' scale through the ReLUs), beta and bias 0, moments
        (0, 1). Deterministic, but not the JAX package's ``PRNGKey(0)``
        init: the two packages' random backbones differ."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    std = math.sqrt(2.0 / p[0].numel())
                    p.copy_(torch.randn(p.shape, generator=gen) * std)
                else:
                    p.zero_()
        return self

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_3d(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # The hub graph's logits head: a (2, 7, 7) stride-1 VALID average
        # pool, which at 224 px is a spatial mean followed by a window-2
        # moving average over time (T' -> T' - 1); then the 1x1x1 conv and
        # a time mean.
        x = x.mean(dim=(3, 4), keepdim=True)  # (B, C, T', 1, 1)
        if x.shape[2] > 1:
            x = (x[:, :, :-1] + x[:, :, 1:]) / 2
        x = self.Logits["Conv3d_0c_1x1"](x)
        return x.flatten(2).mean(dim=2)


class I3DFeatureExtractor:
    """Callable: float32 (B, T, 224, 224, 3) in [-1, 1] -> (B, 400) numpy,
    computed on ``device`` (the card by default) in full f32.

    ``weights_path`` (or ``$LFVDM_I3D_WEIGHTS``) names the JAX package's
    ``.npz``; without one the backbone is ``I3D.seeded_init(0)``.
    ``devices``: one replica per device (``device`` is then the first), and
    each batch's rows split over them in contiguous blocks; a batch they do
    not divide runs on the first."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda", devices=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(devices[0] if devices else device)
        self.module = I3D()
        self.pretrained = False
        weights_path = weights_path or os.environ.get("LFVDM_I3D_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            from ..utils.convert import i3d_state_dict_from_jax

            self.module.load_state_dict(i3d_state_dict_from_jax(dict(np.load(weights_path))))
            self.pretrained = True
        else:
            if weights_path:
                print(f"I3D weights not found at {weights_path}; random backbone.")
            else:
                print("I3D weights unavailable; FVD values will not match published "
                      "numbers (set LFVDM_I3D_WEIGHTS to a converted checkpoint).")
            self.module.seeded_init(0)
        self.module.to(self.device).eval()
        self.replicas = [self.module] + [copy.deepcopy(self.module).to(d)
                                         for d in (devices or [])[1:]]

    @torch.no_grad()
    def features(self, x, prepare=None) -> torch.Tensor:
        """(B, 3, T, H, W) f32 in [-1, 1] on any device -> (B, 400) on
        ``device``, TF32 off; each replica takes its block of rows (``x`` may
        be anything ``prepare`` maps to that on the replica's device)."""
        from ..utils.device import full_f32

        models = self.replicas
        if len(models) == 1 or len(x) % len(models):
            models, blocks = [self.module], [torch.as_tensor(x, device=self.device)]
        else:
            blocks = split_rows(x, [next(m.parameters()).device for m in models])
        out = []
        with full_f32():
            for m, xi in zip(models, blocks):
                out.append(m(prepare(xi) if prepare is not None else xi).to(self.device))
        return torch.cat(out)

    def __call__(self, videos: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(videos, np.float32), device=self.device)
        return self.features(x.permute(0, 4, 1, 2, 3)).cpu().numpy()
