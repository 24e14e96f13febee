"""LPIPS perceptual embedder, AlexNet backbone (counterpart of
lfvdm_tpu/evals/lpips.py).

The adaptive sampling schemes pick maximally diverse conditioning frames by
the squared L2 distance of these embeddings, which equals the LPIPS distance.
Per AlexNet stage l with LPIPS head weights w_l:

  e_l = sqrt(max(w_l, 0)) * (f_l / ||f_l||_channel) / sqrt(H_l W_l),  flattened
  embedding = concat_l e_l

so ||e(x) - e(y)||² = Σ_l mean_hw Σ_c w_l (f̂_l(x) - f̂_l(y))² = LPIPS(x, y).
Each stage is flattened in (H, W, C) order, as the JAX package's NHWC
embedding is, so the two packages give the same vector on the same weights.

Weights: the JAX embedder's ``.npz`` (``conv{i}.kernel`` HWIO, ``conv{i}.bias``,
``lin{i}``), from a path or from ``$LFVDM_LPIPS_WEIGHTS``. The port's
``python -m lfvdm_tpu_torch.scripts.convert_lpips`` writes it from the
``lpips`` package's AlexNet weights, the same file as the repo's
``scripts/convert_lpips.py``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ImageNet scaling constants of LPIPS's ScalingLayer.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision-AlexNet ``features``: (in, out, kernel, stride, padding) of the
# five convolutions, each followed by a ReLU that LPIPS taps; a 3x3 stride-2
# max pool comes before the second and the third.
_CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
_POOL_BEFORE = (1, 2)


class LpipsEmbedderModule(nn.Module):
    """AlexNet taps -> unit-normalised, head-weighted, flattened embedding.

    ``forward(x)``: x (B, 3, H, W) in [-1, 1] -> (B, E) f32. Parameters:
    ``conv{i}_weight`` (out, in, k, k), ``conv{i}_bias`` and ``lin{i}`` (the
    head weights, ones until loaded)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout, k, _, _) in enumerate(_CONVS, start=1):
            self.register_parameter(f"conv{i}_weight", nn.Parameter(torch.empty(cout, cin, k, k)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(torch.zeros(cout)))
        for i, (_, cout, _, _, _) in enumerate(_CONVS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(cout)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def seeded_init(self, seed: int = 0):
        """Random backbone drawn from ``torch.Generator().manual_seed(seed)``:
        each kernel from a truncated normal of variance 1/fan_in (flax's
        ``lecun_normal``, the JAX embedder's initialiser), biases 0, head
        weights 1. Deterministic, but not the JAX embedder's ``PRNGKey(0)``
        draw: the two packages' random backbones differ."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for i in range(1, len(_CONVS) + 1):
                w = getattr(self, f"conv{i}_weight")
                std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
                w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), std=std, a=-2 * std,
                                              b=2 * std, generator=gen))
                getattr(self, f"conv{i}_bias").zero_()
            for i in range(len(_CONVS)):
                getattr(self, f"lin{i}").fill_(1.0)
        return self

    def load_npz(self, path: str):
        """The JAX embedder's ``.npz`` (HWIO kernels)."""
        from ..utils.convert import lpips_state_dict_from_npz

        with np.load(path) as data:
            self.load_state_dict(lpips_state_dict_from_npz(data))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.shift) / self.scale
        pieces = []
        for i, (_, _, _, stride, pad) in enumerate(_CONVS):
            if i in _POOL_BEFORE:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i + 1}_weight"),
                                getattr(self, f"conv{i + 1}_bias"), stride=stride, padding=pad))
            norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + 1e-10
            w = torch.sqrt(torch.clamp(getattr(self, f"lin{i}"), min=0.0))
            scaled = w[None, :, None, None] * (x / norm)
            B, _, H, W = scaled.shape
            pieces.append(scaled.permute(0, 2, 3, 1).reshape(B, -1) / math.sqrt(H * W))
        return torch.cat(pieces, dim=-1)


class LpipsEmbedder:
    """Callable: (B, C, H, W) numpy frames in [-1, 1] -> (B, E) numpy
    embeddings, computed on ``device`` (the card by default). One channel is
    tiled to three; latent frames embed their first three channels.

    ``weights_path`` (or ``$LFVDM_LPIPS_WEIGHTS``) names the ``.npz``; without
    one the backbone is the seeded random one (``seeded_init``), which the
    adaptive schemes' max-min diversity selection can use, and a line says it
    is not pretrained. ``image_size`` is accepted for the JAX embedder's
    signature (it sizes that package's init) and is unused."""

    def __init__(self, weights_path: Optional[str] = None, image_size: int = 64,
                 device="cuda"):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.module = LpipsEmbedderModule()
        self.pretrained = False
        weights_path = weights_path or os.environ.get("LFVDM_LPIPS_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            self.module.load_npz(weights_path)
            self.pretrained = True
        else:
            if weights_path:
                print(f"LPIPS weights not found at {weights_path}; using random backbone.")
            else:
                print("LPIPS weights unavailable; using deterministic random backbone "
                      "(set LFVDM_LPIPS_WEIGHTS for pretrained behavior).")
            self.module.seeded_init(0)
        self.module.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, frames: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.array(frames, np.float32), device=self.device)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        elif x.shape[1] != 3:
            x = x[:, :3]
        return self.module(x).cpu().numpy()


_default: dict = {}  # torch.device -> LpipsEmbedder


def default_lpips_embedder(device="cuda") -> LpipsEmbedder:
    """One ``LpipsEmbedder`` per device for the process, built at first use."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    if device not in _default:
        _default[device] = LpipsEmbedder(device=device)
    return _default[device]
