"""CARLA Town01 world-coordinate metrics: ResNet-152 classifier + regressor
(counterpart of lfvdm_tpu/evals/carla_regressor.py).

The paper's WD/PO metrics map each frame to a world coordinate: a ResNet-152
classifier picks one of 100 grid cells (a 10x10 histogram over
[-10, 400]^2), and a 100-headed ResNet-152 regressor maps the frame to
(x, y) given the cell. ``CoordPredictor`` chains them in batches on the card.

Written in plain torch (no torchvision) with torchvision's module names:
``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` / ``bn{i}`` / ``downsample.0`` /
``downsample.1`` and ``fc``; the regressor's trunk under ``resnet.`` and its
heads as ``regressors.{i}``. So the paper's ``.pth`` files, and the ``.pt``
files the port's ``carla_regressor_train`` writes, load with a plain
``load_state_dict``.

BatchNorm in train mode follows Flax, not ``nn.BatchNorm2d``: both normalise
by the biased batch variance (momentum 0.1, eps 1e-5), but Flax, like this
module, updates the running variance with the biased variance where torch
uses the unbiased one, a factor n/(n-1) apart.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ImageNet normalization used by base_data_transform.
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

GRID_RANGE = ((-10, 400), (-10, 400))  # Town01 histogram range
GRID_BINS = 10
STAGE_SIZES = (3, 8, 36, 3)


def get_cell(coord: np.ndarray) -> int:
    """Map an (x, y) world coordinate to its 10x10 grid cell index."""
    count, _, _ = np.histogram2d([coord[0]], [coord[1]], bins=GRID_BINS,
                                 range=[list(GRID_RANGE[0]), list(GRID_RANGE[1])])
    nz = count.flatten().nonzero()[0]
    return int(nz[0]) if len(nz) else 0


class BatchNorm2d(nn.Module):
    """torchvision's BatchNorm2d parameters and buffers (``weight``, ``bias``,
    ``running_mean``, ``running_var``), with Flax's train-mode update: the
    running statistics take 0.1 of the batch mean and of the *biased* batch
    variance. Eval mode normalises by the running statistics."""

    momentum, eps = 0.1, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        shape = (1, -1, 1, 1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class Bottleneck(nn.Module):
    """torchvision's ResNet v1.5 bottleneck: the stride sits on conv2."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 1), BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = BatchNorm2d(features)
        self.conv3, self.bn3 = _conv(features, features * 4, 1), BatchNorm2d(features * 4)
        self.downsample = (nn.Sequential(_conv(cin, features * 4, 1, stride),
                                         BatchNorm2d(features * 4)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet152Trunk(nn.Module):
    """torchvision resnet152 up to global average pooling:
    (B, 3, H, W) ImageNet-normalised -> (B, 2048)."""

    def __init__(self, stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2, 3), BatchNorm2d(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                blocks.append(Bottleneck(cin, features, 2 if stage > 0 and block == 0 else 1,
                                         downsample=block == 0))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def trunk(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))

    def forward(self, x):
        return self.trunk(x)


def seeded_init(module: nn.Module, seed: int = 0):
    """A random ResNet from ``torch.Generator().manual_seed(seed)``: each
    convolution normal with variance 2/fan_in, each linear layer normal with
    variance 1/fan_in and bias 0, BatchNorm (1, 0) with moments (0, 1),
    except each bottleneck's last BatchNorm scale, 0.2: the 50 residual
    additions of the full trunk then keep its activations finite and of
    order one in eval mode. Returns ``module``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                std = math.sqrt(gain / m.weight[0].numel())
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(0.2 if name.endswith("bn3") else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module


class ResNet152Classifier(ResNet152Trunk):
    """The trunk and ``fc``: (B, 3, H, W) -> (B, 100) cell logits."""

    def __init__(self, num_classes: int = 100, stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__(stage_sizes)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        return self.fc(self.trunk(x))


class MultiHeadResNet152(nn.Module):
    """100 per-cell regression heads over a shared trunk:
    (B, 3, H, W), cells (B,) -> (B, 2)."""

    def __init__(self, num_heads: int = 100, stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__()
        self.resnet = ResNet152Trunk(stage_sizes)
        self.regressors = nn.ModuleList(nn.Linear(2048, 2) for _ in range(num_heads))

    def forward(self, x, cells):
        emb = self.resnet(x)
        kernels = torch.stack([r.weight for r in self.regressors])  # (heads, 2, 2048)
        biases = torch.stack([r.bias for r in self.regressors])
        # One gather picks each frame's head.
        return torch.einsum("bf,bof->bo", emb, kernels[cells]) + biases[cells]


def normalize_frames(frames: np.ndarray) -> np.ndarray:
    """uint8/float (B, C, H, W) in [0, 255] or [0, 1] -> ImageNet-normalised
    float32 (B, C, H, W)."""
    x = np.asarray(frames, np.float32)
    if x.max() > 2.0:
        x = x / 255.0
    return (x - _MEAN[:, None, None]) / _STD[:, None, None]


class CoordPredictor:
    """classifier -> cell; multi-head regressor -> (x, y). Batched, on
    ``device`` (the card by default), in full f32 (TF32 off)."""

    def __init__(self, classifier: ResNet152Classifier, regressor: MultiHeadResNet152,
                 batch_size: int = 64, device="cuda"):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.classifier = classifier.to(self.device).eval()
        self.regressor = regressor.to(self.device).eval()
        self.batch_size = batch_size

    @torch.no_grad()
    def predict_coord_batch(self, frames: np.ndarray) -> np.ndarray:
        from ..utils.device import full_f32

        x = torch.as_tensor(normalize_frames(frames), device=self.device)
        with full_f32():
            cells = self.classifier(x).argmax(dim=1)
            return self.regressor(x, cells).cpu().numpy()

    def predict_coords(self, frames: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(frames), self.batch_size):
            out.append(self.predict_coord_batch(frames[i:i + self.batch_size]))
        return np.concatenate(out, axis=0)


def load_state_dict_like_jax(module: nn.Module, state_dict) -> nn.Module:
    """Load a torchvision-layout state_dict as the JAX package's converter
    reads it: every weight the module has must be there; keys it does not
    read (``num_batches_tracked``, say) are ignored."""
    missing = module.load_state_dict({k: v.float() for k, v in state_dict.items()},
                                     strict=False).missing_keys
    if missing:
        raise KeyError(f"the state_dict lacks {missing[:5]} ({len(missing)} keys)")
    return module


def load_classifier_regressor_like_paper(classifier_path: str, regressor_path: str,
                                         batch_size: int = 64, device="cuda") -> CoordPredictor:
    """Load the paper's released torch checkpoints (or ``carla_regressor_train``'s
    ``.pt`` files): torchvision-layout state_dicts of the classifier and the
    multi-head regressor."""
    cls_sd = torch.load(classifier_path, map_location="cpu", weights_only=False)
    reg_sd = torch.load(regressor_path, map_location="cpu", weights_only=False)
    return CoordPredictor(load_state_dict_like_jax(ResNet152Classifier(), cls_sd),
                          load_state_dict_like_jax(MultiHeadResNet152(), reg_sd),
                          batch_size=batch_size, device=device)
