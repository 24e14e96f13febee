"""Fréchet Video Distance (FVD) and KID (counterpart of lfvdm_tpu/evals/fvd.py).

I3D (Kinetics-400) features of bilinear-resized 224x224 frames scaled to
[-1, 1], then the Fréchet distance with the eps-diagonal sqrtm fallback, and
the polynomial-kernel KID. The metric math is numpy and scipy, copied from
the JAX package; the features are computed on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def frechet_distance(feats1: np.ndarray, feats2: np.ndarray, eps: float = 1e-10) -> float:
    """Fréchet distance between Gaussian fits of two feature sets:
    |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), retried with an
    eps-diagonal when sqrtm is singular. (``sqrtm``'s ``disp`` argument, which
    the JAX package passes, is gone from newer SciPy; the result is the
    same.)"""
    from scipy import linalg

    feats1 = np.asarray(feats1, np.float64)
    feats2 = np.asarray(feats2, np.float64)
    mu1, mu2 = feats1.mean(axis=0), feats2.mean(axis=0)
    sigma1 = np.cov(feats1, rowvar=False)
    sigma2 = np.cov(feats2, rowvar=False)

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"sqrtm returned complex values: imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def polynomial_kernel(X: np.ndarray, Y: np.ndarray, degree: int = 3,
                      gamma: float | None = None, coef0: float = 1.0) -> np.ndarray:
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return (gamma * X @ Y.T + coef0) ** degree


def kid(feats1: np.ndarray, feats2: np.ndarray, n_subsets: int = 100,
        max_subset_size: int = 1000, seed: int = 0) -> float:
    """Kernel Inception Distance (unbiased MMD², polynomial kernel)."""
    rng = np.random.default_rng(seed)
    n = min(len(feats1), len(feats2), max_subset_size)
    total = 0.0
    for _ in range(n_subsets):
        x = feats1[rng.choice(len(feats1), n, replace=False)]
        y = feats2[rng.choice(len(feats2), n, replace=False)]
        k_xx = polynomial_kernel(x, x)
        k_yy = polynomial_kernel(y, y)
        k_xy = polynomial_kernel(x, y)
        m = n
        mmd = (
            (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
            + (k_yy.sum() - np.trace(k_yy)) / (m * (m - 1))
            - 2 * k_xy.mean()
        )
        total += mmd
    return float(total / n_subsets)


def preprocess(videos: torch.Tensor, target_resolution: int = 224) -> torch.Tensor:
    """uint8 (B, T, H, W, C) on any device -> f32 (B, C, T, 224, 224) in
    [-1, 1] on the same device: bilinear resize (half-pixel centres) and
    scale.

    ``jax.image.resize`` antialiases when it shrinks and not when it grows,
    so the resize antialiases exactly when a frame is larger than the target
    (a 256 px frame without it differs by up to 55 of 255)."""
    B, T, H, W, C = videos.shape
    x = videos.reshape(B * T, H, W, C).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(target_resolution, target_resolution), mode="bilinear",
                      align_corners=False,
                      antialias=H > target_resolution or W > target_resolution)
    x = 2.0 * x / 255.0 - 1.0
    return x.reshape(B, T, C, target_resolution, target_resolution).permute(0, 2, 1, 3, 4)


def preprocess_videos(videos: np.ndarray, target_resolution: int = 224,
                      device="cuda") -> np.ndarray:
    """uint8 (B, T, H, W, C) -> float32 (B, T, 224, 224, C) in [-1, 1], the
    JAX package's ``preprocess_videos``, computed on ``device``."""
    from ..utils.device import resolve_device

    videos = np.asarray(videos)
    if videos.dtype != np.uint8:
        raise ValueError("FVD preprocessing expects uint8 videos")
    x = preprocess(torch.as_tensor(videos, device=resolve_device(device)), target_resolution)
    return x.permute(0, 2, 3, 4, 1).cpu().numpy()


class FVD:
    """End-to-end FVD: preprocess -> I3D features -> Fréchet distance, the
    features on ``device`` (the card by default)."""

    def __init__(self, i3d_weights: str | None = None, batch_size: int = 16, device="cuda"):
        from .i3d import I3DFeatureExtractor

        self.extractor = I3DFeatureExtractor(weights_path=i3d_weights, device=device)
        self.batch_size = batch_size

    def _fused_features(self, chunk: np.ndarray) -> np.ndarray:
        """One uint8 (B, T, H, W, C) chunk -> (B, 400): only the uint8 goes
        to the card and only the features come back; the resize, the scale
        and I3D run there."""
        x = torch.as_tensor(np.ascontiguousarray(chunk), device=self.extractor.device)
        return self.extractor.features(preprocess(x)).cpu().numpy()

    def extract_features(self, videos: np.ndarray) -> np.ndarray:
        """uint8 (B, T, H, W, C) -> (B, 400) logit features (the 400-d
        kinetics logits)."""
        feats = [self._fused_features(videos[i:i + self.batch_size])
                 for i in range(0, len(videos), self.batch_size)]
        return np.concatenate(feats, axis=0)

    def compute(self, videos_fake: np.ndarray, videos_real: np.ndarray) -> float:
        return frechet_distance(
            self.extract_features(videos_fake), self.extract_features(videos_real)
        )
