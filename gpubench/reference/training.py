"""Training's host-side draws and its update, in plain numpy and PyTorch:
the flexible-conditioning frame and mask sampler of Flexible Diffusion
Models (a frozen copy of the port's ``training/masks.py``, the reference
code's train_util.py), the uniform timestep draw, CARLA's frames as the
dataset defines them, and AdamW (optax's ``adamw``: bias-corrected
moments, weight decay added to the normalised update) with the EMA of the
new parameters."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sample_some_indices(rng: np.random.Generator, max_indices: int, T: int) -> list:
    """Sample a small group of frame indices with log-uniform spacing.

    Count s ~ U{1..max_indices}; spacing scale ~ LogUniform(1, T/(s-0.999));
    uniform offset; resample on the rare out-of-range draw.
    """
    while True:
        s = int(rng.integers(1, max_indices + 1))
        max_scale = T / (s - 0.999)
        scale = np.exp(rng.random() * np.log(max_scale))
        pos = rng.random() * (T - scale * (s - 1))
        indices = [int(pos + i * scale) for i in range(s)]
        if all(0 <= i < T for i in indices):
            return indices


def sample_all_masks(rng: np.random.Generator, B: int, T: int,
                     max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sample per-row obs/latent masks over the full video length T.

    Each row starts with one latent group, then repeatedly flips a coin to
    extend the obs or latent mask with a fresh non-overlapping index group
    until the total would exceed max_frames. Returns float32 (B, T) masks.
    """
    N = max_frames
    obs = np.zeros((B, T), dtype=np.float32)
    latent = np.zeros((B, T), dtype=np.float32)
    for b in range(B):
        latent[b, sample_some_indices(rng, N, T)] = 1.0
        while True:
            mask = obs[b] if rng.random() < 0.5 else latent[b]
            indices = np.asarray(sample_some_indices(rng, N, T))
            taken = (obs[b, indices] + latent[b, indices]) > 0
            indices = indices[~taken]
            if len(indices) > N - obs[b].sum() - latent[b].sum():
                break
            mask[indices] = 1.0
    return obs, latent


def prepare_training_batch(rng: np.random.Generator, batch1: np.ndarray, obs: np.ndarray,
                           latent: np.ndarray, max_frames: int,
                           batch2: Optional[np.ndarray] = None):
    """Compact selected frames to the front and pad to ``max_frames``.

    Padding frames are drawn uniformly from ``batch2`` (or batch1), and their
    obs/latent mask values are *gathered from the original masks at the
    padded positions* — faithful to the reference (train_util.py:238-240),
    including the case where a random pad index collides with a selected one.

    Returns (batch (B,K,...), frame_indices (B,K) int32,
             obs_mask (B,K,1,1,1), latent_mask (B,K,1,1,1)).
    """
    B, T = obs.shape
    any_mask = np.clip(obs + latent, 0, 1)
    K = max_frames
    source = batch1 if batch2 is None else batch2

    indices = np.zeros((B, K), dtype=np.int64)
    new_batch = np.zeros((B, K) + batch1.shape[2:], dtype=batch1.dtype)
    new_obs = np.zeros((B, K), dtype=np.float32)
    new_latent = np.zeros((B, K), dtype=np.float32)
    for b in range(B):
        sel = np.nonzero(any_mask[b])[0]
        n = len(sel)
        indices[b, :n] = sel
        if n < K:
            indices[b, n:] = rng.integers(0, T, size=K - n)
        new_batch[b, :n] = batch1[b, sel]
        new_batch[b, n:] = source[b, indices[b, n:]]
        new_obs[b, :n] = obs[b, sel]
        new_obs[b, n:] = obs[b, indices[b, n:]]
        new_latent[b, :n] = latent[b, sel]
        new_latent[b, n:] = latent[b, indices[b, n:]]
    return (
        new_batch,
        indices.astype(np.int32),
        new_obs.reshape(B, K, 1, 1, 1),
        new_latent.reshape(B, K, 1, 1, 1),
    )


def sample_training_batch(rng: np.random.Generator, batch1: np.ndarray, max_frames: int,
                          batch2: Optional[np.ndarray] = None):
    """Full pipeline: masks -> gather -> static-shape training inputs."""
    B, T = batch1.shape[:2]
    obs, latent = sample_all_masks(rng, B, T, max_frames)
    return prepare_training_batch(rng, batch1, obs, latent, max_frames, batch2=batch2)


def uniform_timesteps(rng: np.random.Generator, batch: int, steps: int):
    """(timesteps, importance weights) of the uniform schedule sampler."""
    p = np.ones(steps) / steps
    idx = rng.choice(steps, size=(batch,), p=p)
    return idx.astype(np.int32), (1.0 / (steps * p[idx])).astype(np.float32)


def carla_frames(video: np.ndarray) -> np.ndarray:
    """A CARLA video as training reads it: uint8 (T, H, W, C) to float32
    (T, C, H, W) in [-1, 1]."""
    return -1 + 2 * (video.transpose(0, 3, 1, 2).astype(np.float32) / 255)


@torch.no_grad()
def adamw_ema(params, grads, m, v, ema, step, lr, wd=0.0, b1=0.9, b2=0.999, eps=1e-8,
              rate=0.9999):
    """One AdamW step (``step`` counts from 1) in place on the lists, then
    each EMA copy e·rate + p·(1 − rate) from the new parameters."""
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, mi, vi, e in zip(params, grads, m, v, ema):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).add_(g * g, alpha=1 - b2)
        u = (mi / c1) / ((vi / c2).sqrt() + eps)
        if wd:
            u = u + wd * p
        p.sub_(lr * u)
        e.mul_(rate).add_(p, alpha=1 - rate)
