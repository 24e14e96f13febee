"""Training-time flexible-conditioning mask & frame sampler (host side): a
copy of lfvdm_tpu/training/masks.py.

These run on host numpy between data loading and the train step: they
choose which ≤ max_frames frames of a T-frame video the network sees, split
them into observed/latent groups, compact them to the front, and pad to the
static width ``max_frames`` with uniformly random frames (which the loss then
covers via latent_mask = 1 - obs_mask, train_util.py:305). Output shapes are
static — (B, K, ...) with K = max_frames — so every step has one shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def sample_all_masks(
    rng: np.random.Generator,
    B: int,
    T: int,
    max_frames: int,
    set_masks: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample per-row obs/latent masks over the full video length T.

    Each row starts with one latent group, then repeatedly flips a coin to
    extend the obs or latent mask with a fresh non-overlapping index group
    until the total would exceed max_frames. Returns float32 (B, T) masks.

    ``set_masks`` optionally overrides the first rows with fixed masks (used
    for deterministic visualisation batches, train_util.py:207-211).
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
    if set_masks:
        for key, arr in (("obs", obs), ("latent", latent)):
            values = np.asarray(set_masks.get(key, ()), dtype=np.float32)
            if values.size:
                values = values.reshape(values.shape[0], T)
                n_set = min(len(values), B)
                arr[:n_set] = values[:n_set]
    return obs, latent


def prepare_training_batch(
    rng: np.random.Generator,
    batch1: np.ndarray,
    obs: np.ndarray,
    latent: np.ndarray,
    max_frames: int,
    batch2: Optional[np.ndarray] = None,
    pad_with_random_frames: bool = True,
):
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
    if pad_with_random_frames:
        K = max_frames
    else:
        K = int(any_mask.sum(axis=1).max())
    source = batch1 if batch2 is None else batch2

    indices = np.zeros((B, K), dtype=np.int64)
    new_batch = np.zeros((B, K) + batch1.shape[2:], dtype=batch1.dtype)
    new_obs = np.zeros((B, K), dtype=np.float32)
    new_latent = np.zeros((B, K), dtype=np.float32)
    for b in range(B):
        sel = np.nonzero(any_mask[b])[0]
        n = len(sel)
        indices[b, :n] = sel
        if pad_with_random_frames and n < K:
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


def sample_training_batch(
    rng: np.random.Generator,
    batch1: np.ndarray,
    max_frames: int,
    batch2: Optional[np.ndarray] = None,
    pad_with_random_frames: bool = True,
    set_masks: Optional[dict] = None,
):
    """Full pipeline: masks -> gather -> static-shape training inputs."""
    B, T = batch1.shape[:2]
    obs, latent = sample_all_masks(rng, B, T, max_frames, set_masks=set_masks)
    return prepare_training_batch(
        rng, batch1, obs, latent, max_frames,
        batch2=batch2, pad_with_random_frames=pad_with_random_frames,
    )
