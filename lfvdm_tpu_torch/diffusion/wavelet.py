"""Orthonormal Haar wavelet-packet transform on tensors (counterpart of
lfvdm_tpu/diffusion/wavelet.py): the ``wavelet`` diffusion space.

One level applies the symmetric orthogonal 4x4 matrix with entries ±1/2
across each 2x2 polyphase block, so the transform is an isometry (N(0, I)
noise in pixel space is N(0, I) in wavelet space) and is its own inverse.
Every subband is transformed again at each level (packet form), so an
(…, C, H, W) frame packs into (…, C·4^L, H/2^L, W/2^L) subband channels.

Channel layout per level: [LL | LH | HL | HH], each a full copy of the
previous level's channel stack.
"""

from __future__ import annotations

import torch


def haar_dwt2(x: torch.Tensor) -> torch.Tensor:
    """One orthonormal 2-D Haar level: (..., C, H, W) -> (..., 4C, H/2, W/2)."""
    H, W = x.shape[-2:]
    if H % 2 or W % 2:
        raise ValueError(f"Haar DWT needs even H, W; got {(H, W)}")
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5
    hl = (a + b - c - d) * 0.5
    hh = (a - b - c + d) * 0.5
    return torch.cat([ll, lh, hl, hh], dim=-3)


def haar_idwt2(y: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`haar_dwt2`: (..., 4C, H, W) -> (..., C, 2H, 2W)."""
    *lead, C4, H, W = y.shape
    if C4 % 4:
        raise ValueError(f"idwt2 needs 4k channels; got {C4}")
    ll, lh, hl, hh = y.chunk(4, dim=-3)
    # The level matrix is symmetric orthogonal, so the inverse reuses it.
    x = y.new_empty((*lead, C4 // 4, 2 * H, 2 * W))
    x[..., 0::2, 0::2] = (ll + lh + hl + hh) * 0.5
    x[..., 0::2, 1::2] = (ll - lh + hl - hh) * 0.5
    x[..., 1::2, 0::2] = (ll + lh - hl - hh) * 0.5
    x[..., 1::2, 1::2] = (ll - lh - hl + hh) * 0.5
    return x


def wavelet_pack(x: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """L packet levels: (..., C, H, W) -> (..., C·4^L, H/2^L, W/2^L)."""
    if levels < 1:
        raise ValueError(f"wavelet_pack needs levels >= 1, got {levels}")
    for _ in range(levels):
        x = haar_dwt2(x)
    return x


def wavelet_unpack(y: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """Exact inverse of :func:`wavelet_pack`."""
    if levels < 1:
        raise ValueError(f"wavelet_unpack needs levels >= 1, got {levels}")
    for _ in range(levels):
        y = haar_idwt2(y)
    return y
