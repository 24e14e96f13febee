"""Gaussian diffusion in plain PyTorch and numpy: the schedule and its
respacing, the DDIM sampler (eta 0) and the masked epsilon loss, as the
Improved-DDPM code that Flexible Diffusion Models builds on defines them
(tables in float64, used as float32 tensors)."""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(schedule: str, steps: int) -> np.ndarray:
    if schedule == "linear":
        scale = 1000 / steps
        return np.linspace(scale * 1e-4, scale * 0.02, steps, dtype=np.float64)
    if schedule == "cosine":
        def bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - bar((i + 1) / steps) / bar(i / steps), 0.999)
                         for i in range(steps)], dtype=np.float64)
    raise ValueError(f"unknown schedule {schedule!r}")


def spaced(steps: int, respacing: str):
    """The timesteps kept by ``respacing`` ("" for all, "ddimN" for the
    fixed stride, or "N" / "a,b" sections), sorted."""
    if not respacing:
        return list(range(steps))
    if respacing.startswith("ddim"):
        n = int(respacing[4:])
        for i in range(1, steps):
            if len(range(0, steps, i)) == n:
                return list(range(0, steps, i))
        raise ValueError(f"no integer stride gives {n} steps")
    counts = [int(c) for c in respacing.split(",")]
    size, extra, start, kept = steps // len(counts), steps % len(counts), 0, []
    for i, c in enumerate(counts):
        n = size + (1 if i < extra else 0)
        stride, at = (1 if c <= 1 else (n - 1) / (c - 1)), 0.0
        for _ in range(c):
            kept.append(start + round(at))
            at += stride
        start += n
    return sorted(set(kept))


class Diffusion:
    """The process of a configuration: ``noise_schedule``,
    ``diffusion_steps``, ``rescale_timesteps`` and a respacing."""

    def __init__(self, cfg, respacing: str = "", device="cpu"):
        steps = cfg["diffusion_steps"]
        acp_full = np.cumprod(1.0 - betas(cfg["noise_schedule"], steps))
        kept = spaced(steps, respacing)
        acp = acp_full[kept]
        self.n = len(kept)
        self.scale = 1000.0 / steps if cfg.get("rescale_timesteps", True) else 1.0
        f32 = dict(dtype=torch.float32, device=device)
        self.model_t = torch.as_tensor(np.asarray(kept, np.float64) * self.scale, **f32)
        self.acp = torch.as_tensor(acp, **f32)
        self.acp_prev = torch.as_tensor(np.append(1.0, acp[:-1]), **f32)
        self.sqrt_acp = torch.as_tensor(np.sqrt(acp), **f32)
        self.sqrt_1m_acp = torch.as_tensor(np.sqrt(1.0 - acp), **f32)
        self.sqrt_recip = torch.as_tensor(np.sqrt(1.0 / acp), **f32)
        self.sqrt_recipm1 = torch.as_tensor(np.sqrt(1.0 / acp - 1), **f32)

    def ddim(self, model, noise, window):
        """The DDIM window (eta 0, x0 clipped to [-1, 1]) from ``noise``:
        one model call per step, from the last timestep down to 0."""
        x = noise
        B = x.shape[0]
        for s in range(self.n - 1, -1, -1):
            eps = model(x, self.model_t[s].expand(B), **window)
            x0 = (self.sqrt_recip[s] * x - self.sqrt_recipm1[s] * eps).clamp(-1, 1)
            eps = (self.sqrt_recip[s] * x - x0) / self.sqrt_recipm1[s]
            x = x0 * torch.sqrt(self.acp_prev[s]) + torch.sqrt(1 - self.acp_prev[s]) * eps
        return x

    def loss(self, model, x0, t, noise, weights, window):
        """Per-row masked MSE of the predicted noise (the loss covers every
        frame that is not observed), and its weighted mean."""
        shape = (-1,) + (1,) * (x0.ndim - 1)
        x_t = self.sqrt_acp[t].reshape(shape) * x0 + self.sqrt_1m_acp[t].reshape(shape) * noise
        out = model(x_t, self.model_t[t], **window)
        err = (noise - out) ** 2 * (1.0 - window["obs_mask"])
        rows = err.mean(dim=tuple(range(1, err.ndim)))
        return rows, (rows * weights).mean()
