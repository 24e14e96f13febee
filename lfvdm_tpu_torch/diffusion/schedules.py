"""Beta schedules and timestep respacing (numpy; a copy of lfvdm_tpu's).

The port keeps its own copy so that it imports without JAX.

Behavioral parity targets (reference, for capability check only):
  the reference implementation's improved_diffusion/gaussian_diffusion.py:18-62
  the reference implementation's improved_diffusion/respace.py:7-60

All schedule tables are computed on host in float64 for accuracy and cast to
float32 only when they become device tensors.
"""

from __future__ import annotations

import math

import numpy as np


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Return the named beta schedule as a float64 numpy array.

    ``linear`` is the Ho et al. schedule rescaled so that any step count is
    equivalent in the limit; ``cosine`` is the improved-DDPM cosine schedule.
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into per-step betas."""
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    t1 = t / num_diffusion_timesteps
    t2 = (t + 1) / num_diffusion_timesteps
    betas = 1.0 - np.array([alpha_bar(b) for b in t2]) / np.array([alpha_bar(a) for a in t1])
    return np.minimum(betas, max_beta)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Pick a subset of timesteps from the original process.

    ``section_counts`` may be a list of per-section step counts, a
    comma-separated string, or ``"ddimN"`` for the fixed DDIM striding.
    Matches the reference's respacing semantics exactly so respaced
    checkpoints sample identically (respace.py:7-60).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def space_timesteps_lambda_uniform(betas: np.ndarray, n: int) -> set:
    """Pick ``n`` original timesteps uniformly in half-log-SNR space.

    lambda_t = 0.5 * log(abar_t / (1 - abar_t)) — the natural time of the
    probability-flow ODE. The reference's uniform-in-t respacing
    (space_timesteps) concentrates a huge terminal lambda-hop at tiny step
    budgets (for the 1000-step linear schedule, the last t-uniform hop at
    n=10 spans h ~= 3.6), which is exactly where high-order extrapolation
    overshoots; lambda-uniform spacing is the DPM-Solver paper's default
    lattice (arXiv:2211.01095 §4). Endpoints 0 and T-1 are always included.

    Not reference-behavior — reachable only through the ``"dpmN"`` respacing
    spec, so every reference spec still selects identically.
    """
    acp = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    lam = 0.5 * (np.log(acp) - np.log1p(-acp))
    assert n >= 2 and n <= len(betas)
    targets = np.linspace(lam[0], lam[-1], n)  # descending (lam decreases in t)
    idx = set(int(np.abs(lam - x).argmin()) for x in targets)
    idx |= {0, len(betas) - 1}
    # nearest-index collisions can drop below n; fill from the largest
    # lambda-gaps so the count is exact
    while len(idx) < n:
        chosen = np.array(sorted(idx))
        gaps = np.abs(np.diff(lam[chosen]))
        g = int(gaps.argmax())
        mid = (chosen[g] + chosen[g + 1]) // 2
        if mid in idx:  # adjacent indices everywhere — cannot refine further
            break
        idx.add(int(mid))
    return idx


def respaced_betas(betas: np.ndarray, use_timesteps) -> tuple[np.ndarray, np.ndarray]:
    """Compute the spaced-process betas and the timestep map.

    Returns ``(new_betas, timestep_map)`` where ``timestep_map[s]`` is the
    original-process timestep corresponding to spaced step ``s``.
    """
    use_timesteps = set(use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)
