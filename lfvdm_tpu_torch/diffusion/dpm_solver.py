"""DPM-Solver++(2M) sampling (counterpart of lfvdm_tpu/diffusion/dpm_solver.py).

A second-order multistep solver of the probability-flow ODE in the
data-prediction form (Lu et al., arXiv:2211.01095): 10-25 model calls per
window. With alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t),
lambda_t = log(alpha_t / sigma_t), going down the lattice s -> t:

    h   = lambda_t - lambda_s                      (> 0)
    x_t = (sigma_t/sigma_s) x_s - alpha_t (e^{-h} - 1) D
    D   = (1 + 1/(2r)) x0(x_s, s) - 1/(2r) x0(x_prev, prev),  r = h_prev / h

The first step uses D = x0; the last targets abar = 1 and returns x0. The
per-step coefficients are computed on the host in float64, then used as f32:
an (N, 4) table on the sampling device whose rows the step reads as 0-d f32
tensors, which multiply as the f32 constants of the JAX scan do. The first
step's d1 is 0, so one step form (``dpm_solver_pp_step``) serves every step,
and a CUDA graph of it replays for all of them (``sampling/graphs.py``).
Choose the step count with ``timestep_respacing`` ("dpmN" spaces the steps
uniformly in lambda).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DPMSolverCoefficients:
    """Per-step constants, arrays of length N (= number of model calls).

    Step i calls the model at lattice index ``ts[i]`` and updates the state as
    ``x <- c_x[i]*x + c_d[i]*D`` with ``D = d0[i]*x0_i + d1[i]*x0_{i-1}``.
    """

    ts: np.ndarray   # int32, descending lattice indices (N-1 .. 0)
    c_x: np.ndarray  # f32 multiplier of the current state
    c_d: np.ndarray  # f32 multiplier of D
    d0: np.ndarray   # f32 weight of the current x0 prediction in D
    d1: np.ndarray   # f32 weight of the previous x0 prediction in D


def dpm_solver_pp_coefficients(diffusion) -> DPMSolverCoefficients:
    """DPM-Solver++(2M) per-step constants for ``diffusion`` (float64 math)."""
    acp = np.asarray(diffusion.table("alphas_cumprod"), np.float64)
    N = len(acp)
    ts = np.arange(N - 1, -1, -1)

    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha) - np.log(sigma)

    c_x = np.zeros(N)
    c_d = np.zeros(N)
    d0 = np.zeros(N)
    d1 = np.zeros(N)

    h_prev = None
    for i in range(N):
        s = ts[i]
        if i == N - 1:
            # Final step: clean boundary abar=1 (sigma=0, h=inf). Limits:
            # sigma_t/sigma_s -> 0, alpha_t*(-expm1(-h)) -> 1, 1/(2r) -> 0.
            c_x[i], c_d[i], d0[i], d1[i] = 0.0, 1.0, 1.0, 0.0
            continue
        t = ts[i + 1]
        h = lam[t] - lam[s]
        if not h > 0:
            raise ValueError(f"lambda must increase toward t=0 (step {s}->{t})")
        c_x[i] = sigma[t] / sigma[s]
        c_d[i] = alpha[t] * -np.expm1(-h)  # == -alpha_t (e^{-h} - 1)
        if h_prev is None:
            d0[i], d1[i] = 1.0, 0.0  # first step: no history, first order
        else:
            r = h_prev / h
            d0[i] = 1.0 + 1.0 / (2.0 * r)
            d1[i] = -1.0 / (2.0 * r)
        h_prev = h

    return DPMSolverCoefficients(
        ts=ts.astype(np.int32),
        c_x=c_x.astype(np.float32),
        c_d=c_d.astype(np.float32),
        d0=d0.astype(np.float32),
        d1=d1.astype(np.float32),
    )


def dpm_solver_pp_rows(diffusion, device) -> torch.Tensor:
    """The coefficients on ``device``: an (N, 4) f32 table of rows (c_x,
    c_d, d0, d1), one per step (step i at timestep ``ts[i]`` = N - 1 - i,
    ``GaussianDiffusion.step_timesteps``)."""
    co = dpm_solver_pp_coefficients(diffusion)
    return torch.as_tensor(np.stack([co.c_x, co.c_d, co.d0, co.d1], axis=1), device=device)


def dpm_solver_pp_step(diffusion, model_fn, x, x0_prev, t, row, *, clip_denoised=True,
                       denoised_fn=None, model_kwargs=None):
    """One step at timesteps ``t`` (B,) with ``row``, that step's (4,) f32
    coefficients on x's device. Returns (the next state, this step's x0)."""
    x0 = diffusion.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn,
                                   model_kwargs=model_kwargs)["pred_xstart"]
    c_x, c_d, d0, d1 = row.unbind()
    d = d0 * x0 + d1 * x0_prev
    return c_x * x + c_d * d, x0


def dpm_solver_pp_sample_loop(diffusion, model_fn, shape, *, device, noise=None,
                              generator=None, clip_denoised=True, denoised_fn=None,
                              model_kwargs=None, dtype=torch.float32) -> torch.Tensor:
    """The full DPM-Solver++(2M) trajectory, one model call per lattice step.

    Deterministic given the terminal noise; ``generator`` only draws it when
    ``noise`` is not given.
    """
    if noise is None:
        if generator is None:
            raise ValueError("pass noise= or a torch.Generator on the sampling device")
        noise = torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    rows = dpm_solver_pp_rows(diffusion, noise.device)
    x = noise
    x0_prev = torch.zeros_like(noise)
    B = shape[0]
    for i, s in enumerate(range(len(rows) - 1, -1, -1)):
        t = torch.full((B,), s, dtype=torch.int64, device=x.device)
        x, x0_prev = dpm_solver_pp_step(diffusion, model_fn, x, x0_prev, t, rows[i],
                                        clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                        model_kwargs=model_kwargs)
    return x
