"""Gaussian diffusion core: DDPM and DDIM sampling (counterpart of
lfvdm_tpu/diffusion/gaussian.py).

Schedule tables are computed on the host in float64 (numpy) and become f32
tensors on the sampled tensor's device. Timestep respacing is folded in:
``timestep_map`` remaps spaced steps to original steps in ``_model_t``.
The model is any callable ``model_fn(x, t, **kwargs) -> out``. Random
numbers come from an explicit ``torch.Generator`` on the sampling device, or
are injected (``noise=``) so that tests can hand both packages the same
numbers.

Not ported yet: training losses and likelihood evaluation (the training
slice), encoder reuse and the attention-weight sampler.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .schedules import (
    get_named_beta_schedule,
    respaced_betas,
    space_timesteps,
    space_timesteps_lambda_uniform,
)


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()


ModelFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianDiffusion:
    """Diffusion process definition and its table cache.

    Build it with :meth:`create` (config level, handles respacing) or from a
    beta array.
    """

    betas: np.ndarray
    model_mean_type: ModelMeanType
    model_var_type: ModelVarType
    loss_type: LossType
    rescale_timesteps: bool = False
    # Respacing: map from spaced step -> original step. None = no respacing.
    timestep_map: Optional[np.ndarray] = None
    original_num_steps: Optional[int] = None

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        object.__setattr__(self, "betas", betas)
        if self.original_num_steps is None:
            object.__setattr__(self, "original_num_steps", len(betas))

        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        tables = dict(
            alphas_cumprod=acp,
            alphas_cumprod_prev=acp_prev,
            alphas_cumprod_next=acp_next,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
            log_one_minus_alphas_cumprod=np.log(1.0 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(np.append(post_var[1], post_var[1:])),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            # FIXED_LARGE variance: beta_t with the t=0 slot patched to the
            # posterior variance for a better decoder likelihood.
            fixed_large_variance=np.append(post_var[1], betas[1:]),
            log_betas=np.log(betas),
        )
        tables["recip_posterior_mean_coef1"] = 1.0 / tables["posterior_mean_coef1"]
        tables["posterior_mean_coef2_over_coef1"] = (
            tables["posterior_mean_coef2"] / tables["posterior_mean_coef1"])
        tables["fixed_large_log_variance"] = np.log(tables["fixed_large_variance"])
        object.__setattr__(self, "_tables", tables)
        object.__setattr__(self, "_device_tables", {})

    @classmethod
    def create(
        cls,
        *,
        steps: int = 1000,
        noise_schedule: str = "linear",
        timestep_respacing: str = "",
        learn_sigma: bool = False,
        sigma_small: bool = False,
        use_kl: bool = False,
        predict_xstart: bool = False,
        rescale_timesteps: bool = False,
        rescale_learned_sigmas: bool = False,
    ) -> "GaussianDiffusion":
        """Config-level constructor ("N", "a,b,c", "ddimN" or "dpmN" respacing)."""
        betas = get_named_beta_schedule(noise_schedule, steps)
        if use_kl:
            loss_type = LossType.RESCALED_KL
        elif rescale_learned_sigmas:
            loss_type = LossType.RESCALED_MSE
        else:
            loss_type = LossType.MSE
        timestep_map = None
        if timestep_respacing:
            if isinstance(timestep_respacing, str) and timestep_respacing.startswith("dpm"):
                use_ts = space_timesteps_lambda_uniform(
                    betas, int(timestep_respacing[len("dpm"):]))
            else:
                use_ts = space_timesteps(steps, timestep_respacing)
            betas, timestep_map = respaced_betas(betas, use_ts)
        return cls(
            betas=betas,
            model_mean_type=ModelMeanType.EPSILON if not predict_xstart else ModelMeanType.START_X,
            model_var_type=(
                (ModelVarType.FIXED_LARGE if not sigma_small else ModelVarType.FIXED_SMALL)
                if not learn_sigma
                else ModelVarType.LEARNED_RANGE
            ),
            loss_type=loss_type,
            rescale_timesteps=rescale_timesteps,
            timestep_map=timestep_map,
            original_num_steps=steps,
        )

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def table(self, name: str) -> np.ndarray:
        return self._tables[name]

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-timestep f32 scalars of table ``name`` at ``t`` (B,), shaped (B, 1, ...)."""
        key = (name, t.device)
        table = self._device_tables.get(key)
        if table is None:
            src = self.timestep_map if name == "timestep_map" else self._tables[name]
            dtype = torch.int64 if name == "timestep_map" else torch.float32
            table = self._device_tables[key] = torch.as_tensor(
                np.asarray(src), dtype=dtype, device=t.device)
        vals = table[t]
        return vals.reshape(vals.shape + (1,) * (ndim - 1))

    # ---- timestep handling ----

    def _model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced-domain t -> what the model sees (respacing map, then rescale)."""
        if self.timestep_map is not None:
            t = self._extract("timestep_map", t, 1)
        if self.rescale_timesteps:
            t = t.to(torch.float32) * (1000.0 / self.original_num_steps)
        return t

    def call_model(self, model_fn: ModelFn, x, t, model_kwargs=None) -> torch.Tensor:
        return model_fn(x, self._model_t(t), **(model_kwargs or {}))

    # ---- forward process q ----

    def q_sample(self, x_start, t, noise):
        """Sample q(x_t | x_0) with the given noise."""
        if noise.shape != x_start.shape:
            raise ValueError(f"noise shape {noise.shape} != x_start shape {x_start.shape}")
        return (self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (self._extract("posterior_mean_coef1", t, x_t.ndim) * x_start
                + self._extract("posterior_mean_coef2", t, x_t.ndim) * x_t)
        return (mean, self._extract("posterior_variance", t, x_t.ndim),
                self._extract("posterior_log_variance_clipped", t, x_t.ndim))

    # ---- reverse process p ----

    def p_mean_variance_from_output(self, model_output, x, t, clip_denoised=True,
                                    denoised_fn=None) -> Dict[str, torch.Tensor]:
        """Invert a raw model output into (mean, variance, log_variance, pred_xstart)."""
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            C = x.shape[-3]
            if model_output.shape[-3] != 2 * C:
                raise ValueError(f"learned-variance model must output 2*C={2 * C} channels, "
                                 f"got {model_output.shape[-3]}")
            model_output, model_var_values = model_output.split(C, dim=-3)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = self._extract("posterior_log_variance_clipped", t, x.ndim)
                max_log = self._extract("log_betas", t, x.ndim)
                frac = (model_var_values + 1) / 2  # the model emits [-1, 1]
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            var_name, logvar_name = {
                ModelVarType.FIXED_LARGE: ("fixed_large_variance", "fixed_large_log_variance"),
                ModelVarType.FIXED_SMALL: ("posterior_variance", "posterior_log_variance_clipped"),
            }[self.model_var_type]
            model_variance = self._extract(var_name, t, x.ndim).expand(x.shape)
            model_log_variance = self._extract(logvar_name, t, x.ndim).expand(x.shape)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            return xs.clamp(-1.0, 1.0) if clip_denoised else xs

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance.expand(x.shape), "pred_xstart": pred_xstart}

    def p_mean_variance(self, model_fn, x, t, clip_denoised=True, denoised_fn=None,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        model_output = self.call_model(model_fn, x, t, model_kwargs)
        return self.p_mean_variance_from_output(model_output, x, t, clip_denoised=clip_denoised,
                                                denoised_fn=denoised_fn)

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        return (self._extract("recip_posterior_mean_coef1", t, x_t.ndim) * xprev
                - self._extract("posterior_mean_coef2_over_coef1", t, x_t.ndim) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t - pred_xstart)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim))

    # ---- sampling ----

    def p_sample(self, model_fn, x, t, *, noise=None, generator=None, clip_denoised=True,
                 denoised_fn=None, model_kwargs=None) -> Dict[str, torch.Tensor]:
        """One ancestral step x_t -> x_{t-1}; no noise is added at t == 0.
        ``noise`` (x's shape) is drawn from ``generator`` when not given."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        if noise is None:
            noise = _randn(x.shape, x, generator)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(self, model_fn, shape: Tuple[int, ...], *, device, noise=None,
                      generator=None, clip_denoised=True, denoised_fn=None, model_kwargs=None,
                      dtype=torch.float32) -> torch.Tensor:
        """The full ancestral sampler, one model call per step."""
        img = noise if noise is not None else _randn(shape, None, generator, device, dtype)
        B = shape[0]
        for s in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((B,), s, dtype=torch.int64, device=img.device)
            img = self.p_sample(model_fn, img, t, generator=generator,
                                clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                model_kwargs=model_kwargs)["sample"]
        return img

    def ddim_sample(self, model_fn, x, t, *, eta=0.0, noise=None, generator=None,
                    clip_denoised=True, denoised_fn=None,
                    model_kwargs=None) -> Dict[str, torch.Tensor]:
        """One DDIM step (Song et al. Eq. 12). Draws noise only when ``eta`` != 0."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._extract("alphas_cumprod", t, x.ndim)
        alpha_bar_prev = self._extract("alphas_cumprod_prev", t, x.ndim)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                  + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        if eta != 0.0:
            if noise is None:
                noise = _randn(x.shape, x, generator)
            nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            sample = sample + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model_fn, shape: Tuple[int, ...], *, device, noise=None,
                         generator=None, clip_denoised=True, denoised_fn=None,
                         model_kwargs=None, eta=0.0, dtype=torch.float32) -> torch.Tensor:
        """The full DDIM sampler, one model call per step."""
        img = noise if noise is not None else _randn(shape, None, generator, device, dtype)
        B = shape[0]
        for s in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((B,), s, dtype=torch.int64, device=img.device)
            img = self.ddim_sample(model_fn, img, t, eta=eta, generator=generator,
                                   clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                   model_kwargs=model_kwargs)["sample"]
        return img


def _randn(shape, like=None, generator=None, device=None, dtype=None):
    """Standard normal noise of ``shape`` from ``generator``, on ``like``'s
    device and dtype (or ``device``/``dtype``). The global RNG is never used."""
    if generator is None:
        raise ValueError("pass noise= or a torch.Generator on the sampling device")
    if like is not None:
        device, dtype = like.device, like.dtype
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
