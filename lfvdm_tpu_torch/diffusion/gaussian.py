"""Gaussian diffusion core: DDPM and DDIM sampling and the training losses
(counterpart of lfvdm_tpu/diffusion/gaussian.py).

Schedule tables are computed on the host in float64 (numpy) and become f32
tensors on the sampled tensor's device. Timestep respacing is folded in:
``timestep_map`` remaps spaced steps to original steps in ``_model_t``.
The model is any callable ``model_fn(x, t, **kwargs) -> out``. Random
numbers come from an explicit ``torch.Generator`` on the sampling device, or
are injected (``noise=``, and per step ``step_noise=``) so that tests can hand
both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .losses import discretized_gaussian_log_likelihood, normal_kl
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

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


def mean_flat(tensor, mask=None):
    """Mean over all non-batch dims, after an optional multiplicative mask.

    Like the reference, this does NOT renormalise by the mask size: the loss
    scale depends on the number of masked frames by design.
    """
    if mask is not None:
        tensor = tensor * mask
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


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

    def tables_on(self, device) -> None:
        """Put every table on ``device`` now (``_extract``'s cache, and
        ``step_timesteps``), so that a tracer such as ``torch.export`` reads
        them as real constants and a CUDA graph capture copies nothing from
        the host."""
        t = torch.zeros((1,), dtype=torch.int64, device=device)
        for name in [*self._tables, *(["timestep_map"] if self.timestep_map is not None else [])]:
            self._extract(name, t, 1)
        self.step_timesteps(device)

    def step_timesteps(self, device) -> torch.Tensor:
        """The (N,) int64 table of the samplers' timesteps on ``device``, in
        step order: step i runs at timestep N - 1 - i."""
        key = ("step_timesteps", torch.device(device))
        table = self._device_tables.get(key)
        if table is None:
            table = self._device_tables[key] = torch.arange(
                self.num_timesteps - 1, -1, -1, dtype=torch.int64, device=device)
        return table

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

    def q_mean_variance(self, x_start, t):
        mean = self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
        variance = 1.0 - self._extract("alphas_cumprod", t, x_start.ndim)
        log_variance = self._extract("log_one_minus_alphas_cumprod", t, x_start.ndim)
        return mean, variance, log_variance

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

    # The samplers' steps (p_sample, p_sample_features, ddim_sample, and
    # dpm_solver.dpm_solver_pp_step) take the timestep as a tensor and the
    # noise as an input, so one CUDA graph of a step serves every step of a
    # window (sampling/graphs.py): there t is read from ``step_timesteps``
    # at a step index held on the device (``step_timestep``). The eager
    # loops call the same steps.

    def p_sample(self, model_fn, x, t, *, noise=None, generator=None, clip_denoised=True,
                 denoised_fn=None, model_kwargs=None) -> Dict[str, torch.Tensor]:
        """One ancestral step x_t -> x_{t-1}; no noise is added at t == 0.
        ``noise`` (x's shape) is drawn from ``generator`` when not given."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        return {"sample": self._ancestral_update(out, x, t, noise, generator),
                "pred_xstart": out["pred_xstart"]}

    def p_sample_features(self, model_fn_features, x, t, features, *, noise=None,
                          generator=None, clip_denoised=True, denoised_fn=None):
        """One ancestral step under encoder reuse: ``model_fn_features(x,
        model_t, features_or_None) -> (out, features)`` runs the full U-Net
        (``features`` None) or its up path on ``features``. Returns (x_{t-1},
        the features)."""
        out, features = model_fn_features(x, self._model_t(t), features)
        pmv = self.p_mean_variance_from_output(out, x, t, clip_denoised=clip_denoised,
                                               denoised_fn=denoised_fn)
        return self._ancestral_update(pmv, x, t, noise, generator), features

    def p_sample_loop(self, model_fn, shape: Tuple[int, ...], *, device, noise=None,
                      generator=None, clip_denoised=True, denoised_fn=None, model_kwargs=None,
                      dtype=torch.float32, step_noise: Optional[Sequence[torch.Tensor]] = None,
                      return_attn_weights: bool = False, encoder_reuse: int = 1,
                      model_fn_features=None):
        """The full ancestral sampler, one model call per step.

        ``step_noise``: the noise of each step in step order (index 0 is the
        first, noisiest step), in place of draws from ``generator``.

        ``encoder_reuse=k`` (k > 1, arXiv:2312.09608): step ``i`` runs the
        full U-Net when ``i % k == 0`` and otherwise only its up path on the
        features the last full call cached, with this step's timestep.
        ``model_fn_features(x, t, features_or_None) -> (out, features)`` runs
        the model (``model_kwargs`` bound in by the caller). Approximate by
        design; never the default.

        ``return_attn_weights``: ``model_fn`` returns ``(out, attns)`` (the
        U-Net's ``return_attn_weights`` form, per layer (B, T, T) temporal and
        (B, S_l, S_l) spatial maps) and the call returns ``(img,
        {"attn/q{q}-temporal": (B, T, T), "attn/q{q}-spatial": (B, S, S)})``:
        per step the temporal maps summed over layers and the spatial ones
        repeat-upsampled to the first layer's S and summed, averaged over each
        quarter of the diffusion steps (q = 4·t // num_timesteps)."""
        if encoder_reuse > 1:
            if model_fn_features is None:
                raise ValueError("encoder_reuse needs model_fn_features(x, t, features) -> "
                                 "(out, features)")
            if return_attn_weights:
                raise ValueError("encoder_reuse and return_attn_weights cannot be combined")
        img = noise if noise is not None else _randn(shape, None, generator, device, dtype)
        B = shape[0]
        kwargs = model_kwargs or {}
        feats = None
        acc = None
        quarter = self.num_timesteps / 4.0
        step = dict(generator=generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn)
        for i, s in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), s, dtype=torch.int64, device=img.device)
            if encoder_reuse > 1:
                img, feats = self.p_sample_features(
                    model_fn_features, img, t, None if i % encoder_reuse == 0 else feats,
                    noise=_step(step_noise, i), **step)
            elif return_attn_weights:
                out, attns = self.call_model(model_fn, img, t, kwargs)
                if acc is None:
                    acc = _quartile_accumulators(attns, B, img.device)
                q = (4 * s) // self.num_timesteps
                acc[0][q] += sum(a.float() for a in attns["temporal"]) / quarter
                acc[1][q] += _combined_spatial(attns["spatial"], acc[1].shape[-1]) / quarter
                pmv = self.p_mean_variance_from_output(out, img, t, clip_denoised=clip_denoised,
                                                       denoised_fn=denoised_fn)
                img = self._ancestral_update(pmv, img, t, _step(step_noise, i), generator)
            else:
                img = self.p_sample(model_fn, img, t, noise=_step(step_noise, i),
                                    model_kwargs=kwargs, **step)["sample"]
        if not return_attn_weights:
            return img
        maps = {}
        for q in range(4):
            maps[f"attn/q{q}-temporal"] = acc[0][q]
            maps[f"attn/q{q}-spatial"] = acc[1][q]
        return img, maps

    def _ancestral_update(self, pmv, x, t, noise, generator):
        """Draw x_{t-1} from the posterior's mean and log variance; no noise
        at t == 0."""
        if noise is None:
            noise = _randn(x.shape, x, generator)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        return pmv["mean"] + nonzero * torch.exp(0.5 * pmv["log_variance"]) * noise

    def p_sample_loop_progressive(self, model_fn, shape: Tuple[int, ...], *, device, noise=None,
                                  generator=None, clip_denoised=True, denoised_fn=None,
                                  model_kwargs=None, dtype=torch.float32,
                                  step_noise: Optional[Sequence[torch.Tensor]] = None
                                  ) -> Iterator[Dict[str, torch.Tensor]]:
        """The ancestral sampler as a generator of each step's ``p_sample``
        output (``sample`` and ``pred_xstart``), noisiest step first."""
        img = noise if noise is not None else _randn(shape, None, generator, device, dtype)
        B = shape[0]
        for i, s in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), s, dtype=torch.int64, device=img.device)
            out = self.p_sample(model_fn, img, t, noise=_step(step_noise, i),
                                generator=generator, clip_denoised=clip_denoised,
                                denoised_fn=denoised_fn, model_kwargs=model_kwargs)
            yield out
            img = out["sample"]

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

    def ddim_reverse_sample(self, model_fn, x, t, *, clip_denoised=True, denoised_fn=None,
                            model_kwargs=None) -> Dict[str, torch.Tensor]:
        """One deterministic DDIM reverse-ODE step x_t -> x_{t+1}."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn, model_kwargs=model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = self._extract("alphas_cumprod_next", t, x.ndim)
        sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                  + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model_fn, shape: Tuple[int, ...], *, device, noise=None,
                         generator=None, clip_denoised=True, denoised_fn=None,
                         model_kwargs=None, eta=0.0, dtype=torch.float32,
                         step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The full DDIM sampler, one model call per step. ``step_noise``:
        as ``p_sample_loop``'s, read only when ``eta`` != 0."""
        img = noise if noise is not None else _randn(shape, None, generator, device, dtype)
        B = shape[0]
        for i, s in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), s, dtype=torch.int64, device=img.device)
            img = self.ddim_sample(model_fn, img, t, eta=eta, generator=generator,
                                   noise=_step(step_noise, i) if eta != 0.0 else None,
                                   clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                   model_kwargs=model_kwargs)["sample"]
        return img

    # ---- training losses ----

    def _vb_terms_bpd_from_output(self, model_output, x_start, x_t, t, clip_denoised=True,
                                  latent_mask=None) -> Dict[str, torch.Tensor]:
        """The variational-bound term (bits/dim) from a model output."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance_from_output(model_output, x_t, t, clip_denoised=clip_denoised)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl, mask=latent_mask) / np.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll, mask=latent_mask) / np.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True, model_kwargs=None,
                      latent_mask=None) -> Dict[str, torch.Tensor]:
        model_output = self.call_model(model_fn, x_t, t, model_kwargs)
        return self._vb_terms_bpd_from_output(model_output, x_start, x_t, t,
                                              clip_denoised=clip_denoised,
                                              latent_mask=latent_mask)

    def training_losses(self, model_fn, x_start, t, *, model_kwargs=None, noise=None,
                        generator=None, latent_mask=None,
                        eval_mask=None) -> Dict[str, torch.Tensor]:
        """Per-batch-element training losses, each (B,).

        ``noise`` (x_start's shape) is drawn from ``generator`` when not
        given. ``latent_mask`` masks the loss (multiply, then mean over the
        non-batch dims); ``eval_mask`` gives the "eval-mse" term.
        """
        if noise is None:
            noise = _randn(x_start.shape, x_start, generator)
        x_t = self.q_sample(x_start, t, noise=noise)
        terms: Dict[str, torch.Tensor] = {}

        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False,
                                               model_kwargs=model_kwargs,
                                               latent_mask=latent_mask)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
        elif self.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
            model_output = self.call_model(model_fn, x_t, t, model_kwargs)
            if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
                C = x_t.shape[-3]
                if model_output.shape[-3] != 2 * C:
                    raise ValueError(f"learned-variance model must output 2*C={2 * C} "
                                     f"channels, got {model_output.shape[-3]}")
                mean_out, var_out = model_output.split(C, dim=-3)
                # Learn the variance with the bound but freeze the mean, so
                # that the VB term does not perturb the MSE gradient.
                frozen = torch.cat([mean_out.detach(), var_out], dim=-3)
                terms["vb"] = self._vb_terms_bpd_from_output(
                    frozen, x_start, x_t, t, clip_denoised=False,
                    latent_mask=latent_mask)["output"]
                if self.loss_type == LossType.RESCALED_MSE:
                    terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
                model_output = mean_out
            target = {
                ModelMeanType.PREVIOUS_X: lambda: self.q_posterior_mean_variance(
                    x_start, x_t, t)[0],
                ModelMeanType.START_X: lambda: x_start,
                ModelMeanType.EPSILON: lambda: noise,
            }[self.model_mean_type]()
            if not model_output.shape == target.shape == x_start.shape:
                raise ValueError(f"model output {model_output.shape} != target {target.shape}")
            sq_err = (target - model_output) ** 2
            terms["mse"] = mean_flat(sq_err, mask=latent_mask)
            if eval_mask is not None:
                terms["eval-mse"] = mean_flat(sq_err, mask=eval_mask)
            terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        else:
            raise NotImplementedError(self.loss_type)
        return terms


    # ---- likelihood evaluation ----

    def _prior_bpd(self, x_start, latent_mask=None) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) in bits per dim, (B,)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.int64,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)
        return mean_flat(kl_prior, mask=latent_mask) / np.log(2.0)

    def calc_bpd_loop(self, model_fn, x_start, *, generator=None,
                      noise: Optional[Sequence[torch.Tensor]] = None, clip_denoised=True,
                      model_kwargs=None, latent_mask=None, t_seq=None) -> Dict[str, torch.Tensor]:
        """The variational bound of ``x_start`` over every timestep, or over
        ``t_seq``: a 1-D list of timesteps shared by the batch or a (B, S)
        array of per-element ones. Each term draws x_t with noise from
        ``generator``, or with ``noise[i]`` for the i-th term. Returns
        ``total_bpd`` and ``prior_bpd`` (B,) and ``vb``, ``xstart_mse`` and
        ``mse`` (B, S)."""
        B = x_start.shape[0]
        if t_seq is None:
            t_seq = np.arange(self.num_timesteps)[::-1]
        t_seq = np.asarray(t_seq)
        t_mat = np.tile(t_seq[None], (B, 1)) if t_seq.ndim == 1 else t_seq
        t_mat = torch.as_tensor(np.ascontiguousarray(t_mat.T), dtype=torch.int64,
                                device=x_start.device)  # (S, B)
        vb, xstart_mse, mse = [], [], []
        for i, t_batch in enumerate(t_mat):
            eps_true = _step(noise, i)
            if eps_true is None:
                eps_true = _randn(x_start.shape, x_start, generator)
            x_t = self.q_sample(x_start, t_batch, noise=eps_true)
            out = self._vb_terms_bpd(model_fn, x_start, x_t, t_batch,
                                     clip_denoised=clip_denoised, model_kwargs=model_kwargs,
                                     latent_mask=latent_mask)
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2, mask=latent_mask))
            eps = self._predict_eps_from_xstart(x_t, t_batch, out["pred_xstart"])
            mse.append(mean_flat((eps - eps_true) ** 2, mask=latent_mask))
        vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))  # (B, S)
        prior_bpd = self._prior_bpd(x_start, latent_mask=latent_mask)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": xstart_mse, "mse": mse}

def _randn(shape, like=None, generator=None, device=None, dtype=None):
    """Standard normal noise of ``shape`` from ``generator``, on ``like``'s
    device and dtype (or ``device``/``dtype``). The global RNG is never used."""
    if generator is None:
        raise ValueError("pass noise= or a torch.Generator on the sampling device")
    if like is not None:
        device, dtype = like.device, like.dtype
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def step_timestep(table: torch.Tensor, i: torch.Tensor, batch: int) -> torch.Tensor:
    """``table[i]`` repeated to (batch,), ``i`` a 0-d int64 tensor on the
    table's device: one gather, no read back to the host."""
    return table.index_select(0, i.reshape(1).expand(batch))


def _step(noise: Optional[Sequence[torch.Tensor]], i: int) -> Optional[torch.Tensor]:
    """The i-th step's injected noise, or None to draw it."""
    return None if noise is None else noise[i]


def _quartile_accumulators(attns, B: int, device):
    """Zeroed (4, B, T, T) and (4, B, S, S) f32 sums, S the first layer's."""
    T = attns["temporal"][0].shape[-1]
    S = attns["spatial"][0].shape[-1]
    return (torch.zeros(4, B, T, T, dtype=torch.float32, device=device),
            torch.zeros(4, B, S, S, dtype=torch.float32, device=device))


def _combined_spatial(layers, S: int) -> torch.Tensor:
    """The layers' (B, S_l, S_l) maps repeat-upsampled to (B, S, S) and
    summed. Repeating keeps each map's mean, so the reference's
    renormalisation after its interpolation is the identity here."""
    acc = 0
    for a in layers:
        a = a.float()
        r = S // a.shape[-1]
        if r * a.shape[-1] != S:
            raise ValueError(f"spatial map of size {a.shape[-1]} does not divide {S}")
        if r > 1:
            a = a.repeat_interleave(r, dim=-2).repeat_interleave(r, dim=-1)
        acc = acc + a
    return acc
