"""Long-video sampler driver (counterpart of lfvdm_tpu/sampling/driver.py).

Iterate a sampling scheme, gather each window's conditioning frames, run the
reverse diffusion over the K-frame window (ancestral, DDIM or DPM-Solver++),
and scatter the generated frames back into the video buffer. Windows run at
their exact size: the attention pre-norm statistics include every frame of a
window, so padding would perturb real frames.

Sampling happens in diffusion space; with a ``codec`` (``diffusion/codecs.py``)
the assembled video is decoded once at the end (to pixels through the VAE in
latent space, out of the subbands in wavelet space).

Not ported yet: a device mesh (ROADMAP A5).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..diffusion.dpm_solver import dpm_solver_pp_sample_loop
from ..diffusion.gaussian import GaussianDiffusion
from .schemes import sampling_schemes


class VideoSampler:
    """Samples windows and long videos with ``model`` (an ``nn.Module`` on
    the sampling device) under ``diffusion``; ``codec`` decodes a sampled
    video out of diffusion space."""

    def __init__(self, model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                 clip_denoised: bool = True, use_ddim: bool = False, use_dpm: bool = False,
                 eta: float = 0.0, encoder_reuse: int = 1, codec=None):
        if use_ddim and use_dpm:
            raise ValueError("pick one of use_ddim / use_dpm")
        # Encoder reuse (arXiv:2312.09608): the U-Net's down and middle path
        # run every encoder_reuse-th step, the up path alone in between.
        # Approximate; the ancestral sampler only.
        if encoder_reuse < 1:
            raise ValueError(f"encoder_reuse must be >= 1, got {encoder_reuse}")
        if encoder_reuse > 1 and (use_ddim or use_dpm):
            raise ValueError("encoder_reuse supports the ancestral sampler only")
        self.model = model
        self.diffusion = diffusion
        self.codec = codec
        self.device = next(model.parameters()).device
        self.clip_denoised = clip_denoised
        self.use_ddim = use_ddim
        self.use_dpm = use_dpm
        self.eta = eta
        self.encoder_reuse = int(encoder_reuse)
        self.model_calls = 0  # U-Net forwards run by this sampler
        self.reuse_calls = 0  # of which up-path-only calls on cached features

    def _model_fn(self, x, ts, **kw):
        self.model_calls += 1
        out, _ = self.model(x, ts, **kw)
        return out

    def _model_fn_attn(self, x, ts, **kw):
        self.model_calls += 1
        return self.model(x, ts, return_attn_weights=True, **kw)

    def _model_fn_features(self, kwargs):
        """``model_fn_features(x, t, features)`` with ``kwargs`` bound."""

        def fn(x, ts, feats):
            self.model_calls += 1
            self.reuse_calls += feats is not None
            out, _, feats = self.model(x, ts, features=feats, return_features=True, **kwargs)
            return out, feats

        return fn

    def _window_args(self, x0, frame_indices, obs_mask, latent_mask):
        """The model kwargs of one window on the sampler's device, and its shape."""
        dev = self.device
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        kwargs = dict(
            x0=x0,
            frame_indices=torch.as_tensor(frame_indices, dtype=torch.int64, device=dev),
            obs_mask=torch.as_tensor(obs_mask, dtype=torch.float32, device=dev),
            latent_mask=torch.as_tensor(latent_mask, dtype=torch.float32, device=dev),
        )
        return kwargs, tuple(x0.shape)

    @torch.no_grad()
    def sample_window(self, x0, frame_indices, obs_mask, latent_mask, *, generator=None,
                      noise=None, step_noise=None) -> torch.Tensor:
        """Run the reverse process for one K-frame window.

        Arrays may be numpy or tensors; they are moved to the sampler's
        device. ``generator`` (on that device) draws the noise, or pass the
        terminal ``noise`` and, for the ancestral sampler, each step's
        ``step_noise``. Returns a (B, K, C, H, W) f32 tensor.
        """
        kwargs, shape = self._window_args(x0, frame_indices, obs_mask, latent_mask)
        common = dict(device=self.device, noise=noise, generator=generator,
                      clip_denoised=self.clip_denoised, model_kwargs=kwargs)
        with _eval_mode(self.model):
            if self.use_ddim:
                return self.diffusion.ddim_sample_loop(self._model_fn, shape, eta=self.eta,
                                                       **common)
            if self.use_dpm:
                return dpm_solver_pp_sample_loop(self.diffusion, self._model_fn, shape, **common)
            return self.diffusion.p_sample_loop(
                self._model_fn, shape, step_noise=step_noise, encoder_reuse=self.encoder_reuse,
                model_fn_features=self._model_fn_features(kwargs), **common)

    @torch.no_grad()
    def sample_window_attn(self, x0, frame_indices, obs_mask, latent_mask, *, generator=None,
                           noise=None, step_noise=None):
        """``sample_window`` with the reference's per-quartile attention
        heatmaps: returns (sample, {"attn/q{q}-temporal": (B, K, K),
        "attn/q{q}-spatial": (B, S, S)}) (``GaussianDiffusion.p_sample_loop``
        with ``return_attn_weights``). The exact ancestral sampler only. The
        attention weights come from the attention blocks' einsum form, so
        this path launches no attention kernel; the up path's skip
        projections still launch theirs."""
        if self.use_ddim or self.use_dpm or self.encoder_reuse != 1:
            raise ValueError("sample_window_attn runs the exact ancestral sampler; it cannot "
                             "honor use_ddim, use_dpm or encoder_reuse > 1")
        kwargs, shape = self._window_args(x0, frame_indices, obs_mask, latent_mask)
        with _eval_mode(self.model):
            return self.diffusion.p_sample_loop(
                self._model_fn_attn, shape, device=self.device, noise=noise,
                generator=generator, step_noise=step_noise, clip_denoised=self.clip_denoised,
                model_kwargs=kwargs, return_attn_weights=True)

    def sample_video(self, batch: np.ndarray, *, scheme_name: str, n_obs: int, max_frames: int,
                     step_size: int, generator: torch.Generator,
                     optimal_schedule: Optional[dict] = None, embedder=None,
                     just_get_indices: bool = False, verbose: bool = False):
        """Generate a full video given its first ``n_obs`` frames.

        ``batch``: (B, T, C, H, W) ground-truth videos in diffusion space
        (only the first n_obs frames are read unless ``just_get_indices``).
        Returns (samples numpy, indices_used list). With a codec the
        assembled video is uploaded to the sampler's device once and
        decoded there (unless ``just_get_indices``), so the samples are in
        pixel space, (B, T, 3, H', W') for the latent codecs.
        """
        B, T, C, H, W = batch.shape
        samples = np.zeros_like(batch)
        samples[:, :n_obs] = batch[:, :n_obs]

        kwargs = dict(video_length=T, num_obs=n_obs, max_frames=max_frames,
                      step_size=step_size, optimal_schedule=optimal_schedule)
        if scheme_name.startswith("adaptive"):
            kwargs.update(embedder=embedder, device=self.device)
        scheme = iter(sampling_schemes[scheme_name](**kwargs))

        indices_used = []
        while True:
            scheme.set_videos(samples)
            try:
                obs_idx, latent_idx = next(scheme)
            except StopIteration:
                break
            if not isinstance(obs_idx[0], (list, np.ndarray)):
                obs_idx = [list(obs_idx)] * B
                latent_idx = [list(latent_idx)] * B
            if verbose:
                print(f"conditioning on {sorted(obs_idx[0])}, "
                      f"generating {sorted(latent_idx[0])}")

            frame_indices = np.concatenate(
                [np.asarray(obs_idx, np.int64).reshape(B, -1),
                 np.asarray(latent_idx, np.int64).reshape(B, -1)], axis=1)  # (B, K)
            K = frame_indices.shape[1]
            x0 = np.stack([samples[b, frame_indices[b]] for b in range(B)])
            obs_mask = np.zeros((B, K, 1, 1, 1), np.float32)
            obs_mask[:, : len(obs_idx[0])] = 1.0
            latent_mask = 1.0 - obs_mask

            if just_get_indices:
                local = np.stack([batch[b, frame_indices[b]] for b in range(B)])
            else:
                local = self.sample_window(x0, frame_indices, obs_mask, latent_mask,
                                           generator=generator).cpu().numpy()
            n_latent = len(latent_idx[0])
            for b in range(B):
                samples[b, latent_idx[b]] = local[b, -n_latent:]
            indices_used.append((obs_idx, latent_idx))
        if self.codec is not None and not just_get_indices:
            decoded = self.codec.decode(torch.as_tensor(samples, device=self.device))
            samples = decoded.cpu().numpy()
        return samples, indices_used


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """Run ``model`` in eval mode inside (as JAX samples with train=False),
    and put its mode back after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)
