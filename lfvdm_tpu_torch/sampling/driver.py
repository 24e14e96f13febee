"""Long-video sampler driver (counterpart of lfvdm_tpu/sampling/driver.py).

Iterate a sampling scheme, gather each window's conditioning frames, run the
reverse diffusion over the K-frame window (ancestral, DDIM or DPM-Solver++),
and scatter the generated frames back into the video buffer. Windows run at
their exact size: the attention pre-norm statistics include every frame of a
window, so padding would perturb real frames.

Not ported yet: the attention-weight sampler, encoder reuse, latent codecs
and a device mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..diffusion.dpm_solver import dpm_solver_pp_sample_loop
from ..diffusion.gaussian import GaussianDiffusion
from .schemes import sampling_schemes


class VideoSampler:
    """Samples windows and long videos with ``model`` (an ``nn.Module`` on
    the sampling device) under ``diffusion``."""

    def __init__(self, model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                 clip_denoised: bool = True, use_ddim: bool = False, use_dpm: bool = False,
                 eta: float = 0.0):
        if use_ddim and use_dpm:
            raise ValueError("pick one of use_ddim / use_dpm")
        self.model = model
        self.diffusion = diffusion
        self.device = next(model.parameters()).device
        self.clip_denoised = clip_denoised
        self.use_ddim = use_ddim
        self.use_dpm = use_dpm
        self.eta = eta
        self.model_calls = 0  # U-Net forwards run by this sampler

    def _model_fn(self, x, ts, **kw):
        self.model_calls += 1
        out, _ = self.model(x, ts, **kw)
        return out

    @torch.no_grad()
    def sample_window(self, x0, frame_indices, obs_mask, latent_mask, *, generator=None,
                      noise=None) -> torch.Tensor:
        """Run the reverse process for one K-frame window.

        Arrays may be numpy or tensors; they are moved to the sampler's
        device. ``generator`` (on that device) draws the noise, or pass the
        terminal ``noise``. Returns a (B, K, C, H, W) f32 tensor.
        """
        dev = self.device
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        kwargs = dict(
            x0=x0,
            frame_indices=torch.as_tensor(frame_indices, dtype=torch.int64, device=dev),
            obs_mask=torch.as_tensor(obs_mask, dtype=torch.float32, device=dev),
            latent_mask=torch.as_tensor(latent_mask, dtype=torch.float32, device=dev),
        )
        shape = tuple(x0.shape)
        common = dict(device=dev, noise=noise, generator=generator,
                      clip_denoised=self.clip_denoised, model_kwargs=kwargs)
        if self.use_ddim:
            return self.diffusion.ddim_sample_loop(self._model_fn, shape, eta=self.eta, **common)
        if self.use_dpm:
            return dpm_solver_pp_sample_loop(self.diffusion, self._model_fn, shape, **common)
        return self.diffusion.p_sample_loop(self._model_fn, shape, **common)

    def sample_video(self, batch: np.ndarray, *, scheme_name: str, n_obs: int, max_frames: int,
                     step_size: int, generator: torch.Generator,
                     optimal_schedule: Optional[dict] = None, embedder=None,
                     just_get_indices: bool = False, verbose: bool = False):
        """Generate a full video given its first ``n_obs`` frames.

        ``batch``: (B, T, C, H, W) ground-truth videos in diffusion space
        (only the first n_obs frames are read unless ``just_get_indices``).
        Returns (samples numpy, indices_used list).
        """
        B, T, C, H, W = batch.shape
        samples = np.zeros_like(batch)
        samples[:, :n_obs] = batch[:, :n_obs]

        kwargs = dict(video_length=T, num_obs=n_obs, max_frames=max_frames,
                      step_size=step_size, optimal_schedule=optimal_schedule)
        if scheme_name.startswith("adaptive"):
            kwargs["embedder"] = embedder
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
        return samples, indices_used
