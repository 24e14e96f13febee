"""In-training sample logging (counterpart of lfvdm_tpu/training/vis_sampling.py).

On a fixed vis batch: deterministic obs/latent masks (the first third
observed; row 1 strided), one window sampled with the EMA weights, the
composite of observed and sampled frames decoded, the observed frames marked
with a red border, a gif per video. The sampler's noise comes from a
``torch.Generator`` seeded from ``seed`` on the loop's device. With
``log_attn`` the window is sampled by ``VideoSampler.sample_window_attn`` and
its per-quartile attention heatmaps are saved as ``.npy`` beside the gifs.

In a ``torch.distributed`` group every rank takes part in the gather of the
EMA weights (a collective under FSDP2); rank 0 alone samples, on a plain
replica of the model, and writes; every rank then waits at a barrier (the
reference's ``dist.barrier()`` after ``log_samples``).

As the JAX function keeps one sampler per EMA rate, a sample function keeps
one replica and one ``VideoSampler`` per rate across its calls, and loads
each call's EMA weights into that replica in place (``load_state_dict``
copies into the existing parameters): the captured window programs of the
first call read the same tensors, so later calls replay them rather than
capture again. The memo lives as long as the sample function.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import process_index_and_count
from ..utils.logger import logger
from ..utils.rng import RNG
from ..utils.video_io import mark_as_observed, tensor2gif
from .masks import prepare_training_batch, sample_all_masks


def make_vis_masks(B: int, T: int, max_frames: int):
    """Deterministic vis masks: row 0 contiguous prefix, row 1 strided."""
    n_obs = max_frames // 3
    obs = np.zeros((B, T), np.float32)
    latent = np.zeros((B, T), np.float32)
    obs[0, :n_obs] = 1.0
    latent[0, n_obs:max_frames] = 1.0
    if B > 1:
        spacing = T // max_frames
        obs[1, : n_obs * spacing: spacing] = 1.0
        latent[1, n_obs * spacing: max_frames * spacing: spacing] = 1.0
    return obs, latent, n_obs


def make_sample_fn(vis_batch: np.ndarray, *, ema_rate: str = None, out_dir: str = None,
                   seed: int = 0, log_attn: bool = False):
    """A ``TrainLoop.sample_fn`` that samples the vis batch with the EMA
    weights (``ema_rate``, default the largest saved) and, with ``out_dir``,
    writes ``step<step>_video<i>.gif`` there and logs each path. The window
    runs on ``loop.sampling_model``, a plain replica holding the EMA
    weights, made at the rate's first call and kept (``.samplers``: rate ->
    its ``VideoSampler``). With ``log_attn`` the per-quartile attention
    heatmaps (reference gaussian_diffusion.py:448-469) are saved too, as
    ``step<step>_attn_q<q>-{temporal,spatial}.npy``. Returns the marked uint8
    videos (B, K, C, H, W) on rank 0, None on the others.
    """

    samplers = {}  # rate -> the VideoSampler over that rate's replica

    def sample_fn(loop):
        rank, count = process_index_and_count()
        rate = ema_rate or sorted(loop.state.ema.keys())[-1]
        ema = loop.ema_params[rate]  # every rank: under FSDP2 this gathers
        vids = _sample(loop, _sampler(loop, rate, ema)) if rank == 0 else None
        if count > 1:
            import torch.distributed as dist

            dist.barrier()
        return vids

    def _sampler(loop, rate, ema):
        """The rate's sampler, its replica holding ``ema``."""
        from ..sampling.driver import VideoSampler

        sampler = samplers.get(rate)
        if sampler is None:
            sampler = samplers[rate] = VideoSampler(loop.sampling_model(ema), loop.diffusion)
        else:
            sampler.model.load_state_dict(ema)
        return sampler

    def _sample(loop, sampler):
        B, T = vis_batch.shape[:2]
        with RNG(seed):
            rng = np.random.default_rng(seed)
            obs, latent, n_obs = make_vis_masks(B, T, loop.max_frames)
            obs_s, latent_s = sample_all_masks(rng, B, T, loop.max_frames,
                                               set_masks={"obs": obs, "latent": latent})
            batch, fi, obs_m, lat_m = prepare_training_batch(
                rng, vis_batch, obs_s, latent_s, loop.max_frames, pad_with_random_frames=False)
        dev = loop.device
        batch = torch.as_tensor(batch, dtype=torch.float32, device=dev)
        if loop.codec is not None:
            batch = loop.codec.encode(batch)
        obs_t = torch.as_tensor(obs_m, device=dev)
        lat_t = torch.as_tensor(lat_m, device=dev)

        generator = torch.Generator(device=dev).manual_seed(seed)
        if log_attn:
            local, attns = sampler.sample_window_attn(batch, fi, obs_m, lat_m,
                                                      generator=generator)
        else:
            local = sampler.sample_window(batch, fi, obs_m, lat_m, generator=generator)
            attns = {}
        composite = local * lat_t + batch * obs_t
        if loop.codec is not None:
            composite = loop.codec.decode(composite)
        composite = torch.as_tensor(composite).float().cpu().numpy()
        vids = ((composite + 1) * 127.5).clip(0, 255).astype(np.uint8)
        mark_as_observed(vids[:, :n_obs])

        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            for i, vid in enumerate(vids):
                path = f"{out_dir}/step{loop.step:06d}_video{i}.gif"
                tensor2gif(vid, path, drange=(0, 255))
                logger.logkv(f"video-{i}", path, distributed=False)
            for tag, arr in attns.items():
                np.save(f"{out_dir}/step{loop.step:06d}_{tag.replace('/', '_')}.npy",
                        arr.cpu().numpy())
        return vids

    sample_fn.samplers = samplers
    return sample_fn
