"""Diffusion-space codecs: pixel, pre-encoded latent, VAE latent and
wavelet (counterpart of lfvdm_tpu/diffusion/codecs.py).

The reference folds encode/decode into its GaussianDiffusion
(``diffusion_space`` in {pixel, latent}, ``pre_encoded`` normalization
stats, SVD-VAE encode/decode). Here they are codec objects beside the
diffusion, which stays pure math: the train loop encodes each prepared batch
and the sampler decodes the assembled video once at the end.

The production path is the pre-encoded one: videos are VAE-encoded offline
and normalized, training streams latents, and only ``decode`` touches the
VAE (``models/vae.py``). Codecs take tensors (or numpy arrays, read as f32
tensors) and return tensors; a VAE moves its inputs to its own device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..utils import tracing
from .wavelet import wavelet_pack, wavelet_unpack


def _f32(video) -> torch.Tensor:
    return torch.as_tensor(video, dtype=torch.float32)


class PixelCodec:
    """Identity codec: diffusion runs directly in pixel space."""

    diffusion_space = "pixel"
    pre_encoded = False

    def encode(self, video, generator=None):
        return video

    def decode(self, video):
        return video


@dataclasses.dataclass
class PreEncodedLatentCodec:
    """Latents were produced offline; only de-normalization happens at decode.

    ``mean``/``std`` are the channel-wise train-split statistics saved by the
    offline encoder. ``vae`` (optional; ``models.vae.SVDVae``) maps the
    de-normalized latents back to pixels at the end of sampling.
    """

    mean: np.ndarray  # (C,)
    std: np.ndarray  # (C,)
    vae: Optional[object] = None

    diffusion_space = "latent"
    pre_encoded = True

    def __post_init__(self):
        self.mean = np.asarray(self.mean, dtype=np.float32).reshape(1, 1, -1, 1, 1)
        self.std = np.asarray(self.std, dtype=np.float32).reshape(1, 1, -1, 1, 1)

    def encode(self, video, generator=None):
        return video  # the inputs are normalized latents already

    def decode(self, video):
        with tracing.span("codec.decode"):
            video = _f32(video)
            video = (video * torch.as_tensor(self.std, device=video.device)
                     + torch.as_tensor(self.mean, device=video.device))
            if self.vae is not None:
                return self.vae.decode(video)
            return video


@dataclasses.dataclass
class VAECodec:
    """Online VAE encode/decode in latent space (training from pixels).

    ``encode`` takes mean + eps·std of each frame's latent distribution with
    eps from ``generator``, or the mean without one; both directions run in
    chunks of ``chunk_size`` frames to bound peak memory.
    """

    vae: object  # models.vae.SVDVae
    chunk_size: int = 10

    diffusion_space = "latent"
    pre_encoded = False

    def encode(self, video, generator=None):
        return self.vae.encode_video(video, generator=generator, chunk_size=self.chunk_size)

    def decode(self, video):
        with tracing.span("codec.decode"):
            return self.vae.decode_video(video, chunk_size=self.chunk_size)


@dataclasses.dataclass
class WaveletCodec:
    """Orthonormal Haar wavelet-packet diffusion space: encode packs (B, T,
    C, H, W) pixels into (B, T, C·4^L, H/2^L, W/2^L) subband channels by an
    isometry (``wavelet.py``), so N(0, I) noise and the beta schedule carry
    over unchanged; decode is the exact inverse."""

    levels: int = 1

    diffusion_space = "wavelet"
    pre_encoded = False

    def encode(self, video, generator=None):
        return wavelet_pack(_f32(video), self.levels)

    def decode(self, video):
        return wavelet_unpack(_f32(video), self.levels)


def make_codec_from_config(config: dict, *, vae_weights: Optional[str] = None,
                           require_vae: bool = False, device="cuda"):
    """The codec a checkpoint's embedded config implies.

    Normalization stats resolve from, in order: the config's
    ``enc_stats_mean``/``enc_stats_std`` lists, then the dataset registry's
    stats file (``data.datasets.load_encoding_stats``), then identity stats
    with a warning. ``vae_weights`` (or $LFVDM_VAE_WEIGHTS) names the
    ``<prefix>_{encoder,decoder}.npz`` pair of ``scripts/convert_svd_vae.py``
    (the port's or the repo's); without it the decode stops at de-normalized
    latents unless ``require_vae`` asks for a random-init VAE of the
    published widths. A VAE is built on ``device``. An online (not
    pre-encoded) latent config with no VAE raises.
    """
    space = config.get("diffusion_space", "pixel")
    if space in (None, "pixel"):
        return PixelCodec()
    if space != "latent":
        return make_codec(space, wavelet_levels=int(config.get("wavelet_levels", 1)))

    from ..models.vae import SVDVae, load_svd_vae

    vae = None
    vae_weights = vae_weights or os.environ.get("LFVDM_VAE_WEIGHTS")
    if vae_weights:
        vae = load_svd_vae(vae_weights, device=device)
    elif require_vae:
        vae = SVDVae(device=device)  # random init: the right shapes, meaningless pixels

    if config.get("pre_encoded"):
        if config.get("enc_stats_mean") is not None:
            stats = {"mean": np.asarray(config["enc_stats_mean"], np.float32),
                     "std": np.asarray(config["enc_stats_std"], np.float32)}
        else:
            from ..data.datasets import load_encoding_stats

            stats = load_encoding_stats(config.get("dataset"))
        if stats is None:
            print("warning: latent norm stats unavailable; decoding with identity stats")
            C = int(config.get("in_channels", 4))
            stats = {"mean": np.zeros(C, np.float32), "std": np.ones(C, np.float32)}
        return PreEncodedLatentCodec(mean=stats["mean"], std=stats["std"], vae=vae)
    if vae is None:
        raise ValueError("a latent config that is not pre-encoded needs VAE weights "
                         "(vae_weights= or $LFVDM_VAE_WEIGHTS; see "
                         "lfvdm_tpu_torch.scripts.convert_svd_vae)")
    return VAECodec(vae=vae)


def make_codec(diffusion_space: str, *, pre_encoded: bool = False,
               pre_encoded_stats: Optional[dict] = None, vae=None, chunk_size: int = 10,
               wavelet_levels: int = 1):
    """Config-level codec factory."""
    if diffusion_space in (None, "pixel"):
        return PixelCodec()
    if diffusion_space == "latent":
        if pre_encoded:
            if pre_encoded_stats is None:
                raise ValueError("a pre-encoded latent space needs norm stats")
            return PreEncodedLatentCodec(mean=pre_encoded_stats["mean"],
                                         std=pre_encoded_stats["std"], vae=vae)
        if vae is None:
            raise ValueError("an online latent space needs a VAE")
        return VAECodec(vae=vae, chunk_size=chunk_size)
    if diffusion_space == "wavelet":
        return WaveletCodec(levels=wavelet_levels)
    raise ValueError(f"Unknown diffusion space: {diffusion_space}")
