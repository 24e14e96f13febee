"""The system under test, built for a cell: the port's U-Net (and, for a
latent configuration, its SVD VAE and latent codec) with the benchmark's
seeded weights, and its diffusion process. Everything here reaches the
port through its public modules."""

from __future__ import annotations

import numpy as np
import torch

from reference.unet import UNet
from reference.vae import TemporalDecoder
from weights import seeded_state

MODEL_KEYS = ("image_size", "in_channels", "num_channels", "num_res_blocks", "num_heads",
              "attention_resolutions", "diffusion_steps", "noise_schedule", "compute_dtype",
              "diffusion_space", "pre_encoded", "rescale_timesteps")


def model_config(config: dict) -> dict:
    """The model and diffusion keys of a configuration file."""
    return {k: config[k] for k in MODEL_KEYS if k in config}


def unet_weights(config: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        skeleton = UNet(config)
    return seeded_state(skeleton, seed, device)


def vae_decoder_weights(config: dict, seed: int, device) -> dict:
    vae = config["vae"]
    with torch.device("meta"):
        skeleton = TemporalDecoder(vae["block_out_channels"], vae["layers_per_block"],
                                   vae["latent_channels"])
    return seeded_state(skeleton, seed, device, prefix="decoder.")


def build_unet(config: dict, weights: dict, device):
    """The port's ``UNetVideoModel`` as ``config.create_model`` builds it,
    made on the meta device and given ``weights``."""
    from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE
    from lfvdm_tpu_torch.models.unet import UNetVideoModel

    size = config["image_size"]
    with torch.device("meta"):
        model = UNetVideoModel(
            in_channels=config["in_channels"], model_channels=config["num_channels"],
            out_channels=config["in_channels"], num_res_blocks=config["num_res_blocks"],
            attention_resolutions=tuple(size // int(r) for r in
                                        str(config["attention_resolutions"]).split(",")),
            channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[size], num_heads=config["num_heads"],
            use_scale_shift_norm=True, use_rpe_net=True, fused_skip_conv=True,
            dtype=getattr(torch, config["compute_dtype"]))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def build_diffusion(config: dict, respacing: str = ""):
    from lfvdm_tpu_torch.config import create_diffusion

    return create_diffusion(dict(model_config(config), timestep_respacing=respacing))


def build_vae(config: dict, decoder: dict, seed: int, device):
    """The port's ``SVDVae`` at the configuration's widths: the decoder
    with ``decoder`` (the benchmark's weights), the encoder, unused by a
    pre-encoded configuration, with weights from the same seed."""
    from lfvdm_tpu_torch.models.vae import Encoder, SVDVae

    vae = config["vae"]
    with torch.device("meta"):
        enc = torch.nn.Module()
        enc.encoder = Encoder(vae["block_out_channels"], vae["layers_per_block"],
                              vae["latent_channels"])
        enc.quant_conv = torch.nn.Conv2d(2 * vae["latent_channels"], 2 * vae["latent_channels"], 1)
    state = dict(seeded_state(enc, seed + 1, device), **decoder)
    return SVDVae({k: v.cpu() for k, v in state.items()}, device=device)


def build_codec(config: dict, vae, stats):
    from lfvdm_tpu_torch.diffusion.codecs import PreEncodedLatentCodec

    return PreEncodedLatentCodec(mean=np.asarray(stats["mean"], np.float32),
                                 std=np.asarray(stats["std"], np.float32), vae=vae)
