"""Config: defaults dict -> model + diffusion (counterpart of lfvdm_tpu/config.py).

The defaults and the flagship config are the JAX package's, key for key, so
one config dict builds either package's model; the JAX package ignores the
one key it lacks, ``fused_skip_conv``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from .diffusion.gaussian import GaussianDiffusion
from .models.nn import init_parameters
from .models.unet import UNetVideoModel
from .utils.device import resolve_device

CHANNEL_MULT_BY_IMAGE_SIZE = {
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
}


def model_and_diffusion_defaults() -> Dict[str, Any]:
    """Default model+diffusion config (the reference's script_util defaults)."""
    return dict(
        image_size=64,
        in_channels=3,
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        attention_resolutions="16,8",
        dropout=0.0,
        learn_sigma=False,
        sigma_small=False,
        class_cond=False,
        diffusion_steps=1000,
        diffusion_space="pixel",
        pre_encoded=False,
        wavelet_levels=1,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=True,
        rescale_learned_sigmas=True,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        use_rpe_net=True,
        # Torso compute dtype ("bfloat16" or "float32"); params stay f32.
        compute_dtype="bfloat16",
        # The up path's skip projection, residual add and next-GroupNorm
        # statistics as one CUDA kernel (ops/skipconv.py). The counterpart of
        # the JAX package's LFVDM_PALLAS_SKIPCONV, which defaults off there
        # because under XLA the custom call's layout constraints and fusion
        # barrier cost more relayout copies than the kernel saves on a TPU.
        # Eager PyTorch has neither effect, and the unfused form makes three
        # passes (concat conv, residual add, a statistics re-read), so the
        # port turns it on.
        fused_skip_conv=True,
    )


def flagship_config(tiny: bool = False) -> Dict[str, Any]:
    """The flagship config: the CARLA pixel-space config of the released
    reference checkpoint (128 px, 128 channels, 1 res block, K = 20, bf16
    torso). ``tiny``: the shape-compatible miniature the tests use."""
    if tiny:
        return dict(image_size=32, in_channels=2, num_channels=32, num_res_blocks=1,
                    attention_resolutions="8", diffusion_steps=8,
                    noise_schedule="cosine", compute_dtype="float32")
    return dict(image_size=128, in_channels=3, num_channels=128, num_res_blocks=1,
                attention_resolutions="16,8", diffusion_steps=1000,
                compute_dtype="bfloat16")


def latent_config() -> Dict[str, Any]:
    """The latent config: the reference's latent command (pre-encoded 32x32
    C4 SVD-VAE latents, 64 channels, 1 res block, bf16 torso), run at B = 1,
    K = 5 (its ``--batch_size 1 --max_frames 5``)."""
    return dict(image_size=32, in_channels=4, num_channels=64, num_res_blocks=1,
                attention_resolutions="16,8", diffusion_steps=1000,
                compute_dtype="bfloat16", diffusion_space="latent", pre_encoded=True)


def create_model(
    image_size: int,
    in_channels: int,
    num_channels: int,
    num_res_blocks: int,
    *,
    learn_sigma: bool = False,
    attention_resolutions: str = "16,8",
    num_heads: int = 4,
    num_heads_upsample: int = -1,
    use_scale_shift_norm: bool = True,
    dropout: float = 0.0,
    use_rpe_net: bool = True,
    compute_dtype: str = "bfloat16",
    fused_skip_conv: bool = True,
    use_checkpoint: bool = False,
    device="cuda",
    seed: int = 0,
) -> UNetVideoModel:
    """Build the video U-Net with torch-default init drawn from ``seed``, on
    ``device``. The module is left in the mode a new ``nn.Module`` has; the
    trainer and the sampler set the one they need."""
    if image_size not in CHANNEL_MULT_BY_IMAGE_SIZE:
        raise ValueError(f"unsupported image size: {image_size}")
    device = resolve_device(device)
    attention_ds = tuple(image_size // int(res) for res in str(attention_resolutions).split(","))
    model = UNetVideoModel(
        in_channels=in_channels,
        model_channels=num_channels,
        out_channels=in_channels if not learn_sigma else in_channels * 2,
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds,
        dropout=dropout,
        channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[image_size],
        num_heads=num_heads,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        use_rpe_net=use_rpe_net,
        fused_skip_conv=fused_skip_conv,
        use_checkpoint=use_checkpoint,
        dtype=getattr(torch, compute_dtype),
    )
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def create_gaussian_diffusion(
    *,
    diffusion_steps: int = 1000,
    learn_sigma: bool = False,
    sigma_small: bool = False,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    predict_xstart: bool = False,
    rescale_timesteps: bool = False,
    rescale_learned_sigmas: bool = False,
    timestep_respacing: str = "",
) -> GaussianDiffusion:
    return GaussianDiffusion.create(
        steps=diffusion_steps,
        noise_schedule=noise_schedule,
        timestep_respacing=timestep_respacing,
        learn_sigma=learn_sigma,
        sigma_small=sigma_small,
        use_kl=use_kl,
        predict_xstart=predict_xstart,
        rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
    )


def _with_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    defaults = model_and_diffusion_defaults()
    return {**defaults, **{k: v for k, v in config.items() if k in defaults}}


def create_diffusion(config: Dict[str, Any]) -> GaussianDiffusion:
    """Config dict -> GaussianDiffusion (extra keys are ignored)."""
    cfg = _with_defaults(config)
    return create_gaussian_diffusion(
        diffusion_steps=cfg["diffusion_steps"], learn_sigma=cfg["learn_sigma"],
        sigma_small=cfg["sigma_small"], noise_schedule=cfg["noise_schedule"],
        use_kl=cfg["use_kl"], predict_xstart=cfg["predict_xstart"],
        rescale_timesteps=cfg["rescale_timesteps"],
        rescale_learned_sigmas=cfg["rescale_learned_sigmas"],
        timestep_respacing=cfg["timestep_respacing"],
    )


def create_model_and_diffusion(config: Dict[str, Any], *, device="cuda", seed: int = 0):
    """Config dict -> (UNetVideoModel on ``device``, GaussianDiffusion).

    ``config`` may hold extra keys; only the model/diffusion subset is read.
    """
    cfg = _with_defaults(config)
    model = create_model(
        cfg["image_size"], cfg["in_channels"], cfg["num_channels"], cfg["num_res_blocks"],
        learn_sigma=cfg["learn_sigma"], attention_resolutions=cfg["attention_resolutions"],
        num_heads=cfg["num_heads"], num_heads_upsample=cfg["num_heads_upsample"],
        use_scale_shift_norm=cfg["use_scale_shift_norm"], dropout=cfg["dropout"],
        use_rpe_net=cfg["use_rpe_net"], compute_dtype=cfg["compute_dtype"],
        fused_skip_conv=cfg["fused_skip_conv"], use_checkpoint=cfg["use_checkpoint"],
        device=device, seed=seed,
    )
    return model, create_diffusion(cfg)


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_dict_to_argparser(parser: argparse.ArgumentParser, default_dict: Dict[str, Any]):
    """One typed ``--key`` flag per entry, typed by its default: bools parse
    with ``str2bool`` and a None default parses as a string (the CLIs coerce
    such flags, ``--T`` say, themselves)."""
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys):
    return {k: getattr(args, k) for k in keys}
