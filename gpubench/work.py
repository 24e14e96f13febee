"""Work counted from shapes: model FLOPs of the reference's forward (and
backward) at a cell's sizes, by ``torch.utils.flop_counter.FlopCounterMode``
on the ``meta`` device (matrix products and convolutions), and the least
time of each port kernel's launches in one forward (``yardstick``)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.unet import UNet
from reference.vae import TemporalDecoder
from yardstick import bound_s, skip_conv_work, spatial_work, temporal_work

WORK = {"temporal_rpe_attention": temporal_work, "spatial_attention": spatial_work,
        "skip_conv_stats": skip_conv_work}


def _inputs(cfg, B, K):
    C, S = cfg["in_channels"], cfg["image_size"]
    m = torch.device("meta")
    x = torch.zeros((B, K, C, S, S), device=m)
    kw = dict(x0=torch.zeros_like(x), frame_indices=torch.zeros((B, K), dtype=torch.int64, device=m),
              obs_mask=torch.zeros((B, K, 1, 1, 1), device=m),
              latent_mask=torch.zeros((B, K, 1, 1, 1), device=m))
    return x, torch.zeros((B,), device=m), kw


@functools.lru_cache(maxsize=None)
def _forward(cfg_items, B, K, backward):
    cfg = dict(cfg_items)
    with torch.device("meta"):
        model = UNet(cfg)
    model.recorder = []
    x, t, kw = _inputs(cfg, B, K)
    with FlopCounterMode(display=False) as fc:
        out = model(x, t, **kw)
        if backward:
            out.square().mean().backward()
    esize = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
    least = {}
    for name, d in model.recorder[:len(model.recorder)]:
        nbytes, flops = WORK[name](**d, esize=esize)
        least[name] = least.get(name, 0.0) + bound_s(nbytes, flops, "bfloat16")
    n = {name: sum(1 for k, _ in model.recorder if k == name) for name in least}
    return {"flops": float(fc.get_total_flops()), "kernels": least, "launches": n}


def _key(cfg):
    return tuple(sorted((k, v) for k, v in cfg.items() if not isinstance(v, (dict, list))))


def unet_forward(cfg, B, K):
    """{"flops": model FLOPs of one forward at (B, K), "kernels": {kernel:
    least seconds of its launches in that forward}, "launches": {kernel:
    launches in that forward}}."""
    return _forward(_key(cfg), B, K, False)


def unet_train_step(cfg, B, K):
    """As ``unet_forward`` for a training step: the FLOPs of the forward and
    the backward (no recomputation); the kernels launch in the forward."""
    return _forward(_key(cfg), B, K, True)


def decoder_flops(cfg) -> float:
    """Model FLOPs of the VAE decoder per decoded frame."""
    vae = cfg["vae"]
    with torch.device("meta"):
        dec = TemporalDecoder(vae["block_out_channels"], vae["layers_per_block"],
                              vae["latent_channels"])
        z = torch.zeros((1, vae["latent_channels"], cfg["image_size"], cfg["image_size"]))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        dec(z)
    return float(fc.get_total_flops())
