"""JAX parameter tree (numpy) -> the port's ``state_dict``.

The inverse of ``lfvdm_tpu/utils/torch_convert.py``: it maps the Flax
parameter tree of ``lfvdm_tpu.models.unet.UNetVideoModel`` onto the module
names of ``lfvdm_tpu_torch.models.unet.UNetVideoModel`` (the reference
checkpoint's names), so a JAX checkpoint loads with ``load_state_dict``.

Layouts:
  flax Dense kernel (in, out)         -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)  -> torch Conv2d weight (out, in, kh, kw)
  GroupNorm32 scale/bias              -> GroupNorm weight/bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _gn(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _resblock(sd, prefix, p):
    _gn(sd, f"{prefix}.in_layers.0", p["in_norm"])
    _conv(sd, f"{prefix}.in_layers.2", p["in_conv"])
    _lin(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _gn(sd, f"{prefix}.out_layers.0", p["out_norm"])
    _conv(sd, f"{prefix}.out_layers.3", p["out_conv"])
    if "skip_conv" in p:
        _conv(sd, f"{prefix}.skip_connection", p["skip_conv"])


def _rpe(sd, prefix, p):
    if "rpe_net" in p:
        for name in ("embed_distances", "embed_diffusion_time", "out"):
            _lin(sd, f"{prefix}.rpe_net.{name}", p["rpe_net"][name])
    else:
        sd[f"{prefix}.lookup_table_weight"] = _t(p["lookup_table_weight"])


def _rpe_attention(sd, prefix, p):
    _gn(sd, f"{prefix}.norm", p["norm"])
    _lin(sd, f"{prefix}.qkv", p["qkv"])
    _lin(sd, f"{prefix}.proj_out", p["proj_out"])
    for which in ("rpe_q", "rpe_k", "rpe_v"):
        if which in p:
            _rpe(sd, f"{prefix}.{which}", p[which])


def _attn_block(sd, prefix, p):
    _rpe_attention(sd, f"{prefix}.temporal_attention", p["temporal_attention"])
    _rpe_attention(sd, f"{prefix}.spatial_attention", p["spatial_attention"])


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def rpe_attention_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """An ``RPEAttention``'s JAX tree -> the port's ``RPEAttention`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _rpe_attention(sd, "", _unwrap(params))
    return {k[1:]: v for k, v in sd.items()}  # drop the leading "."


def unet_state_dict_from_jax(params: Mapping, *, num_res_blocks: int, channel_mult,
                             attention_resolutions) -> Dict[str, torch.Tensor]:
    """The JAX ``UNetVideoModel`` tree (``{"params": ...}`` or its inner dict,
    numpy leaves) -> the port's ``state_dict``. ``attention_resolutions`` are
    downsample factors (ds values), as the model's field holds them."""
    p = _unwrap(params)
    sd: Dict[str, torch.Tensor] = {}
    _lin(sd, "time_embed.0", p["time_embed_1"])
    _lin(sd, "time_embed.2", p["time_embed_2"])
    _conv(sd, "input_blocks.0.0", p["stem"])

    idx = 1
    ds = 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _resblock(sd, f"input_blocks.{idx}.0", p[f"down_{level}_{i}"])
            if ds in attention_resolutions:
                _attn_block(sd, f"input_blocks.{idx}.1", p[f"down_attn_{level}_{i}"])
            idx += 1
        if level != len(channel_mult) - 1:
            _conv(sd, f"input_blocks.{idx}.0.op", p[f"downsample_{level}"]["conv"])
            idx += 1
            ds *= 2

    _resblock(sd, "middle_block.0", p["middle_res_1"])
    _attn_block(sd, "middle_block.1", p["middle_attn"])
    _resblock(sd, "middle_block.2", p["middle_res_2"])

    jdx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            prefix = f"output_blocks.{jdx}"
            _resblock(sd, f"{prefix}.0", p[f"up_{level}_{i}"])
            sub = 1
            if ds in attention_resolutions:
                _attn_block(sd, f"{prefix}.{sub}", p[f"up_attn_{level}_{i}"])
                sub += 1
            if level and i == num_res_blocks:
                _conv(sd, f"{prefix}.{sub}.conv", p[f"upsample_{level}"]["conv"])
                ds //= 2
            jdx += 1

    _gn(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"])
    return sd
