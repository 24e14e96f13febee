"""JAX parameter tree (numpy) -> the port's ``state_dict``.

The inverse of ``lfvdm_tpu/utils/torch_convert.py``: it maps the Flax
parameter tree of ``lfvdm_tpu.models.unet.UNetVideoModel`` onto the module
names of ``lfvdm_tpu_torch.models.unet.UNetVideoModel`` (the reference
checkpoint's names), so a JAX checkpoint loads with ``load_state_dict``.
``train_state_from_jax`` maps a whole JAX train state (params, EMA copies,
optax Adam state, step) onto the port's ``TrainState.state_dict()`` format.
``vae_state_dict_from_jax`` maps the JAX SVD VAE's encoder and decoder
variables onto ``models/vae.py``'s (diffusers') names: the exact inverse of
``scripts/convert_svd_vae.py``'s ``convert``.

Layouts:
  flax Dense kernel (in, out)         -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)  -> torch Conv2d weight (out, in, kh, kw)
  flax 3-D Conv kernel (kt, kh, kw, in, out) -> Conv3d weight (out, in, kt, kh, kw)
  GroupNorm32 scale/bias              -> GroupNorm weight/bias
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


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


def _has_field(obj, name: str) -> bool:
    return name in getattr(obj, "_fields", ()) or (isinstance(obj, Mapping) and name in obj)


def _field(obj, name: str, index: int):
    """``obj.name`` (a namedtuple, as jax.tree.map keeps it), ``obj[name]``
    (a dict) or ``obj[index]`` (a plain sequence, as a raw restore gives it)."""
    if name in getattr(obj, "_fields", ()):
        return getattr(obj, name)
    if isinstance(obj, Mapping):
        return obj[name] if name in obj else obj[str(index)]
    return obj[index]


def _stage(opt_state, i: int):
    if isinstance(opt_state, Mapping):
        return opt_state[str(i)] if str(i) in opt_state else opt_state[i]
    return opt_state[i]


def train_state_from_jax(state: Mapping, *, num_res_blocks: int, channel_mult,
                         attention_resolutions) -> dict:
    """A JAX train state (``lfvdm_tpu.training.train_loop.init_train_state``
    layout with numpy leaves: params, ``opt_state`` of ``make_optimizer``'s
    optax AdamW, ``ema`` by rate, step) -> the port's train-state dict.

    optax's Adam ``mu``/``nu`` become AdamW's ``exp_avg``/``exp_avg_sq`` and
    its update count AdamW's ``step``; the schedule's count (optax keeps one
    only for an annealed LR) becomes the LambdaLR count."""
    conv = functools.partial(unet_state_dict_from_jax, num_res_blocks=num_res_blocks,
                             channel_mult=channel_mult,
                             attention_resolutions=attention_resolutions)
    opt = state["opt_state"]
    adam = _stage(opt, 0)
    count = int(np.asarray(_field(adam, "count", 0)))
    schedule = _stage(opt, 2)
    schedule_count = (int(np.asarray(_field(schedule, "count", 0)))
                      if _has_field(schedule, "count") else count)
    return {
        "params": conv(state["params"]),
        "ema": {str(float(rate)): conv(tree) for rate, tree in state["ema"].items()},
        "adam": {"count": count, "exp_avg": conv(_field(adam, "mu", 1)),
                 "exp_avg_sq": conv(_field(adam, "nu", 2))},
        "schedule_count": schedule_count,
        "step": int(np.asarray(state["step"])),
    }


# ---------------------------------------------------------------------------
# The SVD VAE
# ---------------------------------------------------------------------------


def _conv_nd(sd, prefix, p):
    """A flax Conv of any rank: kernel (*spatial, in, out) -> (out, in, *spatial)."""
    kernel = np.asarray(p["kernel"])
    n = kernel.ndim
    sd[f"{prefix}.weight"] = _t(kernel.transpose(n - 1, n - 2, *range(n - 2)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _vae_resnet(sd, prefix, p):
    for name in ("norm1", "norm2"):
        _gn(sd, f"{prefix}.{name}", p[name])
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            _conv_nd(sd, f"{prefix}.{name}", p[name])


def _vae_attn(sd, prefix, p):
    _gn(sd, f"{prefix}.group_norm", p["group_norm"])
    for name in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{prefix}.{name}", p[name])
    _lin(sd, f"{prefix}.to_out.0", p["to_out"])


def _vae_st_resblock(sd, prefix, p):
    _vae_resnet(sd, f"{prefix}.spatial_res_block", p["spatial_res_block"])
    _vae_resnet(sd, f"{prefix}.temporal_res_block", p["temporal_res_block"])
    sd[f"{prefix}.time_mixer.mix_factor"] = _t(np.asarray(p["mix_factor"]).reshape(1))


def vae_state_dict_from_jax(enc_vars: Mapping, dec_vars: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Encoder`` and ``TemporalDecoder`` variables
    (``{"params": ...}`` or the inner dicts, numpy leaves) -> the state dict
    of ``models.vae.SVDVae``, with diffusers' names. The JAX encoder ends in
    ``quant_conv``; here, as in diffusers, the VAE holds it."""
    enc, dec = _unwrap(enc_vars), _unwrap(dec_vars)
    sd: Dict[str, torch.Tensor] = {}
    _conv_nd(sd, "encoder.conv_in", enc["conv_in"])
    i = 0
    while f"down_{i}_res_0" in enc:
        j = 0
        while f"down_{i}_res_{j}" in enc:
            _vae_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_res_{j}"])
            j += 1
        if f"down_{i}_downsample" in enc:
            _conv_nd(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     enc[f"down_{i}_downsample"]["conv"])
        i += 1
    _vae_resnet(sd, "encoder.mid_block.resnets.0", enc["mid_res_1"])
    _vae_attn(sd, "encoder.mid_block.attentions.0", enc["mid_attn"])
    _vae_resnet(sd, "encoder.mid_block.resnets.1", enc["mid_res_2"])
    _gn(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv_nd(sd, "encoder.conv_out", enc["conv_out"])
    _conv_nd(sd, "quant_conv", enc["quant_conv"])

    _conv_nd(sd, "decoder.conv_in", dec["conv_in"])
    _vae_st_resblock(sd, "decoder.mid_block.resnets.0", dec["mid_res_1"])
    _vae_attn(sd, "decoder.mid_block.attentions.0", dec["mid_attn"])
    _vae_st_resblock(sd, "decoder.mid_block.resnets.1", dec["mid_res_2"])
    i = 0
    while f"up_{i}_res_0" in dec:
        j = 0
        while f"up_{i}_res_{j}" in dec:
            _vae_st_resblock(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_res_{j}"])
            j += 1
        if f"up_{i}_upsample" in dec:
            _conv_nd(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     dec[f"up_{i}_upsample"]["conv"])
        i += 1
    _gn(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv_nd(sd, "decoder.conv_out", dec["conv_out"])
    _conv_nd(sd, "decoder.time_conv_out", dec["time_conv_out"])
    return sd
