"""Weights into the port: the reference's ``.pt`` checkpoints, and JAX
parameter trees (numpy) -> the port's ``state_dict``.

``load_reference_checkpoint`` reads a reference-format ``.pt`` file
(``{"state_dict", "config"}``), the one checkpoint format both packages
read: the port's U-Net has the reference's module names, so its state_dict
loads as it is.

The inverse of ``lfvdm_tpu/utils/torch_convert.py``: it maps the Flax
parameter tree of ``lfvdm_tpu.models.unet.UNetVideoModel`` onto the module
names of ``lfvdm_tpu_torch.models.unet.UNetVideoModel`` (the reference
checkpoint's names), so a JAX checkpoint loads with ``load_state_dict``;
``unet_jax_tree_from_state_dict`` maps back (what the port's
``export_params`` writes, for the JAX package to read).
``train_state_from_jax`` maps a whole JAX train state (params, EMA copies,
optax Adam state, step) onto the port's ``TrainState.state_dict()`` format.
``vae_state_dict_from_jax`` maps the JAX SVD VAE's encoder and decoder
variables onto ``models/vae.py``'s (diffusers') names: the exact inverse of
``scripts/convert_svd_vae.py``'s ``convert``. ``i3d_state_dict_from_jax``
maps the JAX I3D's flat ``.npz`` (or variables) onto ``evals/i3d.py``, and
``resnet152_state_dict_from_jax`` the JAX CARLA classifier's or regressor's
variables onto torchvision's layout, the exact inverse of
``lfvdm_tpu/evals/carla_regressor.py``'s ``convert_resnet152_state_dict``.

The port's weight converters (``lfvdm_tpu_torch/scripts/convert_*.py``)
write the files the JAX package's converters write, through the mappings
the other way: ``vae_jax_from_state_dict`` (diffusers' names -> the JAX
VAE's variables, the inverse of ``vae_state_dict_from_jax``),
``i3d_npz_entry_from_tf`` (a TF-Hub I3D variable -> its ``.npz`` entry;
``i3d_tf_variables_from_state_dict`` goes back from ``evals/i3d.py``) and
``lpips_npz_from_state_dict`` (the LPIPS embedder's weights -> its
``.npz``; ``lpips_state_dict_from_npz`` is its inverse).

Layouts:
  flax Dense kernel (in, out)         -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)  -> torch Conv2d weight (out, in, kh, kw)
  flax 3-D Conv kernel (kt, kh, kw, in, out) -> Conv3d weight (out, in, kt, kh, kw)
  GroupNorm32 scale/bias              -> GroupNorm weight/bias
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

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


# The inverse: the port's state_dict -> the JAX parameter tree (the port's own
# copy of lfvdm_tpu/utils/torch_convert.py's convert_unet_state_dict).


def _np(sd, key) -> np.ndarray:
    return np.asarray(sd[key].detach().cpu().float().numpy() if torch.is_tensor(sd[key])
                      else sd[key], dtype=np.float32)


def _jlin(sd, prefix):
    return {"kernel": np.ascontiguousarray(_np(sd, f"{prefix}.weight").T),
            "bias": _np(sd, f"{prefix}.bias")}


def _jconv(sd, prefix):
    return {"kernel": np.ascontiguousarray(_np(sd, f"{prefix}.weight").transpose(2, 3, 1, 0)),
            "bias": _np(sd, f"{prefix}.bias")}


def _jgn(sd, prefix):
    return {"scale": _np(sd, f"{prefix}.weight"), "bias": _np(sd, f"{prefix}.bias")}


def _jresblock(sd, prefix):
    out = {"in_norm": _jgn(sd, f"{prefix}.in_layers.0"),
           "in_conv": _jconv(sd, f"{prefix}.in_layers.2"),
           "emb_proj": _jlin(sd, f"{prefix}.emb_layers.1"),
           "out_norm": _jgn(sd, f"{prefix}.out_layers.0"),
           "out_conv": _jconv(sd, f"{prefix}.out_layers.3")}
    if f"{prefix}.skip_connection.weight" in sd:
        out["skip_conv"] = _jconv(sd, f"{prefix}.skip_connection")
    return out


def _jrpe(sd, prefix):
    if f"{prefix}.rpe_net.embed_distances.weight" in sd:
        return {"rpe_net": {name: _jlin(sd, f"{prefix}.rpe_net.{name}")
                            for name in ("embed_distances", "embed_diffusion_time", "out")}}
    return {"lookup_table_weight": _np(sd, f"{prefix}.lookup_table_weight")}


def _jrpe_attention(sd, prefix):
    out = {"norm": _jgn(sd, f"{prefix}.norm"), "qkv": _jlin(sd, f"{prefix}.qkv"),
           "proj_out": _jlin(sd, f"{prefix}.proj_out")}
    for which in ("rpe_q", "rpe_k", "rpe_v"):
        if any(k.startswith(f"{prefix}.{which}.") for k in sd):
            out[which] = _jrpe(sd, f"{prefix}.{which}")
    return out


def _jattn_block(sd, prefix):
    return {"temporal_attention": _jrpe_attention(sd, f"{prefix}.temporal_attention"),
            "spatial_attention": _jrpe_attention(sd, f"{prefix}.spatial_attention")}


def unet_jax_tree_from_state_dict(state_dict: Mapping, *, num_res_blocks: int, channel_mult,
                                  attention_resolutions) -> dict:
    """The port's U-Net ``state_dict`` (tensors or numpy) -> the JAX
    ``UNetVideoModel`` tree ``{"params": ...}`` with f32 numpy leaves: the
    exact inverse of ``unet_state_dict_from_jax``. ``attention_resolutions``
    are downsample factors (ds values), as the model's field holds them."""
    sd = dict(state_dict)
    p = {"time_embed_1": _jlin(sd, "time_embed.0"), "time_embed_2": _jlin(sd, "time_embed.2"),
         "stem": _jconv(sd, "input_blocks.0.0")}
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            p[f"down_{level}_{i}"] = _jresblock(sd, f"input_blocks.{idx}.0")
            if ds in attention_resolutions:
                p[f"down_attn_{level}_{i}"] = _jattn_block(sd, f"input_blocks.{idx}.1")
            idx += 1
        if level != len(channel_mult) - 1:
            p[f"downsample_{level}"] = {"conv": _jconv(sd, f"input_blocks.{idx}.0.op")}
            idx += 1
            ds *= 2
    p["middle_res_1"] = _jresblock(sd, "middle_block.0")
    p["middle_attn"] = _jattn_block(sd, "middle_block.1")
    p["middle_res_2"] = _jresblock(sd, "middle_block.2")
    jdx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            prefix = f"output_blocks.{jdx}"
            p[f"up_{level}_{i}"] = _jresblock(sd, f"{prefix}.0")
            sub = 1
            if ds in attention_resolutions:
                p[f"up_attn_{level}_{i}"] = _jattn_block(sd, f"{prefix}.{sub}")
                sub += 1
            if level and i == num_res_blocks:
                p[f"upsample_{level}"] = {"conv": _jconv(sd, f"{prefix}.{sub}.conv")}
                ds //= 2
            jdx += 1
    p["out_norm"] = _jgn(sd, "out.0")
    p["out_conv"] = _jconv(sd, "out.2")
    return {"params": p}


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
    its update count AdamW's ``count``; the schedule's count (optax keeps
    one only for an annealed LR) becomes ``LinearAnneal``'s."""
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


# The other way, what the port's converters write: a source model's weights
# (tensors or numpy) -> the JAX package's layout, each array in its own dtype
# as the JAX scripts keep it (the U-Net's ``_j*`` helpers above cast to f32,
# the dtype of flax's exported trees).


def _arr(sd, key) -> np.ndarray:
    v = sd[key]
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _kconv(sd, prefix):
    """A conv of any rank: weight (out, in, *spatial) -> kernel (*spatial, in, out)."""
    w = _arr(sd, f"{prefix}.weight")
    return {"kernel": w.transpose(*range(2, w.ndim), 1, 0), "bias": _arr(sd, f"{prefix}.bias")}


def _kdense(sd, prefix):
    return {"kernel": _arr(sd, f"{prefix}.weight").T, "bias": _arr(sd, f"{prefix}.bias")}


def _kgn(sd, prefix):
    return {"scale": _arr(sd, f"{prefix}.weight"), "bias": _arr(sd, f"{prefix}.bias")}


def _kvae_resnet(sd, prefix):
    out = {"norm1": _kgn(sd, f"{prefix}.norm1"), "conv1": _kconv(sd, f"{prefix}.conv1"),
           "norm2": _kgn(sd, f"{prefix}.norm2"), "conv2": _kconv(sd, f"{prefix}.conv2")}
    if f"{prefix}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _kconv(sd, f"{prefix}.conv_shortcut")
    return out


def _kvae_attn(sd, prefix):
    out = {"group_norm": _kgn(sd, f"{prefix}.group_norm")}
    for name in ("to_q", "to_k", "to_v"):
        out[name] = _kdense(sd, f"{prefix}.{name}")
    out["to_out"] = _kdense(sd, f"{prefix}.to_out.0")
    return out


def _kvae_st_resblock(sd, prefix):
    return {"spatial_res_block": _kvae_resnet(sd, f"{prefix}.spatial_res_block"),
            "temporal_res_block": _kvae_resnet(sd, f"{prefix}.temporal_res_block"),
            "mix_factor": _arr(sd, f"{prefix}.time_mixer.mix_factor").reshape(1)}


def vae_jax_from_state_dict(state_dict: Mapping) -> Tuple[dict, dict]:
    """A state dict with diffusers' SVD VAE names (diffusers' own, or
    ``models.vae.SVDVae``'s) -> the JAX package's ``Encoder`` and
    ``TemporalDecoder`` variables ``({"params": ...}, {"params": ...})``:
    the exact inverse of ``vae_state_dict_from_jax``, and the keys, layouts
    and dtypes of the repo's ``scripts/convert_svd_vae.py``. The number of
    blocks and of resnets per block is read from the names."""
    sd = dict(state_dict)
    enc = {"conv_in": _kconv(sd, "encoder.conv_in"),
           "mid_res_1": _kvae_resnet(sd, "encoder.mid_block.resnets.0"),
           "mid_attn": _kvae_attn(sd, "encoder.mid_block.attentions.0"),
           "mid_res_2": _kvae_resnet(sd, "encoder.mid_block.resnets.1"),
           "conv_norm_out": _kgn(sd, "encoder.conv_norm_out"),
           "conv_out": _kconv(sd, "encoder.conv_out"),
           "quant_conv": _kconv(sd, "quant_conv")}
    i = 0
    while f"encoder.down_blocks.{i}.resnets.0.conv1.weight" in sd:
        j = 0
        while f"encoder.down_blocks.{i}.resnets.{j}.conv1.weight" in sd:
            enc[f"down_{i}_res_{j}"] = _kvae_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}")
            j += 1
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            enc[f"down_{i}_downsample"] = {
                "conv": _kconv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
        i += 1
    dec = {"conv_in": _kconv(sd, "decoder.conv_in"),
           "mid_res_1": _kvae_st_resblock(sd, "decoder.mid_block.resnets.0"),
           "mid_attn": _kvae_attn(sd, "decoder.mid_block.attentions.0"),
           "mid_res_2": _kvae_st_resblock(sd, "decoder.mid_block.resnets.1"),
           "conv_norm_out": _kgn(sd, "decoder.conv_norm_out"),
           "conv_out": _kconv(sd, "decoder.conv_out"),
           "time_conv_out": _kconv(sd, "decoder.time_conv_out")}
    i = 0
    while f"decoder.up_blocks.{i}.resnets.0.time_mixer.mix_factor" in sd:
        j = 0
        while f"decoder.up_blocks.{i}.resnets.{j}.time_mixer.mix_factor" in sd:
            dec[f"up_{i}_res_{j}"] = _kvae_st_resblock(sd, f"decoder.up_blocks.{i}.resnets.{j}")
            j += 1
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            dec[f"up_{i}_upsample"] = {
                "conv": _kconv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}
        i += 1
    return {"params": enc}, {"params": dec}


# ---------------------------------------------------------------------------
# The evals: I3D and the CARLA ResNet-152s
# ---------------------------------------------------------------------------


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict -> one level, its keys joined with "/" (the flat
    ``.npz`` keys of the JAX package's weight files)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def i3d_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX I3D's weights -> ``evals.i3d.I3D``'s state_dict.

    ``variables``: the flat ``.npz`` mapping (``params/<path>/conv_3d/kernel``,
    ``params/<path>/beta``, ``batch_stats/<path>/moving_mean``, ...) or the
    nested variables dict (whose scope names such as ``Branch_0/Conv3d_0a_1x1``
    flatten to the same keys). ``<path>`` becomes the module path with ``.``
    for ``/``; a (kt, kh, kw, in, out) kernel becomes (out, in, kt, kh, kw)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(variables).items():
        parts = key.split("/")[1:]  # drop the collection
        leaf = parts.pop()
        if parts[-1] == "conv_3d":
            parts.pop()
        if leaf == "kernel":
            sd[".".join(parts + ["weight"])] = _t(np.asarray(value).transpose(4, 3, 0, 1, 2))
        else:
            sd[".".join(parts + [leaf])] = _t(value)
    return sd


I3D_TF_SCOPE = "RGB/inception_i3d"  # the TF-Hub graph's variable scope


def i3d_npz_entry_from_tf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One TF-slim variable of the TF-Hub I3D graph -> its key and array in
    the flat ``.npz`` (the port's copy of ``tf_var_to_flax`` in the repo's
    ``scripts/convert_i3d.py``).

    ``RGB/inception_i3d/<path>/conv_3d/w`` -> ``params/<path>/conv_3d/kernel``
    (TF's (t, h, w, in, out) as it is), ``.../conv_3d/b`` -> ``.../bias``,
    ``<path>/batch_norm/beta`` -> ``params/<path>/beta`` and
    ``.../moving_mean``, ``.../moving_variance`` -> ``batch_stats/<path>/…``,
    each flattened to (C,)."""
    parts = name.split("/")
    if parts[:2] != I3D_TF_SCOPE.split("/"):
        raise ValueError(f"not a variable of the I3D graph: {name}")
    parts = parts[2:]
    if parts[-1] == "w":
        return "params/" + "/".join(parts[:-1]) + "/kernel", value
    if parts[-1] == "b":
        return "params/" + "/".join(parts[:-1]) + "/bias", value
    if parts[-2] == "batch_norm":
        base, leaf = "/".join(parts[:-2]), parts[-1]
        if leaf == "beta":
            return f"params/{base}/beta", value.reshape(-1)
        if leaf in ("moving_mean", "moving_variance"):
            return f"batch_stats/{base}/{leaf}", value.reshape(-1)
    raise ValueError(f"unmapped variable {name}")


def i3d_tf_variables_from_state_dict(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """``evals.i3d.I3D``'s state_dict -> the TF-Hub graph's variables by name
    (without ``:0``), in TF's layouts: a conv's ``w`` (t, h, w, in, out) and
    ``b``, and the batch norm's ``beta``, ``moving_mean`` and
    ``moving_variance`` of shape (1, 1, 1, 1, C). What
    ``i3d_npz_entry_from_tf`` and then ``i3d_state_dict_from_jax`` map back."""
    out = {}
    for key in state_dict:
        *path, leaf = key.split(".")
        scope = f"{I3D_TF_SCOPE}/{'/'.join(path)}"
        value = _arr(state_dict, key)
        if leaf == "weight":
            out[f"{scope}/conv_3d/w"] = value.transpose(2, 3, 4, 1, 0)
        elif leaf == "bias":
            out[f"{scope}/conv_3d/b"] = value
        else:
            out[f"{scope}/batch_norm/{leaf}"] = value.reshape(1, 1, 1, 1, -1)
    return out


# ---------------------------------------------------------------------------
# The LPIPS embedder
# ---------------------------------------------------------------------------

LPIPS_STAGES = 5  # AlexNet's five convolutions, each with its head


def lpips_npz_from_state_dict(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """``evals.lpips.LpipsEmbedderModule``'s state_dict (``conv{i}_weight``
    (out, in, k, k), ``conv{i}_bias``, ``lin{i}`` (C,)) -> the embedder
    ``.npz``: ``conv{i}.kernel`` in HWIO, ``conv{i}.bias`` and ``lin{i}``
    flattened to (C,), each in its own dtype (the mapping the repo's
    ``scripts/convert_lpips.py`` does inline)."""
    out = {}
    for i in range(1, LPIPS_STAGES + 1):
        out[f"conv{i}.kernel"] = _arr(state_dict, f"conv{i}_weight").transpose(2, 3, 1, 0)
        out[f"conv{i}.bias"] = _arr(state_dict, f"conv{i}_bias")
    for i in range(LPIPS_STAGES):
        out[f"lin{i}"] = _arr(state_dict, f"lin{i}").reshape(-1)
    return out


def lpips_state_dict_from_npz(npz: Mapping) -> Dict[str, torch.Tensor]:
    """The embedder ``.npz`` -> ``LpipsEmbedderModule``'s state_dict (f32):
    the inverse of ``lpips_npz_from_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, LPIPS_STAGES + 1):
        sd[f"conv{i}_weight"] = _t(np.asarray(npz[f"conv{i}.kernel"]).transpose(3, 2, 0, 1))
        sd[f"conv{i}_bias"] = _t(npz[f"conv{i}.bias"])
    for i in range(LPIPS_STAGES):
        sd[f"lin{i}"] = _t(npz[f"lin{i}"])
    return sd


def _stage_sizes(trunk: Mapping):
    """Blocks per stage of a JAX ``ResNet152Trunk`` tree (``layer{s}_{b}``)."""
    sizes = [0, 0, 0, 0]
    for name in trunk:
        if name.startswith("layer"):
            stage, block = name[5:].split("_")
            sizes[int(stage) - 1] = max(sizes[int(stage) - 1], int(block) + 1)
    return sizes


def resnet152_state_dict_from_jax(variables: Mapping, multi_head: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``ResNet152Classifier`` / ``MultiHeadResNet152`` variables
    (``{"params", "batch_stats"}``, numpy leaves) -> torchvision's state_dict
    layout: ``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}`` / ``bn{i}`` /
    ``downsample.0`` / ``downsample.1`` and ``fc``; the regressor's trunk
    under ``resnet.`` with its heads as ``regressors.{i}``. The stage sizes
    are read from the tree, so a cut-down trunk converts too."""
    params, stats = variables["params"], variables["batch_stats"]
    prefix = "resnet." if multi_head else ""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, p):
        sd[f"{prefix}{dst}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(dst, p, s):
        sd[f"{prefix}{dst}.weight"] = _t(p["scale"])
        sd[f"{prefix}{dst}.bias"] = _t(p["bias"])
        sd[f"{prefix}{dst}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}{dst}.running_var"] = _t(s["var"])

    trunk, trunk_stats = params["trunk"], stats["trunk"]
    conv("conv1", trunk["conv1"])
    bn("bn1", trunk["bn1"], trunk_stats["bn1"])
    for stage, n_blocks in enumerate(_stage_sizes(trunk)):
        for block in range(n_blocks):
            src, dst = f"layer{stage + 1}_{block}", f"layer{stage + 1}.{block}"
            p, s = trunk[src], trunk_stats[src]
            for i in (1, 2, 3):
                conv(f"{dst}.conv{i}", p[f"conv{i}"])
                bn(f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "downsample_conv" in p:
                conv(f"{dst}.downsample.0", p["downsample_conv"])
                bn(f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    if multi_head:
        kernels, biases = np.asarray(params["head_kernels"]), np.asarray(params["head_biases"])
        for i in range(len(kernels)):
            sd[f"regressors.{i}.weight"] = _t(kernels[i].T)
            sd[f"regressors.{i}.bias"] = _t(biases[i])
    else:
        _lin(sd, "fc", params["fc"])
    return sd


# ---------------------------------------------------------------------------
# Reference .pt checkpoints
# ---------------------------------------------------------------------------


def read_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A reference ``.pt`` checkpoint -> (f32 state_dict on the CPU, its
    embedded config dict)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = {k: v.float() for k, v in data["state_dict"].items()}
    return state_dict, dict(data.get("config", {}))


def load_reference_checkpoint(path: str, *, device="cuda"):
    """A reference ``.pt`` checkpoint -> (model on ``device``, diffusion,
    config).

    The config is read as the JAX package's converter reads it: image size
    64, ``num_res_blocks`` 2 and ``attention_resolutions`` "16,8" where it
    has none, ``channel_mult`` from ``CHANNEL_MULT_BY_IMAGE_SIZE``. The
    weights load with a strict ``load_state_dict``. Rematerialisation
    (``use_checkpoint``) only changes a backward pass, so the model is built
    without it; the config returned is the checkpoint's, unchanged.
    """
    from ..config import create_model_and_diffusion

    state_dict, config = read_reference_checkpoint(path)
    model, diffusion = create_model_and_diffusion(dict(config, use_checkpoint=False),
                                                  device=device)
    model.load_state_dict(state_dict, strict=True)
    return model, diffusion, config
