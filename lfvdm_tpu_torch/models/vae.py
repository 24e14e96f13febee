"""Stable Video Diffusion VAE: the 2-D encoder and the temporal decoder
(counterpart of lfvdm_tpu/models/vae.py).

The architecture of diffusers' ``AutoencoderKLTemporalDecoder``:
  Encoder:  conv_in -> 4 down blocks (128/256/512/512, 2 resnets each,
            asymmetric-pad stride-2 downsample but the last) -> mid (resnet,
            attention, resnet) -> GroupNorm/SiLU/conv_out (8 ch); the VAE's
            ``quant_conv`` (1x1) follows.
  Decoder:  conv_in -> mid (SpatioTemporalResBlock, attention,
            SpatioTemporalResBlock) -> 4 up blocks (3 SpatioTemporalResBlocks
            + nearest 2x upsample but the last) -> GroupNorm/SiLU/conv_out ->
            time_conv_out, a (3, 1, 1) conv over the frames.
  SpatioTemporalResBlock = a 2-D ResnetBlock2D, then a ResnetBlock of
  (3, 1, 1) 3-D convs, blended as ``alpha*spatial + (1 - alpha)*temporal``
  with ``alpha = sigmoid(mix_factor)``, as the JAX package does it.

Module names are diffusers' own (``encoder.down_blocks.{i}.resnets.{j}``,
``…downsamplers.0.conv``, ``encoder.mid_block.attentions.0.to_out.0``,
``quant_conv``, ``decoder.up_blocks.{i}.resnets.{j}.time_mixer.mix_factor``,
``decoder.time_conv_out``, ...): a diffusers state dict loads with
``load_state_dict``. ``python -m lfvdm_tpu_torch.scripts.convert_svd_vae``
writes diffusers' weights as the ``<prefix>_{encoder,decoder}.npz`` pair of
the JAX package's variables (the files the repo's
``scripts/convert_svd_vae.py`` writes), which ``load_svd_vae`` reads.
Activations are NCHW (NCTHW in the temporal blocks), GroupNorm eps 1e-6,
and everything runs in f32, as the JAX VAE does. The mid-block attention is
one head over the pixel tokens with f32 logits and softmax in plain
``torch.matmul``: the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

SVD_BLOCK_OUT_CHANNELS = (128, 256, 512, 512)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) with eps 1e-6 and its statistics in f32 (diffusers'
    VAE convention; the U-Net's GroupNorm32 differs). On a 5-D (N, C, T, H,
    W) input the statistics span (T, H, W) jointly."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _conv3x3(c_in, c_out, stride=1, padding=1):
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=padding)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the pixel tokens, with the residual
    (diffusers ``Attention``): f32 logits and softmax, the weights cast back
    to the activations' dtype before they weight v."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        N, C, H, W = x.shape
        h = self.group_norm(x).reshape(N, C, H * W).transpose(1, 2)  # (N, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(logits * C ** -0.5, dim=-1).to(h.dtype)
        out = self.to_out[0](torch.matmul(attn, v))
        return x + out.transpose(1, 2).reshape(N, C, H, W)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv after diffusers' asymmetric padding: one row at the
    bottom and one column at the right, none at the top or left."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3x3(channels, channels, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _DownBlock(nn.Module):
    def __init__(self, in_channels, out_channels, layers, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels)
            for j in range(layers))
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)] if downsample else [])

    def forward(self, h):
        for m in (*self.resnets, *self.downsamplers):
            h = m(h)
        return h


class _EncoderMidBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels),
                                      ResnetBlock2D(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Encoder(nn.Module):
    """2-D VAE encoder: (N, 3, H, W) frames -> (N, 2·latent, H/8, W/8) before
    ``quant_conv``, which the VAE holds (diffusers' layout)."""

    def __init__(self, block_out_channels: Sequence[int] = SVD_BLOCK_OUT_CHANNELS,
                 layers_per_block: int = 2, latent_channels: int = 4, in_channels: int = 3):
        super().__init__()
        chans = tuple(block_out_channels)
        self.conv_in = _conv3x3(in_channels, chans[0])
        self.down_blocks = nn.ModuleList(
            _DownBlock(chans[max(i - 1, 0)], ch, layers_per_block, i != len(chans) - 1)
            for i, ch in enumerate(chans))
        self.mid_block = _EncoderMidBlock(chans[-1])
        self.conv_norm_out = GroupNorm(chans[-1])
        self.conv_out = _conv3x3(chans[-1], 2 * latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def _conv311(c_in, c_out):
    return nn.Conv3d(c_in, c_out, (3, 1, 1), padding=(1, 0, 0))


class TemporalResnetBlock(nn.Module):
    """ResnetBlock of (3, 1, 1) 3-D convs on (N, C, T, H, W); its
    GroupNorms' statistics span (T, H, W) jointly."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = _conv311(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = _conv311(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AlphaBlender(nn.Module):
    """The learned blend of a SpatioTemporalResBlock (``time_mixer``)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, spatial, temporal):
        alpha = torch.sigmoid(self.mix_factor)
        return alpha * spatial + (1 - alpha) * temporal


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels)
        self.temporal_res_block = TemporalResnetBlock(out_channels, out_channels)
        self.time_mixer = AlphaBlender()

    def forward(self, x, num_frames: int):  # x: (B·T, C, H, W)
        h = self.spatial_res_block(x)
        BT, C, H, W = h.shape
        h_t = h.reshape(BT // num_frames, num_frames, C, H, W).transpose(1, 2)
        out = self.time_mixer(h_t, self.temporal_res_block(h_t))
        return out.transpose(1, 2).reshape(BT, C, H, W)


class _DecoderMidBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(channels, channels),
                                      SpatioTemporalResBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, h, num_frames):
        h = self.resnets[0](h, num_frames)
        return self.resnets[1](self.attentions[0](h), num_frames)


class _UpBlock(nn.Module):
    def __init__(self, in_channels, out_channels, layers, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            SpatioTemporalResBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(layers))
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)] if upsample else [])

    def forward(self, h, num_frames):
        for res in self.resnets:
            h = res(h, num_frames)
        for up in self.upsamplers:
            h = up(h)
        return h


class TemporalDecoder(nn.Module):
    """SVD temporal decoder: (B·T, latent, h, w) -> (B·T, out, 8h, 8w)."""

    def __init__(self, block_out_channels: Sequence[int] = SVD_BLOCK_OUT_CHANNELS,
                 layers_per_block: int = 2, out_channels: int = 3, latent_channels: int = 4):
        super().__init__()
        rev = tuple(reversed(tuple(block_out_channels)))
        self.conv_in = _conv3x3(latent_channels, rev[0])
        self.mid_block = _DecoderMidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[max(i - 1, 0)], c, layers_per_block + 1, i != len(rev) - 1)
            for i, c in enumerate(rev))
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = _conv3x3(rev[-1], out_channels)
        self.time_conv_out = _conv311(out_channels, out_channels)

    def forward(self, z, num_frames: int = 1):
        h = self.mid_block(self.conv_in(z), num_frames)
        for block in self.up_blocks:
            h = block(h, num_frames)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        BT, C, H, W = h.shape
        ht = h.reshape(BT // num_frames, num_frames, C, H, W).transpose(1, 2)
        return self.time_conv_out(ht).transpose(1, 2).reshape(BT, C, H, W)


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def encoder_config_from_state_dict(sd: Mapping) -> dict:
    """The Encoder's config read from a VAE state dict (the weights win
    over assumptions: a miniature or a future variant builds a matching
    module instead of failing with a shape error)."""
    n_blocks = _count(sd, "encoder.down_blocks.{}.resnets.0.conv1.weight")
    blocks = tuple(int(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"].shape[0])
                   for i in range(n_blocks))
    return dict(block_out_channels=blocks,
                layers_per_block=_count(sd, "encoder.down_blocks.0.resnets.{}.conv1.weight"),
                latent_channels=int(sd["quant_conv.weight"].shape[0]) // 2,
                in_channels=int(sd["encoder.conv_in.weight"].shape[1]))


def decoder_config_from_state_dict(sd: Mapping) -> dict:
    """The TemporalDecoder's config read from a VAE state dict."""
    key = "decoder.up_blocks.{}.resnets.0.spatial_res_block.conv1.weight"
    rev = tuple(int(sd[key.format(i)].shape[0]) for i in range(_count(sd, key)))
    layers = _count(sd, "decoder.up_blocks.0.resnets.{}.spatial_res_block.conv1.weight")
    return dict(block_out_channels=tuple(reversed(rev)), layers_per_block=layers - 1,
                out_channels=int(sd["decoder.conv_out.weight"].shape[0]),
                latent_channels=int(sd["decoder.conv_in.weight"].shape[1]))


def init_vae_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default init for every conv and linear layer below
    ``module`` (weights and biases uniform in ±1/√fan_in), drawn from
    ``generator`` (a CPU generator); GroupNorm stays (1, 0) and every
    ``mix_factor`` 0.5."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
    return module


class SVDVae(nn.Module):
    """The VAE and its chunked video encode and decode (the JAX package's
    ``SVDVae`` bundle).

    ``encode_video``: (B, T, 3, H, W) in [-1, 1] -> (B, T, latent, H/8, W/8),
    mean + eps·std of each frame's latent distribution (logvar clipped to
    [-30, 20]); with no ``generator`` the mean. No scaling factor is
    applied: the reference omits it on both sides.
    ``decode_video``: the inverse, each frame decoded on its own
    (``num_frames=1``, the reference's ``decode(chunk, num_frames=1)``): a
    chunk is a batch of independent frames, never one clip.

    ``state_dict``: the weights (diffusers' names); the module's config is
    read from them. Without it the VAE is built at the given widths (SVD's
    by default) with torch's default init drawn from ``seed``. The module
    lives on ``device`` (the card unless the caller asks for the CPU) in
    eval mode; numpy or tensor inputs are moved there and results stay there.
    """

    def __init__(self, state_dict: Optional[Mapping] = None, *, seed: int = 0,
                 block_out_channels: Sequence[int] = SVD_BLOCK_OUT_CHANNELS,
                 layers_per_block: int = 2, latent_channels: int = 4, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if state_dict is not None:
            enc_cfg = encoder_config_from_state_dict(state_dict)
            dec_cfg = decoder_config_from_state_dict(state_dict)
        else:
            print("SVD VAE weights unavailable — randomly initialized "
                  "(convert with lfvdm_tpu_torch.scripts.convert_svd_vae).")
            enc_cfg = dict(block_out_channels=tuple(block_out_channels),
                           layers_per_block=layers_per_block, latent_channels=latent_channels)
            dec_cfg = dict(enc_cfg)
        self.latent_channels = enc_cfg["latent_channels"]
        self.encoder = Encoder(**enc_cfg)
        self.quant_conv = nn.Conv2d(2 * self.latent_channels, 2 * self.latent_channels, 1)
        self.decoder = TemporalDecoder(**dec_cfg)
        if state_dict is not None:
            self.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()})
        else:
            init_vae_parameters(self, torch.Generator().manual_seed(seed))
        self.pretrained = state_dict is not None
        self.to(device).eval()

    @property
    def device(self) -> torch.device:
        return self.quant_conv.weight.device

    def moments(self, frames):
        """(N, 3, H, W) -> (N, 2·latent, H/8, W/8): the mean and logvar."""
        return self.quant_conv(self.encoder(frames))

    @torch.no_grad()
    def encode_video(self, video, generator: Optional[torch.Generator] = None,
                     chunk_size: int = 10) -> torch.Tensor:
        video = torch.as_tensor(video, dtype=torch.float32, device=self.device)
        B, T, C, H, W = video.shape
        frames = video.reshape(B * T, C, H, W)
        outs = []
        for i in range(0, B * T, chunk_size):
            mean, logvar = self.moments(frames[i:i + chunk_size]).chunk(2, dim=1)
            if generator is None:
                outs.append(mean)
            else:
                std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
                eps = torch.randn(std.shape, generator=generator, device=std.device)
                outs.append(mean + eps * std)
        z = torch.cat(outs)
        return z.reshape(B, T, *z.shape[1:])

    @torch.no_grad()
    def decode_video(self, latents, chunk_size: int = 20) -> torch.Tensor:
        latents = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        B, T = latents.shape[:2]
        z = latents.reshape(B * T, *latents.shape[2:])
        x = torch.cat([self.decoder(z[i:i + chunk_size], num_frames=1)
                       for i in range(0, B * T, chunk_size)])
        return x.reshape(B, T, *x.shape[1:])

    # Codec-facing aliases: PreEncodedLatentCodec calls ``vae.decode`` on
    # the de-normalized latents.
    def decode(self, video):
        return self.decode_video(video)

    def encode(self, video, generator: Optional[torch.Generator] = None):
        return self.encode_video(video, generator=generator)


def load_svd_vae(path_prefix: str, **kwargs) -> SVDVae:
    """An SVDVae from the ``<prefix>_{encoder,decoder}.npz`` pair that
    ``lfvdm_tpu_torch.scripts.convert_svd_vae`` (or the repo's
    scripts/convert_svd_vae.py) writes: the JAX package's variable trees,
    flattened with "/". ``kwargs`` go to ``SVDVae`` (``device``)."""
    from ..utils.convert import vae_state_dict_from_jax

    def tree(path):
        out = {}
        with np.load(path) as flat:
            for key in flat.files:
                node = out
                *parents, leaf = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = flat[key]
        return out

    enc, dec = tree(f"{path_prefix}_encoder.npz"), tree(f"{path_prefix}_decoder.npz")
    return SVDVae(vae_state_dict_from_jax(enc, dec), **kwargs)
