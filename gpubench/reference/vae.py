"""The Stable Video Diffusion VAE's temporal decoder (diffusers'
``AutoencoderKLTemporalDecoder``, arXiv:2311.15127) in plain PyTorch,
float32: the benchmark's reference for the port's ``models/vae.py``
decoder. Parameter names are diffusers' (``decoder.`` prefix left off).
Each frame decodes on its own (``num_frames=1``), as the reference code
decodes latent videos."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight, self.bias, self.eps)


def conv3(i, o):
    return nn.Conv2d(i, o, 3, padding=1)


class ResnetBlock2D(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(i), conv3(i, o)
        self.norm2, self.conv2 = GroupNorm(o), conv3(o, o)
        self.conv_shortcut = nn.Conv2d(i, o, 1) if i != o else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class TemporalResnetBlock(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(i), nn.Conv3d(i, o, (3, 1, 1), padding=(1, 0, 0))
        self.norm2, self.conv2 = GroupNorm(o), nn.Conv3d(o, o, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        return x + self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))


class AlphaBlender(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5))


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(i, o)
        self.temporal_res_block = TemporalResnetBlock(o, o)
        self.time_mixer = AlphaBlender()

    def forward(self, x):  # (N, C, H, W), one frame per row
        h = self.spatial_res_block(x)
        ht = h[:, :, None]
        alpha = torch.sigmoid(self.time_mixer.mix_factor)
        return (alpha * ht + (1 - alpha) * self.temporal_res_block(ht))[:, :, 0]


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = GroupNorm(c)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        N, C, H, W = x.shape
        h = self.group_norm(x).reshape(N, C, H * W).transpose(1, 2)
        attn = torch.softmax(self.to_q(h) @ self.to_k(h).transpose(1, 2) * C ** -0.5, dim=-1)
        return x + self.to_out[0](attn @ self.to_v(h)).transpose(1, 2).reshape(N, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(c, c), SpatioTemporalResBlock(c, c)])
        self.attentions = nn.ModuleList([AttnBlock(c)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class UpBlock(nn.Module):
    def __init__(self, i, o, layers, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(SpatioTemporalResBlock(i if j == 0 else o, o)
                                     for j in range(layers))
        self.upsamplers = nn.ModuleList([Upsample(o)] if upsample else [])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        for u in self.upsamplers:
            h = u(h)
        return h


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = conv3(c, c)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TemporalDecoder(nn.Module):
    """(N, latent, h, w) latents -> (N, 3, 8h, 8w) frames."""

    def __init__(self, block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                 latent_channels=4, out_channels=3):
        super().__init__()
        rev = tuple(reversed(tuple(block_out_channels)))
        self.conv_in = conv3(latent_channels, rev[0])
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(UpBlock(rev[max(i - 1, 0)], c, layers_per_block + 1,
                                               i != len(rev) - 1) for i, c in enumerate(rev))
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = conv3(rev[-1], out_channels)
        self.time_conv_out = nn.Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.time_conv_out(h[:, :, None])[:, :, 0]
