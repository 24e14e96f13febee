"""The frame-indexed video U-Net in plain PyTorch, float32: the benchmark's
reference for the port's ``models/unet.py``, ``models/rpe.py`` and
``models/nn.py``.

The architecture of Flexible Diffusion Models (arXiv:2205.11495): a 2-D
U-Net applied per frame with an observed-frame indicator channel,
scale-shift timestep conditioning, and at the attention resolutions a
factorized block of temporal attention (relative positions from a network
of the signed frame distance and the diffusion time, a two-group mask that
keeps real and padding frames apart) then spatial attention over the pixel
tokens. The residual of each attention adds to the normalised input. Module
and parameter names are the port's, so one state dict loads into both.

No kernel and no fusion: every attention is an einsum with an f32 softmax,
the up path concatenates and convolves, GroupNorm reads its input. Each
departure from the port is of form only: the port's fused skip projection,
its GroupNorm from channel sums and its kernels compute the same
mathematics. ``set_precision("fp8")`` rounds the inputs and weights of
every convolution and linear layer to float8 e4m3 with a per-tensor scale
(the control of a cell whose configuration states bfloat16). ``recorder``
(a list) receives each call that the port runs as one of its kernels, with
its sizes, for the benchmark's roofline arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30
FP8_MAX = 448.0  # float8 e4m3fn's largest finite value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value, back in f32. The
    gradient passes through the rounding unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class _Precision:
    lowp = False

    def operands(self, x, *params):
        if not self.lowp:
            return (x.float(),) + tuple(p.float() for p in params)
        return (fp8_round(x.float()),) + tuple(fp8_round(p.float()) for p in params[:1]) \
            + tuple(p.float() for p in params[1:])


class Linear(nn.Linear, _Precision):
    def __init__(self, i, o, zero=False):
        super().__init__(i, o)
        self.zero = zero

    def forward(self, x):
        x, w, b = self.operands(x, self.weight, self.bias)
        return F.linear(x, w, b)


class Conv2d(nn.Conv2d, _Precision):
    def __init__(self, i, o, k, stride=1, padding=0, zero=False):
        super().__init__(i, o, k, stride=stride, padding=padding)
        self.zero = zero

    def forward(self, x):
        x, w, b = self.operands(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, or gcd(32, C)), eps 1e-5, in f32."""

    def __init__(self, channels, eps=1e-5):
        g = 32 if channels % 32 == 0 else math.gcd(32, channels)
        super().__init__(g, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def timestep_embedding(timesteps, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ResBlock(nn.Module):
    def __init__(self, ch, emb_ch, out_ch):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, 2 * out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Identity(),
                                        Conv2d(out_ch, out_ch, 3, padding=1, zero=True))
        self.skip_connection = Conv2d(ch, out_ch, 1) if ch != out_ch else nn.Identity()

    def forward(self, x, emb, ctx, skip_split=None):
        h = self.in_layers(x)
        scale, shift = self.emb_layers(emb)[:, :, None, None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](self.out_layers[1](h))
        if skip_split is not None and ctx.recorder is not None:
            N, _, H, W = x.shape
            ctx.recorder.append(("skip_conv_stats", dict(
                N=N, c1=skip_split, c2=x.shape[1] - skip_split,
                F=h.shape[1], P=H * W)))
        return self.skip_connection(x) + h


class RPENet(nn.Module):
    def __init__(self, channels, heads, emb_ch):
        super().__init__()
        self.channels, self.heads = channels, heads
        self.embed_distances = Linear(3, channels)
        self.embed_diffusion_time = Linear(emb_ch, channels)
        self.out = Linear(channels, channels, zero=True)

    def forward(self, temb, d):
        B, T, _ = d.shape
        d = d.float()
        feats = torch.stack([torch.log1p(d.clamp(min=0)), torch.log1p((-d).clamp(min=0)),
                             (d == 0).float()], dim=-1)
        e = self.embed_diffusion_time(temb)[:, :, None, :] + self.embed_distances(feats)
        return self.out(F.silu(e)).reshape(B, T, T, self.heads, self.channels // self.heads)


class RPE(nn.Module):
    def __init__(self, channels, heads, emb_ch):
        super().__init__()
        self.rpe_net = RPENet(channels, heads, emb_ch)

    def forward(self, d, temb):
        return self.rpe_net(temb, d)


class RPEAttention(nn.Module):
    """Pre-norm attention over axis 2 of (B, D, T, C); RPE on q, k and v
    (temporal) or none (spatial)."""

    def __init__(self, channels, heads, emb_ch=0, rpe=False):
        super().__init__()
        self.heads, self.rpe = heads, rpe
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels)
        self.proj_out = Linear(channels, channels, zero=True)
        if rpe:
            self.rpe_q = RPE(channels, heads, emb_ch)
            self.rpe_k = RPE(channels, heads, emb_ch)
            self.rpe_v = RPE(channels, heads, emb_ch)

    def forward(self, x, ctx, temb=None, fi=None, mask=None):
        B, D, T, C = x.shape
        H, Fh = self.heads, C // self.heads
        scale = Fh ** -0.5
        h = self.norm(x.reshape(B * D, T, C).transpose(1, 2)).transpose(1, 2).reshape(B, D, T, C)
        qkv = self.qkv(h).reshape(B, D, T, 3, H, Fh)
        q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, D, H, T, F)
        logits = torch.einsum("bdhtf,bdhsf->bdhts", q * scale, k)
        if self.rpe:
            d = fi[:, :, None] - fi[:, None, :]
            logits = logits + torch.einsum("bdhtf,btshf->bdhts", q * scale, self.rpe_k(d, temb))
            logits = logits + torch.einsum("bdhsf,bsthf->bdhts", k * scale, self.rpe_q(d, temb))
        if mask is not None:
            m = mask.float()
            allowed = m[:, :, None] * m[:, None, :] + (1 - m[:, :, None]) * (1 - m[:, None, :])
            logits = torch.where((allowed > 0)[:, None, None], logits,
                                 torch.full_like(logits, NEG_INF))
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bdhts,bdhsf->bdhtf", attn, v)
        if self.rpe:
            out = out + torch.einsum("bdhts,btshf->bdhtf", attn, self.rpe_v(d, temb))
            kind = ("temporal_rpe_attention", dict(B=B, H=H, T=T, D=D, F=Fh))
        else:
            kind = ("spatial_attention", dict(B=B, T=D, H=H, D=T, F=Fh))
        if ctx.recorder is not None:
            ctx.recorder.append(kind)
        out = out.transpose(2, 3).reshape(B, D, T, C)
        return h + self.proj_out(out)


class FactorizedAttentionBlock(nn.Module):
    def __init__(self, channels, heads, emb_ch):
        super().__init__()
        self.temporal_attention = RPEAttention(channels, heads, emb_ch, rpe=True)
        self.spatial_attention = RPEAttention(channels, heads)

    def forward(self, x, ctx):
        BT, C, Hs, Ws = x.shape
        B = BT // ctx.T
        xt = x.reshape(B, ctx.T, C, Hs * Ws).permute(0, 3, 1, 2)
        xt = self.temporal_attention(xt, ctx, ctx.temb, ctx.fi, ctx.mask)
        xs = self.spatial_attention(xt.transpose(1, 2), ctx)
        return xs.permute(0, 1, 3, 2).reshape(BT, C, Hs, Ws)


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Blocks(nn.ModuleList):
    def forward(self, h, emb, ctx, skip=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                split = None
                if skip is not None:
                    split = h.shape[1]
                    h = torch.cat([h, skip], dim=1)
                    skip = None
                h = layer(h, emb, ctx, split)
            elif isinstance(layer, FactorizedAttentionBlock):
                h = layer(h, ctx)
            else:
                h = layer(h)
        return h


class _Ctx:
    pass


# channel_mult by image size (the reference's script_util)
CHANNEL_MULT = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4), 32: (1, 2, 2, 2)}


class UNet(nn.Module):
    """``UNet(cfg)`` from a configuration file's model keys: image_size,
    in_channels, num_channels, num_res_blocks, num_heads,
    attention_resolutions. ``forward(x, t, x0, frame_indices, obs_mask,
    latent_mask)`` as the port's: x, x0 (B, T, C, H, W); t (B,) the
    timesteps the model sees; frame_indices (B, T); masks (B, T, 1, 1, 1)."""

    def __init__(self, cfg):
        super().__init__()
        size, C, mc = cfg["image_size"], cfg["in_channels"], cfg["num_channels"]
        nrb, heads = cfg["num_res_blocks"], cfg["num_heads"]
        attn_ds = tuple(size // int(r) for r in str(cfg["attention_resolutions"]).split(","))
        mult = CHANNEL_MULT[size]
        self.mc, self.out_channels, self.recorder = mc, C, None
        ted = mc * 4
        self.time_embed = nn.Sequential(Linear(mc, ted), nn.SiLU(), Linear(ted, ted))
        self.input_blocks = nn.ModuleList([_Blocks([Conv2d(C + 1, mc, 3, padding=1)])])
        ch, chans, ds = mc, [mc], 1
        for level, m in enumerate(mult):
            for _ in range(nrb):
                layers = [ResBlock(ch, ted, m * mc)]
                ch = m * mc
                if ds in attn_ds:
                    layers.append(FactorizedAttentionBlock(ch, heads, ted))
                self.input_blocks.append(_Blocks(layers))
                chans.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(_Blocks([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = _Blocks([ResBlock(ch, ted, ch), FactorizedAttentionBlock(ch, heads, ted),
                                     ResBlock(ch, ted, ch)])
        self.output_blocks = nn.ModuleList()
        for level, m in reversed(list(enumerate(mult))):
            for i in range(nrb + 1):
                layers = [ResBlock(ch + chans.pop(), ted, mc * m)]
                ch = mc * m
                if ds in attn_ds:
                    layers.append(FactorizedAttentionBlock(ch, heads, ted))
                if level and i == nrb:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_Blocks(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, C, 3, padding=1, zero=True))

    def set_precision(self, name: str):
        """"float32" (the reference) or "fp8" (the control)."""
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        for m in self.modules():
            if isinstance(m, _Precision):
                m.lowp = name == "fp8"
        return self

    def forward(self, x, t, *, x0, frame_indices, obs_mask, latent_mask):
        B, T, C, Hs, Ws = x.shape
        ts = t[:, None].expand(B, T) if t.ndim == 1 else t
        ctx = _Ctx()
        ctx.T, ctx.fi, ctx.recorder = T, frame_indices, self.recorder
        ctx.mask = (obs_mask + latent_mask).clamp(0, 1).reshape(B, T)
        emb = self.time_embed(timestep_embedding(ts.reshape(B * T), self.mc))
        ctx.temb = emb.reshape(B, T, -1)
        obs = obs_mask.float()
        x_in = torch.cat([x * (1 - obs) + x0 * obs, torch.ones_like(x[:, :, :1]) * obs], dim=2)
        h = x_in.reshape(B * T, C + 1, Hs, Ws)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, ctx)
            hs.append(h)
        h = self.middle_block(h, emb, ctx)
        for block in self.output_blocks:
            h = block(h, emb, ctx, skip=hs.pop())
        return self.out(h).reshape(B, T, self.out_channels, Hs, Ws)
