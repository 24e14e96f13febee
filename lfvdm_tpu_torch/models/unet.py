"""Frame-indexed video U-Net (counterpart of lfvdm_tpu/models/unet.py).

A 2-D U-Net applied per frame with factorized spatio-temporal attention, an
obs-indicator input channel, frame-index conditioned RPE temporal attention
and two-group attention masking. Activations are NCHW over (B·T) frames in
the compute dtype; GroupNorm and softmax reduce in f32, and the output head
runs in f32 (a bf16 head quantizes away the x0 signal in the early sampler
steps).

Module names follow the reference checkpoint (``time_embed.0/2``,
``input_blocks.{i}``, ``middle_block``, ``output_blocks.{j}``, ``out.0/2``,
``in_layers``/``emb_layers``/``out_layers``/``skip_connection``, ...), so
``lfvdm_tpu.utils.torch_convert.convert_unet_state_dict`` maps this model's
``state_dict`` into the JAX parameter tree and ``utils/convert.py`` maps it
back.

The up path follows the JAX package's: each up ResBlock's input GroupNorm
takes per-part channel sums (of h and of the skip tensor) instead of reading
the concat again, and with ``fused_skip_conv`` (the default) its 1x1 skip
projection, residual add and the output's channel sums run as one CUDA
kernel (``ops.skipconv.skip_conv_stats``) that reads h and the skip tensor in
place; the next ResBlock takes those sums when nothing came between. The
JAX package's other TPU-only rewrites (split up path, dilated upsample conv,
remat policies) are not ported: this module runs the plain forms they equal
(concat + conv, nearest + conv).

``use_checkpoint`` is the counterpart of JAX's ``nn.remat`` of each ResBlock
and FactorizedAttentionBlock: in training each such block keeps only its
inputs and runs its forward again in the backward pass
(``torch.utils.checkpoint``, non-reentrant), so its kernels launch twice per
step. The recompute draws the same dropout masks as the forward, as JAX's
remat replays the same key (``_remat``).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from ..ops.skipconv import skip_conv_stats
from .nn import Conv2d, GroupNorm32, Linear, channel_sums, timestep_embedding
from .rpe import RPEAttention


class Dropout(nn.Module):
    """Inverted dropout whose masks come from ``self.generator``.

    ``nn.Dropout`` draws from torch's global generator, so a run's seed would
    not reach it; ``set_dropout_generator`` hands every ResBlock the run's own
    generator (None: the global one). ``p == 0`` and eval mode draw nothing."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Draw every dropout mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _remat(fn, generator, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint``, its
    recompute drawing the same random numbers from ``generator`` as the
    forward did. (``checkpoint`` restores the global RNGs itself, not an
    explicit generator's.) The recompute puts the generator back where the
    forward left it, so the run's stream goes on unchanged."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    start = generator.get_state()
    ran = []

    def replay(*a, **kw):
        if not ran:  # the forward
            ran.append(True)
            return fn(*a, **kw)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, **kw)
        finally:
            generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(replay, *args, use_reentrant=False, **kwargs)


def _rematerialises(block: nn.Module) -> bool:
    return block.use_checkpoint and block.training and torch.is_grad_enabled()


class ResBlock(nn.Module):
    """Residual block with timestep-embedding conditioning."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int, *,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False,
                 use_checkpoint: bool = False, dtype=torch.float32):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_checkpoint = use_checkpoint
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out_channels, 3, padding=1, dtype=dtype))
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels,
                   dtype=dtype))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), Dropout(dropout),
            Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype, zero=True))
        if out_channels != channels:
            self.skip_connection = Conv2d(channels, out_channels, 1, dtype=dtype)
        else:
            self.skip_connection = nn.Identity()

    def forward(self, x, emb, *, in_stats=None, parts=None, impl: str = "auto"):
        """Returns ``(out, out_stats)``.

        ``in_stats``: optional per-channel (Σx, Σx²) for the input GroupNorm
        (the up path's, taken from the two parts of the concat x).
        ``parts``: the two halves (h, skip) of the concat x. With them the
        skip projection, the residual add and the output's channel sums run
        as one ``skip_conv_stats`` call, and ``out_stats`` holds those sums;
        otherwise ``out_stats`` is None. ``impl="plain"`` asks that call for
        its plain version."""
        if _rematerialises(self):
            return _remat(self._forward, self.out_layers[2].generator, x, emb, in_stats, parts,
                          impl)
        return self._forward(x, emb, in_stats, parts, impl)

    def _forward(self, x, emb, in_stats, parts, impl):
        h = self.in_layers[0](x, precomputed_sums=in_stats)
        h = self.in_layers[2](self.in_layers[1](h))
        emb_out = self.emb_layers(emb)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[1:](h)
        else:
            h = self.out_layers(h + emb_out)
        if parts is None:
            return self.skip_connection(x) + h, None
        conv = self.skip_connection
        dt = conv.compute_dtype
        y, s1, s2 = skip_conv_stats(parts[0].to(dt), parts[1].to(dt), conv.weight.to(dt),
                                    conv.bias.to(dt), h, impl=impl)
        return y, (s1, s2)


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, *, dtype=torch.float32):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample + 3x3 conv."""

    def __init__(self, channels: int, *, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class FactorizedAttentionBlock(nn.Module):
    """Temporal (RPE, masked) then spatial attention over (B·T, C, H, W)."""

    def __init__(self, channels: int, num_heads: int, use_rpe_net: bool, time_embed_dim: int, *,
                 use_checkpoint: bool = False, dtype=torch.float32):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.temporal_attention = RPEAttention(
            channels, num_heads, use_rpe_net=use_rpe_net, time_embed_dim=time_embed_dim,
            dtype=dtype)
        self.spatial_attention = RPEAttention(
            channels, num_heads, use_rpe_q=False, use_rpe_k=False, use_rpe_v=False,
            dtype=dtype)

    def forward(self, x, temb, frame_indices, attn_mask, *, T: int,
                return_attn: bool = False, impl: str = "auto"):
        if _rematerialises(self):
            return _remat(self._forward, None, x, temb, frame_indices, attn_mask, T=T,
                          return_attn=return_attn, impl=impl)
        return self._forward(x, temb, frame_indices, attn_mask, T=T, return_attn=return_attn,
                             impl=impl)

    def _forward(self, x, temb, frame_indices, attn_mask, *, T, return_attn, impl):
        BT, C, Hs, Ws = x.shape
        B = BT // T
        # Temporal: tokens = frames, batched over pixel sites.
        xt = x.reshape(B, T, C, Hs * Ws).permute(0, 3, 1, 2)  # (B, HW, T, C)
        xt, attn_t = self.temporal_attention(
            xt, temb=temb, frame_indices=frame_indices, attn_mask=attn_mask,
            return_attn=return_attn, impl=impl)
        # Spatial: tokens = pixels, batched over frames. No RPE, no mask.
        xs, attn_s = self.spatial_attention(
            xt.transpose(1, 2), return_attn=return_attn, impl=impl)  # (B, T, HW, C)
        out = xs.permute(0, 1, 3, 2).reshape(BT, C, Hs, Ws)
        attns = None
        if return_attn:
            # Per layer (B, T, T) and (B, HW, HW): |mean over heads and sites|.
            attns = {"temporal": attn_t.mean(dim=(1, 2)).abs(),
                     "spatial": attn_s.mean(dim=(1, 2)).abs()}
        return out, attns


class _Blocks(nn.ModuleList):
    """A sequence of U-Net layers; each is called with what it needs.

    On the up path ``skip`` is the skip tensor that the first layer (a
    ResBlock) concatenates with h, ``in_stats`` that block's input sums, and
    ``fused`` routes its skip projection through ``skip_conv_stats``.
    Returns (h, attention weights, the channel sums of h when the last layer
    emitted them, else None)."""

    def forward(self, h, emb, attn_args, *, skip=None, in_stats=None, fused=False):
        attns = []
        stats = None
        for layer in self:
            if isinstance(layer, ResBlock):
                if skip is None:
                    h, stats = layer(h, emb)
                else:
                    x = torch.cat([h, skip], dim=1)
                    h, stats = layer(x, emb, in_stats=in_stats,
                                     parts=(h, skip) if fused else None,
                                     impl=attn_args[1]["impl"])
                    skip = None
            elif isinstance(layer, FactorizedAttentionBlock):
                h, a = layer(h, *attn_args[0], **attn_args[1])
                attns.append(a)
                stats = None
            else:
                h = layer(h)
                stats = None
        return h, attns, stats


class UNetVideoModel(nn.Module):
    """The full video U-Net.

    ``forward(x, timesteps, *, x0, frame_indices, obs_mask, latent_mask)``:
      x:             (B, T, C, H, W) noisy frames (f32)
      timesteps:     (B,) or (B, T) diffusion steps (may be fractional)
      x0:            (B, T, C, H, W) clean frames (observed content)
      frame_indices: (B, T) int — absolute frame positions in the video
      obs_mask:      (B, T, 1, 1, 1) — 1 where the frame is observed
      latent_mask:   (B, T, 1, 1, 1) — 1 where the frame is being generated
    Returns (out, attns): out (B, T, out_C, H, W) f32; attns is None unless
    ``return_attn_weights``; with ``return_features`` (out, attns, features)
    (see ``forward``). ``impl="plain"`` runs every kernel's plain
    version (for comparisons on the card). ``fused_skip_conv`` (an attribute
    that may be changed after construction) routes the up path's skip
    projections through ``ops.skipconv.skip_conv_stats``. ``use_checkpoint``
    rematerialises each ResBlock and FactorizedAttentionBlock in training
    (see the module docstring).
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int], *,
                 dropout: float = 0.0, channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 num_heads: int = 1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, use_rpe_net: bool = True,
                 fused_skip_conv: bool = True, use_checkpoint: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.fused_skip_conv = fused_skip_conv
        self.in_channels, self.out_channels = in_channels, out_channels
        self.model_channels, self.dtype = model_channels, dtype
        self.num_res_blocks, self.channel_mult = num_res_blocks, tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        ted = model_channels * 4

        def res(ch_in, ch_out):
            return ResBlock(ch_in, ted, ch_out, dropout=dropout,
                            use_scale_shift_norm=use_scale_shift_norm,
                            use_checkpoint=use_checkpoint, dtype=dtype)

        def attn(ch, heads):
            return FactorizedAttentionBlock(ch, heads, use_rpe_net, ted,
                                            use_checkpoint=use_checkpoint, dtype=dtype)

        self.time_embed = nn.Sequential(
            Linear(model_channels, ted, dtype=dtype), nn.SiLU(), Linear(ted, ted, dtype=dtype))

        self.input_blocks = nn.ModuleList(
            [_Blocks([Conv2d(in_channels + 1, model_channels, 3, padding=1, dtype=dtype)])])
        ch = model_channels
        skip_chs = [ch]
        ds = 1
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attn(ch, num_heads))
                self.input_blocks.append(_Blocks(layers))
                skip_chs.append(ch)
            if level != len(self.channel_mult) - 1:
                self.input_blocks.append(_Blocks([Downsample(ch, dtype=dtype)]))
                skip_chs.append(ch)
                ds *= 2

        self.middle_block = _Blocks([res(ch, ch), attn(ch, num_heads), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skip_chs.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in self.attention_resolutions:
                    layers.append(attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dtype=dtype))
                    ds //= 2
                self.output_blocks.append(_Blocks(layers))

        self.out = nn.Sequential(
            GroupNorm32(ch, out_dtype=torch.float32), nn.SiLU(),
            Conv2d(ch, out_channels, 3, padding=1, dtype=torch.float32, zero=True))

    def forward(self, x, timesteps, *, x0, frame_indices, obs_mask, latent_mask,
                return_attn_weights: bool = False, impl: str = "auto", features=None,
                return_features: bool = False):
        """See the class docstring. Encoder reuse (arXiv:2312.09608): with
        ``return_features`` the call also returns ``(middle_h, skips)``;
        passing that tuple back as ``features`` skips the stem, the down path
        and the middle and runs only the up path and the head, with the
        timestep embedding of *this* call. ``features=None`` is the full
        forward."""
        B, T, C, Hs, Ws = x.shape
        if timesteps.ndim == 1:
            timesteps = timesteps[:, None].expand(B, T)
        attn_mask = (obs_mask + latent_mask).clamp(0, 1).reshape(B, T)

        emb = timestep_embedding(timesteps.reshape(B * T), self.model_channels)
        emb = self.time_embed(emb.to(self.dtype))
        temb_bt = emb.reshape(B, T, -1)  # for RPENet
        attn_args = ((temb_bt, frame_indices, attn_mask),
                     dict(T=T, return_attn=return_attn_weights, impl=impl))

        attns = []
        if features is None:
            # Observed frames bypass noising; an indicator channel marks them.
            obs = obs_mask.to(x.dtype)
            indicator = torch.ones_like(x[:, :, :1]) * obs
            if os.environ.get("LFVDM_BREAK_OBS_INDICATOR", "0") == "1":
                # DIAGNOSTIC ONLY: the network can no longer tell observed
                # frames from latents (the quality gate's broken-arm calibration).
                print("WARNING: LFVDM_BREAK_OBS_INDICATOR=1 — obs-indicator "
                      "channel ZEROED (diagnostic broken-arm)")
                indicator = torch.zeros_like(indicator)
            x_in = torch.cat([x * (1 - obs) + x0 * obs, indicator], dim=2)
            h = x_in.reshape(B * T, C + 1, Hs, Ws).to(self.dtype)
            hs = []
            for block in self.input_blocks:
                h, a, _ = block(h, emb, attn_args)
                attns += a
                hs.append(h)
            h, a, _ = self.middle_block(h, emb, attn_args)
            attns += a
        else:
            h, skips = features
            hs = list(skips)
        out_features = (h, tuple(hs)) if return_features else None
        # Up path: the input GroupNorm of each block takes per-part channel
        # sums; the h part comes from the previous block's skip projection
        # when it emitted them and nothing came between.
        prev_stats = None
        for block in self.output_blocks:
            skip = hs.pop()
            h_s1, h_s2 = prev_stats if prev_stats is not None else channel_sums(h)
            k_s1, k_s2 = channel_sums(skip)
            in_stats = (torch.cat([h_s1, k_s1], dim=1), torch.cat([h_s2, k_s2], dim=1))
            h, a, prev_stats = block(h, emb, attn_args, skip=skip, in_stats=in_stats,
                                     fused=self.fused_skip_conv)
            attns += a

        out = self.out(h).reshape(B, T, self.out_channels, Hs, Ws)
        weights = None
        if return_attn_weights:
            weights = {"temporal": [a["temporal"] for a in attns],
                       "spatial": [a["spatial"] for a in attns]}
        if return_features:
            return out, weights, out_features
        return out, weights


def fused_skip_blocks(model: nn.Module) -> int:
    """Number of up-path ResBlocks whose skip projection runs
    ``skip_conv_stats`` per forward when ``fused_skip_conv`` is on."""
    return sum(isinstance(b[0], ResBlock) for b in model.output_blocks)


def attention_blocks(model: nn.Module) -> int:
    """Number of FactorizedAttentionBlocks in ``model`` (each runs one temporal
    and one spatial attention per forward)."""
    return sum(isinstance(m, FactorizedAttentionBlock) for m in model.modules())
