"""Relative-position (frame-distance) attention (counterpart of lfvdm_tpu/models/rpe.py).

iRPE-style relative position on q, k and v, a continuous RPENet conditioned
on diffusion time (or a clipped lookup table), and the two-group masked
softmax. Attention math runs in f32 whatever the torso dtype.

``RPEAttention`` takes (B, D, T, C) and attends over T, batched over (B, D).
With RPE on all of q, k and v it calls ``ops.attention.temporal_rpe_attention``;
with none it calls ``ops.attention.spatial_attention``; each launches its
CUDA kernel for CUDA tensors and its plain version for CPU tensors. Attention
weights (``return_attn=True``) and partial RPE take the einsum path here,
since the kernels cannot return weights.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, spatial_attention, temporal_rpe_attention
from .nn import GroupNorm32, Linear


def _break_two_group() -> bool:
    if os.environ.get("LFVDM_BREAK_TWO_GROUP", "0") != "1":
        return False
    # DIAGNOSTIC ONLY: reintroduces the mask-semantics bug the two-group
    # softmax exists to prevent (real frames attend to padding frames), for
    # the quality gate's broken-arm calibration.
    print("WARNING: LFVDM_BREAK_TWO_GROUP=1 — two-group masked softmax "
          "DISABLED (diagnostic broken-arm; never use in production)")
    return True


class RPENet(nn.Module):
    """(diffusion-time embedding, signed frame distance) -> (B, T, T, heads, C/heads).

    Distance features are [log1p(d⁺), log1p(d⁻), 1(d=0)]; the output
    projection is a zero module, so RPE starts as a no-op.
    """

    def __init__(self, channels: int, num_heads: int, time_embed_dim: int, *,
                 dtype=torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.dtype = channels, num_heads, dtype
        self.embed_distances = Linear(3, channels, dtype=dtype)
        self.embed_diffusion_time = Linear(time_embed_dim, channels, dtype=dtype)
        self.out = Linear(channels, channels, dtype=dtype, zero=True)

    def forward(self, temb: torch.Tensor, relative_distances: torch.Tensor) -> torch.Tensor:
        B, T, _ = relative_distances.shape
        d = relative_distances.to(torch.float32)
        distance_embs = torch.stack(
            [torch.log1p(d.clamp(min=0)), torch.log1p((-d).clamp(min=0)), (d == 0).float()],
            dim=-1,
        )  # (B, T, T, 3)
        emb = self.embed_diffusion_time(temb)[:, :, None, :] + self.embed_distances(distance_embs)
        out = self.out(F.silu(emb))
        return out.reshape(B, T, T, self.num_heads, self.channels // self.num_heads)


class RPE(nn.Module):
    """Relative-position bias provider: RPENet or a clipped lookup table."""

    def __init__(self, channels: int, num_heads: int, use_rpe_net: bool, time_embed_dim: int, *,
                 rpe_beta: int = 64, dtype=torch.float32):
        super().__init__()
        self.use_rpe_net, self.rpe_beta, self.dtype = use_rpe_net, rpe_beta, dtype
        if use_rpe_net:
            self.rpe_net = RPENet(channels, num_heads, time_embed_dim, dtype=dtype)
        else:
            self.lookup_table_weight = nn.Parameter(
                torch.zeros(2 * rpe_beta + 1, num_heads, channels // num_heads))

    def forward(self, pairwise_distances: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        if self.use_rpe_net:
            return self.rpe_net(temb, pairwise_distances)
        idx = pairwise_distances.long().clamp(-self.rpe_beta, self.rpe_beta) + self.rpe_beta
        return self.lookup_table_weight[idx].to(self.dtype)  # (B, T, T, H, F)


def two_group_softmax(logits: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis with two-group connectivity, in f32.

    ``logits``: (B, D, H, T, S); ``attn_mask``: (B, T) in {0, 1}. Tokens with
    mask 1 attend only among themselves, tokens with mask 0 likewise.
    """
    logits = logits.float()
    if _break_two_group():
        attn_mask = None
    if attn_mask is not None:
        m = attn_mask.float()
        allowed = m[:, :, None] * m[:, None, :] + (1 - m[:, :, None]) * (1 - m[:, None, :])
        logits = torch.where((allowed > 0)[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1)


class RPEAttention(nn.Module):
    """Pre-norm multi-head attention over axis T with optional RPE on q/k/v.

    Input and output (B, D, T, C). The residual adds the attention output to
    the *normalized* input (the reference's quirk). ``forward`` returns
    ``(out, attn)``; ``attn`` is the (B, D, H, T, T) f32 softmax when
    ``return_attn``, else None. ``time_embed_dim`` is the width of ``temb``
    (only used with ``use_rpe_net``).
    """

    def __init__(self, channels: int, num_heads: int, *, use_rpe_q: bool = True,
                 use_rpe_k: bool = True, use_rpe_v: bool = True, use_rpe_net: bool = False,
                 time_embed_dim: int = 0, dtype=torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.dtype = channels, num_heads, dtype
        self.use_rpe_q, self.use_rpe_k, self.use_rpe_v = use_rpe_q, use_rpe_k, use_rpe_v
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype)
        self.proj_out = Linear(channels, channels, dtype=dtype, zero=True)
        for which, on in (("rpe_q", use_rpe_q), ("rpe_k", use_rpe_k), ("rpe_v", use_rpe_v)):
            if on:
                setattr(self, which, RPE(channels, num_heads, use_rpe_net, time_embed_dim,
                                         dtype=dtype))

    def forward(self, x, temb=None, frame_indices=None, attn_mask=None, return_attn=False,
                impl: str = "auto"):
        """``impl``: "auto" (kernels on the card, plain versions on the CPU)
        or "plain" (plain versions everywhere)."""
        B, D, T, C = x.shape
        H = self.num_heads
        Fh = C // H
        scale = Fh ** -0.5

        # GroupNorm over (B·D, C, T): statistics over the T tokens and the
        # group's channels.
        h = self.norm(x.reshape(B * D, T, C).transpose(1, 2)).transpose(1, 2).reshape(B, D, T, C)
        qkv = self.qkv(h).reshape(B, D, T, 3, H, Fh)
        # (B, D, H, T, F) each
        q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))

        any_rpe = self.use_rpe_q or self.use_rpe_k or self.use_rpe_v
        all_rpe = self.use_rpe_q and self.use_rpe_k and self.use_rpe_v
        if any_rpe:
            if frame_indices is None:
                raise ValueError("RPE attention needs frame_indices")
            pd = frame_indices[:, :, None] - frame_indices[:, None, :]  # d[t, s]

        if not return_attn and not any_rpe and attn_mask is None:
            out = spatial_attention(q * scale, k, v, impl=impl)  # (B, D, H, T, F)
            return h + self.proj_out(self._merge_heads(out)), None

        if not return_attn and all_rpe:
            R_k = self.rpe_k(pd, temb)  # (B, T, S, H, F)
            R_q = self.rpe_q(pd, temb)
            R_v = self.rpe_v(pd, temb)
            qk = (q * scale).permute(0, 2, 3, 4, 1)     # (B, H, T, F, D)
            kk = k.permute(0, 2, 3, 4, 1)
            vk = v.permute(0, 2, 3, 4, 1)
            r_k = R_k.permute(0, 3, 1, 2, 4)            # (B, H, T, S, F)
            r_q_t = R_q.permute(0, 3, 2, 1, 4) * scale  # r_q_t[t, s] = R_q[s, t]·scale
            r_v_t = R_v.permute(0, 3, 1, 4, 2)          # (B, H, T, F, S)
            if attn_mask is None or _break_two_group():
                m = torch.ones(B, T, dtype=torch.float32, device=x.device)
            else:
                m = attn_mask.float()
            out = temporal_rpe_attention(qk, kk, vk, r_k, r_q_t, r_v_t, m, impl=impl)
            out = out.permute(0, 4, 1, 2, 3)            # (B, D, H, T, F)
            return h + self.proj_out(self._merge_heads(out)), None

        f32 = torch.float32
        logits = torch.einsum("bdhtf,bdhsf->bdhts", (q * scale).to(f32), k.to(f32))
        if self.use_rpe_k:
            R_k = self.rpe_k(pd, temb)
            logits = logits + torch.einsum("bdhtf,btshf->bdhts", (q * scale).to(f32), R_k.to(f32))
        if self.use_rpe_q:
            # Contribution(t, s) = (k_s · scale) · R_q[s, t]
            R_q = self.rpe_q(pd, temb)
            logits = logits + torch.einsum("bdhsf,bsthf->bdhts", (k * scale).to(f32), R_q.to(f32))
        attn = two_group_softmax(logits, attn_mask)
        attn_c = attn.to(self.dtype).to(f32)
        out = torch.einsum("bdhts,bdhsf->bdhtf", attn_c, v.to(f32))
        if self.use_rpe_v:
            R_v = self.rpe_v(pd, temb)
            out = out + torch.einsum("bdhts,btshf->bdhtf", attn_c, R_v.to(f32))
        result = h + self.proj_out(self._merge_heads(out.to(self.dtype)))
        return result, (attn if return_attn else None)

    def _merge_heads(self, out):
        """(B, D, H, T, F) -> (B, D, T, C) in the compute dtype."""
        B, D, H, T, Fh = out.shape
        return out.to(self.dtype).transpose(2, 3).reshape(B, D, T, H * Fh)
