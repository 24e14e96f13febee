"""The fused GroupNorm, scale-shift and SiLU operator (``ops/groupnorm.py``)
on the CPU, where it runs its plain version.

- Its CPU route is bit for bit the chain the U-Net's modules computed before
  the operator existed (``GroupNorm32`` → ``* (1 + scale) + shift`` →
  ``nn.SiLU``, written out here as it stood), its fake implementation gives
  the output's shape and dtype, and its autograd route's gradients are
  autograd's through that chain: bf16 and f32 inputs, statistics from x or
  from given channel sums, with and without scale and shift, and the output
  head's f32 output.
- The U-Net routes every ResBlock norm and the head through it when
  ``_fuses_norms`` says so (on the card, without gradients): forced on the
  CPU, the forward is bitwise the modules' forward, with one call per norm;
  ``GroupNorm32.silu(..., fused=False)`` is the modules' chain bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.models import unet
from lfvdm_tpu_torch.models.nn import GroupNorm32, channel_sums
from lfvdm_tpu_torch.ops import groupnorm


def _chain_before_the_operator(x, weight, bias, groups, eps, out_dtype, sums, scale, shift):
    """``GroupNorm32.forward`` and the ResBlock's chain after it, as written
    before the operator (outside ``saved_group_stats``)."""
    N, C = x.shape[:2]
    G = groups
    if sums is None:
        h = F.group_norm(x.float(), G, weight, bias, eps).to(out_dtype or x.dtype)
    else:
        n_red = x[0, 0].numel() * (C // G)
        s1, s2 = sums
        g_mean = s1.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red
        g_var = (s2.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red
                 - g_mean.square()).clamp(min=0.0)
        mul = torch.rsqrt(g_var + eps) * weight.reshape(G, C // G)
        add = bias.reshape(G, C // G) - g_mean * mul
        bshape = (N, C) + (1,) * (x.ndim - 2)
        h = torch.addcmul(add.reshape(bshape), x, mul.reshape(bshape)).to(out_dtype or x.dtype)
    if scale is not None:
        h = h * (1 + scale) + shift
    return torch.nn.SiLU()(h)


CASES = [(dtype, sums, scale_shift, None)
         for dtype in (torch.float32, torch.bfloat16)
         for sums in (False, True)
         for scale_shift in (False, True)]
CASES += [(torch.bfloat16, False, False, torch.float32),  # the output head
          (torch.float32, False, False, torch.float32),
          (torch.bfloat16, True, True, torch.float32)]


@pytest.mark.parametrize("C", [64, 48])
@pytest.mark.parametrize("dtype,sums,scale_shift,out_dtype", CASES)
def test_operator_is_the_modules_chain(dtype, sums, scale_shift, out_dtype, C):
    g = torch.Generator().manual_seed(C + 7 * len(str(dtype)) + 3 * sums + scale_shift)
    N, H, W = 3, 4, 5
    norm = GroupNorm32(C, out_dtype=out_dtype)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
        norm.bias.copy_(0.2 * torch.randn(C, generator=g))
    x = (0.7 + 1.3 * torch.randn(N, C, H, W, generator=g)).to(dtype)
    emb = (0.3 * torch.randn(N, 2 * C, 1, 1, generator=g)).to(out_dtype or dtype)
    scale, shift = emb.chunk(2, dim=1) if scale_shift else (None, None)
    s = channel_sums(x) if sums else None
    G, eps = norm.num_groups, norm.eps
    want = _chain_before_the_operator(x, norm.weight, norm.bias, G, eps, out_dtype, s, scale,
                                      shift)
    with torch.no_grad():
        got = norm.silu(x, sums=s, scale=scale, shift=shift)
        unfused = norm.silu(x, sums=s, scale=scale, shift=shift, fused=False)
    assert got.dtype == want.dtype == unfused.dtype == (out_dtype or dtype)
    assert torch.equal(got, want) and torch.equal(unfused, want)
    # the module keeps computing the same norm
    assert torch.equal(norm(x, precomputed_sums=s),
                       groupnorm.group_norm_plain(x, G, norm.weight, norm.bias, eps, out_dtype, s))

    op = torch.ops.lfvdm.group_norm_silu.default
    s1, s2 = s if sums else (None, None)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) if t is not None else None
                    for t in (x, norm.weight, norm.bias, scale, shift, s1, s2)),
                  G, eps, out_dtype)
    assert fake.shape == x.shape and fake.dtype == want.dtype

    # autograd: the operator's gradients are the chain's
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in (x, norm.weight, norm.bias, scale, shift, s1, s2)]
    cot = torch.randn(x.shape, generator=g).to(want.dtype)
    present = [t for t in leaves if t is not None]
    out = op(*leaves, G, eps, out_dtype)
    grads = torch.autograd.grad(out, present, cot)
    lx, lw, lb, lsc, lsh, l1, l2 = leaves
    ref = _chain_before_the_operator(lx, lw, lb, G, eps, out_dtype,
                                     (l1, l2) if sums else None, lsc, lsh)
    ref_grads = torch.autograd.grad(ref, present, cot)
    assert torch.equal(out, ref)
    for a, b in zip(grads, ref_grads):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unet_routes_every_norm_through_the_operator(monkeypatch):
    """Forced on the CPU, the fused route is the modules' forward bitwise,
    with one operator call per ResBlock norm and one for the head."""
    cfg = dict(flagship_config(tiny=True), compute_dtype="bfloat16")
    model, _ = create_model_and_diffusion(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    B, K, C, S = 2, 3, cfg["in_channels"], cfg["image_size"]
    x = torch.randn(B, K, C, S, S, generator=g)
    obs = torch.zeros(B, K, 1, 1, 1)
    obs[:, :1] = 1
    kw = dict(x0=torch.randn(B, K, C, S, S, generator=g),
              frame_indices=torch.arange(K)[None].expand(B, K), obs_mask=obs,
              latent_mask=1 - obs)
    t = torch.tensor([3.0, 5.0])
    with torch.no_grad():
        want, _ = model(x, t, **kw)
    calls = []
    real = GroupNorm32.silu

    def spy(self, h, *, fused=True, **kwargs):
        if fused:
            calls.append((tuple(h.shape), h.dtype, {k: v is not None for k, v in kwargs.items()}))
        return real(self, h, fused=fused, **kwargs)

    monkeypatch.setattr(GroupNorm32, "silu", spy)
    monkeypatch.setattr(unet, "_fuses_norms", lambda impl, *a: impl != "plain")
    with torch.no_grad():
        got, _ = model(x, t, **kw)
        plain, _ = model(x, t, impl="plain", **kw)
    assert torch.equal(got, want) and torch.equal(plain, want)
    n_up = unet.fused_skip_blocks(model)
    assert sum(c[2].get("sums", False) for c in calls) == n_up  # the up path's input norms
    assert sum(c[2].get("scale", False) for c in calls) == len(calls) // 2  # every out norm
    assert calls[-1][1] == torch.bfloat16  # the head reads the bf16 torso, emits f32
    assert len(calls) == 2 * sum(isinstance(m, unet.ResBlock) for m in model.modules()) + 1


def test_route_needs_the_card_and_no_gradient():
    block = unet.ResBlock(32, 64, 32)
    x = torch.zeros(1, 32, 4, 4)
    assert not unet._fuses_norms("auto", x, None, block)  # the CPU keeps the modules
    assert not unet._fuses_norms("plain", x, None, block)
