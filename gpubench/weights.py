"""Weights made from the seed on the device, in a few large calls.

``seeded_state(module, seed, device)`` walks a module built on the ``meta``
device (the reference's, whose parameter names are the program's) and
returns a state dict of float32 tensors: every convolution and linear layer
uniform in ±1/√fan_in (torch's default init), those marked ``zero`` (the
layers the architecture starts at zero: each residual branch's last conv,
each attention's output, the relative-position nets' output, the head)
within a tenth of that bound, so that the network's output is neither zero
nor chaotic in bf16; GroupNorm at (1, 0); a blend factor at 0.5. All values
come from one ``torch.rand`` on ``device`` from a generator seeded with
``seed``: the same seed gives the same weights on either side."""

from __future__ import annotations

import math

import torch
from torch import nn

ZERO_MODULE_SCALE = 0.1


def seeded_state(module: nn.Module, seed: int, device, prefix: str = "") -> dict:
    layers, fixed = [], {}
    for mname, m in module.named_modules():
        full = prefix + mname + ("." if mname else "")
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            b = (ZERO_MODULE_SCALE if getattr(m, "zero", False) else 1.0) \
                / math.sqrt(m.weight[0].numel())
            layers.append((full + "weight", tuple(m.weight.shape), b))
            layers.append((full + "bias", tuple(m.bias.shape), b))
        elif isinstance(m, nn.GroupNorm):
            fixed[full + "weight"] = (tuple(m.weight.shape), 1.0)
            fixed[full + "bias"] = (tuple(m.bias.shape), 0.0)
        elif mname.endswith("time_mixer"):
            fixed[full + "mix_factor"] = ((1,), 0.5)
    total = sum(math.prod(s) for _, s, _ in layers)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, b in layers:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(b)
        at += n
    for name, (shape, v) in fixed.items():
        out[name] = torch.full(shape, v, device=device)
    names = {prefix + n for n, _ in module.named_parameters()}
    if set(out) != names:
        raise ValueError(f"weights for {sorted(set(out) ^ names)[:5]} not made")
    return out
