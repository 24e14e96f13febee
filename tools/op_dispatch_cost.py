#!/usr/bin/env python3
"""Host cost per call of the port's kernel operators, by how they are bound.

    python3 tools/op_dispatch_cost.py [--calls 200] [--turns 2]

The three kernels (``spatial_attention``, ``temporal_rpe_attention``,
``skip_conv_stats``) at their smallest flagship bf16 shapes (ds 16), where the
card's work per launch is least, are called four ways:

  wrapper            the port's wrapper: the ``torch.ops.lfvdm`` operator,
                     defined with ``torch.library.Library`` and one
                     implementation per dispatch key, Autograd included
                     (``ops/_common.py``; what the port ships);
  launch             the CUDA implementation called directly (the ctypes
                     launch, no dispatcher): the floor of the host's work;
  autograd_function  an ``autograd.Function`` whose forward calls the launch:
                     how the kernels were bound before they were operators;
  register_autograd  the same ``Library`` operator with its autograd formula
                     registered through ``torch.library.register_autograd``;
  custom_op          ``torch.library.custom_op`` around the same launch, with
                     its autograd formula through ``register_autograd``.

Host µs per call: the stream first runs a spin kernel (~50 ms), and the host
clock times ``--calls`` calls queued behind it (no synchronisation inside),
so it reads what the host spends to issue each call, not the card's time.
Each way is timed under ``torch.no_grad()`` (serving, sampling) and with
inputs that require grad (training), in turns (A, B, C, D, D, C, B, A for
two turns); the least of the turns is kept. Prints one JSON line per kernel
and mode, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_LIBS = []  # the comparison libraries: a Library's registrations live as long as it does


def bindings():
    """{kernel: (its inputs at ds 16 on the card, {way: fn})}."""
    import torch

    from lfvdm_tpu_torch.ops import attention, skipconv

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    shp = chip_smoke.ATTN_SHAPES["ds16"]
    spatial = chip_smoke.spatial_inputs(shp["H"], shp["D"], shp["F"], bf16, gen)
    temporal = chip_smoke.temporal_inputs(shp["H"], shp["D"], shp["F"], bf16, gen)
    _, c1, c2, F, S = chip_smoke.SKIP_SHAPES[0]
    N = chip_smoke.FLAGSHIP_B * chip_smoke.FLAGSHIP_K

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    skip = (rnd(N, c1, S, S), rnd(N, c2, S, S), rnd(F, c1 + c2), rnd(F), rnd(N, F, S, S))
    kernels = {"spatial_attention": (spatial, attention.spatial_attention,
                                     attention._spatial_launch),
               "temporal_rpe_attention": (temporal, attention.temporal_rpe_attention,
                                          attention._temporal_launch),
               "skip_conv_stats": (skip, skipconv.skip_conv_stats, skipconv._launch)}
    lib = torch.library.Library("lfvdm_register_autograd", "DEF")
    _LIBS.append(lib)
    out = {}
    for name, (args, wrapper, launch) in kernels.items():

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *a, _launch=launch):
                ctx.save_for_backward(*a)
                return _launch(*a)

            @staticmethod
            def backward(ctx, *g):
                raise NotImplementedError

        out[name] = (args, {"wrapper": wrapper, "launch": launch,
                            "autograd_function": Fn.apply,
                            "register_autograd": _register_autograd(lib, name, launch),
                            "custom_op": _custom_op(name, len(args), launch)})
    return out


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _register_autograd(lib, name, launch):
    """The port's operator defined again in ``lib``'s namespace, with its
    autograd formula through ``torch.library.register_autograd``."""
    import torch

    op = getattr(torch.ops.lfvdm, name).default
    lib.define(str(op._schema).split("::", 1)[1])
    lib.impl(name, launch, "CUDA")
    torch.library.register_autograd(f"lfvdm_register_autograd::{name}",
                                    lambda ctx, *g: (None,) * len(op._schema.arguments),
                                    setup_context=_save_inputs, lib=lib)
    return getattr(torch.ops.lfvdm_register_autograd, name).default


def _custom_op(name, n_in, launch):
    """``torch.library.custom_op`` around ``launch``, in a namespace of its
    own, with an autograd formula that saves the inputs (as the port's
    operators do)."""
    import torch

    returns = ("tuple[torch.Tensor, torch.Tensor, torch.Tensor]" if name == "skip_conv_stats"
               else "torch.Tensor")
    names = ", ".join(f"a{i}" for i in range(n_in))
    params = ", ".join(f"a{i}: torch.Tensor" for i in range(n_in))
    scope = {"torch": torch, "launch": launch}
    # custom_op reads the operator's schema from the annotations.
    exec(f"def f({params}) -> {returns}:\n    return launch({names})\n", scope)
    custom = torch.library.custom_op(f"lfvdm_custom_op::{name}", scope["f"], mutates_args=(),
                                     device_types="cuda")
    custom.register_autograd(lambda ctx, *g: (None,) * n_in, setup_context=_save_inputs)
    return custom


def host_us(fn, args, calls):
    """Host µs per call of ``fn(*args)``, issued behind a spin kernel."""
    import torch

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(chip_smoke.HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=200)
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("op_dispatch_cost: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for name, (inputs, ways) in bindings().items():
        for mode in ("no_grad", "requires_grad"):
            if mode == "no_grad":
                call_args, ctx = inputs, torch.no_grad
            else:
                call_args = tuple(t.detach().clone().requires_grad_(t.is_floating_point())
                                  for t in inputs)
                ctx = torch.enable_grad
            order = list(ways)
            times = {w: [] for w in ways}
            with ctx():
                for _ in range(args.turns):
                    for w in order + order[::-1]:
                        times[w].append(host_us(ways[w], call_args, args.calls))
            row = {"kernel": name, "mode": mode, "card": smi, "calls": args.calls,
                   "host_us_per_call": {w: min(v) for w, v in times.items()},
                   "host_us_all_turns": times}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
