"""Convert the ``lpips`` package's AlexNet-LPIPS weights into the embedder
``.npz`` both packages read, and check the port's embedder against it
(counterpart of the repo's scripts/convert_lpips.py).

    python -m lfvdm_tpu_torch.scripts.convert_lpips --out weights/lpips_alex.npz [--device cuda]

Needs the ``lpips`` package (its AlexNet downloads the first time). Writes
the five convolutions' kernels in HWIO with their biases and the five
non-negative head weights flattened, the file the JAX script writes, so
``$LFVDM_LPIPS_WEIGHTS`` names one file for both packages. Then the port's
``LpipsEmbedder`` on that file, on ``--device``, must give squared embedding
distances equal to ``lpips``' distances there (f32, TF32 off) to rtol 1e-3
on two seeded (2, 3, 64, 64) batches. A mismatch raises after the file is
written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..evals.lpips import LpipsEmbedder
from ..utils.convert import LPIPS_STAGES, lpips_npz_from_state_dict
from ..utils.device import full_f32, resolve_device


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="weights/lpips_alex.npz")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def convert(convs, lins):
    """The source's arrays (tensors or numpy) -> the embedder ``.npz`` dict.

    ``convs``: AlexNet's five convolutions in order, each (weight (out, in, k,
    k), bias); ``lins``: the five heads' 1x1 conv weights (1, C, 1, 1)."""
    convs, lins = list(convs), list(lins)
    if len(convs) != LPIPS_STAGES or len(lins) != LPIPS_STAGES:
        raise ValueError(f"expected {LPIPS_STAGES} convolutions and heads, got "
                         f"{len(convs)} and {len(lins)}")
    state_dict = {}
    for i, (weight, bias) in enumerate(convs, start=1):
        state_dict[f"conv{i}_weight"], state_dict[f"conv{i}_bias"] = weight, bias
    for i, weight in enumerate(lins):
        state_dict[f"lin{i}"] = weight
    return lpips_npz_from_state_dict(state_dict)


def main(argv=None):
    """Returns the written ``.npz`` path."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    try:
        import lpips
    except ImportError as e:
        raise ImportError("convert_lpips needs the lpips package") from e

    net = lpips.LPIPS(net="alex", spatial=False)
    net.eval()
    convs = [(m.weight, m.bias) for m in net.net.modules() if isinstance(m, torch.nn.Conv2d)]
    out = convert(convs, [lin.model[-1].weight for lin in net.lins])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **out)
    print(f"saved {args.out}")

    emb = LpipsEmbedder(weights_path=args.out, device=device)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    net.to(device)
    with torch.no_grad(), full_f32():
        ours = ((emb(x) - emb(y)) ** 2).sum(axis=1)
        ref = net(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    ref = ref.cpu().numpy().reshape(-1)
    print("ours:", ours, "ref:", ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-3)
    print("validation OK")
    return args.out


if __name__ == "__main__":
    main()
