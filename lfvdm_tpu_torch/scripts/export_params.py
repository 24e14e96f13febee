"""Export sampleable params (EMA or raw) from a training run directory
(counterpart of the repo's scripts/export_params.py).

    python -m lfvdm_tpu_torch.scripts.export_params CKPT_DIR [--step N] [--ema_rate 0.9999|raw]

Reads a run directory of the port's ``video_train`` and writes
``<ckpt_dir>/export/params_{rate}_{step:06d}.msgpack`` with ``config.json``
beside it: the weights in the JAX package's parameter tree, serialised as
``flax.serialization.to_bytes`` does (``utils/msgpack.py``), so the JAX
``scripts/video_sample.py`` reads the file as it reads its own exports, and
the port's ``video_sample`` reads it too. The run directory stays the source
of truth for resuming.
"""

from __future__ import annotations

import argparse
import json
import os

from ..config import CHANNEL_MULT_BY_IMAGE_SIZE, model_and_diffusion_defaults
from ..training import checkpoint as ckpt_lib
from ..utils.convert import unet_jax_tree_from_state_dict
from ..utils.msgpack import to_bytes


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt_dir", type=str)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--ema_rate", type=str, default="0.9999",
                        help="EMA rate to export, or 'raw' for the live params")
    return parser


def jax_tree(state_dict, config):
    """The U-Net's state dict -> the JAX parameter tree of ``config``'s model,
    keys sorted at every level as ``jax.tree.map`` leaves them."""
    cfg = {**model_and_diffusion_defaults(), **config}
    size = cfg["image_size"]
    tree = unet_jax_tree_from_state_dict(
        state_dict, num_res_blocks=cfg["num_res_blocks"],
        channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[size],
        attention_resolutions=tuple(size // int(r)
                                    for r in str(cfg["attention_resolutions"]).split(",")))
    return _sorted(tree)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def main(argv=None):
    """Returns the written ``.msgpack`` path."""
    args = create_argparser().parse_args(argv)
    config = ckpt_lib.load_config(args.ckpt_dir)
    state, step, _ = ckpt_lib.load_checkpoint(args.ckpt_dir, args.step)
    chosen = state["params"] if args.ema_rate == "raw" else state["ema"][args.ema_rate]
    out_dir = os.path.join(args.ckpt_dir, "export")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"params_{args.ema_rate}_{step:06d}.msgpack")
    with open(out_path, "wb") as f:
        f.write(to_bytes(jax_tree(chosen, config)))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    print(f"exported {out_path}")
    return out_path


if __name__ == "__main__":
    main()
