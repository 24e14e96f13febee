"""Export the window sampler as a serving artifact (counterpart of the repo's
scripts/export_sampler.py).

Writes ``<out>/sampler.pt2`` (a ``torch.export`` artifact of one reverse step
for a fixed window shape; the weights are an argument) and
``<out>/params.npz``. A serving process needs only torch and
``lfvdm_tpu_torch.serving.load_window_sampler`` (with the package's kernel
operators), no model code.

    # from a training run directory of the port (latest step, EMA weights)
    python -m lfvdm_tpu_torch.scripts.export_sampler --checkpoint_dir checkpoints/run \\
        --out serve_artifact --batch_size 2 --max_frames 20

    # self-test with seeded random weights
    python -m lfvdm_tpu_torch.scripts.export_sampler --random_init True --out /tmp/artifact \\
        --image_size 32 --num_channels 32 --diffusion_steps 8

The JAX script's flags and defaults, with ``--device`` (default ``cuda``, the
device the artifact is exported for and runs on) in place of ``--platform``.
With ``--checkpoint_dir`` the model comes from the run's saved config, and
the window (``--batch_size``, ``--max_frames``) and the sampler
(``--use_ddim``, ``--eta``, ``--timestep_respacing``) from the flags; the JAX
script takes the respacing from the run's config too, which leaves a
training run's full schedule.
"""

from __future__ import annotations

import argparse
import os

from .. import serving
from ..config import add_dict_to_argparser, create_model_and_diffusion, model_and_diffusion_defaults
from ..training import checkpoint as ckpt_lib
from ..utils.device import resolve_device


def create_argparser():
    defaults = dict(
        checkpoint_dir="",
        random_init=False,
        ema_rate="0.9999",
        out="serve_artifact",
        batch_size=1,
        max_frames=20,
        use_ddim=False,
        eta=0.0,
        device="cuda",  # the artifact's device: cuda (default) or cpu
    )
    # The port's fused_skip_conv is a model key, not a flag of the script.
    defaults.update({k: v for k, v in model_and_diffusion_defaults().items()
                     if k != "fused_skip_conv"})
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


def main(argv=None):
    """Returns the artifact's path."""
    args = create_argparser().parse_args(argv)
    config = vars(args)
    device = resolve_device(args.device)
    if args.checkpoint_dir:
        if ckpt_lib.find_latest_step(args.checkpoint_dir) is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        state, step, saved_config = ckpt_lib.load_checkpoint(args.checkpoint_dir)
        config = {**saved_config, **{k: config[k] for k in ("batch_size", "max_frames",
                                                            "use_ddim", "eta",
                                                            "timestep_respacing")}}
        model, diffusion = create_model_and_diffusion(config, device=device)
        params = state["ema"].get(str(args.ema_rate), state["params"])
        model.load_state_dict(params, strict=True)
        print(f"exporting step {step} (ema {args.ema_rate})")
    elif args.random_init:
        model, diffusion = create_model_and_diffusion(config, device=device, seed=0)
    else:
        raise SystemExit("pass --checkpoint_dir or --random_init")

    params = dict(model.state_dict())
    blob = serving.export_window_sampler(
        model, diffusion, params,
        batch_size=args.batch_size, max_frames=args.max_frames,
        in_channels=config["in_channels"], image_size=config["image_size"],
        use_ddim=args.use_ddim, eta=args.eta, device=device,
    )
    os.makedirs(args.out, exist_ok=True)
    art = os.path.join(args.out, "sampler.pt2")
    with open(art, "wb") as f:
        f.write(blob)
    serving.save_params_npz(params, os.path.join(args.out, "params.npz"))
    print(f"wrote {art} ({len(blob) / 1e6:.1f} MB) + params.npz")
    return art


if __name__ == "__main__":
    main()
