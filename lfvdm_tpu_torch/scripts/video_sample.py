"""Sample long videos from a trained checkpoint with a flexible scheme
(counterpart of the repo's scripts/video_sample.py).

    python -m lfvdm_tpu_torch.scripts.video_sample CHECKPOINT --sampling_scheme hierarchy-2 \\
        --dataset carla_no_traffic --T 300 --use_ddim True --timestep_respacing ddim50

CHECKPOINT is a reference-format ``.pt`` file (``{"state_dict", "config"}``),
a training run directory of the port's ``video_train``, or a params
``.msgpack`` that either package's ``export_params`` wrote. The config comes
from the checkpoint; each video of the test split, from ``--start_index`` to
``--stop_index``, is sampled given its first ``--n_obs`` frames and written as
``results/.../samples/sample_XXXX-<sample_idx>.npy`` (uint8 (T, C, H, W)),
the JAX script's layout; a video whose file exists is skipped.
``--just_visualise`` renders the scheme's index plan to PNGs instead.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import create_diffusion, create_model_and_diffusion, str2bool
from ..data.datasets import get_test_dataset
from ..diffusion.codecs import make_codec_from_config
from ..parallel.mesh import make_eval_mesh
from ..sampling.driver import VideoSampler
from ..sampling.schemes import sampling_schemes
from ..training import checkpoint as ckpt_lib
from ..utils.device import process_index_and_count, resolve_device, setup_distributed
from ..utils.locks import Protect
from ..utils.paths import get_eval_run_identifier, get_model_results_path


def load_model_from_checkpoint(path: str, use_ddim: bool, timestep_respacing: str,
                               ema_rate: str = None, device="cuda"):
    """(model on ``device``, diffusion, config) from a reference ``.pt`` file,
    a port training run directory or an exported params ``.msgpack``, the
    diffusion respaced as asked.

    ``ema_rate``: which weight copy a run directory yields — None picks the
    largest saved EMA rate (the reference's eval default), a rate string
    that EMA, and ``"raw"`` the raw training parameters, the right choice
    for short runs, whose EMA(0.9999) still weights the initial random
    parameters by 0.9999^steps.
    """
    if path.endswith(".pt"):
        from ..utils.convert import load_reference_checkpoint

        model, _, config = load_reference_checkpoint(path, device=device)
    elif path.endswith(".msgpack"):
        model, config = load_exported_params(path, device)
    elif os.path.isdir(path) and ckpt_lib.find_latest_step(path) is not None:
        step = ckpt_lib.find_latest_step(path)
        if not os.path.exists(os.path.join(path, str(step), "params.pt")):
            raise SystemExit(f"{path} is not a run directory of the port's video_train (a JAX "
                             "orbax run?); the port cannot read orbax checkpoints without "
                             "JAX (ROADMAP A8): export the run with the JAX package's "
                             "scripts/export_params.py and pass the .msgpack it writes")
        params, rate, step, config = ckpt_lib.load_ema_params(path, rate=ema_rate)
        model, _ = create_model_and_diffusion(config, device=device)
        model.load_state_dict(params, strict=True)
        which = f"EMA({rate})" if rate is not None else "raw"
        print(f"loaded {which} params at step {step} from {path}")
    else:
        raise SystemExit("pass a reference .pt checkpoint or a training run directory of "
                         "the port's video_train")
    config = dict(config)
    config.update({"use_ddim": use_ddim, "timestep_respacing": timestep_respacing})
    return model, create_diffusion(config), config


def load_exported_params(path: str, device):
    """(model on ``device``, config) from a params ``.msgpack`` that
    ``scripts/export_params.py`` (either package's) wrote, with the
    ``config.json`` beside it: flax's msgpack, then the JAX tree, then the
    port's state dict."""
    from ..utils.convert import unet_state_dict_from_jax
    from ..utils.msgpack import from_bytes

    with open(path, "rb") as f:
        tree = from_bytes(f.read())
    with open(os.path.join(os.path.dirname(path), "config.json")) as f:
        config = json.load(f)
    model, _ = create_model_and_diffusion(config, device=device)
    model.load_state_dict(unet_state_dict_from_jax(
        tree, num_res_blocks=model.num_res_blocks, channel_mult=model.channel_mult,
        attention_resolutions=model.attention_resolutions), strict=True)
    return model, config


def visualise(args, indices_used):
    """Render the obs/latent index plan per step to a PNG."""
    from PIL import Image

    for index in range(len(indices_used[0][0])):
        vis = []
        exist = list(range(args.n_obs))
        border = np.array([0, 0, 0], np.int32)
        for obs_idx, latent_idx in indices_used:
            o, l = obs_idx[index], latent_idx[index]
            exist.extend(l)
            layer = np.full((args.T, 3), 255, np.int32)
            layer[exist] = [50, 50, 50]
            layer[o] = [50, 50, 255]
            layer[l] = [255, 69, 0]
            scale = 4
            layer = np.repeat(layer, scale + 1, axis=0)
            layer[::scale + 1] = border
            layer = np.concatenate([layer, layer[:1]], axis=0)
            vis.extend([layer.copy() for _ in range(scale + 1)])
            vis[-1][:] = border
        vis = np.stack([vis[-1], *vis])
        out_dir = Path("visualisations")
        out_dir.mkdir(parents=True, exist_ok=True)
        fname = (f"vis_{args.sampling_scheme}_sampling-{args.T}-given-{args.n_obs}_"
                 f"{args.max_latent_frames}-{args.max_frames}-chunks_index-{index}.png")
        Image.fromarray(vis.astype(np.uint8)).save(out_dir / fname)
        print(f"saved {out_dir / fname}")


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("--sampling_scheme", required=True, choices=sampling_schemes.keys())
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--eval_dir", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--n_obs", type=int, default=36)
    parser.add_argument("--T", type=int, default=None)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--max_latent_frames", type=int, default=None)
    parser.add_argument("--start_index", type=int, default=0)
    parser.add_argument("--stop_index", type=int, default=None)
    parser.add_argument("--use_ddim", type=str2bool, default=False)
    parser.add_argument("--use_dpm", type=str2bool, default=False,
                        help="DPM-Solver++(2M), a second-order deterministic solver: set "
                             "the model calls with --timestep_respacing 'dpmN' (N = 10-25); "
                             "exclusive with --use_ddim")
    parser.add_argument("--timestep_respacing", type=str, default="")
    parser.add_argument("--clip_denoised", type=str2bool, default=True)
    parser.add_argument("--sample_idx", type=int, default=0)
    parser.add_argument("--just_visualise", action="store_true")
    parser.add_argument("--optimality", type=str, default=None,
                        choices=["index", "lpips", "linspace-t", "random-t",
                                 "linspace-t-force-nearby", "random-t-force-nearby"],
                        help="read <eval_dir>/optimal_schedule.pt for the adaptive schemes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ema_rate", type=str, default=None,
                        help="which weight copy to sample from a run directory: default "
                             "the largest saved EMA rate, a rate (e.g. 0.9999), or 'raw' "
                             "for the raw training parameters (short runs)")
    parser.add_argument("--compilation_cache_dir", type=str, default=None,
                        help="accepted for the JAX script's command lines and has no "
                             "effect: eager PyTorch compiles nothing (the kernels are "
                             "built once into ops/_build/)")
    parser.add_argument("--encoder_reuse", type=int, default=1,
                        help="run the U-Net encoder every k-th diffusion step and "
                             "reuse cached skip features between (training-free "
                             "acceleration, arXiv:2312.09608). Approximate: "
                             "supported for >=1000-step schedules (measured ~4%%/9%% "
                             "recon-err cost at k=2/4, docs/DESIGN.md); not "
                             "recommended for short/respaced schedules")
    parser.add_argument("--vae_weights", type=str, default=None,
                        help="prefix of the converted SVD-VAE npz pair; defaults to "
                             "$LFVDM_VAE_WEIGHTS. Decodes latent-space checkpoints to pixels")
    parser.add_argument("--dp_devices", type=int, default=1,
                        help="data-parallel sampling over this many local devices: each "
                             "window's batch is split over them (pick --batch_size a "
                             "multiple)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to sample on: cuda (default) or cpu")
    return parser


def shard_indices_for_process(indices):
    """Each process of a ``torch.distributed`` group (``torchrun`` starts
    one per card) takes an interleaved shard of the video indices; the
    outputs are idempotent per video, so an overlap is harmless. One process
    keeps the full list."""
    rank, count = process_index_and_count()
    if count == 1:
        return indices
    shard = indices[rank::count]
    print(f"process {rank}/{count}: {len(shard)} of {len(indices)} videos")
    return shard


def to_uint8(samples: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> the uint8 the sample files hold."""
    return ((samples + 1) / 2 * 255).clip(0, 255).astype(np.uint8)


def batch_seed(seed: int, first_index: int) -> int:
    """The sampling noise's seed for the batch starting at ``first_index``
    (the counterpart of ``jax.random.fold_in(PRNGKey(seed), index)``)."""
    return int(np.random.SeedSequence([seed, first_index]).generate_state(1, np.uint64)[0])


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line). Returns a record of
    the run: ``eval_dir``, the files ``written``, the sampler's ``model_calls``
    (``reuse_calls`` of them up-path-only calls under ``--encoder_reuse``) and
    the seconds spent sampling, ``sampling_s`` (None with
    ``--just_visualise``)."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    setup_distributed(device)
    devices = None
    if args.dp_devices > 1:
        devices = make_eval_mesh(args.dp_devices, args.batch_size, device)

    if args.stop_index is None:
        task_id = int(os.environ.get("SLURM_ARRAY_TASK_ID", 0))
        args.start_index = task_id * args.batch_size
        args.stop_index = (task_id + 1) * args.batch_size
    indices = shard_indices_for_process(list(range(args.start_index, args.stop_index)))

    model, diffusion, config = load_model_from_checkpoint(
        args.checkpoint_path, args.use_ddim, args.timestep_respacing,
        ema_rate=args.ema_rate, device=device)
    if args.max_frames is None:
        args.max_frames = config.get("max_frames", 20)
    if args.max_latent_frames is None:
        args.max_latent_frames = args.max_frames // 2
    dataset_name = args.dataset or config.get("dataset", "synthetic")
    dataset = get_test_dataset(dataset_name, T=args.T)
    args.T = dataset.T if dataset.T is not None else args.T

    # A latent checkpoint samples latents; the codec decodes the assembled
    # video to pixels before the uint8 save.
    codec = make_codec_from_config({**config, "dataset": dataset_name},
                                   vae_weights=args.vae_weights, device=device)
    if getattr(codec, "diffusion_space", "pixel") == "latent" and getattr(codec, "vae", None) is None:
        print("warning: no VAE weights — samples will be de-normalized latents, "
              "not pixels (pass --vae_weights)")

    sampler = VideoSampler(model, diffusion, clip_denoised=args.clip_denoised,
                           use_ddim=args.use_ddim, use_dpm=args.use_dpm,
                           encoder_reuse=args.encoder_reuse, codec=codec, devices=devices)

    optimal_schedule = None
    if args.optimality is not None:
        optimal_schedule = torch.load(Path(args.eval_dir) / "optimal_schedule.pt",
                                      weights_only=False)

    if args.just_visualise:
        batch = np.stack([np.asarray(dataset[i])
                          for i in range(min(args.batch_size, len(dataset)))])
        _, indices_used = sampler.sample_video(
            batch, scheme_name=args.sampling_scheme, n_obs=args.n_obs,
            max_frames=args.max_frames, step_size=args.max_latent_frames,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            optimal_schedule=optimal_schedule, just_get_indices=True)
        visualise(args, indices_used)
        return {"eval_dir": None, "written": [], "model_calls": 0, "reuse_calls": 0,
                "sampling_s": None}

    eval_dir = get_model_results_path(
        args.checkpoint_path, use_ddim=args.use_ddim, use_dpm=args.use_dpm,
        timestep_respacing=args.timestep_respacing, eval_dir=args.eval_dir,
    ) / get_eval_run_identifier(
        args.sampling_scheme, args.max_frames, args.max_latent_frames,
        args.T, args.n_obs, optimality=args.optimality,
    )
    (eval_dir / "samples").mkdir(parents=True, exist_ok=True)
    json_path = eval_dir / "model_config.json"
    if not json_path.exists():
        with Protect(json_path):
            with open(json_path, "w") as f:
                json.dump({k: v for k, v in config.items()
                           if isinstance(v, (str, int, float, bool, list, type(None)))},
                          f, indent=4)

    written, sampling_s = [], 0.0
    not_done = list(indices)
    while not_done:
        batch_indices = not_done[:args.batch_size]
        not_done = not_done[args.batch_size:]
        out_paths = [eval_dir / "samples" / f"sample_{i:04d}-{args.sample_idx}.npy"
                     for i in batch_indices]
        todo = [not p.exists() for p in out_paths]
        if not any(todo):
            print(f"nothing to do for batch {batch_indices}")
            continue
        batch = np.stack([np.asarray(dataset[i]) for i in batch_indices])
        if getattr(codec, "diffusion_space", "pixel") == "wavelet":
            # The test split is pixels: encode the conditioning frames into
            # the subbands (an isometry). Latent checkpoints pair with the
            # *_encoded datasets instead.
            batch = codec.encode(torch.as_tensor(batch)).numpy()
        generator = torch.Generator(device=device).manual_seed(
            batch_seed(args.seed, batch_indices[0]))
        t0 = time.perf_counter()
        samples, _ = sampler.sample_video(
            batch, scheme_name=args.sampling_scheme, n_obs=args.n_obs,
            max_frames=args.max_frames, step_size=args.max_latent_frames,
            generator=generator, optimal_schedule=optimal_schedule, verbose=True)
        sampling_s += time.perf_counter() - t0
        samples = to_uint8(samples)
        for i, (p, do) in enumerate(zip(out_paths, todo)):
            if do:
                np.save(p, samples[i])
                written.append(p)
                print(f"*** saved {p} ***")
    return {"eval_dir": eval_dir, "written": written, "model_calls": sampler.model_calls,
            "reuse_calls": sampler.reuse_calls, "sampling_s": sampling_s}


if __name__ == "__main__":
    main()
