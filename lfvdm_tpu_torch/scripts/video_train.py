"""Train a flexible video diffusion model (counterpart of the repo's
scripts/video_train.py).

    python -m lfvdm_tpu_torch.scripts.video_train --dataset carla_no_traffic \\
        --num_res_blocks 1 --batch_size 2 --max_frames 20

The config comes from the flags and the dataset (T, image size, the latent
norm stats of a pre-encoded dataset, the wavelet channels) and is embedded in
every checkpoint, so sampling needs only the run directory. ``--init_from_pt``
warm-starts from a reference ``.pt`` checkpoint whose config wins over the
flags. Runs on the card unless ``--device cpu``. On a card each step
replays one CUDA graph of the whole step, captured at an early step of its
shape (under ``torchrun`` on every rank, with DDP's or FSDP2's collectives
inside; DDP's first 11 steps run eagerly); with ``--device cpu`` the steps
run eagerly. ``TrainLoop.run_loop`` prints which ("train step: captured"
or "train step: eager").

On several cards, launch one process per card:

    torchrun --nproc_per_node N -m lfvdm_tpu_torch.scripts.video_train --fsdp F ...

Every rank loads its own ``--batch_size`` rows; ``--fsdp 1`` trains with
DDP, ``--fsdp F`` > 1 shards each parameter of at least ``--fsdp_min_size``
elements over F ranks (FSDP2), replicated over the N / F groups. Rank 0's
run id and checkpoint directory are every rank's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import add_dict_to_argparser, create_model_and_diffusion, model_and_diffusion_defaults
from ..data.datasets import default_image_size_dict, default_T_dict, load_data, load_encoding_stats
from ..diffusion.codecs import make_codec
from ..diffusion.resample import create_named_schedule_sampler
from ..training.train_loop import TrainLoop
from ..utils.device import process_index_and_count, resolve_device, setup_distributed
from ..utils.logger import logger

# Keys of a reference checkpoint's config that win over the flags with
# --init_from_pt: the architecture the weights need and the diffusion
# parameterization they were trained under.
ADOPT_KEYS = ("image_size", "in_channels", "num_channels", "num_res_blocks",
              "num_heads", "num_heads_upsample", "attention_resolutions",
              "learn_sigma", "use_scale_shift_norm", "use_rpe_net",
              "predict_xstart", "use_kl", "noise_schedule",
              "diffusion_steps", "sigma_small", "rescale_learned_sigmas",
              "rescale_timesteps", "wavelet_levels")


def create_argparser():
    defaults = dict(
        dataset="synthetic",
        T=None,
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        microbatch=-1,  # -1 disables gradient accumulation
        seed=123,
        batch_size=1,
        ema_rate="0.9999",
        log_interval=10,
        save_interval=50000,
        sample_interval=50000,
        max_frames=20,
        pad_with_random_frames=True,
        schedule_sampler="uniform",
        checkpoint_dir="checkpoints/run",
        resume=False,
        init_from_pt="",  # warm-start from a reference .pt checkpoint
        fsdp=1,
        fsdp_min_size=65536,
        max_steps=0,
        use_wandb=False,
        resume_id="",  # resume the run with this id (wandb run id == checkpoint dir key)
        unobserve=False,  # wandb dryrun mode
        enc_dec_chunk_size=20,  # frames per VAE encode chunk (online latent mode)
        profile_dir="",  # a torch.profiler trace of steps 10-14 is written there
        log_attn=False,
    )
    # The port's fused_skip_conv is a model key, not a flag of the script.
    defaults.update({k: v for k, v in model_and_diffusion_defaults().items()
                     if k != "fused_skip_conv"})
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    parser.add_argument("--compilation_cache_dir", type=str, default="",
                        help="accepted for the JAX script's command lines and has no "
                             "effect: eager PyTorch compiles nothing (the kernels are "
                             "built once into ops/_build/)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train on: cuda (default) or cpu")
    return parser


def resolve_run_identity(args) -> str:
    """The run id: ``--resume_id`` resumes that run (checkpoint dir
    checkpoints/<id>, wandb resume under the same id); a fresh run draws
    one, and in a group every rank takes rank 0's (the checkpoint path is
    keyed by it). The default checkpoint_dir is keyed by it, an explicit one
    wins."""
    import uuid

    default_dir = create_argparser().get_default("checkpoint_dir")
    if args.resume_id:
        run_id = args.resume_id
        args.resume = True
    else:
        run_id = uuid.uuid4().hex[:8]
        if process_index_and_count()[1] > 1:
            import torch.distributed as dist

            shared = [run_id]
            dist.broadcast_object_list(shared, src=0)
            run_id = shared[0]
    if args.checkpoint_dir == default_dir:
        args.checkpoint_dir = os.path.join("checkpoints", run_id)
    return run_id


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    ``TrainLoop`` after its run."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    setup_distributed(device)
    run_id = resolve_run_identity(args)
    if args.unobserve:
        os.environ["WANDB_MODE"] = "dryrun"

    # Dataset-derived config. None-default flags parse as strings, so T is
    # coerced here.
    if args.T is None:
        args.T = default_T_dict.get(args.dataset, 100)
    args.T = int(args.T)
    args.image_size = default_image_size_dict.get(args.dataset, args.image_size)
    stats = None
    if "encoded" in args.dataset:
        args.diffusion_space = "latent"
        args.pre_encoded = True
        args.in_channels = 4
        stats = load_encoding_stats(args.dataset)
        if stats is None:
            print(f"warning: norm stats not found for {args.dataset}; using identity stats")
            stats = {"mean": np.zeros(4, np.float32), "std": np.ones(4, np.float32)}
    elif args.diffusion_space == "pixel":
        args.in_channels = 3
    elif args.diffusion_space == "wavelet":
        # The U-Net runs on C·4^L subband channels at 1/2^L the resolution.
        lv = int(args.wavelet_levels)
        args.in_channels = 3 * 4 ** lv
        if args.image_size % (2 ** lv):
            raise ValueError(f"image_size {args.image_size} not divisible by 2^{lv}")
        args.image_size //= 2 ** lv

    if stats is not None:
        # The latent norm stats go into the run config, so the codec at
        # sampling time needs only the checkpoint.
        args.enc_stats_mean = [float(v) for v in np.asarray(stats["mean"]).reshape(-1)]
        args.enc_stats_std = [float(v) for v in np.asarray(stats["std"]).reshape(-1)]

    init_params = None
    if args.init_from_pt:
        from ..utils.convert import read_reference_checkpoint

        init_params, pt_config = read_reference_checkpoint(args.init_from_pt)
        adopted = {k: pt_config[k] for k in ADOPT_KEYS
                   if k in pt_config and pt_config[k] != getattr(args, k)}
        for k, v in adopted.items():
            setattr(args, k, v)
        if adopted:
            print("init_from_pt: checkpoint config overrides CLI/default flags "
                  f"(checkpoint wins): {adopted}")
        ckpt_space = pt_config.get("diffusion_space", args.diffusion_space)
        if ckpt_space != args.diffusion_space:
            raise ValueError(
                f"--init_from_pt checkpoint was trained in {ckpt_space!r} space but "
                f"dataset {args.dataset!r} implies {args.diffusion_space!r} space — pick a "
                "matching dataset or checkpoint")
        if args.diffusion_space == "latent":
            expected_in = 4
        elif args.diffusion_space == "wavelet":
            expected_in = 3 * 4 ** int(args.wavelet_levels)
        else:
            expected_in = 3
        if args.in_channels != expected_in:
            raise ValueError(
                f"--init_from_pt checkpoint has in_channels={args.in_channels} but "
                f"{args.diffusion_space!r}-space training on {args.dataset!r} needs "
                f"in_channels={expected_in}")

    config = {k: v for k, v in vars(args).items() if k != "device"}
    model, diffusion = create_model_and_diffusion(config, device=device, seed=args.seed)
    codec = make_codec(args.diffusion_space, pre_encoded=args.pre_encoded,
                       pre_encoded_stats=stats, chunk_size=args.enc_dec_chunk_size,
                       wavelet_levels=int(args.wavelet_levels))

    logger.configure(
        log_dir=args.checkpoint_dir, use_wandb=args.use_wandb,
        wandb_kwargs=dict(
            id=run_id, resume="allow",
            entity=os.environ.get("WANDB_ENTITY"),
            project=os.environ.get("WANDB_PROJECT", "video-diffusion"),
            config={k: v for k, v in config.items()
                    if isinstance(v, (str, int, float, bool, type(None)))},
        ),
    )
    logger.logkv("num_nodes", int(os.environ.get("SLURM_JOB_NUM_NODES", 1)),
                 distributed=False)
    data = load_data(args.dataset, batch_size=args.batch_size, T=args.T, seed=args.seed)

    sample_fn = None
    if args.sample_interval:
        from ..training.vis_sampling import make_sample_fn

        # The vis batch is taken from the stream up front; the loop samples
        # it every sample_interval steps and at step 5.
        vis_batch = np.asarray(next(data))[: min(args.batch_size, 2)]
        sample_fn = make_sample_fn(vis_batch, out_dir=os.path.join(args.checkpoint_dir, "vis"),
                                   seed=0, log_attn=args.log_attn)

    loop = TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        codec=codec,
        batch_size=args.batch_size,
        max_frames=args.max_frames,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        sample_interval=args.sample_interval,
        lr_anneal_steps=args.lr_anneal_steps,
        weight_decay=args.weight_decay,
        microbatch=args.microbatch,
        pad_with_random_frames=args.pad_with_random_frames,
        schedule_sampler=create_named_schedule_sampler(args.schedule_sampler, diffusion),
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        init_params=init_params,
        config=config,
        fsdp=args.fsdp,
        fsdp_min_size=args.fsdp_min_size,
        seed=args.seed,
        profile_dir=args.profile_dir or None,
        sample_fn=sample_fn,
    )
    loop.run_loop(max_steps=args.max_steps or None)
    return loop


if __name__ == "__main__":
    main()
