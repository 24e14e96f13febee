"""Assemble sampled videos and ground truth into one gif/mp4/avi grid
(counterpart of the repo's scripts/video_make_mp4.py).

    python -m lfvdm_tpu_torch.scripts.video_make_mp4 --eval_dir DIR --do_n 4 --n_seeds 2

The first ``do_n`` test videos, each as its ground truth (every frame
red-marked) stacked over ``n_seeds`` samples (the first ``obs_length``
frames red-marked), along the height per video and along the width across
videos, written as ``<out_dir or eval_dir>/videos/{do_n}_{n_seeds}.{format}``.
The dataset comes from the eval directory's ``model_config.json`` unless
``--dataset`` names one. Host-side numpy only; ``--device`` is accepted for
the port's common command line and selects nothing.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..config import str2bool
from ..utils.video_io import mark_as_observed, tensor2avi, tensor2gif, tensor2mp4


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_dir", required=True, type=str)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--add_gt", type=str2bool, default=True)
    parser.add_argument("--do_n", type=int, default=1,
                        help="assemble the first do_n test videos")
    parser.add_argument("--n_seeds", type=int, default=1,
                        help="samples per video (seeds tried in order)")
    parser.add_argument("--obs_length", type=int, default=0,
                        help="red-mark the first obs_length frames of samples")
    parser.add_argument("--format", choices=["gif", "mp4", "avi"], default="gif")
    parser.add_argument("--dataset", type=str, default=None,
                        help="override the dataset recorded in model_config.json")
    parser.add_argument("--T", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="accepted for the port's common command line; the grid is "
                             "assembled on the host")
    return parser


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the path
    written."""
    args = create_argparser().parse_args(argv)

    eval_dir = Path(args.eval_dir)
    dataset_name = args.dataset
    if args.add_gt:
        from ..data.datasets import get_test_dataset

        if dataset_name is None:
            config = json.loads((eval_dir / "model_config.json").read_text())
            dataset_name = config["dataset"]
        test_set = get_test_dataset(dataset_name, T=args.T)

    out_dir = (Path(args.out_dir) if args.out_dir else eval_dir) / "videos"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{args.do_n}_{args.n_seeds}.{args.format}"

    videos = []
    for data_idx in range(args.do_n):
        rows = []
        if args.add_gt:
            gt = np.asarray(test_set[data_idx])
            gt8 = ((gt + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
            mark_as_observed(gt8)
            rows.append(gt8)
        seed, done = 0, 0
        while done < args.n_seeds:
            if seed >= 100:
                raise FileNotFoundError(f"Not enough seeds for idx {data_idx} "
                                        f"(found {done} after trying {seed} seeds)")
            fname = eval_dir / "samples" / f"sample_{data_idx:04d}-{seed}.npy"
            if fname.exists():
                video = np.load(fname)
                mark_as_observed(video[: args.obs_length])
                rows.append(video)
                done += 1
            seed += 1
        T = min(r.shape[0] for r in rows)
        videos.append(np.concatenate([r[:T] for r in rows], axis=-2))
    video = np.concatenate(videos, axis=-1)

    writer = {"gif": tensor2gif, "mp4": tensor2mp4, "avi": tensor2avi}[args.format]
    writer(video, out_path, drange=(0, 255))
    print(f"Saved to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
