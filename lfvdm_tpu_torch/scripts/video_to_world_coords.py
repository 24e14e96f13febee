"""Run the CARLA world-coordinate regressor over samples or a raw dataset
(counterpart of the repo's scripts/video_to_world_coords.py).

    python -m lfvdm_tpu_torch.scripts.video_to_world_coords --eval_dir DIR \\
        --classifier_path classifier.pt --regressor_path regressor.pt

Writes one ``coords/<stem>.npy`` ((T, 2) float32) per video of
``<eval_dir>/samples/sample_*.npy`` or of ``<dataset_dir>/video_*.pt``, in a
shuffled order (concurrent jobs share the work) and skipping files that
exist. The checkpoints are torchvision-layout state_dicts: the paper's, or
``carla_regressor_train``'s. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np

from ..evals.carla_regressor import load_classifier_regressor_like_paper


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_dir", type=str, default=None,
                        help="Samples directory (reads samples/*.npy).")
    parser.add_argument("--dataset_dir", type=str, default=None,
                        help="Raw dataset directory (reads video_*.pt).")
    parser.add_argument("--classifier_path", type=str, required=True)
    parser.add_argument("--regressor_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to run the regressor on: cuda (default) or cpu")
    return parser


def _load_sample(path):
    return np.load(path).astype(np.float32)  # (T, C, H, W) uint8


def _load_dataset_video(path):
    import torch

    v = torch.load(path, map_location="cpu", weights_only=False).numpy()
    return v.transpose(0, 3, 1, 2).astype(np.float32)  # THWC -> TCHW


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    coords files written."""
    args = create_argparser().parse_args(argv)
    predictor = load_classifier_regressor_like_paper(
        args.classifier_path, args.regressor_path, batch_size=args.batch_size,
        device=args.device)

    if args.eval_dir:
        src = Path(args.eval_dir) / "samples"
        out_dir = Path(args.eval_dir) / "coords"
        paths = sorted(src.glob("sample_*.npy"))
        loader = _load_sample
    else:
        src = Path(args.dataset_dir)
        out_dir = src / "coords"
        paths = sorted(src.glob("video_*.pt"))
        loader = _load_dataset_video

    out_dir.mkdir(parents=True, exist_ok=True)
    random.shuffle(paths)  # concurrent jobs take the videos in different orders
    written = []
    for p in paths:
        out_path = out_dir / (p.stem + ".npy")
        if out_path.exists():
            continue
        np.save(out_path, predictor.predict_coords(loader(p)))
        written.append(out_path)
        print(f"saved {out_path}")
    return written


if __name__ == "__main__":
    main()
