"""Compute FVD between sampled videos and the test set (counterpart of the
repo's scripts/video_fvd.py).

    python -m lfvdm_tpu_torch.scripts.video_fvd --eval_dir results/.../<run> --num_videos 100

Pairs ``samples/sample_{idx:04d}-{sample_idx}.npy`` files (uint8 (T, C, H, W))
with the test set's videos (or with ``--real_dir``'s sample-format files), in
per-dataset feature batches whose last one is zero-padded, and writes the
score to ``fvd-{num_videos}-{sample_idx}[-sK].txt`` in the eval directory; a
score already written is not recomputed. The features run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.datasets import get_test_dataset
from ..evals.fvd import FVD, frechet_distance

BATCH_SIZES = {"mazes_cwvae": 16, "minerl": 8, "carla_no_traffic": 4,
               "carla_no_traffic_2x": 4, "carla_no_traffic_2x_encoded": 4,
               "synthetic": 16, "synthetic_longrange": 16}


class SampleDataset:
    """Reads sample_{idx:04d}-{seed}.npy uint8 (T, C, H, W) files."""

    def __init__(self, samples_dir: Path, sample_idx: int, length: int):
        self.dir = Path(samples_dir)
        self.sample_idx = sample_idx
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, i) -> np.ndarray:
        return np.load(self.dir / f"sample_{i:04d}-{self.sample_idx}.npy")


def to_uint8_thwc(video: np.ndarray, from_unit_range: bool) -> np.ndarray:
    """(T, C, H, W) -> (T, H, W, C) uint8."""
    if from_unit_range:  # test set videos are float in [-1, 1]
        video = ((video + 1) / 2 * 255).clip(0, 255)
    return np.asarray(video, np.uint8).transpose(0, 2, 3, 1)


def real_dataset_name(dataset_name: str) -> str:
    """Dataset whose videos give the real side's I3D features: a latent
    checkpoint's samples are decoded to pixels, so '<x>_encoded' pairs with
    the '<x>' pixel dataset (same T)."""
    suffix = "_encoded"
    return dataset_name[: -len(suffix)] if dataset_name.endswith(suffix) else dataset_name


def compute_fvd(eval_dir: Path, dataset_name: str, num_videos: int, sample_idx: int,
                T: int, i3d_weights=None, batch_size=None, real_dir=None,
                temporal_stride: int = 1, device="cuda") -> float:
    """The FVD of the first ``num_videos`` samples against as many real
    videos, each cut to ``T`` frames and then to every ``temporal_stride``-th
    frame."""
    if batch_size is None:
        batch_size = BATCH_SIZES.get(dataset_name, 8)
    fvd = FVD(i3d_weights=i3d_weights, batch_size=batch_size, device=device)
    samples = SampleDataset(Path(eval_dir) / "samples", sample_idx, num_videos)
    if real_dir is not None:
        # The real side from sample-format uint8 files (VAE-roundtripped
        # reals, say: both sides then go through the same decoder).
        real_set = SampleDataset(Path(real_dir), 0, num_videos)
        real_unit_range = False
    else:
        real_set = get_test_dataset(real_dataset_name(dataset_name), T=T)
        real_unit_range = True

    fake_feats, real_feats = [], []
    for start in range(0, num_videos, batch_size):
        idxs = list(range(start, min(start + batch_size, num_videos)))
        fake = np.stack([to_uint8_thwc(samples[i], False)[:T][::temporal_stride]
                         for i in idxs])
        real = np.stack([to_uint8_thwc(np.asarray(real_set[i]), real_unit_range)[:T]
                         [::temporal_stride] for i in idxs])
        if len(idxs) < batch_size:  # zero-pad the final partial batch
            pad = batch_size - len(idxs)
            fake = np.concatenate([fake, np.zeros((pad,) + fake.shape[1:], np.uint8)])
            real = np.concatenate([real, np.zeros((pad,) + real.shape[1:], np.uint8)])
        fake_feats.append(fvd.extract_features(fake)[:len(idxs)])
        real_feats.append(fvd.extract_features(real)[:len(idxs)])
    return frechet_distance(np.concatenate(fake_feats), np.concatenate(real_feats))


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_dir", required=True, type=str)
    parser.add_argument("--num_videos", type=int, default=100)
    parser.add_argument("--sample_idx", type=int, default=0)
    parser.add_argument("--T", type=int, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--i3d_weights", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="videos per I3D feature batch (default: the per-dataset table)")
    parser.add_argument("--dp_devices", type=int, default=1,
                        help="shard each I3D feature batch over this many devices; only 1 "
                             "is ported (ROADMAP A5)")
    parser.add_argument("--real_dir", type=str, default=None,
                        help="directory of sample-format uint8 .npy files to use as the REAL "
                             "side instead of the test dataset (e.g. VAE-roundtripped reals "
                             "for the latent gate)")
    parser.add_argument("--temporal_stride", type=int, default=1,
                        help="score every k-th frame (aux protocol for slow temporal "
                             "statistics; output file is suffixed -sK so stride variants "
                             "don't collide)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to compute the features on: cuda (default) or cpu")
    return parser


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the score
    (the one already written, when the output file exists)."""
    args = create_argparser().parse_args(argv)
    if args.dp_devices != 1:
        raise NotImplementedError("--dp_devices > 1 waits for data parallelism (ROADMAP A5)")

    eval_dir = Path(args.eval_dir)
    stride_sfx = f"-s{args.temporal_stride}" if args.temporal_stride != 1 else ""
    out_path = eval_dir / f"fvd-{args.num_videos}-{args.sample_idx}{stride_sfx}.txt"
    if out_path.exists():
        print(f"{out_path} exists: FVD = {out_path.read_text().strip()}")
        return float(out_path.read_text())

    with open(eval_dir / "model_config.json") as f:
        config = json.load(f)
    dataset = args.dataset or config.get("dataset", "synthetic")
    T = args.T or config.get("T")

    score = compute_fvd(eval_dir, dataset, args.num_videos, args.sample_idx, T,
                        i3d_weights=args.i3d_weights, batch_size=args.batch_size,
                        real_dir=args.real_dir, temporal_stride=args.temporal_stride,
                        device=args.device)
    out_path.write_text(f"{score}\n")
    print(f"FVD: {score} (saved to {out_path})")
    return score


if __name__ == "__main__":
    main()
