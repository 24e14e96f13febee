"""Offline SVD-VAE pre-encoding of CARLA videos for latent diffusion
(counterpart of the repo's datasets/carla/encode_latent.py).

    python -m lfvdm_tpu_torch.scripts.encode_latent --path datasets/carla/no-traffic-encoded \\
        --normalize --vae_weights svd_vae

For every ``.pt`` line of ``video_train.csv`` and ``video_test.csv`` in
``--path``: the uint8 (T, H, W, C) video is mapped to [-1, 1], upsampled 2x
(nearest) and encoded in chunks of ``--chunk_size`` frames, keeping the mean
of each frame's latent distribution; the (T, 4, 2H/8, 2W/8) means are saved
beside it as ``encoded_<name>`` (``.pt`` through torch, anything else as
``.npy``). With ``--normalize``, the train split's channel-wise mean and std
(float64 running moments) go to ``encoded_train_norm_stats.pt`` ({"mean",
"std", "n_obs"}, which ``data.datasets.load_encoding_stats`` reads), and a
second pass rewrites every encoded file of both splits as (x - mean) / (std +
1e-8) with the train split's statistics.

The VAE comes from ``--vae_weights``' ``<prefix>_{encoder,decoder}.npz`` pair
(``convert_svd_vae``, the port's or the repo's), else it is the seeded
random one. It runs on the card unless ``--device cpu``; a missing card
raises. Each video goes to the device as uint8 and is mapped and upsampled
there chunk by chunk; its means come back in one copy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.vae import SVDVae, load_svd_vae
from ..utils.device import resolve_device

STATS_FILE = "encoded_train_norm_stats.pt"


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", type=str, default="no-traffic-encoded")
    parser.add_argument("--chunk_size", type=int, default=100)
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--vae_weights", type=str, default=None,
                        help="prefix of converted svd vae npz pair")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to encode on: cuda (default) or cpu")
    return parser


def load_vae(weights_prefix, device) -> SVDVae:
    """The VAE of the ``<prefix>_{encoder,decoder}.npz`` pair, or the seeded
    random one (which says so) without a prefix."""
    if weights_prefix:
        return load_svd_vae(weights_prefix, device=device)
    return SVDVae(seed=0, device=device)


def load_video(path: str) -> np.ndarray:
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=False).numpy()
    return np.load(path)


def save(path: str, arr: np.ndarray):
    if path.endswith(".pt"):
        torch.save(torch.tensor(arr), path)
    else:
        np.save(path, arr)


def pixel_table() -> np.ndarray:
    """float32 (256,): each uint8 value v through the JAX script's numpy
    expression, 2 * (v / 255) - 1 in float32."""
    v = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0
    return 2 * v - 1


def prepare_frames(frames: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, C) -> float32 (N, C, 2H, 2W) in [-1, 1], upsampled 2x
    (nearest), on ``frames``' device. The values are looked up in ``table``
    (``pixel_table`` on that device), so they are numpy's bit for bit on any
    device (a CUDA division by a host scalar is a multiplication by its
    reciprocal)."""
    x = table[frames.to(torch.int64)].permute(0, 3, 1, 2)
    N, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(N, C, H, 2, W, 2).reshape(N, C, 2 * H, 2 * W)


def encode_video(vae: SVDVae, video_uint8, chunk_size: int) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, 4, 2H/8, 2W/8) float32 latent means. The
    video is uploaded as uint8, prepared and encoded ``chunk_size`` frames at
    a time on the VAE's device, and read back once."""
    device = vae.device
    video = torch.as_tensor(video_uint8).to(device)
    table = torch.from_numpy(pixel_table()).to(device)
    means = [vae.encode_video(prepare_frames(video[i:i + chunk_size], table)[None],
                              chunk_size=chunk_size)[0]
             for i in range(0, len(video), chunk_size)]
    return torch.cat(means).cpu().numpy()


def split_files(path: str, mode: str):
    """The basenames of the ``.pt`` lines of ``video_<mode>.csv``."""
    with open(os.path.join(path, f"video_{mode}.csv")) as f:
        return [line.rstrip("\n").split("/")[-1] for line in f if ".pt" in line]


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line). Returns the
    statistics written ({"mean", "std", "n_obs"}), or None without
    ``--normalize``."""
    args = create_argparser().parse_args(argv)
    path = args.path
    vae = load_vae(args.vae_weights, resolve_device(args.device))

    mean_x = np.zeros((1, 4, 1, 1), np.float64)
    mean_x2 = np.zeros((1, 4, 1, 1), np.float64)
    n_obs = 0
    mean = std = stats = None
    for mode in ["train", "test"]:
        fnames = split_files(path, mode)
        for fname in fnames:
            video = load_video(os.path.join(path, fname))
            means = encode_video(vae, video, args.chunk_size)
            save(os.path.join(path, "encoded_" + fname), means)
            if args.normalize and mode == "train":
                cur_n = means[:, 0].size
                cur_mean = means.astype(np.float64).mean(axis=(0, 2, 3), keepdims=True)
                cur_mean2 = (means.astype(np.float64) ** 2).mean(axis=(0, 2, 3), keepdims=True)
                mean_x = n_obs / (n_obs + cur_n) * mean_x + cur_n / (n_obs + cur_n) * cur_mean
                mean_x2 = n_obs / (n_obs + cur_n) * mean_x2 + cur_n / (n_obs + cur_n) * cur_mean2
                n_obs += cur_n
                print(f"n_obs: {n_obs}, mean: {mean_x.flatten()}")

        if args.normalize:
            if mode == "train":
                mean = mean_x.astype(np.float32)
                std = np.sqrt(mean_x2 - mean_x**2).astype(np.float32)
                stats = {"mean": mean.flatten(), "std": std.flatten(), "n_obs": n_obs}
                print("=== Final Stats ===", stats)
                torch.save({k: torch.tensor(v) for k, v in stats.items()},
                           os.path.join(path, STATS_FILE))
            print(f"normalizing {mode} data")
            for fname in fnames:
                encoded_path = os.path.join(path, "encoded_" + fname)
                video = load_video(encoded_path)
                save(encoded_path, (video - mean) / (std + 1e-8))
    return stats


if __name__ == "__main__":
    main()
