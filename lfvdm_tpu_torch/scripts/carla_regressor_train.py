"""Train the CARLA world-coordinate classifier or multi-head regressor
(counterpart of the repo's scripts/carla_regressor_train.py).

    python -m lfvdm_tpu_torch.scripts.carla_regressor_train --data_dir datasets/carla/no-traffic \\
        --is_classifier True

A per-frame dataset exploded from the CARLA videos and their ``coords_*.npy``
siblings, SGD with momentum 0.9 and an LR that falls x0.1 every 7 epochs
(counted in optimizer steps), BatchNorm in train mode for the steps and in
eval mode for the test loss; the classifier's loss is the sigmoid BCE of the
one-hot cell, the regressor's the MSE of the coordinates. Each epoch whose
test loss is the best so far saves ``<out_dir>/model_{epoch}.pt``, a
torchvision-layout state_dict that both packages'
``load_classifier_regressor_like_paper`` read. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..config import str2bool
from ..evals.carla_regressor import (
    MultiHeadResNet152,
    ResNet152Classifier,
    get_cell,
    normalize_frames,
    seeded_init,
)
from ..utils.device import full_f32, resolve_device


class CarlaRegressorFrames:
    """Per-frame (frame, coord, cell) dataset exploded from video files into
    ``individual-frames/{train,test}``."""

    def __init__(self, train: bool, path: str):
        self.video_path = Path(path)
        self.path = self.video_path / "individual-frames" / ("train" if train else "test")
        split = self.video_path / f"video_{'train' if train else 'test'}.csv"
        with open(split) as f:
            fnames = [line.rstrip("\n").split("/")[-1] for line in f if ".pt" in line]
        self.path.mkdir(parents=True, exist_ok=True)
        if len(list(self.path.glob("video_*_frame_0.npy"))) != len(fnames):
            for fname in fnames:
                coords_fname = fname.replace(".pt", ".npy").replace("video_", "coords_")
                video = torch.load(self.video_path / fname, weights_only=False).numpy()
                coords = np.load(self.video_path / coords_fname)
                for i, (frame, coord) in enumerate(zip(video, coords)):
                    np.save(self.path / fname.replace(".pt", f"_frame_{i}.npy"), frame)
                    np.save(self.path / coords_fname.replace(".npy", f"_frame_{i}.npy"), coord)
        self.paths = sorted(self.path.glob("video_*.npy"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = np.load(self.paths[idx])  # (H, W, C) uint8
        coord = np.load(str(self.paths[idx]).replace("video", "coords"))[[0, 1]]
        return img.transpose(2, 0, 1), coord.astype(np.float32), get_cell(coord)


def batches(dataset, batch_size, rng, shuffle=True):
    """Full batches (frames normalised, coords, cells) as numpy; a shuffle
    draws from ``rng``."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        items = [dataset[j] for j in order[i:i + batch_size]]
        frames = normalize_frames(np.stack([x[0] for x in items]))
        coords = np.stack([x[1] for x in items])
        cells = np.array([x[2] for x in items], np.int64)
        yield frames, coords, cells


def loss_fn(model, is_classifier, frames, coords, cells):
    if is_classifier:
        onehot = F.one_hot(cells, 100).to(frames.dtype)
        return F.binary_cross_entropy_with_logits(model(frames), onehot)
    return F.mse_loss(model(frames, cells), coords)


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--is_classifier", type=str2bool, default=False)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num_epochs", type=int, default=25)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--out_dir", type=str, default="checkpoints/carla_regressor")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train on: cuda (default) or cpu")
    return parser


def build_model(is_classifier: bool):
    """The seeded full-depth classifier or regressor."""
    return seeded_init(ResNet152Classifier() if is_classifier else MultiHeadResNet152())


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns
    ``{"train_loss", "test_loss"}`` per epoch, the best test loss and the
    checkpoints written."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)

    model = build_model(args.is_classifier).to(device)
    rng = np.random.default_rng(0)
    train_set = CarlaRegressorFrames(True, args.data_dir)
    test_set = CarlaRegressorFrames(False, args.data_dir)
    # The JAX script shuffles once to draw the batch its init is traced on:
    # the same draw here keeps the epochs' batch order the same.
    rng.shuffle(np.arange(len(train_set)))

    # SGD momentum 0.9, x0.1 every 7 epochs of steps (a staircase decay).
    steps_per_epoch = max(1, len(train_set) // args.batch_size)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** (step // (7 * steps_per_epoch)))

    def tensors(frames, coords, cells):
        return (torch.as_tensor(frames, device=device), torch.as_tensor(coords, device=device),
                torch.as_tensor(cells, device=device))

    best_loss = np.inf
    history, saved = [], []
    os.makedirs(args.out_dir, exist_ok=True)
    with full_f32():
        for epoch in range(args.num_epochs):
            model.train()
            train_loss, n = 0.0, 0
            for batch in batches(train_set, args.batch_size, rng):
                frames, coords, cells = tensors(*batch)
                loss = loss_fn(model, args.is_classifier, frames, coords, cells)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                schedule.step()
                train_loss += loss.item() * len(frames)
                n += len(frames)
            model.eval()
            test_loss, m = 0.0, 0
            with torch.no_grad():
                for batch in batches(test_set, args.batch_size, rng, shuffle=False):
                    frames, coords, cells = tensors(*batch)
                    test_loss += float(loss_fn(model, args.is_classifier, frames, coords,
                                               cells)) * len(frames)
                    m += len(frames)
            train_loss, test_loss = train_loss / max(n, 1), test_loss / max(m, 1)
            history.append({"train_loss": train_loss, "test_loss": test_loss})
            print(f"epoch {epoch}: train {train_loss:.4f} test {test_loss:.4f}")
            if test_loss < best_loss:
                best_loss = test_loss
                path = os.path.join(args.out_dir, f"model_{epoch}.pt")
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
                saved.append(path)
    print(f"best test loss: {best_loss:.4f}")
    return {"epochs": history, "best_loss": best_loss, "saved": saved}


if __name__ == "__main__":
    main()
