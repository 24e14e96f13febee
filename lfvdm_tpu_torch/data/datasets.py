"""Video datasets (host side, numpy): the synthetic and pre-encoded latent
parts of lfvdm_tpu/data/datasets.py.

``SyntheticVideoDataset`` and ``SyntheticLongRangeDataset`` are copies of the
JAX package's classes. The latent path's pieces are ported too:
``load_encoding_stats`` (the channel-wise latent norm stats of a pre-encoded
dataset), the one-file-per-video base classes with their DATA_ROOT scratch
cache, and ``EncodedNpyDataset``. ``load_data`` serves ``synthetic``,
``synthetic_longrange`` and ``synthetic_encoded`` single-process. The CARLA,
MineRL and GQN-mazes datasets, ``get_test_dataset``, process sharding, the
background prefetch thread and the native loader are not ported yet.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..utils.locks import Protect

video_data_paths_dict = {
    # Synthetic videos at 256 px, SVD-VAE-encoded offline to 32x32 C4
    # latents (the reference's latent config shape); built by the JAX
    # package's benchmarks/prep_synthetic_latent.py.
    "synthetic_encoded": "datasets/synthetic-encoded",
}

default_T_dict = {"synthetic_encoded": 100}

data_encoding_stats_dict = {
    "carla_no_traffic_2x_encoded": "datasets/carla/no-traffic-encoded/encoded_train_norm_stats.pt",
    "synthetic_encoded": "datasets/synthetic-encoded/encoded_train_norm_stats.pt",
}


def _data_root_path(rel_path: str) -> str:
    root = os.environ.get("DATA_ROOT", "")
    return os.path.join(root, rel_path) if root else rel_path


def load_encoding_stats(dataset_name: Optional[str]):
    """Channel-wise latent norm stats ``{"mean", "std"}`` (numpy (C,)) of a
    pre-encoded dataset, or None.

    The registry path resolves under DATA_ROOT like every dataset path;
    where the scratch cache does not hold the file yet, the source layout
    is read directly rather than training with identity stats.
    """
    rel = data_encoding_stats_dict.get(dataset_name)
    if not rel:
        return None
    path = _data_root_path(rel)
    if not os.path.exists(path):
        if path != rel and os.path.exists(rel):
            path = rel
        else:
            return None
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    return {"mean": raw["mean"].numpy(), "std": raw["std"].numpy()}


class BaseVideoDataset:
    """One file per video; optional DATA_ROOT scratch-dir caching."""

    def __init__(self, path, T: Optional[int]):
        self.T = T
        self.path = Path(path)
        self.is_test = False

    def __len__(self):
        return len(list(self.get_src_path(self.path).iterdir()))

    def __getitem__(self, idx) -> np.ndarray:
        path = self.getitem_path(idx)
        self.cache_file(path)
        video = self.postprocess_video(self.loaditem(path))
        return self.get_video_subsequence(video, self.T)

    def getitem_path(self, idx) -> Path:
        raise NotImplementedError

    def loaditem(self, path):
        raise NotImplementedError

    def postprocess_video(self, video) -> np.ndarray:
        raise NotImplementedError

    def cache_file(self, path: Path):
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            src_path = self.get_src_path(path)
            with Protect(path):
                shutil.copyfile(str(src_path), str(path))

    @staticmethod
    def get_src_path(path: Path) -> Path:
        if os.environ.get("DATA_ROOT"):
            data_root = Path(os.environ["DATA_ROOT"])
            if data_root in path.parents:
                return Path(*path.parts[len(data_root.parts):])
        return path

    def set_test(self):
        self.is_test = True

    def get_video_subsequence(self, video: np.ndarray, T: Optional[int]) -> np.ndarray:
        if T is None or T >= len(video):
            return video
        start = 0 if self.is_test else np.random.randint(len(video) - T + 1)
        return video[start:start + T]


class NpyPerVideoDataset(BaseVideoDataset):
    """{idx}.npy uint8 (T, H, W, C) videos -> float (T, C, H, W) in [-1, 1]."""

    def getitem_path(self, idx):
        return self.path / f"{idx}.npy"

    def loaditem(self, path):
        return np.load(path)

    def postprocess_video(self, video):
        video = video.astype(np.float32) / 255.0
        return 2 * video.transpose(0, 3, 1, 2) - 1


class EncodedNpyDataset(NpyPerVideoDataset):
    """{idx}.npy float32 (T, C, h, w) pre-encoded NORMALIZED latents; items
    pass through untouched (the normalization happened offline)."""

    def postprocess_video(self, video):
        return np.asarray(video, dtype=np.float32)


class SyntheticVideoDataset:
    """Deterministic procedural videos (moving gradients) for tests/benches."""

    # Test-split seed offset: set_test() draws from a DISJOINT parameter
    # range, so evaluating against the test split measures generalization,
    # not memorization.
    TEST_SEED_OFFSET = 100_000

    def __init__(self, num_videos=16, T=100, C=3, H=64, W=64, seed=0):
        self.num_videos, self.T, self.C, self.H, self.W = num_videos, T, C, H, W
        self.seed = seed
        self.is_test = False
        # Per-instance LRU cache of generated videos (bounded by CACHE_CAP).
        self._video_cache: dict = {}

    def __len__(self):
        return self.num_videos

    def set_test(self):
        """Switch to the held-out split (idempotent)."""
        if not self.is_test:
            self.seed += self.TEST_SEED_OFFSET
        self.is_test = True

    def __getitem__(self, idx) -> np.ndarray:
        # Cached: the training loop revisits the same videos every epoch and
        # regenerating (T, C, H, W) sinusoids on the host costs more than a
        # step's host work. Read-only so a cached array can't be mutated.
        key = (self.seed + idx, self.T, self.C, self.H, self.W)
        vid = self._video_cache.get(key)
        if vid is None:
            vid = self._generate(self.seed + idx)
            if len(self._video_cache) >= self.CACHE_CAP:
                # LRU eviction (dicts iterate in insertion order): caching
                # never silently stops, it just bounds resident bytes.
                self._video_cache.pop(next(iter(self._video_cache)))
            self._video_cache[key] = vid
        else:
            # refresh recency so steady-state revisits stay cached
            self._video_cache.pop(key)
            self._video_cache[key] = vid
        return vid

    CACHE_CAP = 64  # ~5 MB/entry at the default shape -> ≤~300 MB/instance

    def _generate(self, seed) -> np.ndarray:
        rng = np.random.default_rng(seed)
        phase = rng.random((self.C, 1, 1, 1)) * 2 * np.pi
        speed = 0.5 + rng.random((self.C, 1, 1, 1))
        t = np.arange(self.T).reshape(1, -1, 1, 1)
        y = np.linspace(0, 2 * np.pi, self.H).reshape(1, 1, -1, 1)
        x = np.linspace(0, 2 * np.pi, self.W).reshape(1, 1, 1, -1)
        vid = np.sin(x + y + speed * t * 0.2 + phase).astype(np.float32)
        vid = vid.transpose(1, 0, 2, 3)  # (T, C, H, W) in [-1, 1]
        vid.setflags(write=False)
        return vid


class SyntheticLongRangeDataset(SyntheticVideoDataset):
    """Synthetic videos with GENUINE long-range temporal dependence.

    Purpose: a proxy for the paper's headline result, that the choice of
    sampling scheme matters. The plain ``synthetic`` sinusoids are fully
    determined by any few frames, so every scheme scores alike on them.
    Here each video carries hidden
    per-video structure whose CONSISTENCY HORIZON exceeds the sampler
    window:

      * a regime square wave: the stripe orientation flips every ``s``
        frames, with s ~ U{25..45} and a hidden phase. Real videos keep s
        CONSTANT for the whole video. Within a segment the appearance gives
        zero information about time-since-switch (the carrier drift is
        continuous across switches), and s > max_frames always, so a
        sliding autoregressive window cannot know when the next flip is due
        — it must hallucinate memoryless switches, producing segment-length
        statistics no real video has. A hierarchy scheme's first call
        jointly generates frames spanning the whole video conditioned on
        the observations, so its anchors pin one globally consistent
        (s, phase).
      * a smooth carrier: the stripes drift at a per-video rate v, locally
        identifiable from any two frames — per-frame quality stays easy;
        only the LONG-RANGE statistic separates the schemes.

    Defaults to more train videos than ``synthetic`` (64 vs 16): the model
    must learn the regime RULE, not memorize 16 (s, phase) combinations —
    the held-out split (disjoint seed range) has unseen parameters.
    """

    def __init__(self, num_videos=64, T=100, C=3, H=64, W=64, seed=0):
        super().__init__(num_videos=num_videos, T=T, C=C, H=H, W=W, seed=seed)

    # exposed for tests and the contrast diagnostics
    S_MIN, S_MAX = 25, 45

    def regime_params(self, seed):
        """(s, phase0, v, psi) drawn for ``seed`` — the same stream
        ``_generate`` uses, so tests can re-derive ground truth."""
        rng = np.random.default_rng(seed)
        s = int(rng.integers(self.S_MIN, self.S_MAX + 1))
        phase0 = int(rng.integers(0, 2 * s))
        v = 0.10 + 0.15 * rng.random()
        psi = float(rng.random() * 2 * np.pi)
        return s, phase0, v, psi, rng

    def _generate(self, seed) -> np.ndarray:
        s, phase0, v, psi, rng = self.regime_params(seed)
        t = np.arange(self.T)
        regime = ((t + phase0) // s) % 2  # (T,) 0/1 square wave
        return self.generate_with_track(seed, regime)

    def generate_with_track(self, seed, regime_track) -> np.ndarray:
        """Render a video with seed's carrier but an EXPLICIT regime track.

        Used to calibrate a metric's sensitivity: surrogate videos that are
        pixel-perfect draws from the
        generator except for a controlled corruption of the segment
        statistic (the exact failure mode a windowed sampler produces)."""
        s, phase0, v, psi, rng = self.regime_params(seed)
        chan = rng.random(self.C) * 2 * np.pi
        t = np.arange(self.T)
        sign = (1.0 - 2.0 * np.asarray(regime_track)).reshape(-1, 1, 1, 1)
        y = np.linspace(0, 2 * np.pi, self.H).reshape(1, 1, -1, 1)
        x = np.linspace(0, 2 * np.pi, self.W).reshape(1, 1, 1, -1)
        # stripes along x+y (regime 0) or x-y (regime 1), drifting at v
        grid = 2.0 * x + 2.0 * y * sign
        phases = (v * t).reshape(-1, 1, 1, 1) + psi + chan.reshape(1, -1, 1, 1)
        vid = np.sin(grid + phases).astype(np.float32)
        vid.setflags(write=False)
        return vid


def _build_dataset(dataset_name, T, image_size, num_shards=1):
    size = {} if image_size is None else dict(H=image_size, W=image_size)
    if dataset_name == "synthetic":
        return SyntheticVideoDataset(T=T or 100, **size)
    if dataset_name == "synthetic_longrange":
        return SyntheticLongRangeDataset(T=T or 100, **size)
    if dataset_name == "synthetic_encoded":
        if num_shards != 1:
            raise ValueError("synthetic_encoded is not shardable (single dir): "
                             f"{num_shards} processes would all read the same rows")
        if image_size is not None:
            raise ValueError("synthetic_encoded has the size its files have; pass no image_size")
        path = _data_root_path(video_data_paths_dict[dataset_name])
        return EncodedNpyDataset(os.path.join(path, "train"),
                                 T=default_T_dict[dataset_name] if T is None else T)
    raise ValueError(f"unknown or not yet ported dataset: {dataset_name}")


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def load_data(dataset_name: str, batch_size: int, T: Optional[int] = None,
              deterministic: bool = False, return_dataset: bool = False, seed: int = 0,
              image_size: Optional[int] = None):
    """Infinite batch generator over the ported datasets.

    Yields float32 (B, T, C, H, W) numpy batches forever (drop_last: an epoch
    is a shuffled pass, ``deterministic`` keeps the dataset order). T defaults
    to 100 frames. ``image_size`` sets H = W of the synthetic videos (the JAX
    package's generator always renders its default 64); None keeps that
    default. ``synthetic_encoded`` reads ``{idx}.npy`` latents from the
    registry's ``train`` directory under DATA_ROOT; it refuses to run in
    more than one process, as every process would read the same rows.
    """
    dataset = _build_dataset(dataset_name, T, image_size, _process_count())
    if return_dataset:
        return dataset
    return batch_generator(dataset, batch_size, deterministic, seed)


def batch_generator(dataset, batch_size: int, deterministic: bool = False,
                    seed: int = 0) -> Iterator[np.ndarray]:
    """Batches of ``batch_size`` items of ``dataset`` forever (drop_last;
    each epoch shuffled by a numpy generator from ``seed`` unless
    ``deterministic``)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    while True:
        if not deterministic:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield np.stack([dataset[j] for j in order[i:i + batch_size]])

