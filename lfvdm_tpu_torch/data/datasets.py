"""Video datasets and loaders, host side (counterpart of
lfvdm_tpu/data/datasets.py).

The registry dicts, the one-file-per-video datasets (CARLA ``.pt``, its 2x
and pre-encoded variants, MineRL and GQN-mazes ``.npy``, pre-encoded latent
``.npy``) with their DATA_ROOT scratch cache, the synthetic datasets, and the
infinite loader: sharded by the ``torch.distributed`` rank and world size
(one process, rank 0, without a process group), reading through the native
C++ loader (``data/native_loader.py``) where a dataset exposes per-video
``.npy`` paths and through Python otherwise, prefetched on a background
thread. Batches, their order and their seeds (``seed + shard``) are the JAX
package's.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from queue import Full, Queue
from typing import Iterator, Optional

import numpy as np

from ..utils import tracing
from ..utils.device import process_index_and_count
from ..utils.locks import Protect

video_data_paths_dict = {
    "minerl": "datasets/minerl_navigate-torch",
    "mazes_cwvae": "datasets/gqn_mazes-torch",
    "carla_no_traffic": "datasets/carla/no-traffic",
    "carla_no_traffic_2x": "datasets/carla/no-traffic",
    "carla_no_traffic_2x_encoded": "datasets/carla/no-traffic-encoded",
    # Synthetic videos at 256 px, SVD-VAE-encoded offline to 32x32 C4
    # latents (the reference's latent config shape); built by the JAX
    # package's benchmarks/prep_synthetic_latent.py.
    "synthetic_encoded": "datasets/synthetic-encoded",
}

default_T_dict = {
    "minerl": 500,
    "mazes_cwvae": 300,
    "carla_no_traffic": 1000,
    "carla_no_traffic_2x": 1000,
    "carla_no_traffic_2x_encoded": 1000,
    "synthetic_encoded": 100,
}

default_image_size_dict = {
    "minerl": 64,
    "mazes_cwvae": 64,
    "carla_no_traffic": 128,
    "carla_no_traffic_2x": 256,
    "carla_no_traffic_2x_encoded": 32,
    "synthetic_encoded": 32,
}

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

    def native_paths(self) -> Optional[list]:
        """Per-video .npy paths for the native loader, or None when this
        dataset cannot be streamed natively (non-.npy storage)."""
        return None

    def resolve_existing(self, path: Path) -> Optional[Path]:
        """Where ``path`` exists now: the DATA_ROOT cache copy if present,
        else the source file (only ``__getitem__`` fills the cache), else
        None. The native loader reads windows straight from either."""
        if path.exists():
            return path
        src = self.get_src_path(path)
        return src if src != path and src.exists() else None

    def get_video_subsequence(self, video: np.ndarray, T: Optional[int]) -> np.ndarray:
        if T is None or T >= len(video):
            return video
        start = 0 if self.is_test else np.random.randint(len(video) - T + 1)
        return video[start:start + T]


def _existing_paths(dataset, paths) -> Optional[list]:
    found = [dataset.resolve_existing(p) for p in paths]
    if found and all(p is not None for p in found):
        return [str(p) for p in found]
    return None


class CarlaDataset(BaseVideoDataset):
    """CARLA Town01: per-video .pt uint8 (T, H, W, C) -> float (T, C, H, W)
    in [-1, 1]; the split's file names come from video_{train,test}.csv,
    every ``num_shards``-th from ``shard``."""

    def __init__(self, train, path, shard, num_shards, T):
        super().__init__(path=path, T=T)
        self.split_path = self.path / f"video_{'train' if train else 'test'}.csv"
        self.cache_file(self.split_path)
        with open(self.split_path) as f:
            self.fnames = [line.rstrip("\n").split("/")[-1] for line in f if ".pt" in line]
        self.fnames = self.fnames[shard::num_shards]

    def __len__(self):
        return len(self.fnames)

    def getitem_path(self, idx):
        return self.path / self.fnames[idx]

    def loaditem(self, path):
        import torch

        return torch.load(path, map_location="cpu", weights_only=False).numpy()

    def postprocess_video(self, video):
        return -1 + 2 * (video.transpose(0, 3, 1, 2).astype(np.float32) / 255)

    def native_paths(self):
        # A .pt item is deserialised whole; .npy siblings (the JAX package's
        # datasets/carla/convert_pt_to_npy.py writes them) let the native
        # loader read just the window. Used when every video has one.
        return _existing_paths(self, [self.getitem_path(i).with_suffix(".npy")
                                      for i in range(len(self))])


class Carla2xDataset(CarlaDataset):
    """2x nearest-upsampled CARLA, or its pre-encoded SVD-VAE latents."""

    def __init__(self, train, path, shard, num_shards, T, encoded=False):
        super().__init__(train, path, shard, num_shards, T)
        self.encoded = encoded
        if encoded:
            self.fnames = ["encoded_" + f for f in self.fnames]

    def postprocess_video(self, video):
        if self.encoded:
            return np.asarray(video, dtype=np.float32)
        video = -1 + 2 * (video.transpose(0, 3, 1, 2).astype(np.float32) / 255)
        return np.repeat(np.repeat(video, 2, axis=2), 2, axis=3)  # nearest 2x


class NpyPerVideoDataset(BaseVideoDataset):
    """{idx}.npy uint8 (T, H, W, C) videos (MineRL, GQN-mazes) -> float
    (T, C, H, W) in [-1, 1]."""

    def getitem_path(self, idx):
        return self.path / f"{idx}.npy"

    def native_paths(self):
        return _existing_paths(self, [self.getitem_path(i) for i in range(len(self))])

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

    def native_paths(self):
        # The C++ loader streams (T, H, W, C) pixel videos; these are
        # (T, C, h, w) latents: the Python path serves them.
        return None


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


# Names whose files sit in one directory that every process would read
# whole: the reference refuses to run them in more than one process.
_SINGLE_DIR = ("minerl", "mazes_cwvae", "synthetic_encoded")


def _build_dataset(dataset_name, T, image_size=None, num_shards=1, *, train=True, shard=0):
    """The dataset of ``dataset_name``'s split, this process's shard of it.
    ``image_size`` (H = W) applies to the synthetic datasets only; the
    others have the size their files have."""
    if dataset_name in _SINGLE_DIR and (shard != 0 or num_shards != 1):
        raise ValueError(f"{dataset_name} is not shardable (single dir): "
                         f"{num_shards} processes would all read the same rows")
    if dataset_name in ("synthetic", "synthetic_longrange"):
        cls = SyntheticVideoDataset if dataset_name == "synthetic" else SyntheticLongRangeDataset
        size = {} if image_size is None else dict(H=image_size, W=image_size)
        ds = cls(T=T or 100, **size)
        if not train:
            ds.set_test()
        return ds
    if dataset_name not in video_data_paths_dict:
        raise ValueError(f"unknown dataset: {dataset_name}")
    if image_size is not None:
        raise ValueError(f"{dataset_name} has the size its files have; pass no image_size")
    data_path = _data_root_path(video_data_paths_dict[dataset_name])
    split = os.path.join(data_path, "train" if train else "test")
    if dataset_name in ("minerl", "mazes_cwvae"):
        return NpyPerVideoDataset(split, T=T)
    if dataset_name == "synthetic_encoded":
        return EncodedNpyDataset(split, T=default_T_dict[dataset_name] if T is None else T)
    kw = dict(train=train, path=data_path, shard=shard, num_shards=num_shards, T=T)
    if dataset_name == "carla_no_traffic":
        return CarlaDataset(**kw)
    return Carla2xDataset(**kw, encoded=dataset_name.endswith("_encoded"))


def load_data(dataset_name: str, batch_size: int, T: Optional[int] = None,
              deterministic: bool = False, num_prefetch: int = 2,
              return_dataset: bool = False, seed: int = 0,
              image_size: Optional[int] = None):
    """Infinite batch generator, sharded across processes.

    Yields float32 (B, T, C, H, W) numpy batches forever (drop_last: an epoch
    is a pass in an order shuffled by a numpy generator from ``seed +
    shard``; ``deterministic`` keeps the dataset order, random window starts
    stay; test mode is ``get_test_dataset``). T defaults to the registry's
    (100 frames for the synthetic datasets). ``image_size`` sets H = W of the
    synthetic videos (the JAX package renders its default 64); None keeps
    that default. Batches are read by the native loader where the dataset
    has per-video ``.npy`` files, else in Python, on a background thread
    ``num_prefetch`` batches ahead. A dataset in one directory refuses more
    than one process: every process would read the same rows.
    """
    T = default_T_dict.get(dataset_name) if T is None else T
    shard, num_shards = process_index_and_count()
    if dataset_name in _SINGLE_DIR and num_shards > 1:
        raise ValueError(f"dataset {dataset_name!r} is not shardable across {num_shards} "
                         "processes; it would duplicate rows")
    dataset = _build_dataset(dataset_name, T, image_size, num_shards, shard=shard)
    if return_dataset:
        return dataset
    return _batch_generator(dataset, batch_size, T, deterministic, num_prefetch, seed + shard)


def batch_generator(dataset, batch_size: int, deterministic: bool = False,
                    seed: int = 0) -> Iterator[np.ndarray]:
    """Batches of ``batch_size`` items of ``dataset`` forever, drawn where
    they are asked for (drop_last; each epoch shuffled by a numpy generator
    from ``seed`` unless ``deterministic``). The prefetch thread runs it.
    Traced (``utils/tracing.py``): each item as ``loader.read`` (a file
    dataset's ``__getitem__`` also normalises it) and the batch's stack as
    ``loader.normalize``."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    while True:
        if not deterministic:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = []
            for j in order[i:i + batch_size]:
                with tracing.span("loader.read"):
                    items.append(dataset[j])
            with tracing.span("loader.normalize"):
                batch = np.stack(items)
            _count_batch(batch)
            yield batch


def _native_batches(dataset, batch_size, T, deterministic, num_prefetch, seed):
    """Normalized batches from the native loader, or None where it cannot
    serve ``dataset``: no per-video ``.npy`` paths, ``LFVDM_NATIVE_LOADER=0``,
    no library, or files it refuses. Traced (``utils/tracing.py``): the wait
    for the C++ pool's batch as ``loader.read``, its normalisation
    (``postprocess_video`` of every item) as ``loader.normalize``."""
    paths = getattr(dataset, "native_paths", lambda: None)()
    if not paths or os.environ.get("LFVDM_NATIVE_LOADER", "1") == "0":
        return None
    from .native_loader import NativeVideoLoader, native_loader_available

    if not native_loader_available():
        return None
    try:
        native = NativeVideoLoader(
            paths, T=T, batch_size=batch_size, seed=seed,
            num_threads=int(os.environ.get("LFVDM_LOADER_THREADS", "4")),
            capacity=num_prefetch, deterministic=deterministic, test_mode=dataset.is_test)
    except RuntimeError as e:
        print(f"native loader unavailable ({e}); using Python loader")
        return None

    def batches():
        try:
            while True:
                with tracing.span("loader.read"):
                    raw = next(native)  # (B, T, H, W, C) in the files' dtype
                with tracing.span("loader.normalize"):
                    batch = np.stack([dataset.postprocess_video(v) for v in raw])
                _count_batch(batch)
                yield batch
        finally:
            native.close()

    return batches()


def _count_batch(batch: np.ndarray):
    tracing.count("loader.batches")
    tracing.count("loader.frames", batch.shape[0] * batch.shape[1])


def _batch_generator(dataset, batch_size, T, deterministic, num_prefetch, seed):
    """The JAX package's prefetching loader (by its name there)."""
    return PrefetchedBatches(dataset, batch_size, T, deterministic, num_prefetch, seed)


class PrefetchedBatches:
    """The infinite batch iterator ``load_data`` returns: the native loader's
    batches where it can serve the dataset, else ``batch_generator``'s,
    read on a background thread ``num_prefetch`` batches ahead (started by
    the first ``next``), so reading and normalising stay off the consumer's
    path. An error on the thread is raised in the consumer. ``source`` says
    which loader reads ("native" or "python", set by the first ``next``),
    ``served`` counts the batches handed out. The thread stops at its next
    batch boundary once the iterator is closed or collected (it holds no
    reference to it); ``close()`` also waits for it to end."""

    JOIN_TIMEOUT_S = 30.0

    def __init__(self, dataset, batch_size, T, deterministic, num_prefetch, seed):
        self._args = (dataset, batch_size, T, deterministic, num_prefetch, seed)
        self._queue: Queue = Queue(maxsize=num_prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.source: Optional[str] = None
        self.served = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.source is None:
            dataset, batch_size, T, deterministic, num_prefetch, seed = self._args
            batches = _native_batches(dataset, batch_size, T, deterministic, num_prefetch, seed)
            self.source = "python" if batches is None else "native"
            if batches is None:
                batches = batch_generator(dataset, batch_size, deterministic, seed)
            self._thread = threading.Thread(target=_produce,
                                            args=(batches, self._queue, self._stop),
                                            daemon=True)
            self._thread.start()
        batch = self._queue.get()
        if isinstance(batch, Exception):
            raise batch
        self.served += 1
        return batch

    def close(self):
        """Stop the producer and wait (up to ``JOIN_TIMEOUT_S``) for it to
        finish the batch it is reading."""
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(self.JOIN_TIMEOUT_S)

    def __del__(self):
        self._stop.set()


def _produce(batches, queue: Queue, stop: threading.Event):
    """Put ``batches`` into ``queue`` until ``stop`` is set; an error goes
    into the queue for the consumer. Traced: each put, blocked while the
    queue is full, as ``loader.put_wait``."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                queue.put(item, timeout=0.1)
                return True
            except Full:
                pass
        return False

    try:
        for batch in batches:
            with tracing.span("loader.put_wait"):
                if not put(batch):
                    return
    except Exception as e:
        put(e)
    finally:
        batches.close()


def get_test_dataset(dataset_name, T=None):
    """The test split (every video, window starts at frame 0)."""
    T = default_T_dict.get(dataset_name) if T is None else T
    dataset = _build_dataset(dataset_name, T, train=False)
    dataset.set_test()
    return dataset
