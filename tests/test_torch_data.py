"""The port's datasets and loaders against lfvdm_tpu.data.datasets.

Fixture videos are written by the tests (uint8 from a numpy seed). Every
comparison is bitwise (no tolerance): the registry dicts, the items of the
CARLA, CARLA-2x (pixel and pre-encoded), MineRL/GQN-mazes-layout datasets
with the same numpy seed for their window starts, the test split, the Python
prefetch loader's batches (``LFVDM_NATIVE_LOADER=0`` on both sides; each
module's window starts drawn from a numpy stream of its own, so the two
background threads cannot interleave their draws), the shard slicing for a
rank and world size, and the "not shardable" refusal.
"""

import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import lfvdm_tpu.data.datasets as jdata
import lfvdm_tpu_torch.data.datasets as tdata


def _make_carla_dir(root: Path, n_videos=6, T=12, H=8, W=8, C=3, encoded=False):
    """CARLA layout: video_XXXXX.pt uint8 (T, H, W, C) (and encoded_ twins,
    float32 (T, 4, H, W)); all but the last video in video_train.csv."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(n_videos):
        name = f"video_{i:05d}.pt"
        torch.save(torch.from_numpy(rng.integers(0, 256, (T + i, H, W, C), dtype=np.uint8)),
                   root / name)
        if encoded:
            lat = rng.standard_normal((T + i, 4, H, W)).astype(np.float32)
            torch.save(torch.from_numpy(lat), root / ("encoded_" + name))
        names.append(name)
    (root / "video_train.csv").write_text("\n".join(f"some/dir/{n}" for n in names[:-1]))
    (root / "video_test.csv").write_text(names[-1] + "\n")
    return names


def _make_npy_dir(root: Path, n_videos=5, T=10, H=8, W=8, C=3):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    for i in range(n_videos):
        np.save(root / f"{i}.npy", rng.integers(0, 256, (T + i, H, W, C), dtype=np.uint8))


def _npy_siblings(ds):
    for f in ds.fnames:
        arr = torch.load(ds.path / f, weights_only=False).numpy()
        np.save((ds.path / f).with_suffix(".npy"), arr)


def test_registry_dicts_equal_jax():
    for name in ("video_data_paths_dict", "default_T_dict", "default_image_size_dict",
                 "data_encoding_stats_dict"):
        assert getattr(tdata, name) == getattr(jdata, name), name


def _pair(kind, tmp_path, T):
    """The same dataset built by both packages."""
    if kind == "carla":
        _make_carla_dir(tmp_path)
        return [m.CarlaDataset(True, tmp_path, 0, 1, T=T) for m in (tdata, jdata)]
    if kind in ("carla2x", "carla2x_encoded"):
        _make_carla_dir(tmp_path, encoded=True)
        enc = kind.endswith("encoded")
        return [m.Carla2xDataset(True, tmp_path, 0, 1, T=T, encoded=enc) for m in (tdata, jdata)]
    _make_npy_dir(tmp_path / "train")
    return [m.NpyPerVideoDataset(tmp_path / "train", T=T) for m in (tdata, jdata)]


@pytest.mark.parametrize("kind", ["carla", "carla2x", "carla2x_encoded", "npy"])
@pytest.mark.parametrize("T", [4, None])
def test_items_equal_jax(kind, T, tmp_path):
    t, j = _pair(kind, tmp_path, T)
    assert len(t) == len(j) and t.is_test == j.is_test is False
    for i in range(len(t)):
        np.random.seed(i)
        a = t[i]
        np.random.seed(i)
        b = j[i]
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    t.set_test()
    j.set_test()
    assert t.is_test and j.is_test
    np.testing.assert_array_equal(t[1], j[1])
    assert t.native_paths() == j.native_paths()
    if kind == "carla":
        assert t.native_paths() is None  # no .npy siblings yet
        _npy_siblings(t)
        assert t.native_paths() == j.native_paths() and len(t.native_paths()) == len(t)
    elif kind == "npy":
        assert len(t.native_paths()) == len(t)
    elif kind == "carla2x_encoded":
        assert t.fnames[0].startswith("encoded_")


def test_resolve_existing_and_cold_cache_match_jax(tmp_path, monkeypatch):
    """A cold DATA_ROOT cache resolves to the source copies; a cached copy
    wins once it exists."""
    src_rel = Path("datasets/carla/no-traffic")
    _make_carla_dir(tmp_path / src_rel)
    scratch = tmp_path / "scratch"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DATA_ROOT", str(scratch))
    t = tdata.CarlaDataset(True, scratch / src_rel, 0, 1, T=4)
    j = jdata.CarlaDataset(True, scratch / src_rel, 0, 1, T=4)
    p = t.getitem_path(0)
    assert t.resolve_existing(p) == j.resolve_existing(p) == src_rel / t.fnames[0]
    _npy_siblings(jdata.CarlaDataset(True, src_rel, 0, 1, T=4))
    assert t.native_paths() == j.native_paths() and all(str(scratch) not in x
                                                       for x in t.native_paths())
    t[0]  # a read fills the cache
    assert t.resolve_existing(p) == j.resolve_existing(p) == p


def _use_registry(monkeypatch, tmp_path):
    """CARLA, its encoded twin and a MineRL-layout dataset under tmp_path."""
    for mod in (tdata, jdata):
        monkeypatch.setitem(mod.video_data_paths_dict, "carla_no_traffic", str(tmp_path / "c"))
        monkeypatch.setitem(mod.video_data_paths_dict, "carla_no_traffic_2x_encoded",
                            str(tmp_path / "c"))
        monkeypatch.setitem(mod.video_data_paths_dict, "minerl", str(tmp_path / "m"))
    _make_carla_dir(tmp_path / "c", encoded=True)
    _make_npy_dir(tmp_path / "m" / "train")
    _make_npy_dir(tmp_path / "m" / "test", n_videos=3)


@pytest.mark.parametrize("name,T", [("carla_no_traffic", 5), ("carla_no_traffic_2x_encoded", 5),
                                    ("minerl", 6), ("synthetic", 7),
                                    ("synthetic_longrange", None)])
def test_get_test_dataset_equals_jax(name, T, tmp_path, monkeypatch):
    _use_registry(monkeypatch, tmp_path)
    t, j = tdata.get_test_dataset(name, T=T), jdata.get_test_dataset(name, T=T)
    assert type(t).__name__ == type(j).__name__ and t.is_test and j.is_test
    assert len(t) == len(j) and t.T == j.T
    for i in range(len(t)):
        np.testing.assert_array_equal(t[i], j[i])


class _NumpyOwnRandom:
    """numpy, with ``np.random.randint`` drawing from a stream per thread: the
    n-th thread started after this proxy to draw gets ``RandomState(n)``.
    Each module gets one, so its loader threads draw the same streams in the
    same order whatever the other module's threads do meanwhile. A thread
    that was alive before the proxy (a loader of an earlier test finishing
    its batch: the JAX loader's thread never stops) draws from a stream of
    its own that is not counted, so it cannot take stream 0."""

    def __init__(self):
        self._streams = {}
        self._earlier = set(threading.enumerate())
        self._stale = np.random.RandomState(2**31)
        self._lock = threading.Lock()
        self.random = types.SimpleNamespace(randint=self._randint,
                                            default_rng=np.random.default_rng)

    def _randint(self, *args, **kwargs):
        with self._lock:
            me = threading.current_thread()
            if me in self._earlier:
                return self._stale.randint(*args, **kwargs)
            if me not in self._streams:
                self._streams[me] = np.random.RandomState(len(self._streams))
        return self._streams[me].randint(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(np, name)


def _take(gen, n):
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("name", ["carla_no_traffic", "minerl", "synthetic"])
@pytest.mark.parametrize("deterministic", [False, True])
def test_prefetch_loader_batches_equal_jax(name, deterministic, tmp_path, monkeypatch):
    _use_registry(monkeypatch, tmp_path)
    monkeypatch.setenv("LFVDM_NATIVE_LOADER", "0")
    monkeypatch.setattr(jdata, "np", _NumpyOwnRandom())
    monkeypatch.setattr(tdata, "np", _NumpyOwnRandom())
    T = 4 if name != "synthetic" else 6
    kw = dict(batch_size=2, T=T, deterministic=deterministic, seed=5)
    loader = tdata.load_data(name, **kw)
    try:
        got = _take(loader, 6)  # three epochs of CARLA's 5 videos
    finally:
        loader.close()
    want = _take(jdata.load_data(name, **kw), 6)
    for a, b in zip(got, want):
        assert a.shape == (2, T) + b.shape[2:] and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _as_rank(monkeypatch, rank, world):
    import jax
    import torch.distributed as dist

    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)


@pytest.mark.parametrize("world", [2, 3])
def test_shards_match_jax_process_index(world, tmp_path, monkeypatch):
    """Rank r of W reads fnames[r::W] and shuffles with seed + r, as JAX
    process r of W does."""
    _use_registry(monkeypatch, tmp_path)
    monkeypatch.setenv("LFVDM_NATIVE_LOADER", "0")
    monkeypatch.setattr(jdata, "np", _NumpyOwnRandom())
    monkeypatch.setattr(tdata, "np", _NumpyOwnRandom())
    every = []
    for rank in range(world):
        _as_rank(monkeypatch, rank, world)
        t = tdata.load_data("carla_no_traffic", batch_size=1, T=4, return_dataset=True)
        j = jdata.load_data("carla_no_traffic", batch_size=1, T=4, return_dataset=True)
        assert t.fnames == j.fnames
        every += t.fnames
        kw = dict(batch_size=1, T=4, seed=11)
        for a, b in zip(_take(tdata.load_data("carla_no_traffic", **kw), 4),
                        _take(jdata.load_data("carla_no_traffic", **kw), 4)):
            np.testing.assert_array_equal(a, b)
    assert sorted(every) == sorted(tdata.CarlaDataset(True, tmp_path / "c", 0, 1, None).fnames)


def test_not_shardable_refusal(tmp_path, monkeypatch):
    _use_registry(monkeypatch, tmp_path)
    _as_rank(monkeypatch, 1, 2)
    for name in ("minerl", "mazes_cwvae", "synthetic_encoded"):
        with pytest.raises(ValueError, match="not shardable"):
            tdata.load_data(name, batch_size=1)
        with pytest.raises(ValueError, match="not shardable"):
            jdata.load_data(name, batch_size=1)
        with pytest.raises(ValueError, match="not shardable"):
            tdata._build_dataset(name, 4, None, num_shards=2, shard=1)
    # The shardable names build their own shard.
    assert len(tdata.load_data("carla_no_traffic", batch_size=1, return_dataset=True)) == 2
    assert tdata.load_data("synthetic", batch_size=1, return_dataset=True).T == 100


def test_unknown_dataset_and_image_size_raise(tmp_path, monkeypatch):
    _use_registry(monkeypatch, tmp_path)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.load_data("nope", batch_size=1)
    with pytest.raises(ValueError, match="image_size"):
        tdata.load_data("carla_no_traffic", batch_size=1, image_size=64)


def test_loader_counts_batches_and_hands_on_errors(tmp_path, monkeypatch):
    """The loader says which reader serves it and counts its batches; an
    error in the thread is raised in the consumer; closing the loader, or
    dropping it, ends the thread."""
    _use_registry(monkeypatch, tmp_path)
    monkeypatch.setenv("LFVDM_NATIVE_LOADER", "0")
    for drop in (False, True):
        gen = tdata.load_data("carla_no_traffic", batch_size=2, T=4, num_prefetch=1)
        assert gen.source is None and threading.active_count() >= 1
        before = threading.active_count()
        _take(gen, 3)
        assert (gen.source, gen.served) == ("python", 3)
        assert threading.active_count() == before + 1
        if drop:
            del gen
        else:
            gen.close()
        deadline = time.time() + 5
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() == before

    ds = tdata.CarlaDataset(True, tmp_path / "c", 0, 1, T=4)
    (tmp_path / "c" / ds.fnames[2]).unlink()
    bad = tdata._batch_generator(ds, 5, 4, True, 2, 0)
    with pytest.raises(FileNotFoundError):
        next(bad)
