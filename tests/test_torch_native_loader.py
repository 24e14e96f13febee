"""The port's binding of the native C++ loader against the JAX package's.

The port builds its own copy of ``videoloader.cpp`` (byte for byte the JAX
package's) into ``lfvdm_tpu_torch/native/_build/``; for the same files and
seed both bindings give the same batches, bitwise, in deterministic (test)
and random-window modes, and ``vl_open`` refuses what
``tests/test_native_loader.py`` has it refuse. Both libraries are built with
``g++``; without one the tests skip.
"""

from pathlib import Path

import numpy as np
import pytest

import lfvdm_tpu.data.native_loader as jnative
import lfvdm_tpu_torch.data.native_loader as tnative

ROOT = Path(__file__).resolve().parent.parent

needs_native = pytest.mark.skipif(
    not (tnative.native_loader_available() and jnative.native_loader_available()),
    reason=f"native loader unavailable: {tnative.native_loader_error()} / "
           f"{jnative.native_loader_error()}")


def _write_videos(tmp_path, n=6, T=12, H=8, W=8, C=3, dtype=np.uint8):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        if dtype == np.uint8:
            vid = rng.integers(0, 256, (T + i, H, W, C), dtype=np.uint8)
        else:
            vid = rng.standard_normal((T + i, H, W, C)).astype(np.float32)
        p = tmp_path / f"{i}.npy"
        np.save(p, vid)
        paths.append(str(p))
    return paths


def test_source_is_the_jax_packages_and_builds_into_the_port():
    assert (ROOT / "lfvdm_tpu_torch/native/videoloader.cpp").read_bytes() == \
        (ROOT / "lfvdm_tpu/native/videoloader.cpp").read_bytes()
    path = tnative.library_path()
    assert path.parent == ROOT / "lfvdm_tpu_torch" / "native" / "_build"
    assert path.name.startswith("libvideoloader-") and path.suffix == ".so"
    if tnative.native_loader_available():
        assert path.exists()


@needs_native
@pytest.mark.parametrize("mode", ["test", "deterministic", "random"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_same_stream_as_jax_binding(mode, dtype, tmp_path):
    paths = _write_videos(tmp_path, n=5, T=10, dtype=dtype)
    kw = dict(T=6, batch_size=2, seed=42, num_threads=3, capacity=2,
              deterministic=mode != "random", test_mode=mode == "test")
    t, j = tnative.NativeVideoLoader(paths, **kw), jnative.NativeVideoLoader(paths, **kw)
    try:
        assert t.item_shape == j.item_shape == (6, 8, 8, 3) and t.dtype == j.dtype == dtype
        for _ in range(7):  # across epochs
            np.testing.assert_array_equal(next(t), next(j))
    finally:
        t.close()
        j.close()
    if mode == "test":
        t = tnative.NativeVideoLoader(paths, **kw)
        np.testing.assert_array_equal(next(t)[0], np.load(paths[0])[:6])
        t.close()


@needs_native
def test_vl_open_refusals(tmp_path):
    np.save(tmp_path / "a.npy", np.zeros((20, 8, 8, 3), np.uint8))
    np.save(tmp_path / "b.npy", np.zeros((20, 4, 4, 3), np.float32))  # same frame bytes
    with pytest.raises(RuntimeError):
        tnative.NativeVideoLoader([str(tmp_path / "a.npy"), str(tmp_path / "b.npy")],
                                  T=4, batch_size=1)
    paths = _write_videos(tmp_path, n=2, T=10)
    with pytest.raises(RuntimeError):
        tnative.NativeVideoLoader(paths, T=4, batch_size=8)  # batch > videos
    with pytest.raises(RuntimeError):
        tnative.NativeVideoLoader(paths, T=64, batch_size=1)  # T > a video


@needs_native
def test_load_data_streams_natively(tmp_path, monkeypatch):
    """A MineRL-layout dataset goes through the native loader, counted, with
    the Python item path's normalization, batch for batch the JAX
    ``load_data``'s; LFVDM_NATIVE_LOADER=0 sends it to the Python loader."""
    import lfvdm_tpu.data.datasets as jdata
    import lfvdm_tpu_torch.data.datasets as tdata

    train = tmp_path / "train"
    train.mkdir()
    paths = _write_videos(train, n=4, T=10)
    for mod in (tdata, jdata):
        monkeypatch.setitem(mod.video_data_paths_dict, "minerl", str(tmp_path))
    t, j = (mod.load_data("minerl", batch_size=2, T=6, seed=3) for mod in (tdata, jdata))
    for _ in range(5):
        np.testing.assert_array_equal(next(t), next(j))
    t.close()
    loader = tdata.load_data("minerl", batch_size=2, T=6, deterministic=True, seed=0)
    batch = next(loader)
    assert (loader.source, loader.served) == ("native", 1)
    assert batch.shape == (2, 6, 3, 8, 8) and batch.dtype == np.float32
    video = tdata.NpyPerVideoDataset(train, T=None).postprocess_video(np.load(paths[0]))
    assert any(np.array_equal(batch[0], video[s:s + 6]) for s in range(len(video) - 5))
    monkeypatch.setenv("LFVDM_NATIVE_LOADER", "0")
    loader = tdata.load_data("minerl", batch_size=2, T=6)
    next(loader)
    assert loader.source == "python"
