"""The native loader's unnormalised batches (``data/datasets.py``
``RawVideoBatch``), CPU.

A ``RawVideoBatch`` holds the frames as the files store them and stands for
``np.stack([postprocess_video(v) for v in raw])``: whole through
``np.asarray`` and frame by frame through indexing, to the same bits, for
every dataset the native loader serves. A tiny ``TrainLoop`` fed raw batches
trains to the same bits as one fed the normalised batches, and normalises
only the frames its steps choose.
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.data import datasets
from lfvdm_tpu_torch.data.datasets import RawVideoBatch
from lfvdm_tpu_torch.training.train_loop import TrainLoop
from lfvdm_tpu_torch.utils import tracing

CFG = dict(flagship_config(tiny=True), in_channels=3)
KINDS = ["carla", "carla2x", "npy"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _dataset(kind, tmp_path):
    """A dataset of ``kind`` (its ``postprocess_video`` is what matters)."""
    if kind == "npy":
        return datasets.NpyPerVideoDataset(tmp_path, T=None)
    (tmp_path / "video_train.csv").write_text("train/0.pt\n")
    if kind == "carla":
        return datasets.CarlaDataset(True, tmp_path, 0, 1, T=None)
    return datasets.Carla2xDataset(True, tmp_path, 0, 1, T=None)


def _raw(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _same_bits(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _total(name):
    return sum(c.n for c in tracing.counts() if c.name == name)


@pytest.mark.parametrize("kind", KINDS)
def test_raw_batch_is_the_normalised_batch(kind, tmp_path):
    ds = _dataset(kind, tmp_path)
    raw = _raw((2, 7, 6, 5, 3))  # H != W, so a misplaced transpose shows
    want = np.stack([ds.postprocess_video(v) for v in raw])
    batch = RawVideoBatch(raw, ds.postprocess_video)
    assert batch.shape == want.shape and batch.dtype == want.dtype == np.float32
    assert len(batch) == 2
    _same_bits(np.asarray(batch), want)
    copied = np.array(batch, copy=True)
    _same_bits(copied, want)
    copied[:] = 0  # a copy: the batch is untouched
    _same_bits(np.asarray(batch), want)
    _same_bits(np.asarray(batch, dtype=np.float64), want.astype(np.float64))
    for b, row in enumerate(batch):
        _same_bits(row, want[b])
    idx = np.array([5, 0, 5, 3, 3, 6, 1])  # repeated, unsorted
    for b in (0, 1, -1):
        _same_bits(batch[b], want[b])
        _same_bits(batch[b, idx], want[b, idx])
        _same_bits(batch[b, idx[:0]], want[b, idx[:0]])
        _same_bits(batch[b, 4], want[b, 4])
        _same_bits(batch[b, 2:5], want[b, 2:5])
        _same_bits(batch[np.int64(b), list(idx)], want[b, idx])
    _same_bits(batch[:1], want[:1])  # any other key indexes the whole batch


@pytest.mark.parametrize("kind", KINDS)
def test_raw_batch_counts_what_it_normalises(kind, tmp_path):
    ds = _dataset(kind, tmp_path)
    batch = RawVideoBatch(_raw((2, 9, 4, 4, 3)), ds.postprocess_video)
    tracing.enable()
    batch[0, np.array([1, 1, 8])]
    batch[1]
    assert _total("loader.frames_normalized") == 3 + 9
    assert _total("loader.batches_materialized") == 0
    np.asarray(batch)
    assert _total("loader.frames_normalized") == 3 + 9 + 18
    assert _total("loader.batches_materialized") == 1


def test_pass_through_frames_are_copies(tmp_path):
    """Where ``postprocess_video`` hands float32 frames back as they are (the
    pre-encoded Carla2x latents), what indexing returns is still a copy."""
    ds = datasets.Carla2xDataset.__new__(datasets.Carla2xDataset)
    ds.encoded = True
    raw = np.random.default_rng(1).standard_normal((2, 5, 4, 3, 3)).astype(np.float32)
    batch = RawVideoBatch(raw, ds.postprocess_video)
    kept = raw.copy()
    for got in (batch[0], batch[1, 1:3], batch[0, 2], np.asarray(batch)):
        got[...] = 7
    _same_bits(raw, kept)


def _loop(data, tmp_path, pad):
    model, diffusion = create_model_and_diffusion(CFG, device="cpu", seed=0)
    return TrainLoop(model=model, diffusion=diffusion, data=data, batch_size=2, max_frames=4,
                     lr=1e-3, log_interval=0, save_interval=0, seed=4,
                     pad_with_random_frames=pad, checkpoint_dir=str(tmp_path / "run"))


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_are_bitwise_the_same_from_raw_batches(kind, pad, tmp_path):
    ds = _dataset(kind, tmp_path)
    S = CFG["image_size"] // (2 if kind == "carla2x" else 1)
    raws = [_raw((2, 6, S, S, 3), seed) for seed in range(4)]
    steps = 2

    def train(lazy):
        batches = [RawVideoBatch(r, ds.postprocess_video) for r in raws]
        feed = batches if lazy else [np.asarray(b) for b in batches]
        tracing.reset()
        tracing.enable()
        loop = _loop(iter(feed), tmp_path / str(lazy), pad)
        losses = [loop.run_step()["loss"].clone() for _ in range(steps)]
        tracing.disable()
        return losses, [p.detach().clone() for p in loop.model.parameters()]

    eager, eager_params = train(False)
    lazy, lazy_params = train(True)
    for a, b in zip(eager + eager_params, lazy + lazy_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The lazy loop normalised the B x K frames each step chose, and no batch whole.
    assert 0 < _total("loader.frames_normalized") == _total("train.frames") <= steps * 2 * 4
    assert _total("loader.batches_materialized") == 0
    normalize = [s for s in tracing.spans() if s.name == "train.normalize"]
    assert len(normalize) == steps
    assert all(tracing.spans()[s.parent].name == "train.prepare" for s in normalize)
