"""The port's recorder of spans and counters (``utils/tracing.py``) and the
spans the port records at its layer boundaries.

Off, the recorder keeps nothing and hands out one shared no-op; on, it
keeps nesting, threads and a bounded buffer. A tiny CPU ``sample_video``
through a codec and a tiny CPU ``TrainLoop`` fed by ``load_data`` record
the spans and counts that the benchmark's readers expect, one per window,
step or batch; and samples and losses come out bitwise the same with the
recorder on and off.
"""

import threading

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.config import create_diffusion, create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.data import datasets
from lfvdm_tpu_torch.data.native_loader import native_loader_available
from lfvdm_tpu_torch.diffusion.codecs import PreEncodedLatentCodec
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.training.train_loop import TrainLoop
from lfvdm_tpu_torch.utils import tracing

CFG = dict(flagship_config(tiny=True), in_channels=3)
MEAN = np.array([0.1, -0.2, 0.3], np.float32)
STD = np.array([0.9, 1.1, 0.8], np.float32)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def model_and_diffusion():
    """The tiny U-Net and a 4-step DDIM spacing of its diffusion."""
    torch.set_num_threads(2)
    model, _ = create_model_and_diffusion(CFG, device="cpu", seed=0)
    return model, create_diffusion(dict(CFG, timestep_respacing="ddim4"))


def _names(records):
    out = {}
    for r in records:
        out[r.name] = out.get(r.name, 0) + 1
    return out


def _total(name):
    return sum(c.n for c in tracing.counts() if c.name == name)


# ---- the recorder ----

def test_off_records_nothing_and_hands_out_the_shared_no_op():
    assert not tracing.enabled()
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second is tracing.NO_SPAN
    with first:
        tracing.count("c", 3)
    assert tracing.spans() == [] and tracing.counts() == [] and tracing.dropped() == 0


def test_on_records_nesting_parents_and_counts():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            tracing.count("things", 4)
        with tracing.span("second"):
            pass
    with tracing.span("after"):
        pass
    got = tracing.spans()
    assert [s.name for s in got] == ["outer", "inner", "second", "after"]
    assert [s.parent for s in got] == [-1, 0, 0, -1]
    assert all(s.start_ns <= s.end_ns for s in got)
    assert got[0].start_ns <= got[1].start_ns and got[2].end_ns <= got[0].end_ns
    (c,) = tracing.counts()
    assert (c.name, c.n) == ("things", 4) and got[1].start_ns <= c.t_ns <= got[1].end_ns
    tracing.reset()
    assert tracing.spans() == [] and tracing.counts() == []


def test_threads_keep_their_own_parents():
    tracing.enable()
    started, release = threading.Event(), threading.Event()

    def producer():
        with tracing.span("producer"):
            started.set()
            release.wait(10)
            with tracing.span("producer.child"):
                pass

    with tracing.span("main"):
        thread = threading.Thread(target=producer)
        thread.start()
        assert started.wait(10)
        with tracing.span("main.child"):
            release.set()
            thread.join(10)
    assert not thread.is_alive()
    got = {s.name: (i, s) for i, s in enumerate(tracing.spans())}
    assert got["main.child"][1].parent == got["main"][0]
    assert got["producer.child"][1].parent == got["producer"][0]
    assert got["producer"][1].parent == -1
    assert got["producer"][1].thread != got["main"][1].thread == threading.get_ident()


def test_the_cap_refuses_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for _ in range(2):
        with tracing.span("s"):
            pass
    tracing.count("c")
    with tracing.span("late"):
        tracing.count("late")
    assert _names(tracing.spans()) == {"s": 2} and len(tracing.counts()) == 1
    assert tracing.dropped() == 2
    tracing.reset()
    assert tracing.dropped() == 0


# ---- the window driver ----

def _video(T=9, n_obs=3):
    S = CFG["image_size"]
    video = np.zeros((2, T, CFG["in_channels"], S, S), np.float32)
    video[:, :n_obs] = np.random.default_rng(3).uniform(-1, 1, (2, n_obs) + video.shape[2:])
    return video


def _sample(model, diffusion, codec=None):
    sampler = VideoSampler(model, diffusion, use_ddim=True, codec=codec)
    return sampler.sample_video(_video(), scheme_name="autoreg", n_obs=3, max_frames=5,
                                step_size=3, generator=torch.Generator().manual_seed(5))


def test_sample_video_spans_one_per_window(model_and_diffusion):
    model, diffusion = model_and_diffusion
    tracing.enable()
    samples, used = _sample(model, diffusion, PreEncodedLatentCodec(MEAN, STD))
    windows, steps = len(used), diffusion.num_timesteps
    assert windows == 2 and steps == 4
    names = _names(tracing.spans())
    # One plan per window, and the last plan, which finds the scheme done.
    assert names.pop("driver.plan") == windows + 1
    assert names == {"driver.gather": windows, "driver.scatter": windows,
                     "window.load": windows, "window.steps": windows,
                     "driver.upload": windows + 1, "driver.download": windows + 1,
                     "codec.decode": 1}
    assert _total("window.replays") == windows * steps
    window_bytes = 2 * 5 * int(np.prod(samples.shape[2:])) * 4
    assert _total("driver.d2h_bytes") == windows * window_bytes + samples.nbytes
    assert _total("driver.h2d_bytes") == windows * (window_bytes + 2 * 5 * (8 + 4 + 4)) \
        + samples.nbytes
    assert _total("graph.captures") == 0  # nothing is captured on the CPU
    # sample_window runs between the gather and the scatter, in no span of the driver.
    assert all(s.parent == -1 for s in tracing.spans())


def test_sample_video_is_bitwise_the_same_traced(model_and_diffusion):
    model, diffusion = model_and_diffusion
    codec = PreEncodedLatentCodec(MEAN, STD)
    off, _ = _sample(model, diffusion, codec)
    tracing.enable()
    on, _ = _sample(model, diffusion, codec)
    assert tracing.spans()
    np.testing.assert_array_equal(on, off)


# ---- the train loop and the loaders ----

def _write_minerl(tmp_path, monkeypatch, n=4, T=12):
    train = tmp_path / "train"
    train.mkdir()
    rng = np.random.default_rng(0)
    S = CFG["image_size"]
    for i in range(n):
        np.save(train / f"{i}.npy", rng.integers(0, 256, (T, S, S, 3), dtype=np.uint8))
    monkeypatch.setitem(datasets.video_data_paths_dict, "minerl", str(tmp_path))


def _loop(data, tmp_path, K):
    model, diffusion = create_model_and_diffusion(CFG, device="cpu", seed=0)
    return TrainLoop(model=model, diffusion=diffusion, data=data, batch_size=2, max_frames=K,
                     lr=1e-3, log_interval=0, save_interval=0, seed=4,
                     checkpoint_dir=str(tmp_path / "run"))


@pytest.mark.parametrize("native", ["1", "0"])
def test_train_loop_and_loader_spans(tmp_path, monkeypatch, native):
    if native == "1" and not native_loader_available():
        pytest.skip("the native loader cannot be built here")
    monkeypatch.setenv("LFVDM_NATIVE_LOADER", native)
    _write_minerl(tmp_path, monkeypatch)
    B, T, K, steps = 2, 6, 4, 3
    data = datasets.load_data("minerl", batch_size=B, T=T, seed=1)
    loop = _loop(data, tmp_path, K)
    tracing.enable()
    try:
        for _ in range(steps):
            loop.run_step()
    finally:
        tracing.disable()
        data.close()
    assert data.source == ("native" if native == "1" else "python")
    spans = tracing.spans()
    names = _names(spans)
    for name in ("train.step", "train.prepare", "train.place", "train.replay"):
        assert names[name] == steps, name
    assert names["train.next_batch"] == 2 * steps  # two batches a step, with padding
    main = threading.get_ident()
    loader = [s for s in spans if s.name.startswith("loader.")]
    assert loader and all(s.thread != main for s in loader)
    batches = int(_total("loader.batches"))
    assert batches >= 2 * steps  # the thread runs ahead by its queue
    per_batch = B if native == "0" else 1  # the Python loader reads item by item
    assert names["loader.read"] >= per_batch * batches
    assert names["loader.normalize"] >= batches and names["loader.put_wait"] >= 2 * steps
    # Over the batches the steps used, the steps' frames are K of every 2T.
    used = sorted((c for c in tracing.counts() if c.name == "loader.frames"),
                  key=lambda c: c.t_ns)[:2 * steps]
    assert sum(c.n for c in used) == 2 * steps * B * T
    assert _total("train.frames") / sum(c.n for c in used) == K / (2 * T)
    for s in spans:
        if s.name in ("train.next_batch", "train.prepare", "train.place", "train.replay"):
            assert spans[s.parent].name == "train.step"


def test_train_losses_are_bitwise_the_same_traced(tmp_path):
    S, K = CFG["image_size"], 4
    rng = np.random.default_rng(2)
    batches = [rng.uniform(-1, 1, (2, 6, 3, S, S)).astype(np.float32) for _ in range(4)]

    def losses(traced):
        if traced:
            tracing.enable()
        loop = _loop(iter(batches), tmp_path / str(traced), K)
        out = [loop.run_step()["loss"].clone() for _ in range(2)]
        tracing.disable()
        return out, [p.detach().clone() for p in loop.model.parameters()]

    (off, off_params), (on, on_params) = losses(False), losses(True)
    assert _names(tracing.spans())["train.step"] == 2
    for a, b in zip(off + off_params, on + on_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
