"""The train loop's placement of a step's inputs (``train_loop.place``), CPU.

On a card ``TrainLoop`` stages each input in page-locked memory and copies
it to the device with ``non_blocking``, so the host never waits (the JAX
loop's ``device_put``). On the CPU nothing is pinned and the inputs are what
``torch.as_tensor(..., device=)`` made before: here the tiny config's inputs
and steps are held against ``blocking_next_step_inputs``, the placement as
it was written before (one ``torch.as_tensor`` per array). The card's side
is ``tests/test_torch_placement_cuda.py``.
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.diffusion.codecs import WaveletCodec
from lfvdm_tpu_torch.training import train_loop
from lfvdm_tpu_torch.training.masks import sample_training_batch
from lfvdm_tpu_torch.training.train_loop import TrainLoop

CFG = flagship_config(tiny=True)
B, K = 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def blocking_next_step_inputs(loop):
    """``TrainLoop.next_step_inputs`` as it placed its inputs before: one
    ``torch.as_tensor(..., device=)`` per pageable array, each of which makes
    the host wait for a card."""
    dev = loop.device
    batch1 = loop._next_batch()
    batch2 = loop._next_batch() if loop.pad_with_random_frames else batch1
    x0, fi, obs, lat = sample_training_batch(
        loop.host_rng, batch1, loop.max_frames,
        batch2=batch2 if loop.pad_with_random_frames else None,
        pad_with_random_frames=loop.pad_with_random_frames)
    x0 = x0.astype(np.float32)
    if loop.codec is not None:
        x0 = loop.codec.encode(torch.as_tensor(x0, device=dev))
    batch = {"x0": torch.as_tensor(x0, dtype=torch.float32, device=dev),
             "frame_indices": torch.as_tensor(fi, dtype=torch.int64, device=dev),
             "obs_mask": torch.as_tensor(obs, dtype=torch.float32, device=dev),
             "latent_mask": torch.as_tensor(lat, dtype=torch.float32, device=dev)}
    t_np, w_np = loop.schedule_sampler.sample(batch["x0"].shape[0], loop.host_rng)
    t = torch.as_tensor(t_np, dtype=torch.int64, device=dev)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    return batch, t, w, t_np, w_np


def data(seed=0):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    while True:
        yield rng.uniform(-1, 1, (B, 10, C, S, S)).astype(np.float32)


def make_loop(tmp_path, device="cpu", codec=None, **kw):
    model, diffusion = create_model_and_diffusion(CFG, device=device, seed=1)
    return TrainLoop(model=model, diffusion=diffusion, data=data(), batch_size=B,
                     max_frames=K, lr=1e-3, ema_rate="0.9999,0.99", log_interval=1000,
                     save_interval=0, checkpoint_dir=str(tmp_path), codec=codec, **kw)


def assert_inputs_equal(got, want):
    (batch, t, w, t_np, w_np), (wb, wt, ww, wt_np, ww_np) = got, want
    assert set(batch) == set(wb)
    for name in wb:
        assert batch[name].dtype == wb[name].dtype and batch[name].device == wb[name].device
        assert batch[name].shape == wb[name].shape and torch.equal(batch[name], wb[name]), name
    for a, b in ((t, wt), (w, ww)):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    assert np.array_equal(t_np, wt_np) and np.array_equal(w_np, ww_np)


@pytest.mark.parametrize("codec", [None, "wavelet"])
def test_next_step_inputs_are_placed_as_before(tmp_path, codec):
    """Values, dtypes, shapes and devices of three draws, with and without a
    codec (the wavelet codec encodes x0 after it is placed; no step runs)."""
    new = make_loop(tmp_path / "new", codec=WaveletCodec(levels=1) if codec else None)
    old = make_loop(tmp_path / "old", codec=WaveletCodec(levels=1) if codec else None)
    for _ in range(3):
        assert_inputs_equal(new.next_step_inputs(), blocking_next_step_inputs(old))


def test_the_cpu_path_pins_nothing(tmp_path, monkeypatch):
    """No page-locked staging without a card: a pinned allocation would raise
    here, and ``place`` is ``torch.as_tensor`` on the CPU."""
    empty = torch.empty

    def no_pinned_empty(*args, **kwargs):
        assert not kwargs.get("pin_memory"), "a pinned staging block on the CPU path"
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinned_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a: pytest.fail("pinned"))
    loop = make_loop(tmp_path)
    batch, t, w, _, _ = loop.next_step_inputs()
    assert all(v.device.type == "cpu" for v in (*batch.values(), t, w))
    a = np.arange(6, dtype=np.float32)
    assert np.shares_memory(train_loop.place(a, torch.float32, torch.device("cpu")).numpy(), a)


def test_three_steps_are_bitwise_the_blocking_placements(tmp_path, monkeypatch):
    """Three ``run_step`` calls: metrics and the whole train state (parameters,
    Adam moments and count, every EMA copy) bit for bit those of the same
    loop placing its inputs the old way, from the same seeds."""
    new = make_loop(tmp_path / "new")
    old = make_loop(tmp_path / "old")
    monkeypatch.setattr(old, "next_step_inputs", lambda: blocking_next_step_inputs(old))
    for _ in range(3):
        got, want = new.run_step(), old.run_step()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    a, b = new.state.state_dict(), old.state.state_dict()
    assert a["adam"]["count"] == b["adam"]["count"] == 3 and a["step"] == b["step"]
    for name in b["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a["adam"][key][name], b["adam"][key][name]), (key, name)
        for rate in b["ema"]:
            assert torch.equal(a["ema"][rate][name], b["ema"][rate][name]), (rate, name)
