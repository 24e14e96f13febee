"""The train loop's placement of a step's inputs on the card (``train_loop.place``).

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_placement_cuda.py

On the tiny config (f32, TF32 off, cuDNN deterministic), a ``TrainLoop`` whose
steps replay a captured step: four steps leave every bit of the state that
the old, blocking placement (``test_torch_placement.blocking_next_step_inputs``)
leaves; a replayed step makes no host sync with the uniform sampler; the host
arrays a step was drawn from may be overwritten as soon as ``run_step``
returns, even while its copies wait behind a busy stream; the loss-aware
sampler still learns from each step's own losses.
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.diffusion.resample import LossSecondMomentResampler
from test_torch_placement import B, blocking_next_step_inputs, make_loop

pytestmark = pytest.mark.cuda

SPIN_CYCLES = 50_000_000  # ~25 ms of a busy stream at the H100's ~2 GHz


@pytest.fixture
def cuda():
    """The card, TF32 off, and cuDNN's deterministic algorithms (the tiny f32
    step is not reproducible eager against eager under the heuristics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_state(a, b):
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert sa["adam"]["count"] == sb["adam"]["count"] and sa["step"] == sb["step"]
    for name in sb["params"]:
        assert torch.equal(bits(sa["params"][name]), bits(sb["params"][name])), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(bits(sa["adam"][key][name]), bits(sb["adam"][key][name])), \
                (key, name)
        for rate in sb["ema"]:
            assert torch.equal(bits(sa["ema"][rate][name]), bits(sb["ema"][rate][name])), \
                (rate, name)


def assert_same_metrics(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_captured_steps_are_bitwise_the_blocking_placements(cuda, tmp_path, monkeypatch):
    new, old = make_loop(tmp_path / "new", "cuda"), make_loop(tmp_path / "old", "cuda")
    monkeypatch.setattr(old, "next_step_inputs", lambda: blocking_next_step_inputs(old))
    assert new.step_kind == old.step_kind == "captured"
    for _ in range(4):
        assert_same_metrics(new.run_step(), old.run_step())
    torch.cuda.synchronize()
    assert_same_state(new, old)


def test_a_replayed_step_makes_no_host_sync(cuda, tmp_path):
    loop = make_loop(tmp_path, "cuda")
    loop.run_step()  # the warm-up and the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            metrics = loop.run_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]).all() and loop.state.step == 4


def test_host_arrays_may_change_once_run_step_returns(cuda, tmp_path, monkeypatch):
    """Each step's copies queue behind a spinning stream; the numpy arrays they
    were drawn from are overwritten before the spin ends. The state follows
    the loop whose arrays were left alone, bit for bit."""
    calm, raced = make_loop(tmp_path / "calm", "cuda"), make_loop(tmp_path / "raced", "cuda")
    drawn = []
    prepare, sample = raced._prepare, raced.schedule_sampler.sample

    def keep_prepared(batch1, batch2):
        out = prepare(batch1, batch2)
        drawn.extend(out.values())
        return out

    def keep_sampled(n, rng):
        out = sample(n, rng)
        drawn.extend(out)
        return out

    monkeypatch.setattr(raced, "_prepare", keep_prepared)
    monkeypatch.setattr(raced.schedule_sampler, "sample", keep_sampled)
    for _ in range(4):
        want = calm.run_step()
        torch.cuda._sleep(SPIN_CYCLES)
        got = raced.run_step()
        for a in drawn:
            a.fill(np.nan if a.dtype.kind == "f" else 10**6)
        drawn.clear()
        torch.cuda.synchronize()
        assert_same_metrics(got, want)
    assert_same_state(raced, calm)


def test_the_loss_aware_sampler_learns_each_steps_losses(cuda, tmp_path, monkeypatch):
    loop = make_loop(tmp_path, "cuda")
    sampler = loop.schedule_sampler = LossSecondMomentResampler(loop.diffusion)
    seen = []
    update = sampler.update_with_local_losses

    def record(ts, losses):
        seen.append((np.array(ts), np.array(losses)))
        update(ts, losses)

    monkeypatch.setattr(sampler, "update_with_local_losses", record)
    for i in range(3):
        metrics = loop.run_step()
        ts, losses = seen[-1]
        assert len(seen) == i + 1 and np.array_equal(ts, loop._pending[-1][1])
        assert np.array_equal(losses, metrics["loss"].float().cpu().numpy())
    assert int(sampler._loss_counts.sum()) == 3 * B
