"""The check catches a broken program: each tiny cell runs on the CPU with
the timed path broken underneath, past the harness's look for a card, and
``correct`` comes out false; and the control (the reference a precision
below the configuration's, in the program's place) fails the limits."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402


@pytest.fixture(scope="module")
def gpubench(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.tiny_benchmark(tmp_path_factory.mktemp("bench"))


def _altered_window(monkeypatch):
    """Every window's answer altered where the sampler produces it."""
    from lfvdm_tpu_torch.sampling import driver

    produce = driver._run_program

    def altered(*args, **kwargs):
        out = produce(*args, **kwargs)
        out[:, -1] += 0.05
        return out

    monkeypatch.setattr(driver, "_run_program", altered)


def _altered_decode(monkeypatch):
    from lfvdm_tpu_torch.models import vae

    decode = vae.SVDVae.decode_video

    def altered(self, latents, chunk_size=20):
        out = decode(self, latents, chunk_size)
        return out * 1.05

    monkeypatch.setattr(vae.SVDVae, "decode_video", altered)


def _unchanged_state(monkeypatch):
    """A step that leaves the parameters, moments and EMA as they were."""
    from lfvdm_tpu_torch.training import train_loop

    monkeypatch.setattr(train_loop, "fused_adamw_ema", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from lfvdm_tpu_torch.training import train_loop

    loss = train_loop.micro_loss

    def half(model, diffusion, batch, t, weights, *, noise=None, **kw):
        h = len(t) // 2
        return loss(model, diffusion, {k: v[:h] for k, v in batch.items()}, t[:h], weights[:h],
                    noise=None if noise is None else noise[:h], **kw)

    monkeypatch.setattr(train_loop, "micro_loss", half)


@pytest.mark.parametrize("cell, fault", [
    ("tiny.video", _altered_window),
    ("tiny.latent_video", _altered_window),
    ("tiny.latent_video", _altered_decode),
    ("tiny.train", _unchanged_state),
    ("tiny.train", _half_batch),
])
def test_fault_comes_out_not_correct(gpubench, monkeypatch, cell, fault):
    fault(monkeypatch)
    run, correct = tiny.run_tiny(gpubench, cell, seconds=0.5)
    assert not correct, run.checks


@pytest.mark.parametrize("cell", ["tiny.video", "tiny.latent_video", "tiny.train"])
def test_control_fails_the_limits(gpubench, cell):
    run, correct = tiny.run_tiny(gpubench, cell, seconds=0.5, control=True)
    assert correct, run.checks
    limits = {k: lim for k, (_, lim) in run.checks.items()}
    readings = run.control.get("fp8", run.control)
    assert any(v > limits[k] for k, v in readings.items()), (readings, limits)
