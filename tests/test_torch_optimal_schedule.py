"""The port's ``video_optimal_schedule`` against the repo's JAX script: the
same ``optimal_schedule.pt`` for the same command line (each written to its
own ``tmp_path``), for ``--optimality index``, the reference's strategy
names and ``lpips`` (both embedders on one ``.npz``, the synthetic
training split); and the file drives the port's scheme through a whole
video.
"""

import sys

import numpy as np
import pytest
import torch

import lfvdm_tpu.evals.lpips as jlpips
from lfvdm_tpu_torch.sampling.schemes import sampling_schemes
from lfvdm_tpu_torch.scripts import video_optimal_schedule as port
from test_torch_cli import _jax_script
from test_torch_lpips import npz  # noqa: F401 (a fixture)


def run_both(tmp_path, monkeypatch, argv):
    got = torch.load(port.main(["--eval_dir", str(tmp_path / "t"), "--device", "cpu"] + argv),
                     weights_only=False)
    monkeypatch.setattr(sys, "argv", ["video_optimal_schedule.py", "--eval_dir",
                                      str(tmp_path / "j")] + argv)
    _jax_script("video_optimal_schedule").main()
    want = torch.load(tmp_path / "j" / "optimal_schedule.pt", weights_only=False)
    return got, want


@pytest.mark.parametrize("scheme,optimality", [
    ("autoreg", "index"), ("hierarchy-2", "index"), ("autoreg", "linspace-t"),
    ("hierarchy-2", "random-t"), ("hierarchy-3", "linspace-t-force-nearby"),
    ("long-range", "random-t-force-nearby")])
def test_schedule_equals_jax_script(tmp_path, monkeypatch, scheme, optimality):
    argv = ["--sampling_scheme", scheme, "--optimality", optimality, "--T", "30",
            "--n_obs", "4", "--max_frames", "8", "--step_size", "3", "--seed", "2"]
    got, want = run_both(tmp_path, monkeypatch, argv)
    assert got and got == want
    # The file drives the port's scheme through the whole video.
    s = sampling_schemes[scheme](video_length=30, num_obs=4, max_frames=8, step_size=3,
                                 optimal_schedule=got)
    steps = list(s)
    for step, (obs, _) in enumerate(steps):
        if step in got:
            assert sorted(obs) == got[step]
    assert set().union(*(set(lat) for _, lat in steps)) | set(range(4)) == set(range(30))


def test_lpips_schedule_equals_jax_script(tmp_path, monkeypatch, npz):  # noqa: F811
    monkeypatch.setenv("LFVDM_LPIPS_WEIGHTS", npz)
    monkeypatch.setattr(jlpips, "_default", None)
    jscript = _jax_script("video_optimal_schedule")
    sim = port.embedding_similarity("synthetic", 12, 2, 64, device="cpu")
    jsim = jscript.embedding_similarity("synthetic", 12, 2, 64)
    assert sim.shape == (12, 12)
    np.testing.assert_allclose(sim, jsim, atol=1e-5)
    argv = ["--sampling_scheme", "autoreg", "--optimality", "lpips", "--T", "12",
            "--n_obs", "2", "--max_frames", "5", "--step_size", "2", "--num_videos", "2"]
    got, want = run_both(tmp_path, monkeypatch, argv)
    assert got and got == want
