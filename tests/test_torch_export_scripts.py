"""The port's export scripts (``lfvdm_tpu_torch.scripts.export_sampler`` and
``export_params``) and the converter from its state dict to the JAX tree, on
the CPU.

``export_sampler`` runs on ``--random_init`` and on a one-step run directory
of the port's ``video_train``; the served window equals the live sampler on
the run's weights. ``export_params`` writes a ``.msgpack`` that the JAX
``scripts/video_sample.py`` loader and the port's both read: their U-Nets
agree on one forward (f32, relative L2 <= 1e-5, as the reference ``.pt``
loaders do in ``test_torch_cli``), and the port's equals the run directory's
bitwise. ``unet_jax_tree_from_state_dict`` equals the JAX package's
``convert_unet_state_dict`` on the same state dict, leaf for leaf.
"""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.utils.torch_convert import convert_unet_state_dict
from lfvdm_tpu_torch import serving
from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE, create_model_and_diffusion
from lfvdm_tpu_torch.config import flagship_config
from lfvdm_tpu_torch.scripts import export_params, export_sampler, video_sample, video_train
from lfvdm_tpu_torch.training import checkpoint as ckpt_lib
from lfvdm_tpu_torch.utils.convert import unet_jax_tree_from_state_dict, unet_state_dict_from_jax
from test_torch_cli import TRAIN_ARGS

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TINY_FLAGS = ["--image_size", "32", "--in_channels", "2", "--num_channels", "32",
              "--num_res_blocks", "1", "--attention_resolutions", "8", "--diffusion_steps", "8",
              "--noise_schedule", "cosine", "--compute_dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A one-step run directory of the port's video_train (64 px, 32 channels)."""
    from lfvdm_tpu_torch.utils.logger import logger

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("train"))
        mp.setattr(logger, "_jsonl_path", logger._jsonl_path)
        loop = video_train.main(TRAIN_ARGS + ["--max_steps", "1", "--save_interval", "1",
                                              "--sample_interval", "0", "--log_interval", "1"])
        return str(Path(loop.checkpoint_dir).resolve())


def window(config, B, K, seed=0):
    rng = np.random.default_rng(seed)
    C, S = config["in_channels"], config["image_size"]
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :1] = 1.0
    return dict(x0=rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32),
                frame_indices=np.tile(np.arange(K, dtype=np.int64) * 2, (B, 1)), obs_mask=obs,
                latent_mask=1.0 - obs)


def test_export_sampler_random_init(tmp_path):
    art = export_sampler.main(["--random_init", "True", "--out", str(tmp_path), "--device", "cpu",
                               "--max_frames", "5"] + TINY_FLAGS)
    assert Path(art) == tmp_path / "sampler.pt2"
    meta = serving.artifact_meta(Path(art).read_bytes())
    assert meta["shape"] == [1, 5, 2, 32, 32] and meta["sampler"] == "ancestral"
    assert meta["num_timesteps"] == 8 and meta["device"] == "cpu"
    params = serving.load_params_npz(tmp_path / "params.npz")
    model, _ = create_model_and_diffusion(flagship_config(tiny=True), device="cpu", seed=0)
    assert [p[0] for p in meta["params"]] == list(params) == list(model.state_dict())
    for name, p in model.state_dict().items():
        assert torch.equal(params[name], p), name


def test_export_sampler_on_a_run_directory(run_dir, tmp_path):
    export_sampler.main(["--checkpoint_dir", run_dir, "--out", str(tmp_path), "--device", "cpu",
                         "--max_frames", "4", "--use_ddim", "True"])
    state, _, config = ckpt_lib.load_checkpoint(run_dir)
    params = serving.load_params_npz(tmp_path / "params.npz")
    assert set(params) == set(state["ema"]["0.9999"])
    for name, p in state["ema"]["0.9999"].items():
        assert torch.equal(params[name], p), name
    run = serving.load_window_sampler((tmp_path / "sampler.pt2").read_bytes())
    assert run.meta["sampler"] == "ddim" and run.meta["num_timesteps"] == 8
    model, diffusion = create_model_and_diffusion(config, device="cpu")
    kw = [torch.from_numpy(v) for v in window(config, 1, 4).values()]
    want = serving.make_window_sampler(model, diffusion, use_ddim=True)(params, *kw, 3)
    torch.testing.assert_close(run(params, *kw, 3), want, atol=1e-6, rtol=1e-6)


def _jax_video_sample():
    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module("video_sample")
    finally:
        sys.path.pop(0)


def test_export_params_read_by_both_loaders(run_dir):
    path = export_params.main([run_dir, "--ema_rate", "raw"])
    step = ckpt_lib.find_latest_step(run_dir)  # the one step's state is saved as step 0
    assert Path(path).name == f"params_raw_{step:06d}.msgpack"
    config = json.loads((Path(path).parent / "config.json").read_text())
    assert config == ckpt_lib.load_config(run_dir)
    jmodel, _, jparams, _ = _jax_video_sample().load_model_from_checkpoint(path, False, "")
    model, _, _ = video_sample.load_model_from_checkpoint(path, False, "", device="cpu")
    from_run, _, _ = video_sample.load_model_from_checkpoint(run_dir, False, "", ema_rate="raw",
                                                              device="cpu")
    kw = window(config, 2, 4, seed=1)
    x = np.random.default_rng(2).standard_normal(kw["x0"].shape).astype(np.float32)
    t = np.array([3, 6], np.int64)
    ref, _ = jax.jit(jmodel.apply)(jparams, jnp.asarray(x), jnp.asarray(t),
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(x), torch.from_numpy(t), **tkw)
        run_out, _ = from_run.eval()(torch.from_numpy(x), torch.from_numpy(t), **tkw)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0
    assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)
    assert torch.equal(got, run_out)


@pytest.mark.parametrize("use_rpe_net", [True, False])
def test_inverse_converter_matches_jax(use_rpe_net):
    cfg = dict(flagship_config(tiny=True), use_rpe_net=use_rpe_net)
    model, _ = create_model_and_diffusion(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    sd = model.state_dict()
    layout = dict(num_res_blocks=cfg["num_res_blocks"],
                  channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[cfg["image_size"]],
                  attention_resolutions=model.attention_resolutions)
    got = unet_jax_tree_from_state_dict(sd, **layout)
    want = convert_unet_state_dict({k: v.numpy() for k, v in sd.items()}, **layout)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    back = unet_state_dict_from_jax(got, **layout)
    assert set(back) == set(sd)
    for name, p in sd.items():
        assert torch.equal(back[name], p), name
