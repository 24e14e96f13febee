"""Port vs JAX package: encoder reuse (arXiv:2312.09608) at the tiny config
(f32, CPU).

The U-Net's ``return_features`` tuple (the middle block's output and every
skip tensor) and its up-path-only call on those features match the JAX
U-Net's ``features=`` call. The ancestral sampler with ``encoder_reuse=3``
matches the JAX sampler's whole trajectory when each step gets the JAX
step's own noise (``step_noise``), and runs the full U-Net exactly at the
steps i with i % 3 == 0. ``VideoSampler(encoder_reuse=)`` binds the window
into the features call and refuses DDIM and DPM-Solver++, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.sampling.driver import VideoSampler as JVideoSampler
from lfvdm_tpu_torch.data.datasets import get_test_dataset
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.scripts import video_sample
from test_torch_cli import pt64  # noqa: F401 (a fixture)
from test_torch_sampling import CFG, assert_close_conditioned, build_models, diffusions, window
from test_torch_unet import TOL, make_inputs, run_port

REUSE = 3


@pytest.fixture(scope="module")
def models():
    return build_models()


def jax_step_noise(key, shape, steps):
    """The per-step noise JAX's ``p_sample_loop`` draws from ``key``."""
    rng, _ = jax.random.split(key)
    out = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        out.append(np.array(jax.random.normal(k, shape, dtype=jnp.float32)))
    return out


def jax_apply(models, x, t, kw, features=None, return_features=False):
    _, jmodel, params = models
    apply = jax.jit(jmodel.apply, static_argnames=("return_features",))
    return apply(params, jnp.asarray(x), jnp.asarray(t), features=features,
                 return_features=return_features,
                 **{k: jnp.asarray(v) for k, v in kw.items()})


def test_return_features_and_reuse_call_match_jax(models):
    model = models[0]
    x, t, kw = make_inputs(B=1, T=5)
    out, _, feats = run_port(model, x, t, kw, return_features=True)
    jout, _, jfeats = jax_apply(models, x, t, kw, return_features=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    h, skips = feats
    jh, jskips = jfeats
    assert isinstance(skips, tuple) and len(skips) == len(jskips) == len(model.output_blocks)
    for a, b in zip((h,) + skips, (jh,) + tuple(jskips)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 3, 1, 2), **TOL)

    # The up path alone on the cached features, at another step and input.
    x2 = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    t2 = np.array([40.0], np.float32)
    ops.reset_launch_counts()
    reuse, _, again = run_port(model, x2, t2, kw, features=feats, return_features=True)
    assert again[0] is h and all(a is b for a, b in zip(again[1], skips))  # handed back
    jreuse, _ = jax_apply(models, x2, t2, kw, features=jfeats)
    assert np.abs(np.asarray(jreuse)).max() > 0.1
    np.testing.assert_allclose(reuse.numpy(), np.asarray(jreuse), **TOL)
    full, _ = run_port(model, x2, t2, kw)
    assert not np.allclose(full.numpy(), reuse.numpy(), atol=1e-3)  # the cache was used
    plain, _ = run_port(model, x2, t2, kw, features=feats, impl="plain")
    torch.testing.assert_close(reuse, plain, atol=0, rtol=0)  # the CPU runs plain versions
    assert set(ops.launch_counts().values()) == {0}


def test_reuse_loop_matches_jax_with_injected_noise(models):
    _, jmodel, params = models
    noise, kw = window(11)
    jd, td = diffusions()
    key = jax.random.PRNGKey(3)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def j_features(x, ts, feats):
        out, _, new = jmodel.apply(params, x, ts, features=feats, return_features=True, **jkw)
        return out, new

    ref = jd.p_sample_loop(None, noise.shape, key, noise=jnp.asarray(noise),
                           encoder_reuse=REUSE, model_fn_features=j_features)
    steps = [torch.from_numpy(n) for n in jax_step_noise(key, noise.shape, td.num_timesteps)]
    sampler = VideoSampler(models[0], td, encoder_reuse=REUSE)
    out = sampler.sample_window(**kw, noise=torch.from_numpy(noise), step_noise=steps)
    assert (sampler.model_calls, sampler.reuse_calls) == (8, 5)
    assert_close_conditioned(out.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())
    full = VideoSampler(models[0], td).sample_window(**kw, noise=torch.from_numpy(noise),
                                                     step_noise=steps)
    assert not np.allclose(full.numpy(), out.numpy(), atol=1e-3)


@pytest.mark.parametrize("k,steps", [(2, 8), (3, 8), (4, 7), (8, 8), (1, 5)])
def test_full_calls_at_every_kth_step(k, steps):
    """A counting model: step i runs the full network iff i % k == 0; the
    features of the last full call reach every reuse call; k = 1 runs the
    plain loop."""
    from lfvdm_tpu_torch.diffusion.gaussian import GaussianDiffusion

    td = GaussianDiffusion.create(steps=steps, noise_schedule="cosine")
    calls = []

    def fn_features(x, ts, feats):  # as the U-Net: a reuse call hands its features back
        calls.append(None if feats is None else feats[0])
        return torch.zeros_like(x), (len(calls) - 1, ()) if feats is None else feats

    def fn(x, ts):
        calls.append("plain")
        return torch.zeros_like(x)

    td.p_sample_loop(fn, (1, 2, 1, 2, 2), device="cpu", generator=torch.Generator(),
                     encoder_reuse=k, model_fn_features=fn_features)
    if k == 1:
        assert calls == ["plain"] * steps
        return
    last_full = None
    for i, c in enumerate(calls):
        if i % k == 0:
            assert c is None
            last_full = i
        else:
            assert c == last_full
    assert len(calls) == steps


def test_refusals_match_jax(models):
    td = diffusions()[1]
    for kwargs in (dict(use_ddim=True), dict(use_dpm=True)):
        with pytest.raises(ValueError, match="ancestral"):
            VideoSampler(models[0], td, encoder_reuse=2, **kwargs)
        with pytest.raises(AssertionError, match="ancestral"):
            JVideoSampler(None, None, None, encoder_reuse=2, **kwargs)
    with pytest.raises(ValueError, match=">= 1"):
        VideoSampler(models[0], td, encoder_reuse=0)
    with pytest.raises(ValueError, match="model_fn_features"):
        td.p_sample_loop(None, (1, 2, 1, 2, 2), device="cpu", generator=torch.Generator(),
                         encoder_reuse=2)
    with pytest.raises(ValueError, match="return_attn_weights"):
        td.p_sample_loop(None, (1, 2, 1, 2, 2), device="cpu", generator=torch.Generator(),
                         encoder_reuse=2, model_fn_features=lambda *a: None,
                         return_attn_weights=True)
    sampler = VideoSampler(models[0], td, encoder_reuse=2)
    _, kw = window(0)
    with pytest.raises(ValueError, match="exact ancestral"):
        sampler.sample_window_attn(**kw, generator=torch.Generator())


def test_video_sample_cli_with_encoder_reuse(pt64, tmp_path, monkeypatch):  # noqa: F811
    """``--encoder_reuse 3``: two autoreg windows of 6 ancestral steps, each
    with full calls at steps 0 and 3 and reuse calls between; the observed
    frames are kept exactly."""
    monkeypatch.chdir(tmp_path)
    argv = [pt64, "--sampling_scheme", "autoreg", "--T", "6", "--n_obs", "2",
            "--max_frames", "4", "--batch_size", "2", "--timestep_respacing", "6",
            "--encoder_reuse", "3", "--device", "cpu"]
    run = video_sample.main(argv)
    assert (run["model_calls"], run["reuse_calls"]) == (12, 8)
    dataset = get_test_dataset("synthetic", T=6)
    assert len(run["written"]) == 2
    for i, path in enumerate(run["written"]):
        video = np.load(path)
        assert video.dtype == np.uint8 and video.shape == (6, 3, 64, 64)
        np.testing.assert_array_equal(video[:2], video_sample.to_uint8(dataset[i][:2]))
    with pytest.raises(ValueError, match="ancestral"):
        video_sample.main(argv + ["--use_ddim", "True", "--eval_dir", "other"])
