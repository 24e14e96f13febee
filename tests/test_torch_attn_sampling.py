"""Port vs JAX package: the ancestral sampler's per-quartile attention
heatmaps (``p_sample_loop(return_attn_weights=True)``,
``VideoSampler.sample_window_attn``) and their logging in training
(``make_sample_fn(log_attn=True)``, ``video_train --log_attn``), on the CPU.

The accumulator is held to JAX's exactly on a fixed model whose layer maps
have different sizes (so the spatial repeat-upsampling runs), for a schedule
whose step count 4 divides and one it does not; the tiny U-Net's whole window
(through the program memoized per ("attn", shapes)) matches JAX's when each
step gets the JAX step's own noise, and that program's window and maps equal
the eager loop's (``graphs=False``) bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from lfvdm_tpu_torch.diffusion.gaussian import GaussianDiffusion as TDiffusion
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.scripts import video_train
from test_torch_cli import TRAIN_ARGS, quiet_loggers  # noqa: F401 (a fixture)
from test_torch_encoder_reuse import jax_step_noise, models  # noqa: F401 (a fixture)
from test_torch_sampling import assert_close_conditioned, diffusions, window

SHAPE = (2, 3, 1, 4, 4)
SPATIAL_SIZES = (16, 4, 16, 8)


def _fixed_maps(seed=0):
    rng = np.random.default_rng(seed)
    temporal = [rng.uniform(0, 1, (SHAPE[0], SHAPE[1], SHAPE[1])).astype(np.float32)
                for _ in SPATIAL_SIZES]
    spatial = [rng.uniform(0, 1, (SHAPE[0], s, s)).astype(np.float32) for s in SPATIAL_SIZES]
    return temporal, spatial


@pytest.mark.parametrize("respacing", ["", "5"])
def test_quartile_accumulator_matches_jax_on_a_fixed_model(respacing):
    kw = dict(steps=8, noise_schedule="cosine", timestep_respacing=respacing)
    jd, td = JDiffusion.create(**kw), TDiffusion.create(**kw)
    temporal, spatial = _fixed_maps()
    noise = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)

    def j_fn(x, ts):
        w = (1.0 + ts.astype(jnp.float32) / 100.0)[:, None, None]
        return 0.1 * x, {"temporal": [jnp.asarray(a) * w for a in temporal],
                         "spatial": [jnp.asarray(a) * w for a in spatial]}

    def t_fn(x, ts):
        w = (1.0 + ts.float() / 100.0)[:, None, None]
        return 0.1 * x, {"temporal": [torch.from_numpy(a) * w for a in temporal],
                         "spatial": [torch.from_numpy(a) * w for a in spatial]}

    key = jax.random.PRNGKey(2)
    img, maps = jd.p_sample_loop(j_fn, SHAPE, key, noise=jnp.asarray(noise),
                                 return_attn_weights=True)
    steps = [torch.from_numpy(n) for n in jax_step_noise(key, SHAPE, td.num_timesteps)]
    t_img, t_maps = td.p_sample_loop(t_fn, SHAPE, device="cpu", noise=torch.from_numpy(noise),
                                     step_noise=steps, return_attn_weights=True)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(img), atol=1e-5, rtol=1e-5)
    assert sorted(t_maps) == sorted(maps) and len(maps) == 8
    for tag, ref in maps.items():
        assert t_maps[tag].dtype == torch.float32 and t_maps[tag].shape == ref.shape
        np.testing.assert_allclose(t_maps[tag].numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6,
                                   err_msg=tag)
    assert t_maps["attn/q0-spatial"].shape == (SHAPE[0], 16, 16)
    assert all(float(t_maps[f"attn/q{q}-temporal"].abs().sum()) > 0 for q in range(4))


def test_spatial_maps_that_do_not_divide_raise():
    td = TDiffusion.create(steps=4, noise_schedule="cosine")

    def fn(x, ts):
        return x, {"temporal": [torch.ones(2, 3, 3)] * 2,
                   "spatial": [torch.ones(2, 16, 16), torch.ones(2, 6, 6)]}

    with pytest.raises(ValueError, match="does not divide"):
        td.p_sample_loop(fn, SHAPE, device="cpu", generator=torch.Generator(),
                         return_attn_weights=True)


def test_sample_window_attn_matches_jax_with_injected_noise(models):  # noqa: F811
    model, jmodel, params = models
    noise, kw = window(12)
    jd, td = diffusions()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def j_fn(x, ts, **_):
        return jmodel.apply(params, x, ts, return_attn_weights=True, **jkw)

    key = jax.random.PRNGKey(4)
    ref, ref_maps = jd.p_sample_loop(j_fn, noise.shape, key, noise=jnp.asarray(noise),
                                     return_attn_weights=True)
    steps = [torch.from_numpy(n) for n in jax_step_noise(key, noise.shape, td.num_timesteps)]
    sampler = VideoSampler(model, td)
    out, maps = sampler.sample_window_attn(**kw, noise=torch.from_numpy(noise), step_noise=steps)
    assert sampler.model_calls == td.num_timesteps
    assert_close_conditioned(out.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())
    K = noise.shape[1]
    S = 8 ** 2  # the tiny U-Net attends at 8x8 (ds 4 of 32 px)
    for tag, r in ref_maps.items():
        want = (1, K, K) if tag.endswith("temporal") else (1, S, S)
        assert tuple(maps[tag].shape) == want == r.shape
        np.testing.assert_allclose(maps[tag].numpy(), np.asarray(r), atol=1e-5, rtol=1e-4,
                                   err_msg=tag)
    # Drawn from the generator: seeded, repeatable.
    a = sampler.sample_window_attn(**kw, generator=torch.Generator().manual_seed(1))
    b = sampler.sample_window_attn(**kw, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    for tag in a[1]:
        torch.testing.assert_close(a[1][tag], b[1][tag], atol=0, rtol=0)


@pytest.fixture
def one_thread():
    """One intra-op thread while the test runs (the tier-1 command runs six
    test files at once on the host's cores); restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("injected", [False, True])
def test_heatmap_program_is_the_eager_loop_bitwise(models, injected):  # noqa: F811
    """The program memoized under ("attn", shapes) (on the CPU its step runs
    eagerly on its buffers and accumulators) against the eager
    ``p_sample_loop(return_attn_weights=True)`` (``graphs=False``): the
    window and all eight maps bitwise, with the generator left where the
    eager loop leaves it, or with injected noise; a second call, whose
    ``load`` zeroes the accumulators, repeats the first bitwise."""
    noise, kw = window(14)
    td = diffusions("5")[1]  # 5 steps: quartiles of 2, 1, 1 and 1 steps
    if injected:
        rng = np.random.default_rng(15)
        opts = dict(noise=torch.from_numpy(noise), step_noise=[
            torch.from_numpy(rng.standard_normal(noise.shape).astype(np.float32))
            for _ in range(td.num_timesteps)])
        gens = [None, None]
    else:
        gens = [torch.Generator().manual_seed(16) for _ in range(2)]
        opts = {}
    eager, program = VideoSampler(models[0], td, graphs=False), VideoSampler(models[0], td)
    want = eager.sample_window_attn(**kw, generator=gens[0], **opts)
    got = program.sample_window_attn(**kw, generator=gens[1], **opts)
    if not injected:
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    again = program.sample_window_attn(
        **kw, generator=None if injected else torch.Generator().manual_seed(16), **opts)
    for out in (got, again):
        assert torch.equal(out[0], want[0])
        assert list(out[1]) == list(want[1]) and len(want[1]) == 8
        for tag, ref in want[1].items():
            assert torch.equal(out[1][tag], ref), tag
    (prog,) = program._programs.values()
    assert got[1]["attn/q0-temporal"] is not prog.acc[0][0]  # the caller's own
    assert eager.model_calls * 2 == program.model_calls == 2 * td.num_timesteps


@pytest.mark.usefixtures("one_thread")
def test_heatmap_program_is_memoized_apart_from_the_window_program(models):  # noqa: F811
    """One program per ("attn", shapes), made at its first call and kept,
    beside (not shared with) the plain window's program of the same shape."""
    _, kw = window(17)
    s = VideoSampler(models[0], diffusions("4")[1])
    s.sample_window(**kw, generator=torch.Generator().manual_seed(1))
    s.sample_window_attn(**kw, generator=torch.Generator().manual_seed(1))
    s.sample_window_attn(**kw, generator=torch.Generator().manual_seed(2))
    keys = list(s._programs)
    assert len(keys) == 2 and keys[1] == ("attn",) + keys[0]
    plain, attn = (s._programs[k] for k in keys)
    assert (plain.mode, attn.mode) == ("ancestral", "attn") and plain.acc is None
    tail = {k: v[:, :3] for k, v in kw.items()}  # another K: a program of its own
    _, maps = s.sample_window_attn(**tail, generator=torch.Generator().manual_seed(3))
    assert len(s._programs) == 3 and maps["attn/q0-temporal"].shape == (1, 3, 3)


@pytest.mark.parametrize("kwargs", [dict(use_ddim=True), dict(use_dpm=True)])
def test_sample_window_attn_refuses_other_samplers(models, kwargs):  # noqa: F811
    _, kw = window(0)
    with pytest.raises(ValueError, match="exact ancestral"):
        VideoSampler(models[0], diffusions()[1], **kwargs).sample_window_attn(
            **kw, generator=torch.Generator())


def test_video_train_log_attn_saves_the_heatmaps(tmp_path, monkeypatch,
                                                quiet_loggers):  # noqa: F811
    """``--log_attn True``: the vis sampler at step 1 writes its gifs and the
    eight quartile heatmaps of the window it sampled."""
    monkeypatch.chdir(tmp_path)
    loop = video_train.main(TRAIN_ARGS + ["--max_steps", "2", "--save_interval", "0",
                                          "--sample_interval", "1", "--log_interval", "0",
                                          "--log_attn", "True"])
    vis = sorted(p.name for p in (tmp_path / loop.checkpoint_dir / "vis").iterdir())
    tags = [f"attn_q{q}-{kind}" for q in range(4) for kind in ("spatial", "temporal")]
    assert vis == sorted([f"step000001_{t}.npy" for t in tags]
                         + [f"step000001_video{i}.gif" for i in range(2)])
    K = 4  # --max_frames
    S = 8 ** 2  # --attention_resolutions 8: attention at 8x8 of 64 px
    for t in tags:
        arr = np.load(tmp_path / loop.checkpoint_dir / "vis" / f"step000001_{t}.npy")
        assert arr.shape == ((2, K, K) if t.endswith("temporal") else (2, S, S))
        assert np.isfinite(arr).all() and arr.dtype == np.float32
