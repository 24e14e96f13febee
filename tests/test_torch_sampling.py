"""Port vs JAX package: diffusion steps, whole DDIM and DPM-Solver++ windows,
sampling schemes and the long-video driver (tiny config, f32, CPU).

Random numbers do not cross frameworks: the ancestral sampler is compared one
step at a time with the JAX step's own noise injected into the port's, and
whole trajectories only for the deterministic samplers (DDIM with eta 0,
DPM-Solver++), both started from the same ``noise``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.diffusion.dpm_solver import dpm_solver_pp_sample_loop as j_dpm_loop
from lfvdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from lfvdm_tpu.sampling.driver import VideoSampler as JVideoSampler
from lfvdm_tpu.sampling.schemes import sampling_schemes as j_schemes
from lfvdm_tpu.utils.torch_convert import convert_unet_state_dict
from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE, create_diffusion, flagship_config
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_sample_loop as t_dpm_loop
from lfvdm_tpu_torch.diffusion.gaussian import GaussianDiffusion as TDiffusion
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.sampling.schemes import sampling_schemes as t_schemes

CFG = flagship_config(tiny=True)  # 8 diffusion steps
B, K = 1, 5


def assert_close_conditioned(out, ref, kappa, err_msg=""):
    """1e-4, plus what a step's x0 estimate x0 = √(1/ᾱ)·x − √(1/ᾱ − 1)·ε
    multiplies the U-Net's own f32 disagreement by: kappa = √(1/ᾱ) of the
    noisiest step taken (163 at the last step of the 8-step cosine
    schedule, <= 5.2 elsewhere), times 1e-5 (the two packages' U-Nets agree
    to ~4e-6 on outputs of magnitude ~2)."""
    np.testing.assert_allclose(out, ref, atol=1e-4 + 1e-5 * kappa, rtol=1e-4, err_msg=err_msg)


def build_models():
    """The tiny U-Net in both packages, sharing perturbed weights."""
    model, _ = t_create(CFG, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = convert_unet_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        num_res_blocks=CFG["num_res_blocks"],
        channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[CFG["image_size"]],
        attention_resolutions=model.attention_resolutions)
    jmodel, _ = j_create(CFG)
    return model, jmodel, params


@pytest.fixture(scope="module")
def models():
    return build_models()


def window(seed=0):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    x0 = rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32)
    fi = np.array([[0, 1, 4, 5, 6]], np.int32)
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :2] = 1.0
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    return noise, dict(x0=x0, frame_indices=fi, obs_mask=obs, latent_mask=1.0 - obs)


def model_fns(models, kw):
    model, jmodel, params = models
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tkw["frame_indices"] = tkw["frame_indices"].long()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def t_fn(x, ts, **_):
        return model(x, ts, **tkw)[0]

    def j_fn(x, ts, **_):
        return jmodel.apply(params, x, ts, **jkw)[0]

    return t_fn, j_fn


def diffusions(respacing=""):
    cfg = dict(CFG, timestep_respacing=respacing)
    _, jd = j_create(cfg)
    return jd, create_diffusion(cfg)


# ---- single steps ----


@pytest.fixture(scope="module")
def ancestral_step(models):
    """One jitted JAX ancestral step (compiled once for every t) and the port's."""
    noise0, kw = window(1)
    jd, td = diffusions()
    t_fn, j_fn = model_fns(models, kw)
    j_step = jax.jit(lambda x, t, key: jd.p_sample(j_fn, x, t, key))
    return noise0, jd, td, t_fn, j_step


@pytest.mark.parametrize("s", [0, 3, 5, 7])
def test_p_sample_step_with_injected_noise(ancestral_step, s):
    noise0, jd, td, t_fn, j_step = ancestral_step
    key = jax.random.PRNGKey(s)
    ref = j_step(jnp.asarray(noise0), jnp.full((B,), s, jnp.int32), key)
    step_noise = np.asarray(jax.random.normal(key, noise0.shape))  # the JAX step's draw
    with torch.no_grad():
        out = td.p_sample(t_fn, torch.from_numpy(noise0), torch.full((B,), s),
                          noise=torch.from_numpy(step_noise))
    kappa = td.table("sqrt_recip_alphas_cumprod")[s]
    for name in ("sample", "pred_xstart"):
        assert_close_conditioned(out[name].numpy(), np.asarray(ref[name]), kappa, name)


@pytest.mark.parametrize("variant", ["fixed_large", "fixed_small", "learned_range", "start_x"])
@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_from_output(variant, clip):
    kw = dict(steps=8, noise_schedule="cosine", timestep_respacing="",
              learn_sigma=variant == "learned_range", sigma_small=variant == "fixed_small",
              predict_xstart=variant == "start_x")
    jd, td = JDiffusion.create(**kw), TDiffusion.create(**kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 2, 4, 4)).astype(np.float32)
    c_out = 4 if variant == "learned_range" else 2
    out = rng.uniform(-1.5, 1.5, (3, 2, c_out, 4, 4)).astype(np.float32)
    t = np.array([0, 3, 7])
    ref = jd.p_mean_variance_from_output(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
                                         clip_denoised=clip)
    got = td.p_mean_variance_from_output(torch.from_numpy(out), torch.from_numpy(x),
                                         torch.from_numpy(t), clip_denoised=clip)
    for name in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_q_sample():
    jd, td = diffusions()
    rng = np.random.default_rng(3)
    x, n = (rng.standard_normal((4, 2, 3, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 2, 5, 7])
    ref = jd.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(n))
    got = td.q_sample(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


# ---- whole deterministic windows ----


def test_ddim_window_matches_jax(models):
    noise, kw = window(4)
    jd, td = diffusions("ddim4")
    t_fn, j_fn = model_fns(models, kw)
    ref = jd.ddim_sample_loop(j_fn, noise.shape, jax.random.PRNGKey(0),
                              noise=jnp.asarray(noise), eta=0.0)
    with torch.no_grad():
        out = td.ddim_sample_loop(t_fn, noise.shape, device="cpu", noise=torch.from_numpy(noise))
    assert_close_conditioned(out.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())


def test_dpm_window_matches_jax(models):
    noise, kw = window(5)
    jd, td = diffusions("dpm4")
    t_fn, j_fn = model_fns(models, kw)
    ref = j_dpm_loop(jd, j_fn, noise.shape, jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    with torch.no_grad():
        out = t_dpm_loop(td, t_fn, noise.shape, device="cpu", noise=torch.from_numpy(noise))
    assert_close_conditioned(out.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())


def test_samplers_draw_only_from_the_given_generator(models):
    _, kw = window(6)
    sampler = VideoSampler(models[0], diffusions("4")[1])
    a = sampler.sample_window(**kw, generator=torch.Generator().manual_seed(3))
    b = sampler.sample_window(**kw, generator=torch.Generator().manual_seed(3))
    c = sampler.sample_window(**kw, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c)
    assert sampler.model_calls == 3 * 4
    with pytest.raises(ValueError, match="Generator"):
        sampler.sample_window(**kw)


# ---- schemes and the long-video driver ----

SCHEME_CASES = [
    ("autoreg", 40, 10, 20, 10),
    ("autoreg", 23, 0, 6, 3),
    ("long-range", 30, 5, 8, 3),
    ("hierarchy-2", 40, 4, 10, 5),
    ("hierarchy-3", 60, 5, 12, 6),
]


def _indices(schemes, name, T, n_obs, K_, step, B_=2):
    scheme = iter(schemes[name](video_length=T, num_obs=n_obs, max_frames=K_, step_size=step))
    seq = []
    for i, (obs, lat) in enumerate(scheme):
        if i % 2:  # the driver calls set_videos before each step
            scheme.set_videos(np.zeros((B_, T, 1, 1, 1), np.float32))
        seq.append((obs, lat))
    return seq


@pytest.mark.parametrize("name,T,n_obs,K_,step", SCHEME_CASES)
def test_scheme_indices_match_jax(name, T, n_obs, K_, step):
    assert _indices(t_schemes, name, T, n_obs, K_, step) == _indices(j_schemes, name, T, n_obs,
                                                                     K_, step)


def test_adaptive_scheme_matches_jax_with_a_given_embedder():
    videos = np.random.default_rng(8).standard_normal((2, 16, 1, 4, 4)).astype(np.float32)

    def embedder(frames):
        return frames.reshape(len(frames), -1)[:, :6]

    def run(schemes):
        s = schemes["adaptive-autoreg"](video_length=16, num_obs=3, max_frames=6,
                                        step_size=2, embedder=embedder)
        out = []
        while not s.is_done():
            s.set_videos(videos)
            out.append(next(s))
        return out

    assert run(t_schemes) == run(j_schemes)
    # Without one, the scheme takes the port's default LPIPS embedder.
    from lfvdm_tpu_torch.evals.lpips import LpipsEmbedder

    s = t_schemes["adaptive-autoreg"](video_length=16, num_obs=3, max_frames=6, step_size=2,
                                      device="cpu")
    assert isinstance(s._embedder, LpipsEmbedder)


def test_driver_windows_match_jax_indices(models):
    video = np.zeros((2, 21, CFG["in_channels"], 4, 4), np.float32)
    args = dict(scheme_name="hierarchy-2", n_obs=3, max_frames=7, step_size=3,
                just_get_indices=True)
    _, used = VideoSampler(models[0], diffusions()[1]).sample_video(
        video, generator=torch.Generator(), **args)
    _, j_used = JVideoSampler(None, None, None).sample_video(video, rng=jax.random.PRNGKey(0),
                                                             **args)
    assert used == j_used


def test_sample_video_keeps_observed_frames_and_covers_all(models):
    T, n_obs = 11, 2
    video = np.random.default_rng(9).uniform(
        -1, 1, (B, T, CFG["in_channels"], CFG["image_size"], CFG["image_size"])).astype(np.float32)
    sampler = VideoSampler(models[0], diffusions("4")[1], use_ddim=True)
    samples, used = sampler.sample_video(video, scheme_name="autoreg", n_obs=n_obs, max_frames=K,
                                         step_size=3, generator=torch.Generator().manual_seed(0))
    assert samples.shape == video.shape and np.isfinite(samples).all()
    np.testing.assert_array_equal(samples[:, :n_obs], video[:, :n_obs])
    generated = {i for _, lat in used for i in lat[0]}
    assert generated | set(range(n_obs)) == set(range(T))
    assert all(np.abs(samples[:, i]).max() > 0 for i in generated)
    assert sampler.model_calls == 4 * len(used)
