"""Port vs JAX package: the latent slice as a whole (tiny widths, f32, CPU).

A tiny latent U-Net (4 input channels) runs a DDIM (eta 0) window from the
same ``noise`` in both packages; each package decodes its window through its
own ``PreEncodedLatentCodec`` over the same tiny VAE. Then the port's own
composition: ``sample_video(codec=...)`` decodes exactly what a codec-less
run samples, and ``TrainLoop(codec=VAECodec)`` prepares the encoding of the
batch it would prepare without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.diffusion.codecs import PreEncodedLatentCodec as JPreEncoded
from lfvdm_tpu.utils.torch_convert import convert_unet_state_dict
from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE, create_diffusion, flagship_config
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.config import latent_config
from lfvdm_tpu_torch.diffusion.codecs import PreEncodedLatentCodec, VAECodec
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.training.train_loop import TrainLoop
from test_torch_sampling import assert_close_conditioned
from test_torch_vae import rel_l2, tiny_vae_pair

# The tiny U-Net's shapes with the latent config's space: 4 latent channels.
CFG = dict(flagship_config(tiny=True), in_channels=4, diffusion_space="latent", pre_encoded=True)
B, K = 1, 5
MEAN = np.array([0.1, -0.2, 0.3, 0.0], np.float32)
STD = np.array([0.9, 1.1, 0.8, 1.2], np.float32)


@pytest.fixture(scope="module")
def models():
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
def vaes():
    return tiny_vae_pair(seed=2)


def test_latent_config_is_the_reference_command():
    cfg = latent_config()
    assert (cfg["image_size"], cfg["in_channels"], cfg["num_channels"], cfg["num_res_blocks"],
            cfg["attention_resolutions"], cfg["compute_dtype"]) == (32, 4, 64, 1, "16,8",
                                                                    "bfloat16")
    assert cfg["diffusion_space"] == "latent" and cfg["pre_encoded"]
    model, _ = t_create(dict(cfg, compute_dtype="float32"), device="cpu")
    assert model.attention_resolutions == (2, 4)


def test_latent_window_and_decode_match_jax(models, vaes):
    model, jmodel, params = models
    vae, jvae = vaes
    rng = np.random.default_rng(11)
    S = CFG["image_size"]
    x0 = rng.standard_normal((B, K, 4, S, S)).astype(np.float32)
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :2] = 1.0
    kw = dict(x0=x0, frame_indices=np.array([[0, 1, 3, 5, 6]], np.int32), obs_mask=obs,
              latent_mask=1.0 - obs)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tkw["frame_indices"] = tkw["frame_indices"].long()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    cfg = dict(CFG, timestep_respacing="ddim4")
    _, jd = j_create(cfg)
    td = create_diffusion(cfg)
    ref = jd.ddim_sample_loop(lambda x, t, **_: jmodel.apply(params, x, t, **jkw)[0],
                              noise.shape, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                              eta=0.0)
    with torch.no_grad():
        out = td.ddim_sample_loop(lambda x, t, **_: model(x, t, **tkw)[0], noise.shape,
                                  device="cpu", noise=torch.from_numpy(noise))
    assert_close_conditioned(out.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())

    pixels = PreEncodedLatentCodec(MEAN, STD, vae=vae).decode(out)
    j_pixels = np.asarray(JPreEncoded(MEAN, STD, vae=jvae).decode(np.asarray(ref)))
    assert pixels.shape == j_pixels.shape == (B, K, 3, 8 * S, 8 * S)
    assert rel_l2(pixels.numpy(), j_pixels) <= 1e-4


def test_sample_video_decodes_the_codecless_run(models, vaes):
    model, vae = models[0], vaes[0]
    diffusion = create_diffusion(dict(CFG, timestep_respacing="4"))
    codec = PreEncodedLatentCodec(MEAN, STD, vae=vae)
    S = CFG["image_size"]
    video = np.random.default_rng(12).standard_normal((B, 6, 4, S, S)).astype(np.float32)
    args = dict(scheme_name="autoreg", n_obs=2, max_frames=K, step_size=3)

    latents, used = VideoSampler(model, diffusion).sample_video(
        video, generator=torch.Generator().manual_seed(5), **args)
    sampler = VideoSampler(model, diffusion, codec=codec)
    pixels, used_c = sampler.sample_video(video, generator=torch.Generator().manual_seed(5), **args)
    assert used_c == used and isinstance(pixels, np.ndarray)
    assert pixels.shape == (B, 6, 3, 8 * S, 8 * S) and np.isfinite(pixels).all()
    np.testing.assert_array_equal(latents[:, :2], video[:, :2])
    np.testing.assert_allclose(pixels, codec.decode(latents).numpy(), atol=1e-6, rtol=1e-6)
    # Indices only: nothing is sampled or decoded.
    same, _ = sampler.sample_video(video, generator=torch.Generator(), just_get_indices=True,
                                   **args)
    assert same.shape == video.shape


def test_train_loop_encodes_the_prepared_batch(models, vaes, tmp_path):
    """Two loops with one seed draw the same frames and masks; the one with
    ``VAECodec`` holds the encoding (the mean, on the training device) of
    the other's x0. Then one step of the online latent path."""
    vae = vaes[0]
    codec = VAECodec(vae=vae)
    S = 8 * CFG["image_size"]
    rng = np.random.default_rng(13)
    videos = [rng.uniform(-1, 1, (B, 8, 3, S, S)).astype(np.float32) for _ in range(2)]

    def loop(**kw):
        model, diffusion = t_create(CFG, device="cpu", seed=1)
        return TrainLoop(model=model, diffusion=diffusion, data=iter(videos * 2), batch_size=B,
                         max_frames=K, lr=1e-3, log_interval=0, save_interval=0,
                         checkpoint_dir=str(tmp_path / "run"), seed=4, **kw)

    plain, online = loop(), loop(codec=codec)
    a = plain._prepare(*videos)
    b = online._prepare(*videos)
    for key in ("frame_indices", "obs_mask", "latent_mask"):
        np.testing.assert_array_equal(a[key], b[key])
    assert b["x0"].shape == (B, K, 4, CFG["image_size"], CFG["image_size"])
    torch.testing.assert_close(b["x0"], codec.encode(torch.from_numpy(a["x0"])), atol=0, rtol=0)

    metrics = online.run_step()
    assert np.isfinite(metrics["loss"].numpy()).all()
    # The pre-encoded codec's encode is the identity.
    pre = loop(codec=PreEncodedLatentCodec(MEAN, STD))
    latents = rng.standard_normal((B, 8, 4, CFG["image_size"], CFG["image_size"]))
    latents = latents.astype(np.float32)
    np.testing.assert_array_equal(pre._prepare(latents, latents)["x0"].numpy(),
                                  loop()._prepare(latents, latents)["x0"])
