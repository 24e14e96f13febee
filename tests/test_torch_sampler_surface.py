"""Port vs JAX package: the rest of the diffusion sampler surface at the tiny
config (f32, CPU): ``p_sample_loop_progressive`` (each step's output, with
the JAX steps' own noise injected), ``ddim_reverse_sample``, ``_prior_bpd``
and ``calc_bpd_loop`` (each term drawn with the JAX term's noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from lfvdm_tpu_torch.diffusion.gaussian import GaussianDiffusion as TDiffusion
from test_torch_encoder_reuse import jax_step_noise, models  # noqa: F401 (a fixture)
from test_torch_sampling import assert_close_conditioned, diffusions, model_fns, window


def jax_term_noise(key, shape, terms):
    """The noise of each term JAX's ``calc_bpd_loop`` draws from ``key``."""
    rng, out = key, []
    for _ in range(terms):
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.normal(k, shape, dtype=jnp.float32))))
    return out


def test_progressive_matches_jax_step_by_step(models):  # noqa: F811
    noise, kw = window(13)
    jd, td = diffusions()
    t_fn, j_fn = model_fns(models, kw)
    key = jax.random.PRNGKey(6)
    ref = list(jd.p_sample_loop_progressive(j_fn, noise.shape, key, noise=jnp.asarray(noise)))
    steps = [torch.from_numpy(n) for n in jax_step_noise(key, noise.shape, td.num_timesteps)]
    with torch.no_grad():
        got = list(td.p_sample_loop_progressive(t_fn, noise.shape, device="cpu",
                                                noise=torch.from_numpy(noise),
                                                step_noise=steps))
        last = td.p_sample_loop(t_fn, noise.shape, device="cpu", noise=torch.from_numpy(noise),
                                step_noise=steps)
    assert len(got) == len(ref) == td.num_timesteps
    kappa = td.table("sqrt_recip_alphas_cumprod").max()
    for i, (a, b) in enumerate(zip(got, ref)):
        for name in ("sample", "pred_xstart"):
            assert_close_conditioned(a[name].numpy(), np.asarray(b[name]), kappa, f"{i} {name}")
    torch.testing.assert_close(got[-1]["sample"], last, atol=0, rtol=0)


@pytest.mark.parametrize("s", [2, 6])
def test_ddim_reverse_sample_matches_jax(models, s):  # noqa: F811
    x, kw = window(14)
    jd, td = diffusions()
    t_fn, j_fn = model_fns(models, kw)
    ref = jd.ddim_reverse_sample(j_fn, jnp.asarray(x), jnp.full((1,), s, jnp.int32))
    with torch.no_grad():
        got = td.ddim_reverse_sample(t_fn, torch.from_numpy(x), torch.full((1,), s))
    kappa = td.table("sqrt_recip_alphas_cumprod")[s]
    for name in ("sample", "pred_xstart"):
        assert_close_conditioned(got[name].numpy(), np.asarray(ref[name]), kappa, name)


def test_calc_bpd_loop_matches_jax_at_two_timesteps(models):  # noqa: F811
    _, kw = window(15)
    x_start = kw["x0"]
    jd, td = diffusions()
    t_fn, j_fn = model_fns(models, kw)
    lat = kw["latent_mask"]
    key = jax.random.PRNGKey(7)
    t_seq = [5, 0]  # a KL term and the decoder's NLL term
    ref = jd.calc_bpd_loop(j_fn, jnp.asarray(x_start), key, latent_mask=jnp.asarray(lat),
                           t_seq=t_seq)
    with torch.no_grad():
        got = td.calc_bpd_loop(t_fn, torch.from_numpy(x_start),
                               noise=jax_term_noise(key, x_start.shape, 2),
                               latent_mask=torch.from_numpy(lat), t_seq=t_seq)
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert tuple(got[name].shape) == r.shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(r), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    assert float(got["vb"][0, 0]) != float(got["vb"][0, 1])


def test_calc_bpd_loop_per_element_timesteps_and_prior():
    """A (B, S) ``t_seq`` on a fixed model, and the prior term, equal JAX's."""
    kw = dict(steps=8, noise_schedule="cosine", learn_sigma=True)
    jd, td = JDiffusion.create(**kw), TDiffusion.create(**kw)
    rng = np.random.default_rng(16)
    x_start = rng.uniform(-1, 1, (2, 3, 1, 4, 4)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (2, 1, 2, 4, 4)).astype(np.float32)

    def j_fn(x, ts):
        return jnp.concatenate([0.5 * x, jnp.tanh(x)], axis=2) + jnp.asarray(w)

    def t_fn(x, ts):
        return torch.cat([0.5 * x, torch.tanh(x)], dim=2) + torch.from_numpy(w)

    t_seq = np.array([[7, 3, 0], [1, 0, 4]])
    key = jax.random.PRNGKey(8)
    ref = jd.calc_bpd_loop(j_fn, jnp.asarray(x_start), key, t_seq=t_seq)
    got = td.calc_bpd_loop(t_fn, torch.from_numpy(x_start),
                           noise=jax_term_noise(key, x_start.shape, 3), t_seq=t_seq)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(td._prior_bpd(torch.from_numpy(x_start)).numpy(),
                               np.asarray(jd._prior_bpd(jnp.asarray(x_start))), atol=1e-7,
                               rtol=1e-5)
    # Drawn from a generator: seeded, repeatable.
    a, b = (td.calc_bpd_loop(t_fn, torch.from_numpy(x_start),
                             generator=torch.Generator().manual_seed(0)) for _ in range(2))
    assert a["vb"].shape == (2, 8)
    torch.testing.assert_close(a["total_bpd"], b["total_bpd"], atol=0, rtol=0)
