"""Port vs JAX package: beta schedules, diffusion tables, respacing, DPM-Solver++ coefficients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.diffusion import schedules as jsched
from lfvdm_tpu.diffusion.dpm_solver import dpm_solver_pp_coefficients as j_coeffs
from lfvdm_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from lfvdm_tpu_torch.diffusion import schedules as tsched
from lfvdm_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_coefficients as t_coeffs
from lfvdm_tpu_torch.diffusion.gaussian import GaussianDiffusion as TDiffusion

RTOL = 1e-12
STEPS = 8
# The linear schedule needs >= 20 steps to keep every beta below 1.
STEPS_OF = {"cosine": STEPS, "linear": 1000}
CASES = [(schedule, respacing) for schedule in ("linear", "cosine")
         for respacing in ("", "4", "ddim4", "dpm4")]


def _pair(schedule, respacing, **kw):
    args = dict(steps=STEPS_OF[schedule], noise_schedule=schedule,
                timestep_respacing=respacing, rescale_timesteps=True, **kw)
    return JDiffusion.create(**args), TDiffusion.create(**args)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("steps", [8, 1000])
def test_named_beta_schedules(schedule, steps):
    np.testing.assert_allclose(tsched.get_named_beta_schedule(schedule, steps),
                               jsched.get_named_beta_schedule(schedule, steps), rtol=RTOL)


@pytest.mark.parametrize("spec", ["4", "ddim4", "2,1", "8", "ddim2"])
def test_space_timesteps(spec):
    assert tsched.space_timesteps(STEPS, spec) == jsched.space_timesteps(STEPS, spec)


@pytest.mark.parametrize("n", [2, 4, 20])
def test_space_timesteps_lambda_uniform(n):
    betas = jsched.get_named_beta_schedule("linear", 1000)
    assert (tsched.space_timesteps_lambda_uniform(betas, n)
            == jsched.space_timesteps_lambda_uniform(betas, n))


@pytest.mark.parametrize("schedule,respacing", CASES)
def test_diffusion_tables(schedule, respacing):
    jd, td = _pair(schedule, respacing)
    np.testing.assert_allclose(td.betas, jd.betas, rtol=RTOL)
    assert td.num_timesteps == jd.num_timesteps
    if respacing:
        np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    else:
        assert td.timestep_map is None and jd.timestep_map is None
    for name, table in jd._tables.items():
        np.testing.assert_allclose(td.table(name), table, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("schedule,respacing", CASES)
def test_model_timesteps(schedule, respacing):
    """What the model sees: respacing map, then the 1000/N rescale, in f32."""
    jd, td = _pair(schedule, respacing)
    t = np.arange(jd.num_timesteps, dtype=np.int32)
    np.testing.assert_array_equal(td._model_t(torch.from_numpy(t).long()).numpy(),
                                  np.asarray(jd._model_t(jnp.asarray(t))))


@pytest.mark.parametrize("schedule,respacing", CASES)
def test_dpm_solver_coefficients(schedule, respacing):
    jd, td = _pair(schedule, respacing)
    jc, tc = j_coeffs(jd), t_coeffs(td)
    for name in ("ts", "c_x", "c_d", "d0", "d1"):
        np.testing.assert_allclose(getattr(tc, name), getattr(jc, name), rtol=RTOL, err_msg=name)


def test_extract_gathers_f32_tables():
    _, td = _pair("cosine", "")
    t = torch.tensor([0, 3, 7])
    vals = td._extract("sqrt_alphas_cumprod", t, 4)
    assert vals.shape == (3, 1, 1, 1) and vals.dtype == torch.float32
    np.testing.assert_array_equal(
        vals.flatten().numpy(), td.table("sqrt_alphas_cumprod")[[0, 3, 7]].astype(np.float32))
