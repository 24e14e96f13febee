from .schedules import get_named_beta_schedule, betas_for_alpha_bar, space_timesteps  # noqa: F401
from .gaussian import GaussianDiffusion, ModelMeanType, ModelVarType, LossType  # noqa: F401
from .dpm_solver import dpm_solver_pp_coefficients, dpm_solver_pp_sample_loop  # noqa: F401
