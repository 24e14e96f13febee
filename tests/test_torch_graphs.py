"""Port: the window programs (``sampling/graphs.py`` ``WindowProgram`` and
``VideoSampler._sampler_for``, the counterpart of the JAX driver's per-shape
compiled sampler) on the CPU, at the tiny config (f32, one torch thread).

On the CPU a program runs its step eagerly on its static buffers (the card
replays a CUDA graph of the same step: ``test_torch_graphs_cuda.py``), so
here it is held:
- (a) bitwise to the eager loops (``graphs=False``) with the same generator,
  for the ancestral, DDIM (eta 0 and not), DPM-Solver++ and encoder-reuse
  (k = 2) samplers, which also leave the generator where the eager loops do;
  and the DPM-Solver++ step's 0-d f32 coefficient tensors bitwise to the f32
  constants the loop used before it had a step form;
- (b) to the JAX package: whole DDIM (eta 0) and DPM-Solver++ windows of
  JAX's ``VideoSampler.sample_window`` from the same terminal noise
  (``assert_close_conditioned``), and the ancestral program one step at a
  time with each JAX step's noise injected (atol 1e-5; the noisiest step,
  whose x0 estimate is ill-conditioned, to ``assert_close_conditioned``);
- (c) the memo: a second window of a shape makes no program, a tail window
  of another K makes one;
- (d) ``model_calls``, ``reuse_calls`` and the launch counters advance per
  run as the eager loop's do: on the CPU no launch is counted, and a replay
  (here of stand-in graphs that run the step eagerly) adds a stub of a
  capture's launch counts;
- (e) ``devices=[cpu, cpu]``: one program per replica, and the window
  bitwise the one-device program run on each block of rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.sampling.driver import VideoSampler as JVideoSampler
from lfvdm_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_coefficients
from lfvdm_tpu_torch.ops import _common
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.sampling.graphs import WindowProgram, eval_mode
from test_torch_sampling import (B, CFG, K, assert_close_conditioned, build_models, diffusions,
                                 model_fns, window)

# name -> (respacing, VideoSampler options); the tiny config has 8 steps.
SAMPLERS = {
    "ancestral": ("4", {}),
    "ddim": ("ddim4", dict(use_ddim=True)),
    "ddim_eta": ("ddim4", dict(use_ddim=True, eta=0.5)),
    "dpm": ("dpm4", dict(use_dpm=True)),
    "reuse": ("", dict(encoder_reuse=2)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return build_models()


def sampler(models, name, **kw):
    respacing, opts = SAMPLERS[name]
    return VideoSampler(models[0], diffusions(respacing)[1], **opts, **kw)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_program_is_the_eager_loop_bitwise(models, name):
    _, kw = window(20)
    eager, graphs = sampler(models, name, graphs=False), sampler(models, name)
    g_eager, g_graphs = (torch.Generator().manual_seed(21) for _ in range(2))
    want = eager.sample_window(**kw, generator=g_eager)
    got = graphs.sample_window(**kw, generator=g_graphs)
    assert torch.equal(got, want)
    assert torch.equal(g_graphs.get_state(), g_eager.get_state())  # the same draws
    assert (graphs.model_calls, graphs.reuse_calls) == (eager.model_calls, eager.reuse_calls)
    assert len(graphs._programs) == 1
    # A second window of the shape reuses the program and its buffers.
    again = graphs.sample_window(**kw, generator=torch.Generator().manual_seed(21))
    assert torch.equal(again, want) and again is not got


def test_dpm_step_coefficients_are_the_f32_constants_bitwise(models):
    """The step form multiplies by 0-d f32 tensors; the loop it replaced
    multiplied by the same f32 values as Python floats."""
    noise, kw = window(22)
    _, td = diffusions("dpm4")
    t_fn, _ = model_fns(models, kw)
    co = dpm_solver_pp_coefficients(td)
    with torch.no_grad():
        x = torch.from_numpy(noise)
        x0_prev = torch.zeros_like(x)
        for i in range(len(co.ts)):
            t = torch.full((B,), int(co.ts[i]), dtype=torch.int64)
            x0 = td.p_mean_variance(t_fn, x, t)["pred_xstart"]
            c_x, c_d, d0, d1 = (float(a[i]) for a in (co.c_x, co.c_d, co.d0, co.d1))
            x = c_x * x + c_d * (d0 * x0 + d1 * x0_prev)
            x0_prev = x0
    for graphs in (False, True):
        got = sampler(models, "dpm", graphs=graphs).sample_window(
            **kw, noise=torch.from_numpy(noise))
        assert torch.equal(got, x)


@pytest.mark.parametrize("name", ["ddim", "dpm"])
def test_program_window_matches_jax_sampler(models, name):
    _, jmodel, params = models
    _, kw = window(23)
    jd, td = diffusions(SAMPLERS[name][0])
    key = jax.random.PRNGKey(24)
    j_sampler = JVideoSampler(jmodel, jd, params, use_ddim=name == "ddim", use_dpm=name == "dpm")
    ref = j_sampler.sample_window(*(jnp.asarray(kw[k]) for k in
                                    ("x0", "frame_indices", "obs_mask", "latent_mask")), key)
    # Both JAX samplers draw the terminal noise from the key's second split.
    noise = np.array(jax.random.normal(jax.random.split(key)[1], kw["x0"].shape))
    port = sampler(models, name)
    got = port.sample_window(**kw, noise=torch.from_numpy(noise))
    assert port.model_calls == 4 and len(port._programs) == 1
    assert_close_conditioned(got.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())


def test_program_ancestral_steps_match_jax_with_injected_noise(models):
    noise, kw = window(25)
    jd, td = diffusions()
    _, j_fn = model_fns(models, kw)
    j_step = jax.jit(lambda x, t, key: jd.p_sample(j_fn, x, t, key)["sample"])
    noise = noise.copy()
    port = VideoSampler(models[0], td)
    program = port._sampler_for(0, port._window_args(**kw)[0])
    program.load(port._window_args(**kw)[0], torch.from_numpy(noise))
    for i in range(td.num_timesteps):
        key = jax.random.PRNGKey(100 + i)
        x = program.x.numpy().copy()
        s = td.num_timesteps - 1 - i
        ref = j_step(jnp.asarray(x), jnp.full((B,), s, jnp.int32), key)
        step_noise = np.array(jax.random.normal(key, x.shape))  # the JAX step's draw
        program.run(i, torch.from_numpy(step_noise))
        kappa = td.table("sqrt_recip_alphas_cumprod")[s]
        if kappa > 10:
            # The noisiest step multiplies the U-Nets' f32 disagreement by
            # kappa = 163 in its x0 estimate (8.6e-5 here), as the single
            # step of test_torch_sampling.py does.
            assert_close_conditioned(program.x.numpy(), np.asarray(ref), kappa, f"step {i}")
        else:
            np.testing.assert_allclose(program.x.numpy(), np.asarray(ref), atol=1e-5, rtol=0,
                                       err_msg=f"step {i}")
    assert port.model_calls == td.num_timesteps


def test_memo_one_program_per_shape(models):
    rng = np.random.default_rng(26)
    _, kw = window(26)
    s = sampler(models, "ddim")
    gen = torch.Generator().manual_seed(27)
    s.sample_window(**kw, generator=gen)
    (program,) = s._programs.values()
    s.sample_window(**{k: v.copy() for k, v in kw.items()}, generator=gen)
    assert list(s._programs.values()) == [program]
    tail = {k: v[:, :3] for k, v in kw.items()}  # a scheme's tail window: K = 3
    tail["x0"] = rng.uniform(-1, 1, tail["x0"].shape).astype(np.float32)
    out = s.sample_window(**tail, generator=gen)
    assert out.shape == tail["x0"].shape and len(s._programs) == 2
    assert sorted(p.shape[1] for p in s._programs.values()) == [3, K]
    want = sampler(models, "ddim", graphs=False).sample_window(
        **tail, noise=torch.zeros(tail["x0"].shape))
    got = s.sample_window(**tail, noise=torch.zeros(tail["x0"].shape))
    assert torch.equal(got, want) and len(s._programs) == 2


def _stub(n_temporal, n_spatial, n_skip):
    """A capture's launch counts, as ``_common.launch_snapshot`` keys them."""
    return {("temporal_rpe_attention", None): n_temporal,
            ("spatial_attention", None): n_spatial, ("spatial_attention", "mma"): n_spatial,
            ("skip_conv_stats", None): n_skip, ("skip_conv_stats", "bulk"): n_skip}


class _EagerGraph:
    """A stand-in for a captured graph of ``program``: its replay runs the
    step of ``kind`` eagerly on the program's buffers."""

    def __init__(self, program, kind):
        self.program, self.kind = program, kind

    def replay(self):
        with torch.no_grad(), eval_mode(self.program.model):
            features = self.program._step(self.kind)
        if self.kind == "full":
            self.program.features = features


def test_calls_and_launch_counters_advance_per_run(models):
    _, kw = window(28)
    eager, graphs = sampler(models, "reuse", graphs=False), sampler(models, "reuse")
    ops.reset_launch_counts()
    eager.sample_window(**kw, generator=torch.Generator().manual_seed(29))
    graphs.sample_window(**kw, generator=torch.Generator().manual_seed(29))
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert (graphs.model_calls, graphs.reuse_calls) == (eager.model_calls, eager.reuse_calls) \
        == (8, 4)
    (program,) = graphs._programs.values()
    program.graphs = {kind: _EagerGraph(program, kind) for kind in ("full", "reuse")}
    program.deltas = {"full": _stub(7, 7, 10), "reuse": _stub(4, 4, 10)}
    kinds = []
    for i in range(program.steps):
        calls = (graphs.model_calls, graphs.reuse_calls)
        before = _common.launch_snapshot()
        program.run(i, torch.zeros(program.shape))
        kind = program.kind(i)
        kinds.append(kind)
        assert _common.launch_delta(_common.launch_snapshot(), before) == {
            **dict.fromkeys(before, 0), **program.deltas[kind]}
        assert (graphs.model_calls, graphs.reuse_calls) == (calls[0] + 1,
                                                            calls[1] + (kind == "reuse"))
    assert kinds == ["full", "reuse"] * 4
    assert ops.launch_counts() == {"temporal_rpe_attention": 44, "spatial_attention": 44,
                                   "skip_conv_stats": 80}
    assert ops.spatial_attention.launches_by_route == {"mma": 44, "fma": 0}
    ops.reset_launch_counts()


def test_one_program_per_replica_bitwise_per_block(models):
    rng = np.random.default_rng(30)
    _, kw = window(30)
    window2 = {k: np.concatenate([v, v], axis=0) for k, v in kw.items()}  # B = 2
    window2["x0"] = rng.uniform(-1, 1, window2["x0"].shape).astype(np.float32)
    two = sampler(models, "ancestral", devices=[torch.device("cpu")] * 2)
    got = two.sample_window(**window2, generator=torch.Generator().manual_seed(31))
    assert len(two._programs) == 2
    assert [p.model for p in two._programs.values()] == two.replicas
    assert two.model_calls == 2 * 4
    # The one-device eager window on each block, with that block's rows of
    # every draw of the whole batch.
    gen = torch.Generator().manual_seed(31)
    shape = window2["x0"].shape
    draws = [torch.randn(shape, generator=gen) for _ in range(5)]  # terminal + 4 steps
    one = sampler(models, "ancestral", graphs=False)
    per_block = torch.cat([
        one.sample_window(**{k: v[r] for k, v in window2.items()}, noise=draws[0][r],
                          step_noise=[d[r] for d in draws[1:]])
        for r in (slice(0, 1), slice(1, 2))])
    assert torch.equal(got, per_block)


def test_program_refuses_a_mode_it_does_not_run(models):
    _, kw = window(32)
    args = VideoSampler(models[0], diffusions()[1])._window_args(**kw)[0]
    with pytest.raises(ValueError, match="mode"):
        WindowProgram(models[0], diffusions()[1], args, mode="heun")
    with pytest.raises(RuntimeError, match="CUDA"):
        WindowProgram(models[0], diffusions()[1], args, mode="ancestral").capture("full")
