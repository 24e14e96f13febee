"""The port's parallel package against the JAX package's, remat, and
sampling over several devices of one process (CPU, f32, one torch thread).

- ``best_mesh_shape`` and ``make_eval_mesh``: the same shapes, devices and
  refusals (word for word) as ``lfvdm_tpu.parallel.mesh``, on JAX's 8
  virtual CPU devices (``tests/conftest.py``) and 8 pretended cards.
- ``fsdp_param_placement`` against ``fsdp_param_sharding`` on the tiny
  U-Net's parameter shapes: the same axis, or replicated, for every
  parameter (JAX reads only the shapes; nothing is compiled).
- ``use_checkpoint=True`` with dropout 0.1: loss, gradients and the dropout
  generator's state bitwise equal to the step without it (the recompute
  must draw the forward's masks). The step against JAX's remat step is in
  ``test_torch_training.py``, which holds the compiled JAX step.
- ``VideoSampler(devices=[cpu, cpu])``: a DDIM window equals, bitwise, the
  one-device sampler run on each block of rows with that block's noise, and
  the one-device window of the whole batch to 1e-5 (on the CPU the U-Net's
  output for a row moves in the last digits with the batch size).

The data-parallel train step across two ranks is in
``test_torch_distributed.py``.
"""

import jax
import numpy as np
import pytest
import torch

from lfvdm_tpu.parallel import mesh as j_mesh
from lfvdm_tpu.parallel.sharding import fsdp_param_sharding
from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.models.unet import set_dropout_generator
from lfvdm_tpu_torch.parallel import mesh, sharding
from lfvdm_tpu_torch.sampling.driver import VideoSampler
from lfvdm_tpu_torch.training.train_loop import backward_microbatches

CFG = flagship_config(tiny=True)
B, K = 2, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raised(fn, *args):
    try:
        return fn(*args), None
    except (AssertionError, ValueError) as e:
        return None, str(e)


@pytest.mark.parametrize("n,fsdp", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 3), (1, 1), (8, 3),
                                    (1, 2), (4, 0)])
def test_best_mesh_shape_matches_jax(n, fsdp):
    want, want_err = _raised(j_mesh.best_mesh_shape, n, fsdp)
    if want_err is None:
        assert mesh.best_mesh_shape(n, fsdp) == want
    else:
        with pytest.raises(ValueError) as e:
            mesh.best_mesh_shape(n, fsdp)
        assert str(e.value) == want_err


@pytest.mark.parametrize("dp,batch", [(2, 4), (8, None), (3, 6), (9, None), (2, 3), (4, 6)])
def test_make_eval_mesh_matches_jax(dp, batch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    want, want_err = _raised(j_mesh.make_eval_mesh, dp, batch)
    if want_err is None:
        got = mesh.make_eval_mesh(dp, batch, "cuda")
        assert got == [torch.device("cuda", d.id) for d in want.devices.reshape(-1)]
        assert want.devices.shape == (dp, 1)
    else:
        with pytest.raises(ValueError) as e:
            mesh.make_eval_mesh(dp, batch, "cuda")
        assert str(e.value) == want_err


def test_make_eval_mesh_counts_the_cpu_as_one_device():
    assert mesh.make_eval_mesh(1, 8, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match=r"^--dp_devices 2 > 1 visible devices$"):
        mesh.make_eval_mesh(2, 8, "cpu")


@pytest.mark.parametrize("min_size", [2**10, 2**16])
@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_param_placement_matches_jax(fsdp, min_size):
    model, _ = create_model_and_diffusion(CFG, device="cpu")
    named = dict(model.named_parameters())
    shapes = {n: jax.ShapeDtypeStruct(tuple(p.shape), np.float32) for n, p in named.items()}
    j_specs = fsdp_param_sharding(j_mesh.make_mesh(fsdp=fsdp), shapes, min_size=min_size)
    want = {}
    for n, s in j_specs.items():
        axes = [a for a, name in enumerate(s.spec) if name == j_mesh.FSDP_AXIS]
        want[n] = axes[0] if axes else None
    got = sharding.fsdp_param_placement(named, fsdp, min_size)
    assert got == want
    assert any(a is None for a in got.values()) and any(a is not None for a in got.values())


def test_remat_step_is_bitwise_the_plain_step_with_dropout():
    rng = np.random.default_rng(0)
    C, S = CFG["in_channels"], CFG["image_size"]
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, 0] = 1
    batch = {"x0": torch.tensor(rng.uniform(-1, 1, (B, K, C, S, S)), dtype=torch.float32),
             "frame_indices": torch.tensor(np.tile(np.arange(K), (B, 1))),
             "obs_mask": torch.tensor(obs), "latent_mask": torch.tensor(1 - obs)}
    t, w = torch.tensor([3, 6]), torch.ones(B)
    noise = torch.randn(B, K, C, S, S, generator=torch.Generator().manual_seed(1))
    out = {}
    for remat in (False, True):
        model, diffusion = create_model_and_diffusion(
            dict(CFG, dropout=0.1, use_checkpoint=remat), device="cpu", seed=0)
        _perturb(model)  # a fresh model's zero head would leave every other gradient 0
        gen = torch.Generator().manual_seed(9)
        set_dropout_generator(model, gen)
        model.train()
        loss, _ = backward_microbatches(model, diffusion, batch, t, w, noise=noise)
        out[remat] = (loss, [p.grad for p in model.parameters()], gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(g.abs().max() > 0 for g in g0)


def _perturb(model, seed=3):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))


def test_sampler_over_two_devices_is_the_one_device_sampler_per_block():
    cfg = dict(CFG, timestep_respacing="ddim4")
    model, diffusion = create_model_and_diffusion(cfg, device="cpu", seed=0)
    _perturb(model)
    rng = np.random.default_rng(4)
    C, S = CFG["in_channels"], CFG["image_size"]
    x0 = rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32)
    fi = np.tile(np.arange(K), (B, 1))
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :2] = 1
    window = (x0, fi, obs, 1 - obs)

    one = VideoSampler(model, diffusion, use_ddim=True)
    two = VideoSampler(model, diffusion, use_ddim=True, devices=[torch.device("cpu")] * 2)
    assert len(two.replicas) == 2 and two.replicas[1] is not model
    g_one, g_two = (torch.Generator().manual_seed(5) for _ in range(2))
    got = two.sample_window(*window, generator=g_two)
    want = one.sample_window(*window, generator=g_one)
    assert torch.equal(g_one.get_state(), g_two.get_state())  # the stream goes on as one's
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(5))
    per_block = torch.cat([one.sample_window(*(a[r] for a in window), noise=noise[r])
                           for r in (slice(0, 1), slice(1, 2))])
    assert torch.equal(got, per_block)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert two.model_calls == 2 * 4
