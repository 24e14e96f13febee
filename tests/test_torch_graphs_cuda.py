"""The captured window programs (``sampling/graphs.py``) on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

At the tiny config (f32 and bf16): a captured window equals the eager
loop's (``graphs=False``) bitwise for every sampler; the orderings of
shapes A, B, A and of full, reuse, reuse, full calls replay bitwise on
graphs sharing one memory pool; the launch counters count the kernels the
replays execute; and a capture that cannot proceed raises rather than
returning an eager result.
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.sampling.driver import VideoSampler

pytestmark = pytest.mark.cuda

SAMPLERS = {
    "ancestral": ("4", {}),
    "ddim": ("ddim4", dict(use_ddim=True)),
    "ddim_eta": ("ddim4", dict(use_ddim=True, eta=0.5)),
    "dpm": ("dpm4", dict(use_dpm=True)),
    "reuse": ("8", dict(encoder_reuse=2)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tiny(respacing, compute_dtype="float32"):
    cfg = dict(flagship_config(tiny=True), timestep_respacing=respacing,
               compute_dtype=compute_dtype)
    model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    return cfg, model, diffusion


def window(cfg, K=5, B=2, seed=0):
    rng = np.random.default_rng(seed)
    C, S = cfg["in_channels"], cfg["image_size"]
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :2] = 1
    return dict(x0=rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32),
                frame_indices=np.tile(np.arange(K), (B, 1)), obs_mask=obs,
                latent_mask=1 - obs)


def run(sampler, kw, seed=1):
    return sampler.sample_window(**kw, generator=torch.Generator(device="cuda").manual_seed(seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_captured_window_is_the_eager_window_bitwise(cuda, name, dtype):
    respacing, opts = SAMPLERS[name]
    cfg, model, diffusion = tiny(respacing, dtype)
    kw = window(cfg)
    eager = VideoSampler(model, diffusion, graphs=False, **opts)
    graphs = VideoSampler(model, diffusion, **opts)
    ops.reset_launch_counts()
    want = run(eager, kw)
    eager_counts = ops.launch_counts()
    ops.reset_launch_counts()
    got = run(graphs, kw)
    torch.cuda.synchronize()
    assert ops.launch_counts() == eager_counts and eager_counts["skip_conv_stats"] > 0
    (program,) = graphs._programs.values()
    assert set(program.graphs) == ({"full", "reuse"} if name == "reuse" else {"full"})
    assert torch.equal(got, want)
    assert (graphs.model_calls, graphs.reuse_calls) == (eager.model_calls, eager.reuse_calls)
    for _ in range(2):  # replayed again, from the start
        assert torch.equal(run(graphs, kw), want)


def test_shapes_a_b_a_share_a_pool_bitwise(cuda):
    cfg, model, diffusion = tiny("ddim4")
    a, b = window(cfg, K=5, seed=2), window(cfg, K=3, seed=3)
    eager = VideoSampler(model, diffusion, use_ddim=True, graphs=False)
    graphs = VideoSampler(model, diffusion, use_ddim=True)
    want_a, want_b = run(eager, a), run(eager, b)
    outs = [run(graphs, w) for w in (a, b, a, b, a)]
    assert len(graphs._programs) == 2 and len(graphs._pools) == 1
    for out, want in zip(outs, (want_a, want_b) * 3):
        assert torch.equal(out, want)


def test_full_reuse_reuse_full_bitwise(cuda):
    cfg, model, diffusion = tiny("7")
    kw = window(cfg, seed=4)
    eager = VideoSampler(model, diffusion, encoder_reuse=3, graphs=False)
    graphs = VideoSampler(model, diffusion, encoder_reuse=3)
    want = run(eager, kw)  # steps: full, reuse, reuse, full, reuse, reuse, full
    assert (eager.model_calls, eager.reuse_calls) == (7, 4)
    for _ in range(3):
        assert torch.equal(run(graphs, kw), want)


def test_a_capture_that_cannot_proceed_raises(cuda):
    cfg, model, diffusion = tiny("ddim4")
    kw = window(cfg, seed=5)
    graphs = VideoSampler(model, diffusion, use_ddim=True)
    real = model.forward

    def syncing_forward(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0].sum().item()  # a host sync: stream capture refuses it
        return out

    model.forward = syncing_forward
    with pytest.raises(RuntimeError):
        run(graphs, kw)


@pytest.mark.parametrize("name", ["ancestral", "dpm", "reuse"])
def test_replicas_on_two_cards_each_capture_their_own_step(cuda, name):
    """A replica on a second card captures on a stream of its own card:
    captured over two cards equals the eager two-card window bitwise, and
    each card's program holds a graph that advances its rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    respacing, opts = SAMPLERS[name]
    cfg, model, diffusion = tiny(respacing)
    kw = window(cfg, B=4, seed=6)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eager = VideoSampler(model, diffusion, devices=devices, graphs=False, **opts)
    graphs = VideoSampler(model, diffusion, devices=devices, **opts)
    want = run(eager, kw)
    for _ in range(2):  # the captures, then replays alone
        assert torch.equal(run(graphs, kw), want)
    programs = list(graphs._programs.values())
    assert [p.device for p in programs] == devices
    assert all(p.graphs for p in programs)
