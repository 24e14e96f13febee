"""The served window (``serving.py`` ``ServedWindow``) and the heatmap
sampler's program (``sampling/graphs.py``, mode "attn") on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py

At the tiny config: a loaded artifact's captured window (one CUDA graph of
the exported step, replayed per step) equals its eager loop
(``graphs=False``) bitwise, for DDIM and the ancestral sampler, in f32 and
bf16, with the launch counters counting the kernels the replays execute;
two artifacts of different shapes in one process each replay their own
graph bitwise; a call with other params, or with params changed in place,
gives those params' window; a capture that cannot proceed raises rather
than looping eagerly. The heatmap program's window and eight maps equal the
eager ``p_sample_loop(return_attn_weights=True)``'s bitwise, with only the
skip projections launched (0 + 0 + one per up-path ResBlock per call). The
training loop's vis sample function, called again after the EMA weights
changed in place, replays its memo's graphs on the same replica and equals
a fresh sample function's window (and maps) bitwise.
"""

import types

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch import serving
from lfvdm_tpu_torch.config import create_diffusion, create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.models.unet import fused_skip_blocks
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.sampling.driver import VideoSampler

pytestmark = pytest.mark.cuda

RESPACING = {"ddim": "ddim4", "ancestral": "4"}


@pytest.fixture
def cuda():
    """The card with TF32 off, the settings restored after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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
    arrays = dict(x0=rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32),
                  frame_indices=np.tile(np.arange(K), (B, 1)), obs_mask=obs,
                  latent_mask=1 - obs)
    return [torch.from_numpy(a).cuda() for a in arrays.values()]


def export(cfg, model, diffusion, kind, K=5, B=2):
    blob = serving.export_window_sampler(
        model, diffusion, dict(model.state_dict()), batch_size=B, max_frames=K,
        in_channels=cfg["in_channels"], image_size=cfg["image_size"], use_ddim=kind == "ddim")
    run = serving.load_window_sampler(blob)
    return run, serving.ServedWindow(run.program, run.meta, graphs=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(RESPACING))
def test_captured_served_window_is_the_eager_loop_bitwise(cuda, kind, dtype):
    cfg, model, diffusion = tiny(RESPACING[kind], dtype)
    run, eager = export(cfg, model, diffusion, kind)
    params, win = dict(model.state_dict()), window(cfg)
    ops.reset_launch_counts()
    want = eager(params, *win, 3)
    torch.cuda.synchronize()
    eager_counts = ops.launch_counts()
    assert eager_counts["skip_conv_stats"] > 0
    for i in range(3):  # the capture, then replays alone
        ops.reset_launch_counts()
        got = run(params, *win, 3)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert ops.launch_counts() == eager_counts
    assert run.graph is not None and run.capture_s > 0
    assert not torch.equal(run(params, *win, 4), want)  # the seed reaches the noise


def test_two_artifacts_of_two_shapes_replay_their_own_graphs(cuda):
    cfg, model, diffusion = tiny(RESPACING["ddim"])
    params = dict(model.state_dict())
    (a, a_eager), (b, b_eager) = (export(cfg, model, diffusion, "ddim", K=K) for K in (5, 3))
    wa, wb = window(cfg, K=5, seed=1), window(cfg, K=3, seed=2)
    want_a, want_b = a_eager(params, *wa, 5), b_eager(params, *wb, 6)
    for run, win, seed, want in [(a, wa, 5, want_a), (b, wb, 6, want_b)] * 2 + [(a, wa, 5, want_a)]:
        assert torch.equal(run(params, *win, seed), want)
    assert a.graph is not b.graph


def test_params_swapped_or_changed_in_place_give_their_window(cuda):
    cfg, model, diffusion = tiny(RESPACING["ancestral"])
    run, eager = export(cfg, model, diffusion, "ancestral")
    win = window(cfg, seed=3)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    other = {k: v * 1.01 if v.is_floating_point() else v for k, v in params.items()}
    first = run(params, *win, 8)
    assert torch.equal(first, eager(params, *win, 8))
    got = run(other, *win, 8)
    assert torch.equal(got, eager(other, *win, 8)) and not torch.equal(got, first)
    for v in params.values():
        if v.is_floating_point():
            v.mul_(0.99)
    got = run(params, *win, 8)
    assert torch.equal(got, eager(params, *win, 8)) and not torch.equal(got, first)


def test_a_capture_that_cannot_proceed_raises(cuda):
    cfg, model, diffusion = tiny(RESPACING["ddim"])
    run, _ = export(cfg, model, diffusion, "ddim")
    real = run.step

    def syncing_step(*args):
        out = real(*args)
        out.sum().item()  # a host sync: stream capture refuses it
        return out

    run.step = syncing_step
    with pytest.raises(RuntimeError):
        run(dict(model.state_dict()), *window(cfg, seed=4), 0)
    assert run.graph is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heatmap_program_is_the_eager_loop_bitwise(cuda, dtype):
    cfg, model, diffusion = tiny("5", dtype)
    x0, fi, obs, lat = window(cfg, seed=5)
    eager, graphs = VideoSampler(model, diffusion, graphs=False), VideoSampler(model, diffusion)
    want = eager.sample_window_attn(x0, fi, obs, lat,
                                    generator=torch.Generator(device="cuda").manual_seed(9))
    per_call = {"temporal_rpe_attention": 0, "spatial_attention": 0,
                "skip_conv_stats": fused_skip_blocks(model)}
    for i in range(3):  # the capture, then replays alone
        ops.reset_launch_counts()
        graphs.model_calls = 0
        img, maps = graphs.sample_window_attn(
            x0, fi, obs, lat, generator=torch.Generator(device="cuda").manual_seed(9))
        torch.cuda.synchronize()
        calls = graphs.model_calls
        assert calls == diffusion.num_timesteps
        assert ops.launch_counts() == {k: n * calls for k, n in per_call.items()}, i
        assert torch.equal(img, want[0]), i
        assert list(maps) == list(want[1])
        for tag, ref in want[1].items():
            assert torch.equal(maps[tag], ref), (i, tag)
    (program,) = graphs._programs.values()
    assert program.mode == "attn" and set(program.graphs) == {"full"}


@pytest.mark.parametrize("log_attn", [False, True])
def test_vis_memo_replays_with_the_changed_ema(cuda, tmp_path, monkeypatch, log_attn):
    """The vis sample function keeps one replica and sampler per EMA rate.
    After the EMA changes in place, its second call reloads the replica's
    own parameters, replays the graphs its first call captured, and gives
    a fresh sample function's window (and the 8 maps with ``log_attn``)
    bitwise; the window differs from the first call's."""
    from lfvdm_tpu_torch.training.vis_sampling import make_sample_fn
    from test_torch_placement import CFG, K, data, make_loop

    outs = []
    for name in ("sample_window", "sample_window_attn"):
        real = getattr(VideoSampler, name)

        def spy(self, *args, _real=real, **kw):
            out = _real(self, *args, **kw)
            outs.append(out)
            return out

        monkeypatch.setattr(VideoSampler, name, spy)
    loop = make_loop(tmp_path, "cuda")
    loop.run_step()
    diffusion = create_diffusion(dict(CFG, timestep_respacing="4"))

    def view():
        return types.SimpleNamespace(
            model=loop.model, diffusion=diffusion, state=loop.state, max_frames=K, codec=None,
            device=loop.device, step=0, ema_params=loop.ema_params,
            sampling_model=loop.sampling_model)

    vis = next(data(5))  # (B, 10, C, H, W): more frames than the window's K
    fn = make_sample_fn(vis, seed=0, log_attn=log_attn)
    first = fn(view())
    ((rate, sampler),) = fn.samplers.items()
    (program,) = sampler._programs.values()
    graphs = dict(program.graphs)
    ptrs = [p.data_ptr() for p in sampler.model.parameters()]
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the zero-initialised head too, so the window moves
        for p in loop.state.ema[rate].values():
            if p.is_floating_point():
                p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device))
    second = fn(view())
    assert list(sampler._programs.values()) == [program] and program.graphs == graphs
    assert [p.data_ptr() for p in sampler.model.parameters()] == ptrs
    fresh = make_sample_fn(vis, seed=0, log_attn=log_attn)(view())
    np.testing.assert_array_equal(second, fresh)
    assert len(outs) == 3
    (w1, w2, w3) = (o[0] if log_attn else o for o in outs)
    assert torch.equal(w2, w3) and not torch.equal(w2, w1)
    if log_attn:
        assert list(outs[1][1]) == list(outs[2][1]) and len(outs[1][1]) == 8
        for tag, ref in outs[2][1].items():
            assert torch.equal(outs[1][1][tag], ref), tag
    assert not np.array_equal(second, first)
