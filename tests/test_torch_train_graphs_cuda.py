"""The captured train step (``training/graphs.py`` ``TrainProgram``) on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graphs_cuda.py

From one state and one set of draws, a program's captured steps equal the
eager ``train_step``'s bitwise (losses, gradient norms, parameters, Adam
moments and counts, every EMA copy): over several flagship steps (128 px,
B=2, K=20, bf16), and at the tiny config with two microbatches, with
``use_checkpoint``, and with dropout > 0. A non-finite step inside a replay
leaves the state's bits alone; a load between replays is what the next
replay reads; the launch counters count the kernels the replays execute; a
capture that cannot proceed raises rather than stepping eagerly.
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.models.unet import set_dropout_generator
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.training import graphs
from lfvdm_tpu_torch.training.graphs import TrainProgram
from lfvdm_tpu_torch.training.masks import sample_training_batch
from lfvdm_tpu_torch.training.train_loop import (
    draw_noise, init_train_state, make_optimizer, train_step)

pytestmark = pytest.mark.cuda

RATES = ("0.9999", "0.99")
PER_FORWARD = {"temporal_rpe_attention": 7, "spatial_attention": 7, "skip_conv_stats": 10}


@pytest.fixture
def cuda():
    """The card, TF32 off, and cuDNN's deterministic algorithms: with the
    heuristics' own choice the tiny f32 step is not reproducible even eager
    against eager (276 of its 432 gradients differed in some bit on an H100,
    torch 2.11, cuDNN 9.2), so no bitwise comparison could hold. The
    flagship's bf16 step is reproducible either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def make_state(cfg, anneal=0, dropout_seed=3):
    """A seeded model (every weight perturbed, so the zero layers carry
    signal), AdamW with weight decay and two EMA rates; its dropout draws
    from a generator seeded with ``dropout_seed``."""
    model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((0.01 * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(dropout_seed))
    optimizer, schedule = make_optimizer(model.parameters(), 1e-4, 0.1, lr_anneal_steps=anneal)
    return init_train_state(model, optimizer, schedule, RATES), diffusion


def step_inputs(cfg, B, K, seed):
    rng = np.random.default_rng(seed)
    C, S = cfg["in_channels"], cfg["image_size"]
    video = rng.uniform(-1, 1, (B, 3 * K, C, S, S)).astype(np.float32)
    x0, fi, obs, lat = sample_training_batch(rng, video, K, batch2=video[::-1])
    batch = {"x0": torch.tensor(x0, device="cuda"),
             "frame_indices": torch.tensor(fi, dtype=torch.int64, device="cuda"),
             "obs_mask": torch.tensor(obs, device="cuda"),
             "latent_mask": torch.tensor(lat, device="cuda")}
    t = torch.tensor(rng.integers(0, cfg["diffusion_steps"], B), device="cuda")
    w = torch.tensor(rng.uniform(0.5, 1.5, B).astype(np.float32), device="cuda")
    return batch, t, w


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_states_bitwise(a, b):
    """Two states' parameters, moments, counts and EMA copies, bit for bit."""
    assert int(a.optimizer.count) == int(b.optimizer.count) and a.step == b.step
    if a.scheduler is not None:
        assert int(a.scheduler.count) == int(b.scheduler.count)
    for (n, p), (_, q) in zip(a.named_params(), b.named_params()):
        assert torch.equal(bits(p.detach()), bits(q.detach())), n
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(bits(a.optimizer.state[p][key]), bits(b.optimizer.state[q][key])), \
                (key, n)
        for r in RATES:
            assert torch.equal(bits(a.ema[r][n]), bits(b.ema[r][n])), (r, n)


def assert_metrics_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def captured_against_eager(cfg, B, K, steps, n_microbatches=1, anneal=0):
    """``steps`` steps through a program and through ``train_step`` from one
    state and one set of draws, held bitwise after each; returns the
    program, the launch counts of its replays and its state."""
    eager, diffusion = make_state(cfg, anneal)
    captured, _ = make_state(cfg, anneal)
    noise_gen = torch.Generator(device="cuda").manual_seed(11)
    program, counts = None, {}
    for i in range(steps):
        batch, t, w = step_inputs(cfg, B, K, seed=20 + i)
        noise = draw_noise(noise_gen, batch["x0"], n_microbatches)
        ops.reset_launch_counts()
        want = train_step(eager, batch, t, w, diffusion=diffusion, noise=noise,
                          n_microbatches=n_microbatches)
        eager_counts = ops.launch_counts()
        if program is None:
            program = TrainProgram(captured, diffusion, batch, n_microbatches=n_microbatches)
        ops.reset_launch_counts()
        got = program.run(batch, t, w, noise)
        torch.cuda.synchronize()
        if i > 0:  # a replay counts the kernels an eager step launches
            counts = ops.launch_counts()
            assert counts == eager_counts and all(counts.values())
        assert_metrics_bitwise(got, want)
        assert_states_bitwise(captured, eager)
    assert program.graph is not None
    return program, counts, captured, diffusion


def test_flagship_captured_steps_are_the_eager_steps_bitwise(cuda):
    cfg = flagship_config()
    program, counts, _, _ = captured_against_eager(cfg, B=2, K=20, steps=3, anneal=4)
    assert counts == PER_FORWARD  # a replay's launches: one forward's kernels
    assert program.capture_s > 0


def test_two_microbatches_and_remat_are_bitwise(cuda):
    cfg = flagship_config(tiny=True)
    _, one, _, _ = captured_against_eager(cfg, B=2, K=5, steps=2)
    _, two, _, _ = captured_against_eager(cfg, B=2, K=5, steps=3, n_microbatches=2)
    assert two == {k: 2 * n for k, n in one.items()}
    remat = dict(cfg, use_checkpoint=True)
    _, counts, _, _ = captured_against_eager(remat, B=2, K=5, steps=3)
    assert counts == {k: 2 * n for k, n in one.items()}  # forward and recompute


def test_dropout_is_bitwise_and_refused_under_remat(cuda):
    """dropout > 0: the masks come from the model's generator, registered
    with the graph, so each replay draws the eager step's masks; under
    use_checkpoint (dropout 0.1) each rematerialised block's recompute draws
    its forward's masks from a registered copy of the generator's state, so
    the captured steps are the eager ones bitwise there too (the name is the
    test's from when the capture refused that model)."""
    cfg = dict(flagship_config(tiny=True), dropout=0.3)
    captured_against_eager(cfg, B=2, K=5, steps=3)
    remat = dict(cfg, dropout=0.1, use_checkpoint=True)
    program, counts, _, _ = captured_against_eager(remat, B=2, K=5, steps=3)
    assert program.streams.calls  # the rematerialised draws the replays repeat
    _, plain, _, _ = captured_against_eager(dict(cfg, dropout=0.1), B=2, K=5, steps=2)
    assert counts == {k: 2 * n for k, n in plain.items()}  # forward and recompute


def snapshot(state):
    return [t.clone() for t in [p.detach() for _, p in state.named_params()]
            + [x for st in state.optimizer.state.values() for x in st.values()]
            + [x for copy in state.ema.values() for x in copy.values()]
            + [state.optimizer.count]]


def test_nonfinite_replay_and_load_between_replays(cuda):
    """A NaN batch replayed leaves every bit of the state (counts included)
    as it was, with skipped_nonfinite 1 and no host sync in the replay;
    after ``load_state_dict`` of another state, and gradients dropped
    (``zero_grad``, as an eager step on the state does), the next replay
    steps from the loaded state as the eager step does, and ``.grad`` is
    the graph's gradients again."""
    cfg = dict(flagship_config(tiny=True))
    program, _, state, diffusion = captured_against_eager(cfg, B=2, K=5, steps=2, anneal=6)
    batch, t, w = step_inputs(cfg, 2, 5, seed=40)
    batch["x0"][0, 0, 0, 0, 0] = float("nan")
    noise = torch.randn(batch["x0"].shape, device="cuda")
    before = snapshot(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = program.run(batch, t, w, noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m["skipped_nonfinite"].item() == 1.0 and not torch.isfinite(m["grad_norm"])
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(before, snapshot(state)))

    other, _ = make_state(cfg, anneal=6)
    batch, t, w = step_inputs(cfg, 2, 5, seed=41)
    train_step(other, batch, t, w, diffusion=diffusion, noise=noise)
    state.load_state_dict(other.state_dict())
    state.optimizer.zero_grad()
    batch, t, w = step_inputs(cfg, 2, 5, seed=42)
    want = train_step(other, batch, t, w, diffusion=diffusion, noise=noise)
    got = program.run(batch, t, w, noise)
    assert_metrics_bitwise(got, want)
    assert_states_bitwise(state, other)
    assert all(p.grad is g for p, g in zip(program.params, program.grads))


def test_a_capture_that_cannot_proceed_raises(cuda, monkeypatch):
    cfg = flagship_config(tiny=True)
    state, diffusion = make_state(cfg)
    batch, t, w = step_inputs(cfg, 2, 5, seed=50)
    real = graphs.step_body

    def syncing_body(*args, **kwargs):
        out = real(*args, **kwargs)
        out["loss"].sum().item()  # a host sync: stream capture refuses it
        return out

    monkeypatch.setattr(graphs, "step_body", syncing_body)
    program = TrainProgram(state, diffusion, batch)
    with pytest.raises(RuntimeError):
        program.run(batch, t, w, torch.randn(batch["x0"].shape, device="cuda"))
    assert program.graph is None
