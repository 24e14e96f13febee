"""The captured train step's body against JAX's jitted train step (CPU).

``TrainProgram`` (lfvdm_tpu_torch/training/graphs.py) captures one whole
optimizer step as a CUDA graph on the card; on the CPU it runs the same
``step_body`` eagerly on its static buffers, and that is what these tests
hold against ``jax.jit(make_train_step(...))`` (lfvdm_tpu/training/
train_loop.py), compiled once in the module fixture, on the same seeded
weights, batches, timesteps and importance weights, with the noise JAX draws
from each step's key injected into the port. The tiny flagship config in
f32, AdamW with weight decay, the LR annealed linearly to 0 over 3 updates,
two EMA rates.

Tolerances: the loss terms and the gradient norm rtol 1e-5 (as
test_torch_training.py); the Adam moments and the EMA copies rtol 1e-5 with
an atol of 1e-5 times the largest |leaf| (the tolerance of
``test_update_matches_optax_and_the_ema_formula``); the parameters the same,
plus LR·(1 + WD·|p|) on an element for each update whose JAX gradient
there was within 1e-7 of zero (ten times Adam's eps, read off JAX's first
moments). There Adam's normalised step g / (|g| + eps) turns last-digit
gradient differences into up to a whole step in either package; in the tiny
config these are mostly biases in front of one-channel GroupNorm groups,
whose true gradient is 0. The non-finite step is compared bitwise.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.training.train_loop import init_train_state as j_init_train_state
from lfvdm_tpu.training.train_loop import make_optimizer as j_make_optimizer
from lfvdm_tpu.training.train_loop import make_train_step
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.models.unet import set_dropout_generator
from lfvdm_tpu_torch.training.graphs import TrainProgram
from lfvdm_tpu_torch.training.train_loop import (
    TrainLoop, init_train_state, make_optimizer, train_step)
from lfvdm_tpu_torch.utils.convert import train_state_from_jax
from test_torch_training import (
    ARCH, B, CFG, LR, RATES, WD, _data, flat, jax_params, make_batch, port_batch, tensor)

ANNEAL = 3  # updates over which the LR falls linearly to 0
STEPS = 4  # the chain: three annealed updates, then one at LR 0
LOSS_RTOL = 1e-5
TOL = 1e-5  # rtol, and atol relative to the largest |leaf|
FLAT_G = 1e-7  # |gradient| under which Adam's step is eps-sensitive (ten times eps)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jax_noise(key, shape):
    """The noise JAX's step draws from ``key`` (make_micro_loss: split, then
    training_losses' normal draw)."""
    return np.asarray(jax.random.normal(jax.random.split(key)[0], shape, dtype=np.float32))


def nan_batch(batch):
    bad = {k: np.array(v) for k, v in batch.items()}
    bad["x0"][0, 0, 0, 0, 0] = np.nan
    return bad


@pytest.fixture(scope="module")
def ref():
    """JAX: a chain of STEPS jitted steps from the same weights (states and
    metrics after each), a non-finite step from the first state, and the
    first step with doubled weights (the two-microbatch reference)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LFVDM_PALLAS_SKIPCONV", "xla")
        jmodel, jdiff = j_create(dict(CFG))
        tx = j_make_optimizer(LR, WD, lr_anneal_steps=ANNEAL)
        rates = [float(r) for r in RATES]
        step = jax.jit(make_train_step(jmodel, jdiff, tx, rates))
        params = jax_params()
        state = j_init_train_state(params, tx, rates)
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        inputs, states, metrics = [], [to_np(state)], []
        for i in range(STEPS):
            batch, t, w, _ = make_batch(i)
            key = jax.random.PRNGKey(10 + i)
            inputs.append((batch, t, w, jax_noise(key, batch["x0"].shape)))
            state, m = step(state, batch, t, w, key)
            states.append(to_np(state))
            metrics.append(to_np(m))
        batch, t, w, noise = inputs[1]
        nan_state, nan_metrics = step(states[1], nan_batch(batch), t, w, jax.random.PRNGKey(11))
        batch, t, w, noise = inputs[0]
        two_state, two_metrics = step(states[0], batch, t, 2 * w, jax.random.PRNGKey(10))
    return dict(params=to_np(params), inputs=inputs, states=states, metrics=metrics,
                nan_state=to_np(nan_state), nan_metrics=to_np(nan_metrics),
                two_state=to_np(two_state), two_metrics=to_np(two_metrics))


def port_state(params_tree, **config):
    model, diffusion = t_create(dict(CFG, **config), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat(params_tree).items()})
    optimizer, schedule = make_optimizer(model.parameters(), LR, WD, lr_anneal_steps=ANNEAL)
    return init_train_state(model, optimizer, schedule, RATES), diffusion


def step_args(inputs, batch=None):
    b, t, w, noise = inputs
    return (port_batch(b if batch is None else batch), tensor(t, torch.int64), tensor(w),
            torch.from_numpy(noise))


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Inside, reading a tensor's value on the host raises (``bool``,
    ``item``, ``float``, ``int``, ``tolist``, ``numpy``): the reads that
    synchronise the host with the card."""
    names = ("__bool__", "item", "__float__", "__int__", "__index__", "tolist", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise HostRead(f"Tensor.{name} read a value on the host")
        return read

    for n in names:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.fixture(scope="module")
def chain(ref):
    """The port: one TrainProgram over ref's chain, with the non-finite step
    (under ``no_host_reads``) after the first; state dicts and metrics
    after each step."""
    state, diffusion = port_state(ref["params"])
    first = step_args(ref["inputs"][0])
    program = TrainProgram(state, diffusion, first[0])
    out = {"states": [clone(state.state_dict())], "metrics": []}
    for i, inputs in enumerate(ref["inputs"]):
        out["metrics"].append(program.run(*step_args(inputs)))
        out["states"].append(clone(state.state_dict()))
        if i == 0:
            with no_host_reads():
                nan = ref["inputs"][1]
                out["nan_metrics"] = program.run(*step_args(nan, nan_batch(nan[0])))
            out["after_nan"] = clone(state.state_dict())
    return out


def assert_close(got, want, rtol=TOL, atol_rel=TOL, err=""):
    scale = max(v.abs().max().item() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol,
                                   atol=atol_rel * scale, err_msg=f"{err}{k}")


def assert_state_matches(got, jax_states, lr=LR, wd=WD, ema_flat_steps=False):
    """The port's state_dict against the last of ``jax_states`` (JAX's
    states from the one both started from, one per update, at learning rate
    ``lr`` and weight decay ``wd``): the counts exactly, moments and every
    EMA copy within TOL, the parameters within TOL plus, on each element,
    lr·(1 + wd·|p|) for every update whose JAX gradient there was under
    FLAT_G (module docstring). With ``ema_flat_steps`` an EMA copy at rate
    r, which takes 1 - r of the parameters at each update, is allowed
    (1 - r^updates) of the parameters' allowance beside TOL (a rate of 0.9
    carries a tenth of a flat step)."""
    states = [train_state_from_jax(s, **ARCH) for s in jax_states]
    want, updates = states[-1], states[-1]["adam"]["count"]
    assert got["adam"]["count"] == updates and got["schedule_count"] == want["schedule_count"]
    for key in ("exp_avg", "exp_avg_sq"):
        assert_close(got["adam"][key], want["adam"][key], err=f"{key} ")
    params, scale = want["params"], max(v.abs().max().item() for v in want["params"].values())
    flat_allowance = {}
    for k in params:
        g, w = got["params"][k], params[k]
        flat_steps = sum(
            ((b["adam"]["exp_avg"][k] - 0.9 * a["adam"]["exp_avg"][k]) / 0.1).abs() < FLAT_G
            for a, b in zip(states, states[1:]))
        flat_allowance[k] = flat_steps * lr * (1 + wd * w.abs())
        tol = TOL * scale + TOL * w.abs() + flat_allowance[k]
        bad = (g - w).abs() > tol
        assert not bad.any(), (k, (g - w).abs().max().item())
    assert set(got["ema"]) == set(want["ema"])
    for r in want["ema"]:
        if not ema_flat_steps:
            assert_close(got["ema"][r], want["ema"][r], err=f"ema {r} ")
            continue
        copy = want["ema"][r]
        ema_scale = max(v.abs().max().item() for v in copy.values())
        share = 1 - float(r) ** updates
        for k, w in copy.items():
            tol = TOL * ema_scale + TOL * w.abs() + share * flat_allowance[k]
            bad = (got["ema"][r][k] - w).abs() > tol
            assert not bad.any(), (r, k, (got["ema"][r][k] - w).abs().max().item())


def assert_metrics_match(got, want):
    np.testing.assert_allclose(got["weighted_loss"].numpy(), want["weighted_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].numpy(), want["grad_norm"], rtol=LOSS_RTOL)
    for k in ("loss", "mse", "eval-mse"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert got["skipped_nonfinite"].item() == want["skipped_nonfinite"] == 0.0


def test_one_finite_step_matches_jax(ref, chain):
    """(a) loss, terms, gradient norm, parameters, moments, EMA and counts."""
    assert_metrics_match(chain["metrics"][0], ref["metrics"][0])
    got = chain["states"][1]
    assert got["step"] == 1
    assert_state_matches(got, ref["states"][:2])
    moved = max((got["params"][k] - v).abs().max().item()
                for k, v in chain["states"][0]["params"].items())
    assert moved > 5e-5  # the update is visible above the tolerance


def test_nonfinite_step_keeps_the_state_bitwise_without_host_reads(ref, chain):
    """(b) a batch holding a NaN: params, moments, counts and every EMA keep
    their bits, skipped_nonfinite is 1, and the step read no value back to
    the host (the fixture ran it under ``no_host_reads``); JAX skips too."""
    m = chain["nan_metrics"]
    assert m["skipped_nonfinite"].item() == 1.0 == ref["nan_metrics"]["skipped_nonfinite"]
    assert not np.isfinite(m["grad_norm"].item()) and not np.isfinite(
        ref["nan_metrics"]["grad_norm"])
    before, after = chain["states"][1], chain["after_nan"]
    assert after["step"] == before["step"] + 1
    assert after["adam"]["count"] == before["adam"]["count"] == 1
    assert after["schedule_count"] == before["schedule_count"] == 1
    trees = [(after["params"], before["params"]),
             (after["adam"]["exp_avg"], before["adam"]["exp_avg"]),
             (after["adam"]["exp_avg_sq"], before["adam"]["exp_avg_sq"])]
    trees += [(after["ema"][r], before["ema"][r]) for r in RATES]
    for got, want in trees:
        for k in want:
            assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k
    jax_before, jax_after = ref["states"][1], ref["nan_state"]
    for a, b in zip(jax.tree.leaves(jax_after["params"]), jax.tree.leaves(jax_before["params"])):
        np.testing.assert_array_equal(a, b)


def test_two_microbatches_match_jax(ref):
    """(c) B = 2 in two microbatches of one row: each chunk's gradient of its
    own mean loss, summed. The U-Net never mixes rows, so this is JAX's
    one-chunk step with the importance weights doubled (B / chunk rows), on
    the same noise; the port draws it per chunk, here injected whole."""
    state, diffusion = port_state(ref["params"])
    args = step_args(ref["inputs"][0])
    program = TrainProgram(state, diffusion, args[0], n_microbatches=2)
    m = program.run(*args)
    assert_metrics_match(m, ref["two_metrics"])
    assert_state_matches(state.state_dict(), [ref["states"][0], ref["two_state"]])


def test_linear_lr_anneal_over_steps_matches_optax(ref, chain):
    """(d) three annealed updates (LR, 2/3 LR, 1/3 LR) and one at LR 0, the
    schedule read on the device at the updates made so far, as optax's."""
    for i in range(STEPS):
        assert_metrics_match(chain["metrics"][i], ref["metrics"][i])
        assert_state_matches(chain["states"][i + 1], ref["states"][:i + 2])
    last, before = chain["states"][STEPS], chain["states"][STEPS - 1]
    # At LR 0 nothing moves but the moments and the EMA copies.
    for k, v in before["params"].items():
        assert torch.equal(last["params"][k], v), k
    assert not all(torch.equal(last["adam"]["exp_avg"][k], v)
                   for k, v in before["adam"]["exp_avg"].items())


def state_tensors(state):
    out = [p for _, p in state.named_params()]
    out += [t for st in state.optimizer.state.values() for t in st.values()]
    out += [t for copy in state.ema.values() for t in copy.values()]
    return out + [state.optimizer.count, state.scheduler.count]


def test_program_runs_on_a_loaded_state(ref):
    """(e) a step, then ``load_state_dict`` of JAX's state after two steps:
    every tensor of the state keeps its storage (a captured graph reads
    those), and the program's next step is JAX's third."""
    state, diffusion = port_state(ref["params"])
    args = step_args(ref["inputs"][0])
    program = TrainProgram(state, diffusion, args[0])
    program.run(*args)
    held = [(t, t.data_ptr()) for t in state_tensors(state)]
    state.load_state_dict(train_state_from_jax(ref["states"][2], **ARCH))
    assert state.step == 2 and int(state.optimizer.count) == int(state.scheduler.count) == 2
    assert all(t is u and t.data_ptr() == ptr for (t, ptr), u in zip(held, state_tensors(state)))
    m = program.run(*step_args(ref["inputs"][2]))
    assert_metrics_match(m, ref["metrics"][2])
    assert_state_matches(state.state_dict(), ref["states"][2:4])


def _loop(tmp_path, monkeypatch=None):
    model, diffusion = t_create(CFG, device="cpu", seed=1)
    loop = TrainLoop(model=model, diffusion=diffusion, data=_data(), batch_size=B, max_frames=4,
                     lr=1e-3, ema_rate="0.9999,0.99", log_interval=3, save_interval=0,
                     checkpoint_dir=str(tmp_path))
    if monkeypatch is not None:  # step as the card does: through a TrainProgram
        monkeypatch.setattr(TrainLoop, "step_kind", property(lambda self: "captured"))
    return loop


def test_loop_keeps_each_steps_metrics(tmp_path, monkeypatch):
    """(f) the loop holds each step's metrics until the log interval: through
    a program (whose outputs every step overwrites) they stay distinct, and
    equal the eager loop's bitwise."""
    eager = _loop(tmp_path / "eager")
    assert eager.step_kind == "eager"
    want = [eager.run_step() for _ in range(2)]
    loop = _loop(tmp_path / "captured", monkeypatch)
    got = [loop.run_step() for _ in range(2)]
    (program,) = loop._programs.values()
    assert len(loop._pending) == 2 and all(p[3] is m for p, m in zip(loop._pending, got))
    assert not torch.equal(got[0]["loss"], got[1]["loss"])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
            assert g[k].data_ptr() != program.outputs[k].data_ptr()
    assert loop.state.step == 2 and int(loop.state.optimizer.count) == 2
    for (n, p), (_, q) in zip(loop.state.named_params(), eager.state.named_params()):
        assert torch.equal(p, q), n


def test_eager_step_and_program_agree_bitwise(ref):
    """The eager ``train_step`` and a program's step run one body: from one
    state and one set of draws they leave the same bits."""
    a, diffusion = port_state(ref["params"])
    b, _ = port_state(ref["params"])
    args = step_args(ref["inputs"][0])
    m_eager = train_step(a, *args[:3], diffusion=diffusion, noise=args[3])
    m_prog = TrainProgram(b, diffusion, args[0]).run(*args)
    for k in m_eager:
        assert torch.equal(m_eager[k], m_prog[k]), k
    sa, sb = a.state_dict(), b.state_dict()
    for key in ("params",):
        for k in sa[key]:
            assert torch.equal(sa[key][k], sb[key][k]), k
    assert sa["adam"]["count"] == sb["adam"]["count"] == 1 and sa["step"] == sb["step"] == 1


class NoState:
    """A stand-in dropout generator that refuses to be read or set."""

    def get_state(self):
        raise AssertionError("the generator's state was read")

    def set_state(self, state):
        raise AssertionError("the generator's state was set")


def test_remat_at_zero_dropout_keeps_no_rng_state(ref):
    """``use_checkpoint`` with dropout 0 (the flagship's and the latent
    config's): the rematerialised blocks read and set no generator state,
    which a CUDA graph could not replay, and the step is the plain one."""
    plain, diffusion = port_state(ref["params"])
    remat, _ = port_state(ref["params"], use_checkpoint=True)
    set_dropout_generator(remat.model, NoState())
    args = step_args(ref["inputs"][0])
    want = TrainProgram(plain, diffusion, args[0]).run(*args)
    got = TrainProgram(remat, diffusion, args[0]).run(*args)
    np.testing.assert_allclose(got["weighted_loss"].numpy(), want["weighted_loss"].numpy(),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].numpy(), want["grad_norm"].numpy(),
                               rtol=LOSS_RTOL)


def test_warm_start_loads_into_the_models_own_tensors(tmp_path):
    """``TrainLoop(init_params=)`` copies into the parameters in place, so
    nothing a step (or a captured graph) holds is left stale."""
    model, diffusion = t_create(CFG, device="cpu", seed=2)
    held = [(p, p.data_ptr()) for p in model.parameters()]
    sd = {k: v.clone() + 1.0 for k, v in model.state_dict().items()}
    loop = TrainLoop(model=model, diffusion=diffusion, data=_data(), batch_size=B, max_frames=4,
                     lr=1e-3, checkpoint_dir=str(tmp_path), init_params=sd)
    for (p, ptr), q in zip(held, loop.model.parameters()):
        assert p is q and q.data_ptr() == ptr
    for k, v in loop.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
