"""Port vs JAX package: losses, the train step, its state and the train loop (CPU).

The tiny flagship config in f32. The JAX side runs its fused up-path skip
projection (``LFVDM_PALLAS_SKIPCONV=xla``, set only inside the module fixture
that traces it), as the port does by default, and rematerialises its blocks
(``use_checkpoint=True``, which moves no gradient by more than 4e-9 there),
so one compiled step is the reference of the port's step with and without
remat. Weights, batch, timesteps,
importance weights and noise are numpy arrays handed to both packages; the
JAX parameters reach the port through ``utils/convert.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.config import create_gaussian_diffusion as j_create_diffusion
from lfvdm_tpu.data import datasets as j_datasets
from lfvdm_tpu.diffusion import losses as j_losses
from lfvdm_tpu.diffusion import resample as j_resample
from lfvdm_tpu.training import masks as j_masks
from lfvdm_tpu.training.train_loop import init_train_state as j_init_train_state
from lfvdm_tpu.training.train_loop import make_optimizer as j_make_optimizer
from lfvdm_tpu.utils.torch_convert import convert_unet_state_dict
from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE, flagship_config
from lfvdm_tpu_torch.config import create_gaussian_diffusion as t_create_diffusion
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.data import datasets as t_datasets
from lfvdm_tpu_torch.diffusion import losses as t_losses
from lfvdm_tpu_torch.diffusion import resample as t_resample
from lfvdm_tpu_torch.models.unet import Dropout
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.training import checkpoint as ckpt
from lfvdm_tpu_torch.training import masks as t_masks
from lfvdm_tpu_torch.training.train_loop import (
    TrainLoop, apply_gradients, backward_microbatches, init_train_state, make_optimizer,
    train_step)
from lfvdm_tpu_torch.utils.convert import train_state_from_jax, unet_state_dict_from_jax

CFG = flagship_config(tiny=True)
ARCH = dict(num_res_blocks=CFG["num_res_blocks"],
            channel_mult=CHANNEL_MULT_BY_IMAGE_SIZE[CFG["image_size"]], attention_resolutions=(4,))
B, K = 2, 4
LR, WD, RATES = 1e-4, 0.1, ("0.9999", "0.99")


def tensor(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def port_batch(b):
    return {"x0": tensor(b["x0"]), "frame_indices": tensor(b["frame_indices"], torch.int64),
            "obs_mask": tensor(b["obs_mask"]), "latent_mask": tensor(b["latent_mask"])}


def flat(tree):
    """A JAX U-Net tree -> {port name: numpy}."""
    return {k: v.numpy() for k, v in unet_state_dict_from_jax(tree, **ARCH).items()}


def assert_trees_close(got, want, rtol, atol_rel):
    """Each leaf within rtol, and an atol of atol_rel times the largest |leaf|."""
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=rtol, atol=atol_rel * scale,
                                   err_msg=k)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    video = rng.uniform(-1, 1, (B, 12, C, S, S)).astype(np.float32)
    x0, fi, obs, lat = j_masks.sample_training_batch(rng, video, K, batch2=video[::-1])
    return ({"x0": x0, "frame_indices": fi, "obs_mask": obs, "latent_mask": lat},
            rng.integers(0, CFG["diffusion_steps"], B).astype(np.int32),
            rng.uniform(0.5, 1.5, B).astype(np.float32),
            rng.standard_normal(x0.shape).astype(np.float32))


def jax_params():
    """The port's seeded init with every parameter perturbed (so the zero
    layers carry signal), as a JAX tree through the JAX package's converter
    (cheaper here than an un-jitted Flax init)."""
    model, _ = t_create(CFG, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(5)
    sd = {k: (v + 0.02 * torch.randn(v.shape, generator=gen)).numpy()
          for k, v in model.state_dict().items()}
    return convert_unet_state_dict(sd, **ARCH)


@pytest.fixture(scope="module")
def ref():
    """JAX: loss and gradients of two consecutive steps (AdamW + EMA by the
    formula), and the summed gradients of the first batch in two chunks."""
    batch, t, w, noise = make_batch(0)
    batch2, t2, w2, noise2 = make_batch(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LFVDM_PALLAS_SKIPCONV", "xla")
        jmodel, jdiff = j_create(dict(CFG, use_checkpoint=True))
        params = jax_params()

        def loss_fn(params, batch, t, w, noise):
            def model_fn(x, ts, **kw):
                out, _ = jmodel.apply(params, x, ts, train=True, **kw)
                return out

            terms = jdiff.training_losses(
                model_fn, batch["x0"], t, None, model_kwargs=dict(batch), noise=noise,
                latent_mask=1.0 - batch["obs_mask"], eval_mask=batch["latent_mask"])
            return jnp.mean(terms["loss"] * w), terms

        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss1, terms1), g1 = vg(params, batch, t, w, noise)
        # Chunk i's gradient of its own mean loss, from the same compiled
        # function: the other sample weighted 0 and this one by B / chunk size
        # (the U-Net never mixes samples).
        chunks = [vg(params, batch, t, w * np.eye(B, dtype=np.float32)[i] * B, noise)[1]
                  for i in range(B)]
        tx = j_make_optimizer(LR, WD)
        state0 = j_init_train_state(params, tx, [float(r) for r in RATES])

        def update(state, grads):
            updates, opt = tx.update(grads, state["opt_state"], state["params"])
            new = optax.apply_updates(state["params"], updates)
            ema = {r: jax.tree.map(lambda e, p, r=float(r): e * r + p * (1 - r), state["ema"][r],
                                   new) for r in state["ema"]}
            return {"params": new, "opt_state": opt, "ema": ema, "step": state["step"] + 1}

        state1 = update(state0, g1)
        (loss2, _), g2 = vg(state1["params"], batch2, t2, w2, noise2)
        state2 = update(state1, g2)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(batch=batch, t=t, w=w, noise=noise, batch2=batch2, t2=t2, w2=w2, noise2=noise2,
                params=to_np(params), loss1=float(loss1), terms1=to_np(terms1), g1=to_np(g1),
                g_chunks=to_np(jax.tree.map(lambda a, b: a + b, *chunks)),
                state1=to_np(state1), state2=to_np(state2), loss2=float(loss2), g2=to_np(g2))


def port_state(params_tree, **config):
    model, diffusion = t_create(dict(CFG, **config), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat(params_tree).items()})
    optimizer, scheduler = make_optimizer(model.parameters(), LR, WD)
    return init_train_state(model, optimizer, scheduler, RATES), diffusion


def step_inputs(r, suffix=""):
    return (port_batch(r["batch" + suffix]), tensor(r["t" + suffix], torch.int64),
            tensor(r["w" + suffix]), tensor(r["noise" + suffix]))


def grads_of(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def test_loss_and_gradients_match_jax(ref):
    state, diffusion = port_state(ref["params"])
    batch, t, w, noise = step_inputs(ref)
    ops.reset_launch_counts()
    loss, terms = backward_microbatches(state.model, diffusion, batch, t, w, noise=noise)
    np.testing.assert_allclose(loss.item(), ref["loss1"], rtol=1e-5, atol=0)
    for k in ("loss", "mse", "eval-mse"):
        np.testing.assert_allclose(terms[k].numpy(), ref["terms1"][k], rtol=1e-5, atol=1e-7)
    assert_trees_close(grads_of(state.model), flat(ref["g1"]), rtol=1e-4, atol_rel=1e-4)
    assert sum(ops.launch_counts().values()) == 0


def test_remat_loss_and_gradients_match_jax(ref):
    """``use_checkpoint=True``: each block's forward runs again in the
    backward (its kernels launch twice), and the step is JAX's remat step."""
    state, diffusion = port_state(ref["params"], use_checkpoint=True)
    batch, t, w, noise = step_inputs(ref)
    loss, _ = backward_microbatches(state.model, diffusion, batch, t, w, noise=noise)
    np.testing.assert_allclose(loss.item(), ref["loss1"], rtol=1e-5, atol=0)
    got, want = grads_of(state.model), flat(ref["g1"])
    diff = np.sqrt(sum(np.square(got[k] - want[k]).sum() for k in want))
    assert diff <= 1e-5 * np.sqrt(sum(np.square(v).sum() for v in want.values()))
    assert_trees_close(got, want, rtol=1e-4, atol_rel=1e-4)


def set_grads(model, tree):
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(tree[n].copy())


def assert_state_matches(got, want):
    """The port's state_dict against a JAX state (converted): params, every
    EMA and both Adam moments."""
    conv = train_state_from_jax(want, **ARCH)
    assert got["adam"]["count"] == conv["adam"]["count"] and got["step"] == conv["step"]
    pairs = [(got["params"], conv["params"]), (got["adam"]["exp_avg"], conv["adam"]["exp_avg"]),
             (got["adam"]["exp_avg_sq"], conv["adam"]["exp_avg_sq"])]
    pairs += [(got["ema"][r], conv["ema"][r]) for r in RATES]
    for g, w in pairs:
        assert_trees_close({k: v.numpy() for k, v in g.items()},
                           {k: v.numpy() for k, v in w.items()}, rtol=1e-5, atol_rel=1e-5)


def test_update_matches_optax_and_the_ema_formula(ref):
    """The update from JAX's gradients: AdamW with decoupled weight decay
    against optax.adamw, the f32 EMA against e·r + p·(1 − r). (Given
    gradients: Adam's first step lr·g/(|g| + ε) turns last-digit gradient
    differences on elements with |g| ≈ ε into differences of a whole step;
    the gradients are compared on their own above.)"""
    state, _ = port_state(ref["params"])
    set_grads(state.model, flat(ref["g1"]))
    grad_norm, finite = apply_gradients(state)
    assert finite and state.step == 1
    g1 = flat(ref["g1"])
    np.testing.assert_allclose(grad_norm.item(),
                               np.sqrt(sum(np.square(v).sum() for v in g1.values())), rtol=1e-5)
    assert_state_matches(state.state_dict(), ref["state1"])
    moved = max(np.abs(flat(ref["state1"]["params"])[k] - flat(ref["params"])[k]).max()
                for k in g1)
    assert moved > 5e-5  # the update is visible above the tolerance


def test_train_step_runs_loss_update_and_ema(ref):
    state, diffusion = port_state(ref["params"])
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batch, t, w, noise = step_inputs(ref)
    metrics = train_step(state, batch, t, w, diffusion=diffusion, noise=noise)
    assert state.step == 1 and metrics["skipped_nonfinite"].item() == 0.0
    np.testing.assert_allclose(metrics["weighted_loss"].item(), ref["loss1"], rtol=1e-5)
    np.testing.assert_allclose(metrics["loss"].numpy(), ref["terms1"]["loss"], rtol=1e-5)
    assert set(metrics) == {"loss", "grad_norm", "skipped_nonfinite", "weighted_loss", "mse",
                            "eval-mse"}
    for n, p in state.model.named_parameters():
        for r in RATES:
            want = p0[n] * float(r) + p.detach() * (1 - float(r))
            torch.testing.assert_close(state.ema[r][n], want, atol=1e-7, rtol=1e-6)
    assert max((p - p0[n]).abs().max().item() for n, p in state.model.named_parameters()) > 5e-5


def test_two_chunk_accumulation_sums_chunk_gradients(ref):
    state, diffusion = port_state(ref["params"])
    batch, t, w, noise = step_inputs(ref)
    backward_microbatches(state.model, diffusion, batch, t, w, noise=noise, n_microbatches=2)
    assert_trees_close(grads_of(state.model), flat(ref["g_chunks"]), rtol=1e-4, atol_rel=1e-4)


def test_jax_train_state_resumes_in_the_port(ref):
    """JAX's state after one step -> train_state_from_jax -> the port's state
    (and back out unchanged); the second step's loss and gradients then match
    JAX's, and its update reaches JAX's second state."""
    converted = train_state_from_jax(ref["state1"], **ARCH)
    assert converted["adam"]["count"] == 1 and converted["step"] == 1
    assert set(converted["ema"]) == set(RATES)
    state, diffusion = port_state(ref["params"])
    state.load_state_dict(converted)
    assert_state_matches(state.state_dict(), ref["state1"])
    batch, t, w, noise = step_inputs(ref, "2")
    state.model.train()
    loss, _ = backward_microbatches(state.model, diffusion, batch, t, w, noise=noise)
    np.testing.assert_allclose(loss.item(), ref["loss2"], rtol=1e-5)
    assert_trees_close(grads_of(state.model), flat(ref["g2"]), rtol=1e-4, atol_rel=1e-4)
    set_grads(state.model, flat(ref["g2"]))
    apply_gradients(state)
    assert_state_matches(state.state_dict(), ref["state2"])


def test_nonfinite_step_leaves_the_state_unchanged(ref):
    state, diffusion = port_state(ref["params"])
    batch, t, w, noise = step_inputs(ref)
    train_step(state, batch, t, w, diffusion=diffusion, noise=noise)  # moments are non-zero
    clone = lambda d: {k: clone(v) if isinstance(v, dict) else  # noqa: E731
                       (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}
    before = clone(state.state_dict())
    batch["x0"][0, 0, 0, 0, 0] = float("nan")
    metrics = train_step(state, batch, t, w, diffusion=diffusion, noise=noise)
    assert metrics["skipped_nonfinite"].item() == 1.0
    assert not np.isfinite(metrics["grad_norm"].item())
    after = state.state_dict()
    assert after["step"] == 2 and after["adam"]["count"] == before["adam"]["count"] == 1
    for n, v in before["params"].items():
        assert torch.equal(after["params"][n], v)
        assert torch.equal(after["adam"]["exp_avg"][n], before["adam"]["exp_avg"][n])
        assert torch.equal(after["adam"]["exp_avg_sq"][n], before["adam"]["exp_avg_sq"][n])
        for r in RATES:
            assert torch.equal(after["ema"][r][n], before["ema"][r][n])


def test_linear_lr_anneal_matches_optax():
    """Three annealed steps on a few tensors with fixed gradients, and a
    skipped (non-finite) step between them that leaves the schedule alone."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = j_make_optimizer(1e-2, 0.05, lr_anneal_steps=3)
    jp, opt = p0, tx.init(p0)
    for g in grads:
        updates, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, updates)

    model = torch.nn.ParameterDict({k: torch.nn.Parameter(tensor(v)) for k, v in p0.items()})
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-2, 0.05, lr_anneal_steps=3)
    state = init_train_state(model, optimizer, scheduler, [0.9])
    for i, g in enumerate(grads):
        if i == 1:
            for k, p in model.items():
                p.grad = torch.full_like(p, float("inf"))
            assert apply_gradients(state)[1] is False
        for k, p in model.items():
            p.grad = tensor(g[k])
        assert apply_gradients(state)[1] is True
    assert state.step == 4 and scheduler.last_epoch == 3
    assert optimizer.param_groups[0]["lr"] == 0.0
    for k, p in model.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_likelihood_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal((3, 7)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(t_losses.normal_kl(tensor(a), tensor(b), tensor(c), tensor(d)),
                               j_losses.normal_kl(a, b, c, d), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_losses.normal_kl(tensor(a), tensor(b), 0.0, 0.0),
                               j_losses.normal_kl(a, b, 0.0, 0.0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_losses.approx_standard_normal_cdf(tensor(a)),
                               j_losses.approx_standard_normal_cdf(a), rtol=1e-5, atol=1e-6)
    # pixel values on the 1/255 grid, the two edge bins included; means within
    # a few sigma (far out, both CDFs round to 1 in f32 and the bin mass is
    # cancellation noise in either package)
    x = np.clip(np.round(rng.uniform(-1.2, 1.2, (4, 50)) * 127.5) / 127.5, -1, 1).astype(np.float32)
    x[0, :3] = (-1.0, 1.0, 0.0)
    log_scales = rng.uniform(-3, -1, x.shape).astype(np.float32)
    means = (x + np.exp(log_scales) * rng.standard_normal(x.shape)).astype(np.float32)
    np.testing.assert_allclose(
        t_losses.discretized_gaussian_log_likelihood(tensor(x), means=tensor(means),
                                                     log_scales=tensor(log_scales)),
        j_losses.discretized_gaussian_log_likelihood(x, means=means, log_scales=log_scales),
        rtol=1e-5, atol=1e-5)


def _toy_model(lib, a, c):
    """out = [tanh(a·x + t/1000) ‖ tanh(c·x)]: the mean from ``a``, the
    variance values from ``c`` (the second half only with learned sigma)."""

    def model_fn(x, ts, learned):
        tt = (ts.astype(jnp.float32) if lib is jnp else ts.float())
        tt = tt.reshape((-1,) + (1,) * (x.ndim - 1)) / 1000.0
        mean = lib.tanh(a * x + tt)
        if not learned:
            return mean
        var = lib.tanh(c * x)
        return jnp.concatenate([mean, var], axis=-3) if lib is jnp else torch.cat([mean, var], -3)

    return model_fn


@pytest.mark.parametrize("kind", ["mse", "learned_sigma_rescaled_mse", "kl"])
def test_training_losses_match_jax(kind):
    learned = kind != "mse"
    kw = dict(diffusion_steps=50, noise_schedule="linear", learn_sigma=learned,
              rescale_learned_sigmas=kind == "learned_sigma_rescaled_mse", use_kl=kind == "kl")
    jdiff, tdiff = j_create_diffusion(**kw), t_create_diffusion(**kw)
    rng = np.random.default_rng(1)
    x0 = np.clip(rng.standard_normal((3, 4, 2, 5, 5)) * 0.5, -1, 1).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 17, 49], np.int32)  # t = 0 takes the decoder NLL branch
    mask = np.ones((3, 4, 1, 1, 1), np.float32)
    mask[:, 0] = 0.0
    a, c = 0.8, 0.6
    jfn = _toy_model(jnp, jnp.float32(a), jnp.float32(c))
    jterms = jdiff.training_losses(lambda x, ts: jfn(x, ts, learned), jnp.asarray(x0),
                                   jnp.asarray(t), None, noise=jnp.asarray(noise),
                                   latent_mask=jnp.asarray(mask), eval_mask=jnp.asarray(mask))
    ta = torch.tensor(a, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    tfn = _toy_model(torch, ta, tc)
    tterms = tdiff.training_losses(lambda x, ts: tfn(x, ts, learned), tensor(x0),
                                   tensor(t, torch.int64), noise=tensor(noise),
                                   latent_mask=tensor(mask), eval_mask=tensor(mask))
    assert set(tterms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(tterms[k].detach().numpy(), np.asarray(jterms[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if kind == "learned_sigma_rescaled_mse":
        # the VB term trains the variance only: no gradient reaches the mean
        ga, gc = torch.autograd.grad(tterms["vb"].sum(), (ta, tc), allow_unused=True)
        assert (ga is None or ga.item() == 0.0) and gc.item() != 0.0


# ---------------------------------------------------------------------------
# Numpy copies, data and the loop
# ---------------------------------------------------------------------------


def test_mask_and_batch_sampling_match_jax():
    video = np.random.default_rng(0).standard_normal((3, 30, 2, 4, 4)).astype(np.float32)
    for pad in (True, False):
        got = t_masks.sample_training_batch(np.random.default_rng(9), video, 8, batch2=video[::-1],
                                            pad_with_random_frames=pad)
        want = j_masks.sample_training_batch(np.random.default_rng(9), video, 8,
                                             batch2=video[::-1], pad_with_random_frames=pad)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        np.stack(t_masks.sample_all_masks(np.random.default_rng(2), 4, 50, 20)),
        np.stack(j_masks.sample_all_masks(np.random.default_rng(2), 4, 50, 20)))


def test_schedule_samplers_match_jax():
    diffusion = t_create_diffusion(diffusion_steps=100)
    for name in ("uniform", "loss-second-moment"):
        ts = t_resample.create_named_schedule_sampler(name, diffusion)
        js = j_resample.create_named_schedule_sampler(name, diffusion)
        rng = np.random.default_rng(4)
        for i in range(25):
            ta, tw = ts.sample(8, np.random.default_rng(i))
            ja, jw = js.sample(8, np.random.default_rng(i))
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tw, jw)
            if name != "uniform":
                losses = rng.uniform(0, 2, 8)
                ts.update_with_local_losses(ta, losses)
                js.update_with_local_losses(ja, losses)
        np.testing.assert_array_equal(ts.weights(), js.weights())


def test_synthetic_data_matches_jax():
    for name, cls in (("synthetic", j_datasets.SyntheticVideoDataset),
                      ("synthetic_longrange", j_datasets.SyntheticLongRangeDataset)):
        # the registry at its default size, then at 16 px (the port's image_size)
        t_ds = t_datasets.load_data(name, batch_size=2, T=6, return_dataset=True)
        j_ds = j_datasets.load_data(name, batch_size=2, T=6, return_dataset=True)
        assert len(t_ds) == len(j_ds)
        np.testing.assert_array_equal(t_ds[3], j_ds[3])
        small = t_datasets.load_data(name, batch_size=2, T=6, return_dataset=True, image_size=16)
        assert small[3].shape == (6, 3, 16, 16)
        np.testing.assert_array_equal(small[3], cls(num_videos=len(j_ds), T=6, H=16, W=16)[3])
        t_test = t_datasets.load_data(name, batch_size=2, T=6, return_dataset=True,
                                      image_size=16)
        t_test.set_test()
        j_test = cls(num_videos=len(j_ds), T=6, H=16, W=16)
        j_test.set_test()
        np.testing.assert_array_equal(t_test[1], j_test[1])
    batches = t_datasets.load_data("synthetic", batch_size=3, T=5, seed=1)
    assert next(batches).shape == (3, 5, 3, 64, 64)
    with pytest.raises(ValueError):
        t_datasets.load_data("no_such_dataset", batch_size=1)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.uniform(-1, 1, (B, 10, CFG["in_channels"], 32, 32)).astype(np.float32)


def test_train_loop_steps_saves_resumes_and_loads_raw(tmp_path, capsys):
    def loop(**kw):
        model, diffusion = t_create(CFG, device="cpu", seed=1)
        return TrainLoop(model=model, diffusion=diffusion, data=_data(), batch_size=B,
                         max_frames=K, lr=1e-3, ema_rate="0.9999,0.99", log_interval=2,
                         save_interval=0, checkpoint_dir=str(tmp_path / "run"),
                         config=dict(CFG), **kw)

    first = loop(schedule_sampler=None)
    p0 = {n: p.detach().clone() for n, p in first.model.named_parameters()}
    first.run_loop(max_steps=3)
    assert first.step == 3 and first.state.step == 3
    assert max((p - p0[n]).abs().max().item() for n, p in first.model.named_parameters()) > 0
    assert "mse" in capsys.readouterr().out  # the log flush ran
    first.save()
    saved = first.state.state_dict()

    second = loop(resume=True)
    assert second.step == 3
    got = second.state.state_dict()
    assert got["step"] == saved["step"] and got["adam"]["count"] == saved["adam"]["count"]
    for n, v in saved["params"].items():
        assert torch.equal(got["params"][n], v)
        assert torch.equal(got["adam"]["exp_avg_sq"][n], saved["adam"]["exp_avg_sq"][n])
        assert torch.equal(got["ema"]["0.99"][n], saved["ema"]["0.99"][n])
    second.run_step()
    assert second.state.step == 4

    raw, picked, step, config = ckpt.load_ema_params(str(tmp_path / "run"), rate="raw")
    assert picked is None and step == 3 and config["image_size"] == CFG["image_size"]
    for n, v in saved["params"].items():
        assert torch.equal(raw[n], v)
    ema, picked, _, _ = ckpt.load_ema_params(str(tmp_path / "run"))
    assert picked == "0.9999" and "INITIAL RANDOM" in capsys.readouterr().out
    assert torch.equal(ema["out.2.weight"], saved["ema"]["0.9999"]["out.2.weight"])
    model, _ = t_create(CFG, device="cpu")
    model.load_state_dict(raw)  # a plain state_dict of the model


def _dropout_masks(tmp_path, seed, dropout=0.5):
    """The first two dropout masks of a TrainLoop's model (ResBlock order),
    drawn on a batch of ones, and one train-mode forward's output (every
    weight perturbed, so the zero-initialised layers pass the dropout on)."""
    model, diffusion = t_create(dict(CFG, dropout=dropout), device="cpu", seed=1)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    loop = TrainLoop(model=model, diffusion=diffusion, data=_data(), batch_size=B, max_frames=K,
                     lr=1e-3, checkpoint_dir=str(tmp_path), seed=seed)
    drops = [m for m in loop.model.modules() if isinstance(m, Dropout)]
    assert drops and all(d.generator is loop.dropout_generator for d in drops)
    loop.model.train()
    masks = [drops[0](torch.ones(4096)), drops[1](torch.ones(4096))]
    batch, t, _, noise = step_inputs(dict(zip(("batch", "t", "w", "noise"), make_batch(3))))
    with torch.no_grad():
        x_t = diffusion.q_sample(batch["x0"], t, noise=noise)
        out, _ = loop.model(x_t, t, **batch)
    return masks, out


def test_dropout_masks_follow_the_train_loop_seed(tmp_path):
    """ResBlock dropout draws from the loop's seeded generator: one seed gives
    the same masks (and the same train-mode forward) twice, two seeds differ.
    Masks keep 1 / (1 - p) or 0, about half of each at p = 0.5."""
    a, out_a = _dropout_masks(tmp_path, seed=0)
    again, out_again = _dropout_masks(tmp_path, seed=0)
    other, out_other = _dropout_masks(tmp_path, seed=1)
    for m, m2 in zip(a, again):
        assert torch.equal(m, m2)
        assert set(m.unique().tolist()) <= {0.0, 2.0} and 0.4 < (m > 0).float().mean() < 0.6
    assert not torch.equal(a[0], a[1])  # successive draws move the stream
    assert not any(torch.equal(m, o) for m, o in zip(a, other))
    assert torch.equal(out_a, out_again) and not torch.equal(out_a, out_other)


def test_zero_dropout_draws_nothing_and_changes_nothing():
    """dropout = 0 (the default and the flagship): the module is the identity
    in train mode and its generator does not move, so the f32 parity with
    lfvdm_tpu (test_loss_and_gradients_match_jax) is unaffected."""
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    d = Dropout(0.0).train()
    d.generator = gen
    x = torch.randn(3, 5)
    assert d(x) is x and torch.equal(gen.get_state(), state)
    model, _ = t_create(CFG, device="cpu")
    assert all(m.p == 0.0 for m in model.modules() if isinstance(m, Dropout))


def test_train_loop_warm_start_checks_names_and_shapes(tmp_path):
    model, diffusion = t_create(CFG, device="cpu", seed=2)
    sd = {k: v.clone() + 1.0 for k, v in model.state_dict().items()}
    kw = dict(model=model, diffusion=diffusion, data=_data(), batch_size=B, max_frames=K,
              lr=1e-3, checkpoint_dir=str(tmp_path))
    TrainLoop(init_params=sd, **kw)
    assert torch.equal(model.state_dict()["out.2.bias"], sd["out.2.bias"])
    bad = dict(sd)
    bad["out.2.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape mismatch"):
        TrainLoop(init_params=bad, **kw)
    bad = dict(sd)
    bad.pop("out.2.bias")
    with pytest.raises(ValueError, match="missing"):
        TrainLoop(init_params=bad, **kw)


def test_train_loop_cadence_profile_and_test_exit(tmp_path, monkeypatch):
    model, diffusion = t_create(CFG, device="cpu", seed=3)
    calls = []
    loop = TrainLoop(model=model, diffusion=diffusion, data=_data(), batch_size=B, max_frames=K,
                     lr=1e-3, log_interval=0, save_interval=0, checkpoint_dir=str(tmp_path / "c"),
                     sample_fn=lambda lp: calls.append(lp.step), sample_interval=2,
                     profile_dir=str(tmp_path / "trace"), profile_start_step=1,
                     profile_num_steps=1)
    loop.run_loop(max_steps=3)
    assert loop.step == 3 and calls == [2]
    assert (tmp_path / "trace" / "train_trace.json").stat().st_size > 0
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    loop.run_loop()  # returns after its first step past step 0
    assert loop.step == 3 and loop.state.step == 4
