"""The port's CARLA coordinate regressor (``lfvdm_tpu_torch.evals.carla_regressor``)
against the JAX package on the CPU, f32.

The full-depth ResNet-152 classifier and 100-head regressor go port (seeded,
every BatchNorm moment and bias perturbed) -> torchvision-layout ``.pt`` ->
each package's ``load_classifier_regressor_like_paper`` (JAX's through its
``convert_resnet152_state_dict``): logits and coordinates to relative L2
1e-4, the same argmax cells. Train mode runs on a cut-down trunk
(``stage_sizes=(1, 1, 1, 1)`` on both sides): the JAX variables are drawn
from a numpy seed on the tree ``jax.eval_shape`` gives, so JAX's Flax
``init`` of ResNet-152 (about 20 s on a CPU) is never called. Two SGD steps
with momentum match optax's in float64: parameters to relative L2 1e-4 (their
updates to 1e-6), BatchNorm running statistics to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from lfvdm_tpu.evals import carla_regressor as J
from lfvdm_tpu_torch.evals import carla_regressor as T
from lfvdm_tpu_torch.utils import convert
from lfvdm_tpu_torch.utils.convert import resnet152_state_dict_from_jax

SMALL = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its many small ops share
    the CPU with the other test workers, where more threads only wait on
    each other. Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def perturbed(module, seed):
    """``seeded_init`` plus non-trivial BatchNorm moments and biases."""
    T.seeded_init(module, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    return module


def test_get_cell_and_normalize_equal_jax():
    rng = np.random.default_rng(0)
    for coord in list(rng.uniform(-20, 420, (50, 2))) + [np.array([-10.0, 400.0])]:
        assert T.get_cell(coord) == J.get_cell(coord)
    for frames in (rng.integers(0, 256, (2, 3, 8, 8)).astype(np.float32),
                   rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)):
        np.testing.assert_allclose(T.normalize_frames(frames),
                                   J.normalize_frames(frames).transpose(0, 3, 1, 2), rtol=1e-6)


@pytest.fixture(scope="module")
def paper_files(tmp_path_factory):
    """Full-depth classifier and regressor as torchvision-layout ``.pt``
    state_dicts, with ``num_batches_tracked`` entries as torchvision writes
    them (ignored by both loaders)."""
    root = tmp_path_factory.mktemp("regressor")
    paths = []
    for name, module in (("classifier", T.ResNet152Classifier()),
                         ("regressor", T.MultiHeadResNet152())):
        sd = perturbed(module, seed=len(paths)).state_dict()
        sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                   for k in list(sd) if k.endswith("running_mean")})
        paths.append(str(root / f"{name}.pt"))
        torch.save(sd, paths[-1])
    return paths


def test_resnet152_matches_jax(paper_files):
    """Logits, the regressor at two given cells (the head gather) and the
    classifier -> cell -> regressor chain of ``predict_coords``; JAX's
    modules applied un-jitted (a jit of the full depth costs twice as much
    here)."""
    port = T.load_classifier_regressor_like_paper(*paper_files, device="cpu")
    jax_pred = J.load_classifier_regressor_like_paper(*paper_files)
    frames = np.random.default_rng(1).integers(0, 256, (2, 3, 32, 32)).astype(np.float32)
    x = torch.as_tensor(T.normalize_frames(frames))
    xj = jnp.asarray(J.normalize_frames(frames))
    cells = np.array([3, 71])
    with torch.no_grad():
        logits = port.classifier(x).numpy()
        coords = port.regressor(x, torch.as_tensor(cells)).numpy()
    want_logits = np.asarray(jax_pred.classifier.apply(jax_pred.classifier_vars, xj))
    assert _rel(logits, want_logits) <= 1e-4
    assert (logits.argmax(1) == want_logits.argmax(1)).all()

    def jax_regressor(c):
        return np.asarray(jax_pred.regressor.apply(jax_pred.regressor_vars, xj, jnp.asarray(c)))

    assert _rel(coords, jax_regressor(cells)) <= 1e-4
    got = port.predict_coords(frames)
    assert got.shape == (2, 2) and np.isfinite(got).all()
    assert _rel(got, jax_regressor(want_logits.argmax(1))) <= 1e-4


def test_state_dict_from_jax_inverts_the_jax_converter(paper_files):
    for path, multi_head in zip(paper_files, (False, True)):
        sd = {k: v for k, v in torch.load(path).items() if not k.endswith("num_batches_tracked")}
        back = resnet152_state_dict_from_jax(
            J.convert_resnet152_state_dict({k: v.numpy() for k, v in sd.items()},
                                           multi_head=multi_head), multi_head=multi_head)
        assert set(back) == set(sd)
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)


def test_loader_names_missing_weights(tmp_path):
    with pytest.raises(KeyError, match="lacks"):
        T.load_state_dict_like_jax(T.ResNet152Classifier(stage_sizes=SMALL), {})


# ---- train mode, on a cut-down trunk ----


class SmallTrunk(J.ResNet152Trunk):
    stage_sizes: tuple = SMALL


@pytest.fixture
def small_jax(monkeypatch):
    """The JAX classifier and regressor build their trunk from the module's
    global ``ResNet152Trunk``: a cut-down one stands in."""
    monkeypatch.setattr(J, "ResNet152Trunk", SmallTrunk)


def seeded_jax_variables(model, inputs, seed):
    """Numpy-seeded variables on the tree ``jax.eval_shape`` gives for
    ``model.init``: conv kernels of variance 2/fan_in, heads of 1/fan_in,
    BatchNorm scales near 1, biases and moments perturbed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']") or "head_kernels" in name:
            fan_in = int(np.prod(s.shape[:-1])) if "head" not in name else s.shape[1]
            gain = 1.0 if ("fc" in name or "head" in name) else 2.0
            return rng.standard_normal(s.shape) * np.sqrt(gain / fan_in)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def port_model(is_classifier, variables):
    model = (T.ResNet152Classifier(stage_sizes=SMALL) if is_classifier
             else T.MultiHeadResNet152(stage_sizes=SMALL))
    model.load_state_dict(resnet152_state_dict_from_jax(variables, multi_head=not is_classifier))
    return model


def _batch(seed, B=4, size=32):
    rng = np.random.default_rng(seed)
    frames = T.normalize_frames(rng.integers(0, 256, (B, 3, size, size)).astype(np.float32))
    coords = rng.uniform(-10, 400, (B, 2)).astype(np.float32) / 100.0
    cells = rng.integers(0, 100, B)
    return frames, coords, cells


@pytest.mark.parametrize("is_classifier", [True, False], ids=["classifier", "regressor"])
def test_train_steps_match_optax(small_jax, monkeypatch, is_classifier):
    """Two SGD steps (momentum 0.9, lr 0.01) with BatchNorm in train mode,
    in float64 on both sides (``jax.enable_x64``): the loss, the parameters,
    their updates and the running statistics of JAX's ``apply(...,
    train=True, mutable=["batch_stats"])`` + ``optax.sgd``. In f32 this
    comparison measures conditioning, not semantics: with train-mode
    BatchNorm subtracting most of the gradient that reaches it, the
    regressor's f32 gradients in the stem and layers 1-2 are only good to
    1.5e-3 (torch) and 4e-3 (JAX) against float64, and Flax's E[x²] - E[x]²
    batch variance loses digits where a channel's mean dwarfs its spread."""
    from lfvdm_tpu_torch.scripts.carla_regressor_train import loss_fn

    with jax.enable_x64(True):
        jmodel = J.ResNet152Classifier() if is_classifier else J.MultiHeadResNet152()
        frames, coords, cells = _batch(0)
        inputs = (jnp.asarray(frames.transpose(0, 2, 3, 1)),) + (
            () if is_classifier else (jnp.asarray(cells),))
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                           seeded_jax_variables(jmodel, inputs, seed=2))
        model = port_model(is_classifier, variables).double().train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        tx = optax.sgd(0.01, momentum=0.9)
        params, stats = variables["params"], variables["batch_stats"]
        opt_state = tx.init(params)

        def jloss(p, s, x, y, c):
            args = (x,) if is_classifier else (x, c)
            out, mut = jmodel.apply({"params": p, "batch_stats": s}, *args, train=True,
                                    mutable=["batch_stats"])
            if is_classifier:
                loss = optax.sigmoid_binary_cross_entropy(out, jax.nn.one_hot(c, 100)).mean()
            else:
                loss = jnp.mean((out - y) ** 2)
            return loss, mut["batch_stats"]

        step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for seed in (0, 1):
            frames, coords, cells = (a.astype(np.float64) if a.dtype == np.float32 else a
                                     for a in _batch(seed))
            (want_loss, stats), grads = step(params, stats,
                                             jnp.asarray(frames.transpose(0, 2, 3, 1)),
                                             jnp.asarray(coords), jnp.asarray(cells))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)

            loss = loss_fn(model, is_classifier, torch.as_tensor(frames),
                           torch.as_tensor(coords), torch.as_tensor(cells))
            opt.zero_grad()
            loss.backward()
            opt.step()
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-9)
        # The converter writes f32; its float64 twin keeps the updates' digits.
        monkeypatch.setattr(convert, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
        want = resnet152_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats}),
            multi_head=not is_classifier)

    got = model.state_dict()
    assert set(got) == set(want) == set(before)
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-4, k
            step, want_step = got[k] - before[k], want[k] - before[k]
            if want_step.abs().max() == 0:  # a head no frame used
                assert step.abs().max() == 0, k
            else:
                assert _rel(step, want_step) <= 1e-6, k


def test_train_mode_running_variance_is_biased():
    """The running variance takes the biased batch variance (Flax), where
    ``nn.BatchNorm2d`` takes the unbiased one: n/(n-1) apart."""
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn = T.BatchNorm2d(3).train()
    ref = torch.nn.BatchNorm2d(3).train()
    torch.testing.assert_close(bn(x), ref(x), rtol=1e-5, atol=1e-5)
    n = x.numel() // 3
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    torch.testing.assert_close((bn.running_var - 0.9) * n / (n - 1), ref.running_var - 0.9)
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False))
    bn.eval()
    torch.testing.assert_close(bn(x), F.batch_norm(x, bn.running_mean, bn.running_var,
                                                   bn.weight, bn.bias, False, 0.0, 1e-5))
