"""The train state's update against the JAX package's (CPU): the port's one
update, the single-pass AdamW + EMA (the counterpart of JAX's
``LFVDM_FUSED_OPT`` arm), against both JAX arms; bf16 EMA copies
(``LFVDM_BF16_EMA``) and their checkpoints.

A few small f32 tensors (a matrix, a vector and a scalar, the shapes of
``tests/test_fused_opt.py``) stand for the model; their seeded values and
gradients are numpy arrays handed to both packages. On the CPU the port's
update runs its operator's plain version (``ops/adamw.py``); the kernel
itself is held to that version on the card
(``tests/test_torch_adamw_cuda.py``, ``chip_smoke.py``). The update also
runs under FSDP2 on two gloo ranks (a small MLP, against one process's
update).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfvdm_tpu.training.train_loop import _OPT_HYPERPARAMS, _fused_adamw_ema
from lfvdm_tpu.training.train_loop import init_train_state as j_init_train_state
from lfvdm_tpu.training.train_loop import make_optimizer as j_make_optimizer
from lfvdm_tpu_torch.ops import adamw
from lfvdm_tpu_torch.training import checkpoint as ckpt_lib
from lfvdm_tpu_torch.training.train_loop import (apply_gradients, init_train_state,
                                                 make_optimizer)

LR = 1e-3
RATES = ["0.9999", "0.99"]
NAMES = {"a": ("a",), "w": ("b", "w"), "s": ("b", "s")}  # port name -> JAX tree path
TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_fused_opt.py's


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": {"w": (rng.standard_normal((5,)) * scale).astype(np.float32),
                  "s": np.asarray(rng.standard_normal(()) * scale, np.float32)}}


def _leaf(tree, name):
    for key in NAMES[name]:
        tree = tree[key]
    return np.asarray(tree)


def _port_state(params, wd=0.0, anneal=0, rates=RATES):
    model = torch.nn.ParameterDict({n: torch.nn.Parameter(torch.tensor(_leaf(params, n)))
                                    for n in NAMES})
    optimizer, schedule = make_optimizer(model.parameters(), LR, wd, lr_anneal_steps=anneal)
    return init_train_state(model, optimizer, schedule, rates)


def _step(state, grads):
    for n, p in state.model.items():
        p.grad = torch.tensor(_leaf(grads, n))
    return apply_gradients(state)


def _jax_default_update(params, grads, opt_state, ema, rates, tx):
    """The JAX step's default arm (``make_train_step`` without
    ``LFVDM_FUSED_OPT``): the optax chain, then each EMA copy in f32 stored
    at the copy's dtype."""
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    ema = {r: jax.tree.map(lambda e, p, r=float(r): jnp.asarray(e.astype(p.dtype) * r
                                                                + p * (1 - r), e.dtype),
                           ema[r], params) for r in rates}
    return params, opt_state, ema


def _check(state, params, opt_state, ema, rates=RATES, **tol):
    adam = opt_state[0]
    assert int(state.optimizer.count) == int(adam.count)
    for n, p in state.model.items():
        st = state.optimizer.state[p]
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params, n), err_msg=n, **tol)
        np.testing.assert_allclose(st["exp_avg"].numpy(), _leaf(adam.mu, n), err_msg=n, **tol)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), _leaf(adam.nu, n), err_msg=n,
                                   **tol)
        for r in rates:
            np.testing.assert_allclose(state.ema[r][n].float().numpy(),
                                       np.asarray(_leaf(ema[r], n), np.float32), err_msg=n,
                                       **tol)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("anneal", [0, 50])
def test_fused_update_matches_jax_and_the_flat_update(wd, anneal):
    """Three steps of the port's update against JAX's ``_fused_adamw_ema``
    (its ``LFVDM_FUSED_OPT`` arm) and against JAX's default arm (the optax
    chain), at test_fused_opt.py's rtol 1e-6, atol 1e-7: parameters, both
    moments, the count, both EMAs."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tx = j_make_optimizer(LR, wd, anneal)
    jstate = j_init_train_state(jax.tree.map(jnp.asarray, params), tx, RATES)
    fused = (jstate["params"], jstate["opt_state"], jstate["ema"])
    chain = fused
    state = _port_state(params, wd, anneal)
    for _ in range(3):
        grads = _tree(rng, scale=0.1)
        jgrads = jax.tree.map(jnp.asarray, grads)
        fused = _fused_adamw_ema(fused[0], jgrads, fused[1], fused[2], RATES,
                                 _OPT_HYPERPARAMS[tx])
        chain = _jax_default_update(chain[0], jgrads, chain[1], chain[2], RATES, tx)
        norm, finite = _step(state, grads)
        assert finite and torch.isfinite(norm)
        _check(state, *fused, **TOL)
        _check(state, *chain, **TOL)
    if anneal:
        assert int(state.scheduler.count) == 3


def test_fused_nonfinite_step_leaves_the_state_bitwise():
    """A non-finite gradient: parameters, moments, count, the schedule's
    count and every EMA keep every bit; the next finite step updates."""
    rng = np.random.default_rng(1)
    state = _port_state(_tree(rng), wd=0.01, anneal=10)
    _step(state, _tree(rng, scale=0.1))  # moments non-zero

    def snapshot():
        out = [state.optimizer.count.clone(), state.scheduler.count.clone()]
        for n, p in state.model.items():
            st = state.optimizer.state[p]
            out += [p.detach().clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone()]
            out += [state.ema[r][n].clone() for r in RATES]
        return out

    before = snapshot()
    bad = _tree(rng, scale=0.1)
    bad["b"]["w"][2] = np.inf
    norm, finite = _step(state, bad)
    assert not finite and not torch.isfinite(norm)
    assert all(torch.equal(a, b) for a, b in zip(snapshot(), before))
    assert _step(state, _tree(rng, scale=0.1))[1]
    assert int(state.optimizer.count) == int(state.scheduler.count) == 2
    assert not torch.equal(state.model["a"].detach(), before[2])


def _bf16_ulp(x):
    """One unit in the last place of bf16 at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_bf16_ema_copies_match_the_jax_arm(monkeypatch, fused):
    """``LFVDM_BF16_EMA=1``: the copies are bf16 from the start, stay within
    JAX's 2e-2/1e-2 of the parameters after a step, and equal the JAX
    step's copies under the same variable within one bf16 ulp, whether JAX
    runs its default arm (``fused`` "0": the optax chain) or its
    ``LFVDM_FUSED_OPT`` arm ("1")."""
    monkeypatch.setenv("LFVDM_BF16_EMA", "1")
    rng = np.random.default_rng(2)
    params = _tree(rng)
    tx = j_make_optimizer(LR, 0.0)
    jstate = j_init_train_state(jax.tree.map(jnp.asarray, params), tx, ["0.9999"])
    assert all(leaf.dtype == jnp.bfloat16 for leaf in jax.tree.leaves(jstate["ema"]))
    state = _port_state(params, rates=["0.9999"])
    assert all(e.dtype == torch.bfloat16 for e in state.ema["0.9999"].values())
    grads = _tree(rng, scale=0.1)
    jgrads = jax.tree.map(jnp.asarray, grads)
    if fused == "1":
        jp, _, jema = _fused_adamw_ema(jstate["params"], jgrads, jstate["opt_state"],
                                       jstate["ema"], ["0.9999"], _OPT_HYPERPARAMS[tx])
    else:
        jp, _, jema = _jax_default_update(jstate["params"], jgrads, jstate["opt_state"],
                                          jstate["ema"], ["0.9999"], tx)
    assert _step(state, grads)[1]
    for n, p in state.model.items():
        e = state.ema["0.9999"][n]
        assert e.dtype == torch.bfloat16
        np.testing.assert_allclose(e.float().numpy(), p.detach().numpy(), rtol=2e-2, atol=1e-2)
        want = np.asarray(_leaf(jema["0.9999"], n), np.float32)
        assert (np.abs(e.float().numpy() - want) <= _bf16_ulp(want)).all(), n
        np.testing.assert_allclose(p.detach().numpy(), _leaf(jp, n), **TOL)


def test_bf16_ema_checkpoint_round_trip(monkeypatch, tmp_path):
    """A checkpoint of a bf16-EMA state keeps its copies bf16 and bitwise;
    it loads into a fresh state, and ``load_ema_params`` hands the copy out
    as f32 values the model loads."""
    monkeypatch.setenv("LFVDM_BF16_EMA", "1")
    rng = np.random.default_rng(3)
    params = _tree(rng)
    state = _port_state(params)
    _step(state, _tree(rng, scale=0.1))
    saved = state.state_dict()
    ckpt_lib.save_checkpoint(str(tmp_path), 1, saved, config={"lr": LR})
    loaded, step, _ = ckpt_lib.load_checkpoint(str(tmp_path))
    assert step == 1
    for r in RATES:
        for n, e in saved["ema"][r].items():
            assert loaded["ema"][r][n].dtype == torch.bfloat16
            assert torch.equal(loaded["ema"][r][n], e)
    fresh = _port_state(params)
    fresh.load_state_dict(loaded)
    for r in RATES:
        for n, e in fresh.ema[r].items():
            assert e.dtype == torch.bfloat16 and torch.equal(e, saved["ema"][r][n])
    ema, rate, _, _ = ckpt_lib.load_ema_params(str(tmp_path), rate="0.99")
    assert rate == "0.99"
    assert all(v.dtype == torch.float32 for v in ema.values())
    model = torch.nn.ParameterDict({n: torch.nn.Parameter(torch.zeros(_leaf(params, n).shape))
                                    for n in NAMES})
    model.load_state_dict(ema)
    for n, p in model.items():
        assert torch.equal(p.detach(), saved["ema"]["0.99"][n].float())


def test_fused_operator_checks_its_inputs():
    """The operator's plain version on the CPU matches optax's AdamW alone
    (no EMA) over a step with a schedule factor, and the kernel's input
    checks refuse mixed EMA dtypes and non-contiguous tensors."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    tx = optax.adamw(optax.linear_schedule(LR, 0.0, 4), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.01)
    opt = tx.init(jnp.asarray(p0))
    updates, _ = tx.update(jnp.asarray(g), opt, jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), updates))
    p, m, v = torch.tensor(p0), torch.zeros(6, 5), torch.zeros(6, 5)
    adamw.fused_adamw_ema([p], [torch.tensor(g)], [m], [v], [], torch.tensor(True),
                          torch.zeros((), dtype=torch.int64), lr=LR, weight_decay=0.01,
                          rates=[], lr_factor=torch.tensor(1.0))
    np.testing.assert_allclose(p.numpy(), want, **TOL)
    e32, e16 = torch.zeros(6, 5), torch.zeros(6, 5, dtype=torch.bfloat16)
    args = ([p, p.clone()], [p, p], [m, m], [v, v])
    with pytest.raises(ValueError):
        adamw._check_kernel_inputs(*args, [e16, e32], torch.tensor(True),
                                   torch.zeros((), dtype=torch.int64), None)
    with pytest.raises(ValueError):
        adamw._check_kernel_inputs([p.t()], [p], [m], [v], [], torch.tensor(True),
                                   torch.zeros((), dtype=torch.int64), None)
    with pytest.raises(ValueError):
        adamw.fused_adamw_ema([p], [p], [m], [v], [[e32]], torch.tensor(True),
                              torch.zeros((), dtype=torch.int64), lr=LR, weight_decay=0.0,
                              rates=[0.9, 0.99])


def test_fused_operator_passes_opcheck():
    """``torch.ops.lfvdm.fused_adamw_ema`` (plain version on the CPU): its
    schema's mutations, fake implementation and Autograd registration."""
    rng = np.random.default_rng(5)
    params = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in ((5, 3), (7,))]
    args = (params, [torch.randn_like(p) for p in params], [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params], [p.to(torch.bfloat16) for p in params],
            torch.tensor(True), torch.zeros((), dtype=torch.int64), torch.tensor(0.5),
            adamw.hyperparameters(LR, 0.01, (0.9, 0.999), 1e-8, [0.99]))
    torch.library.opcheck(torch.ops.lfvdm.fused_adamw_ema.default, args)


# Two gloo ranks: a small MLP under FSDP2 (fsdp 2: the weights sharded, the
# biases under MIN_SIZE replicated and averaged by hand), two steps of the
# update with the LR anneal and one EMA, each rank on its half of the
# rows; rank 0 saves the gathered state.
TWO_RANKS = r"""
import json, os, sys
import torch, torch.distributed as dist
job = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="tcp://localhost:%d" % job["port"], rank=rank,
                        world_size=2)
from lfvdm_tpu_torch.parallel.mesh import make_mesh
from lfvdm_tpu_torch.parallel.sharding import shard_model
from lfvdm_tpu_torch.training.train_loop import apply_gradients, init_train_state, make_optimizer
data = torch.load(job["data"])
model = torch.nn.Sequential(torch.nn.Linear(16, 128), torch.nn.SiLU(), torch.nn.Linear(128, 8))
model.load_state_dict(data["params"])
model = shard_model(model, make_mesh(2, "cpu"), min_size=job["min_size"])
optimizer, schedule = make_optimizer(model.parameters(), job["lr"], job["wd"], lr_anneal_steps=10)
state = init_train_state(model, optimizer, schedule, job["rates"])
for x, y in zip(data["x"], data["y"]):
    rows = slice(rank * len(x) // 2, (rank + 1) * len(x) // 2)
    torch.nn.functional.mse_loss(model(x[rows]), y[rows]).backward()
    assert bool(apply_gradients(state)[1])
    optimizer.zero_grad()
out = state.state_dict()
if rank == 0:
    torch.save(out, job["out"])
dist.destroy_process_group()
"""


def test_fused_update_on_two_fsdp_ranks_matches_one_process(tmp_path):
    """The update under FSDP2 over two gloo ranks: the operator on each
    rank's local shards and on the replicated parameters, the global norm
    over both, against one process's update on all the rows: parameters,
    moments and the EMA within 1e-6 relative (the ranks reduce their
    gradients in another order)."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    gen = torch.Generator().manual_seed(6)
    model = torch.nn.Sequential(torch.nn.Linear(16, 128), torch.nn.SiLU(),
                                torch.nn.Linear(128, 8))
    data = {"params": {k: v.clone() for k, v in model.state_dict().items()},
            "x": [torch.randn(8, 16, generator=gen) for _ in range(2)],
            "y": [torch.randn(8, 8, generator=gen) for _ in range(2)]}
    torch.save(data, tmp_path / "data.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    job = dict(port=port, data=str(tmp_path / "data.pt"), out=str(tmp_path / "out.pt"),
               min_size=1024, lr=LR, wd=0.01, rates=["0.99"])
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS, json.dumps(job)],
                              env=dict(os.environ, RANK=str(r), PYTHONPATH=str(root),
                                       OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    got = torch.load(tmp_path / "out.pt")
    assert got["adam"]["count"] == got["schedule_count"] == got["step"] == 2

    optimizer, schedule = make_optimizer(model.parameters(), LR, 0.01, lr_anneal_steps=10)
    state = init_train_state(model, optimizer, schedule, ["0.99"])
    for x, y in zip(data["x"], data["y"]):
        halves = [torch.nn.functional.mse_loss(model(x[r * 4:(r + 1) * 4]), y[r * 4:(r + 1) * 4])
                  for r in range(2)]
        (sum(halves) / 2).backward()  # FSDP2 averages the ranks' gradients
        apply_gradients(state)
        optimizer.zero_grad()
    want = state.state_dict()
    for key, g, w in [("params", got["params"], want["params"]),
                      ("exp_avg", got["adam"]["exp_avg"], want["adam"]["exp_avg"]),
                      ("exp_avg_sq", got["adam"]["exp_avg_sq"], want["adam"]["exp_avg_sq"]),
                      ("ema", got["ema"]["0.99"], want["ema"]["0.99"])]:
        assert set(g) == set(w)
        err = torch.cat([(g[k] - w[k]).reshape(-1) for k in w]).norm()
        assert err <= 1e-6 * torch.cat([v.reshape(-1) for v in w.values()]).norm(), key
    moved = max((got["params"][k] - v).abs().max().item() for k, v in data["params"].items())
    assert moved > 1e-4
