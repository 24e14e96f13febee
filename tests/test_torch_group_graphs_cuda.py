"""The captured train step under data parallelism on the card: a
``TrainProgram`` (``training/graphs.py``) on a model wrapped by DDP or FSDP2,
with NCCL's collectives inside the graph.

Marked ``cuda``: each test skips without a CUDA device. On a machine with a
card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_graphs_cuda.py

In a NCCL group of one (this process) on one card, at the tiny config in
f32 with cuDNN's deterministic algorithms, from two identical states and one
set of draws, through DDP and through FSDP2 on a (1, 1) mesh: the program's
steps (its eager steps, the captured one, then replays) equal the eager
``train_step``'s bitwise after each step (metrics, parameters, Adam moments
and count, every EMA copy); every replay makes no host sync and launches
what an eager step launches; a NaN batch replayed leaves every bit of the
state; a state loaded between replays is what the next replay reads. The
same over two cards (two NCCL processes, DDP and FSDP2 with fsdp 2), where
the machine has two.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.models.unet import set_dropout_generator
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.parallel import mesh as mesh_lib
from lfvdm_tpu_torch.parallel import sharding
from lfvdm_tpu_torch.training.graphs import TrainProgram, eager_steps_before_capture
from lfvdm_tpu_torch.training.train_loop import (
    TrainLoop, draw_noise, init_train_state, make_optimizer, train_step)
from test_torch_train_graphs_cuda import (
    RATES, assert_metrics_bitwise, bits, cuda, step_inputs)  # noqa: F401  (cuda: a fixture)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
CFG = flagship_config(tiny=True)
B, K = 2, 5
MIN_SIZE = 2**10  # so that FSDP2 with fsdp 2 shards some parameters and replicates others
REPLAYS = 3  # steps replayed after the capture, each held bitwise


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """A NCCL group of one rank (this process) on the first card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def group_state(kind, fsdp=1, anneal=0):
    """A seeded tiny model (every weight perturbed), wrapped over the
    group's (dp, fsdp) mesh: DDP ("ddp") or FSDP2 ("fsdp"); AdamW with
    weight decay and two EMA rates."""
    model, diffusion = create_model_and_diffusion(CFG, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((0.01 * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(3))
    mesh = mesh_lib.make_mesh(fsdp=fsdp, device_type="cuda")
    model = (sharding.wrap_for_training(model, mesh) if kind == "ddp"
             else sharding.shard_model(model, mesh, MIN_SIZE))
    optimizer, schedule = make_optimizer(model.parameters(), 1e-4, 0.1, lr_anneal_steps=anneal)
    return init_train_state(model, optimizer, schedule, RATES), diffusion


def local_tensors(state):
    """(name, this rank's tensor) for every tensor of ``state``: parameters,
    moments and EMA copies (FSDP2's local shards), and the counts."""
    out = [("adam/count", state.optimizer.count)]
    for name, p in state.named_params():
        st = state.optimizer.state[p]
        out += [(f"params/{name}", sharding.local(p.detach())),
                (f"exp_avg/{name}", sharding.local(st["exp_avg"])),
                (f"exp_avg_sq/{name}", sharding.local(st["exp_avg_sq"]))]
        out += [(f"ema/{r}/{name}", sharding.local(c[name])) for r, c in state.ema.items()]
    return out


def bitwise_diffs(a, b):
    """The names whose tensors differ in any bit, of two ``local_tensors``."""
    return [n for (n, x), (_, y) in zip(a, b) if not torch.equal(bits(x), bits(y))]


def group_captured_against_eager(kind, fsdp=1, rank=0, anneal=0):
    """A program's steps (its eager steps, the captured one, REPLAYS
    replays) against ``train_step`` from twin states and one set of draws
    per step, bitwise after each; every replay under
    ``set_sync_debug_mode("error")`` and launching what the eager step
    launched. Returns (program, captured state, eager state, diffusion,
    the launch counts of a replay, the first step's noise)."""
    eager, diffusion = group_state(kind, fsdp, anneal)
    captured, _ = group_state(kind, fsdp, anneal)
    noise_gen = torch.Generator(device="cuda").manual_seed(11 + rank)
    program, counts = None, None
    steps = eager_steps_before_capture(captured.model) + 1 + REPLAYS
    for i in range(steps):
        batch, t, w = step_inputs(CFG, B, K, seed=100 * rank + 20 + i)
        noise = draw_noise(noise_gen, batch["x0"])
        ops.reset_launch_counts()
        want = train_step(eager, batch, t, w, diffusion=diffusion, noise=noise)
        eager_counts = ops.launch_counts()
        if program is None:
            program = TrainProgram(captured, diffusion, batch)
        replay = program.graph is not None
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        if replay:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = program.run(batch, t, w, noise)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if replay:
            counts = ops.launch_counts()
            assert counts == eager_counts and all(counts.values()), (counts, eager_counts)
        assert_metrics_bitwise(got, want)
        diffs = bitwise_diffs(local_tensors(captured), local_tensors(eager))
        assert not diffs, (i, diffs[:10])
        assert captured.step == eager.step == i + 1
    assert program.graph is not None and program.eager_steps_run == program.eager_steps
    return program, captured, eager, diffusion, counts, noise


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_group_step_kind_is_captured(cuda, group, kind, tmp_path):
    model, diffusion = create_model_and_diffusion(CFG, device="cuda", seed=0)
    mesh = mesh_lib.make_mesh(fsdp=1, device_type="cuda")
    if kind == "fsdp":
        model = sharding.shard_model(model, mesh)
    loop = TrainLoop(model=model, diffusion=diffusion, data=iter(()), batch_size=B,
                     max_frames=K, lr=1e-4, checkpoint_dir=str(tmp_path), mesh=mesh)
    wrapped = sharding.is_sharded(loop.model) or sharding.unwrap(loop.model) is not loop.model
    assert wrapped and loop.step_kind == "captured"


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_captured_group_steps_are_the_eager_steps_bitwise(cuda, group, kind):
    program, _, _, _, counts, _ = group_captured_against_eager(kind, anneal=20)
    assert program.eager_steps == (10 if kind == "ddp" else 0)
    assert program.capture_s > 0 and counts


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_group_nonfinite_replay_and_load_between_replays(cuda, group, kind):
    """A NaN batch replayed leaves every bit of the state as it was, with
    skipped_nonfinite 1 and no host sync; after ``load_state_dict`` of the
    eager twin's state one step on, the next replay steps from it as the
    eager step does."""
    program, state, other, diffusion, _, noise = group_captured_against_eager(kind, anneal=20)
    batch, t, w = step_inputs(CFG, B, K, seed=40)
    batch["x0"][0, 0, 0, 0, 0] = float("nan")
    before = [(n, v.clone()) for n, v in local_tensors(state)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = program.run(batch, t, w, noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m["skipped_nonfinite"].item() == 1.0 and not torch.isfinite(m["grad_norm"])
    assert not bitwise_diffs(local_tensors(state), before)

    batch, t, w = step_inputs(CFG, B, K, seed=41)
    train_step(other, batch, t, w, diffusion=diffusion, noise=noise)
    state.load_state_dict(other.state_dict())
    batch, t, w = step_inputs(CFG, B, K, seed=42)
    want = train_step(other, batch, t, w, diffusion=diffusion, noise=noise)
    got = program.run(batch, t, w, noise)
    assert_metrics_bitwise(got, want)
    assert not bitwise_diffs(local_tensors(state), local_tensors(other))


# One rank of the two-card test: joins the NCCL group the environment
# describes and runs the group case (DDP, then FSDP2 with fsdp 2).
TWO_CARD_RANK = r"""
import json, os, sys
sys.path.insert(0, os.environ["TESTS_DIR"])
import torch, torch.distributed as dist
from lfvdm_tpu_torch.utils.device import resolve_device, setup_distributed
device = resolve_device("cuda")
setup_distributed(device)
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
import test_torch_group_graphs_cuda as case
rank = dist.get_rank()
out = {}
for kind, fsdp in (("ddp", 1), ("fsdp", 2)):
    program = case.group_captured_against_eager(kind, fsdp=fsdp, rank=rank)[0]
    out[kind] = {"eager_steps": program.eager_steps, "captured": program.graph is not None}
    del program
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def test_two_cards_captured_group_steps_are_bitwise(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA devices, this machine has {torch.cuda.device_count()}")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), TESTS_DIR=str(ROOT / "tests"))
        procs.append(subprocess.Popen([sys.executable, "-c", TWO_CARD_RANK], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert p.returncode == 0 and line, out[-3000:] + err[-6000:]
            results.append(json.loads(line[0][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for r in results:
        assert r == {"ddp": {"eager_steps": 10, "captured": True},
                     "fsdp": {"eager_steps": 0, "captured": True}}
