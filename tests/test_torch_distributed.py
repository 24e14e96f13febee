"""A ``torchrun``-style launch of the port: each process joins the
``torch.distributed`` group the environment describes (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and takes the
card ``LOCAL_RANK`` names.

Two ``gloo`` processes on the CPU, launched once for every case
(``OMP_NUM_THREADS=2``):

- ``video_sample.main`` on the tiny 64 px reference ``.pt`` of
  test_torch_cli.py: the ranks write disjoint interleaved shares of the
  videos whose union is every index;
- ``video_train.main`` for 2 steps under DDP: one run id and one run
  directory, rank 0 alone writes the checkpoints; its vis sampler, called
  after the run, writes gifs on rank 0 and returns None on rank 1;
- one train step of the tiny U-Net at B=1 per rank under DDP and under
  FSDP2 (fsdp 2, some parameters sharded and some replicated), and at B=2
  per rank in two microbatches under FSDP2, each against one process's step
  on the same rows and injected noise (B=2, and B=4 in two chunks):
  parameters, Adam moments and every EMA within 1e-6 relative;
- each case again through a ``TrainProgram`` on the wrapped model (its CPU
  route, ``step_body`` on its buffers) for two steps, against
  ``train_step`` on a twin loop bitwise after each; its state after the
  first against one process's step, and, for FSDP2 over the two ranks,
  against the JAX package's jitted step over a (1, 2) mesh of two CPU
  devices (params placed by ``fsdp_param_sharding``, the batch by
  ``shard_batch``, JAX's noise injected into the port) within
  test_torch_train_graphs.py's tolerances; ``step_kind`` is "eager" on the
  CPU and "captured" on a card, wrapped or not;
- the loss-aware sampler: both ranks hold the weights of one process's
  ``update_with_all_losses`` on the rows in rank order;
- the FSDP2 run saved by the two ranks resumes in one process, and one
  process's save resumes under the two ranks, bitwise.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.parallel import mesh as j_mesh
from lfvdm_tpu.parallel import sharding as j_sharding
from lfvdm_tpu.training.train_loop import init_train_state as j_init_train_state
from lfvdm_tpu.training.train_loop import make_optimizer as j_make_optimizer
from lfvdm_tpu.training.train_loop import make_train_step
from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
from lfvdm_tpu_torch.diffusion.resample import LossSecondMomentResampler
from lfvdm_tpu_torch.training import checkpoint as ckpt_lib
from lfvdm_tpu_torch.training.train_loop import TrainLoop, train_step
from lfvdm_tpu_torch.utils import device as device_lib
from test_torch_cli import CFG64, SAMPLE_ARGS, TRAIN_ARGS, write_reference_pt
from test_torch_train_graphs import assert_state_matches, jax_noise
from test_torch_training import jax_params

ROOT = Path(__file__).resolve().parents[1]
CFG = flagship_config(tiny=True)
K, LR, WD, RATES, MIN_SIZE = 4, 1e-3, 0.1, "0.9999,0.9", 2**10

# Each rank: the entry points, then the train-step cases on its rows of the
# inputs the parent wrote. State dicts are gathered on every rank and saved
# by rank 0.
RANK_MAIN = r"""
import json, os, sys
import numpy as np, torch
from lfvdm_tpu_torch.scripts import video_sample, video_train
from lfvdm_tpu_torch.training import checkpoint as ckpt_lib, vis_sampling
from lfvdm_tpu_torch.utils.device import process_index_and_count
job = json.loads(sys.argv[1])
writes, gifs = [], []
real_write, real_gif = ckpt_lib._write, vis_sampling.tensor2gif
ckpt_lib._write = lambda d, step, *a: (writes.append(step), real_write(d, step, *a))[1]
vis_sampling.tensor2gif = lambda v, path, **kw: (gifs.append(path), real_gif(v, path, **kw))[1]

run = video_sample.main(job["sample_argv"])
rank, world = process_index_and_count()
out = {"group": [rank, world], "written": [p.name for p in run["written"]]}
loop = video_train.main(job["train_argv"])
out["train"] = {"dir": os.path.relpath(loop.checkpoint_dir), "step": loop.step,
                "writes": list(writes), "gifs": len(gifs)}
out["vis_returned"] = loop.sample_fn(loop) is not None
out["vis_gifs"] = len(gifs)

from lfvdm_tpu_torch.config import create_model_and_diffusion
from lfvdm_tpu_torch.diffusion.resample import LossSecondMomentResampler
from lfvdm_tpu_torch.training.graphs import TrainProgram
from lfvdm_tpu_torch.training.train_loop import TrainLoop, train_step
inputs = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}

def equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b

def new_loop(fsdp, rows, **kw):
    model, diffusion = create_model_and_diffusion(job["cfg"], device="cpu")
    model.load_state_dict(torch.load(job["params"]))
    return TrainLoop(model=model, diffusion=diffusion, data=iter(()), batch_size=len(rows),
                     max_frames=job["K"], lr=job["lr"], weight_decay=job["wd"],
                     ema_rate=job["rates"], fsdp=fsdp, fsdp_min_size=job["min_size"], **kw)

for case, (fsdp, size, micro) in job["cases"].items():
    rows = slice(rank * size, (rank + 1) * size)
    loop = new_loop(fsdp, range(size), microbatch=micro,
                    checkpoint_dir=os.path.join(job["out"], case))
    x = {f: inputs[f"{case}_{f}"][rows]
         for f in ("x0", "frame_indices", "obs_mask", "latent_mask", "t", "w", "noise")}
    train_step(loop.state, {f: x[f] for f in ("x0", "frame_indices", "obs_mask", "latent_mask")},
               x["t"], x["w"], diffusion=loop.diffusion, noise=x["noise"],
               n_microbatches=loop.n_microbatches)
    state = loop.state.state_dict()
    if rank == 0:
        torch.save(state, os.path.join(job["out"], case + ".pt"))
    loop.save()
    # The same case through a TrainProgram (its CPU route) and through
    # train_step on a twin loop, two steps.
    eager, prog = (new_loop(fsdp, range(size), microbatch=micro,
                            checkpoint_dir=os.path.join(job["out"], case + "_program"))
                   for _ in range(2))
    kinds = [prog.step_kind]
    prog.device = torch.device("cuda")  # the rule alone: the model stays on the CPU
    kinds.append(prog.step_kind)
    prog.device = torch.device("cpu")
    program, bitwise = None, []
    for s in (1, 2):
        x = {f: inputs[f"{case}_p{s}_{f}"][rows]
             for f in ("x0", "frame_indices", "obs_mask", "latent_mask", "t", "w", "noise")}
        batch = {f: x[f] for f in ("x0", "frame_indices", "obs_mask", "latent_mask")}
        if program is None:
            program = TrainProgram(prog.state, prog.diffusion, batch,
                                   n_microbatches=prog.n_microbatches)
        want = train_step(eager.state, batch, x["t"], x["w"], diffusion=eager.diffusion,
                          noise=x["noise"], n_microbatches=eager.n_microbatches)
        got = program.run(batch, x["t"], x["w"], x["noise"])
        a, b = prog.state.state_dict(), eager.state.state_dict()
        bitwise.append(equal(a, b) and set(got) == set(want)
                       and all(torch.equal(got[k], want[k]) for k in want))
        if s == 1 and rank == 0:
            torch.save(a, os.path.join(job["out"], f"program_{case}.pt"))
    out.setdefault("program", {})[case] = {
        "bitwise": bitwise, "step_kinds": kinds, "wrapper": type(prog.model).__name__,
        "steps": [prog.state.step, eager.state.step]}
resumed = new_loop(2, range(1), checkpoint_dir=job["one_process_run"], resume=True)
state = resumed.state.state_dict()
if rank == 0:
    torch.save(state, os.path.join(job["out"], "resumed_under_two.pt"))

sampler = LossSecondMomentResampler(loop.diffusion)
for ts, losses in zip(job["sampler_ts"], job["sampler_losses"]):
    sampler.update_with_local_losses(np.array(ts[rank]), np.array(losses[rank]))
out["sampler"] = [sampler._loss_history.tolist(), sampler._loss_counts.tolist()]
print("RESULT " + json.dumps(out), flush=True)
"""

# case: (fsdp, rows per rank, microbatch)
CASES = {"ddp": (1, 1, -1), "fsdp": (2, 1, -1), "fsdp_micro": (2, 2, 1)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    obs = np.zeros((n, K, 1, 1, 1), np.float32)
    obs[:, :1] = 1
    return {"x0": rng.uniform(-1, 1, (n, K, C, S, S)).astype(np.float32),
            "frame_indices": np.sort(rng.permutation(10)[:K])[None].repeat(n, 0),
            "obs_mask": obs, "latent_mask": 1 - obs,
            "t": rng.integers(0, CFG["diffusion_steps"], n), "w": rng.uniform(0.5, 1.5, n)
            .astype(np.float32), "noise": rng.standard_normal((n, K, C, S, S)).astype(np.float32)}


def program_key(case):
    """The JAX key whose noise the program's first step of ``case`` takes."""
    return jax.random.PRNGKey(30 + list(CASES).index(case))


def _one_process_state(params, inputs, case, tmp_path, n_micro=1):
    """One process's step on every row of ``case``'s inputs (a key of
    ``inputs``' prefix); its loop."""
    model, diffusion = create_model_and_diffusion(CFG, device="cpu")
    model.load_state_dict(params)
    n = len(inputs[case + "_x0"])
    loop = TrainLoop(model=model, diffusion=diffusion, data=iter(()), batch_size=n,
                     max_frames=K, lr=LR, weight_decay=WD, ema_rate=RATES,
                     microbatch=n // n_micro, checkpoint_dir=str(tmp_path / f"one_{case}"))
    x = {f: torch.from_numpy(inputs[f"{case}_{f}"])
         for f in ("x0", "frame_indices", "obs_mask", "latent_mask", "t", "w", "noise")}
    train_step(loop.state, {f: x[f] for f in ("x0", "frame_indices", "obs_mask", "latent_mask")},
               x["t"], x["w"], diffusion=diffusion, noise=x["noise"],
               n_microbatches=loop.n_microbatches)
    return loop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_torch_thread):
    tmp = tmp_path_factory.mktemp("ranks")
    pt = tmp / "model.pt"
    write_reference_pt(pt, CFG64, dataset="synthetic", max_frames=4)
    model, _ = create_model_and_diffusion(CFG, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(5)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
              for k, v in model.state_dict().items()}
    torch.save(params, tmp / "params.pt")
    inputs = {}
    for i, (case, (_, size, _)) in enumerate(CASES.items()):
        inputs.update({f"{case}_{k}": v for k, v in _batch(2 * size, i).items()})
        first = _batch(2 * size, 10 + i)  # the program's steps; the first with JAX's noise
        first["noise"] = np.array(jax_noise(program_key(case), first["x0"].shape))
        inputs.update({f"{case}_p1_{k}": v for k, v in first.items()})
        inputs.update({f"{case}_p2_{k}": v for k, v in _batch(2 * size, 20 + i).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "out").mkdir()
    one = _one_process_state(params, inputs, "ddp", tmp)  # a one-process run to resume
    one.save()
    rng = np.random.default_rng(9)
    steps = CFG["diffusion_steps"]
    job = dict(sample_argv=[str(pt)] + SAMPLE_ARGS + ["--stop_index", "5",
                                                      "--eval_dir", str(tmp / "ev")],
               train_argv=TRAIN_ARGS + ["--max_steps", "2", "--sample_interval", "1000"],
               cfg=CFG, K=K, lr=LR, wd=WD, rates=RATES, min_size=MIN_SIZE, cases=CASES,
               inputs=str(tmp / "inputs.npz"), params=str(tmp / "params.pt"),
               out=str(tmp / "out"), one_process_run=one.checkpoint_dir,
               sampler_ts=[rng.integers(0, steps, (2, 12)).tolist() for _ in range(2)],
               sampler_losses=[rng.uniform(0, 1, (2, 12)).tolist() for _ in range(2)])
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, json.dumps(job)], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out[-3000:] + err[-3000:]
            results.append(json.loads(line[0][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return dict(results=results, tmp=tmp, job=job, params=params, inputs=inputs, one=one)


def _assert_states_close(got, want, rtol, moments_rtol):
    """Both Adam moments (after one step, the reduced gradient g as 0.1·g and
    0.001·g²) within ``moments_rtol``, the parameters and every EMA within
    ``rtol``: each a relative L2 distance over all its tensors. Where |g| < 1e-6 the gradient is f32 cancellation residue of an
    exact 0 (in the tiny config each conv bias that feeds a one-channel
    GroupNorm group), and Adam's first step lr·g/(|g| + eps) is noise: there
    the parameters and EMAs are held to one step, lr."""
    assert got["adam"]["count"] == want["adam"]["count"] == 1
    for k in ("exp_avg", "exp_avg_sq"):
        _assert_trees_close(got["adam"][k], want["adam"][k], moments_rtol)
    noise = {k: v.abs() < 1e-7 for k, v in want["adam"]["exp_avg"].items()}
    assert set(got["ema"]) == set(want["ema"])
    for g, w in [(got["params"], want["params"])] + [(got["ema"][r], want["ema"][r])
                                                    for r in want["ema"]]:
        _assert_trees_close({k: v.masked_fill(noise[k], 0) for k, v in g.items()},
                            {k: v.masked_fill(noise[k], 0) for k, v in w.items()}, rtol)
        assert max((g[k] - w[k]).abs().max().item() for k in w) <= LR


def _assert_trees_close(got, want, rtol):
    assert set(got) == set(want)
    diff = torch.cat([(got[k] - want[k]).reshape(-1) for k in want])
    err = diff.norm() / torch.cat([v.reshape(-1) for v in want.values()]).norm()
    assert err <= rtol, err.item()


def test_two_gloo_ranks_shard_sampling_and_refuse_training(ranks):
    """Sampling shards by rank; training now runs on both ranks (the refusal
    is gone): one run directory, which rank 0 alone writes."""
    results, tmp = ranks["results"], ranks["tmp"]
    assert [r["group"] for r in results] == [[0, 2], [1, 2]]
    assert [r["written"] for r in results] == [
        ["sample_0000-0.npy", "sample_0002-0.npy", "sample_0004-0.npy"],
        ["sample_0001-0.npy", "sample_0003-0.npy"]]
    files = sorted(p.name for p in (tmp / "ev").rglob("sample_*.npy"))
    assert files == [f"sample_{i:04d}-0.npy" for i in range(5)]
    train = [r["train"] for r in results]
    assert train[0]["dir"] == train[1]["dir"] and train[0]["step"] == train[1]["step"] == 2
    assert os.listdir(tmp / "checkpoints") == [os.path.basename(train[0]["dir"])]
    assert [t["writes"] for t in train] == [[0, 2], []]  # the saves at steps 0 and 2
    run_dir = tmp / train[0]["dir"]
    assert ckpt_lib.find_latest_step(str(run_dir)) == 2
    assert (run_dir / "config.json").exists() and (run_dir / "metrics.jsonl").exists()


def test_vis_sampling_writes_on_rank_0_and_returns_on_rank_1(ranks):
    results, tmp = ranks["results"], ranks["tmp"]
    # The sampler ran once, after the 2 steps: 2 videos.
    assert [r["train"]["gifs"] for r in results] == [0, 0]
    assert [r["vis_gifs"] for r in results] == [2, 0]
    assert [r["vis_returned"] for r in results] == [True, False]
    assert len(list((tmp / results[0]["train"]["dir"] / "vis").glob("*.gif"))) == 2


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_one_process(ranks, case, tmp_path):
    got = torch.load(ranks["tmp"] / "out" / f"{case}.pt")
    n_micro = 2 if CASES[case][2] > 0 else 1
    want = _one_process_state(ranks["params"], ranks["inputs"], case, tmp_path, n_micro)
    # The gradients to 5e-6: on the CPU the U-Net's f32 output for a row
    # moves by ~1e-6 with the batch it is in, and one rank's batch is half
    # the one process's.
    _assert_states_close(got, want.state.state_dict(), rtol=1e-6, moments_rtol=5e-6)
    moved = max((got["params"][k] - v).abs().max().item() for k, v in ranks["params"].items())
    assert moved > 1e-4  # a step of lr 1e-3 is far above the tolerance


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_program_is_train_step_bitwise(ranks, case):
    """The program's CPU route on the wrapped model equals ``train_step`` on
    a twin loop, state and metrics, after each of two steps; the rule of
    ``step_kind`` ignores the wrapper."""
    for r in ranks["results"]:
        got = r["program"][case]
        assert got["bitwise"] == [True, True] and got["steps"] == [2, 2]
        assert got["step_kinds"] == ["eager", "captured"]
        assert got["wrapper"] == ("DistributedDataParallel" if case == "ddp" else "FSDPUNetVideoModel")


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_program_matches_one_process(ranks, case, tmp_path):
    got = torch.load(ranks["tmp"] / "out" / f"program_{case}.pt")
    inputs = {k.replace(f"{case}_p1_", f"{case}_"): v for k, v in ranks["inputs"].items()
              if k.startswith(f"{case}_p1_")}
    n_micro = 2 if CASES[case][2] > 0 else 1
    want = _one_process_state(ranks["params"], inputs, case, tmp_path, n_micro)
    _assert_states_close(got, want.state.state_dict(), rtol=1e-6, moments_rtol=5e-6)


def test_two_rank_program_matches_jax_mesh_step(ranks):
    """FSDP2 over the two ranks (fsdp 2, parameters under MIN_SIZE elements
    replicated) against ``jax.jit(make_train_step(...))`` over a (1, 2) mesh
    of two CPU devices: the JAX package's params placed by
    ``fsdp_param_sharding`` with the same MIN_SIZE, its batch, t and weights
    by ``shard_batch``, the same seeded weights and rows; the port took the
    noise JAX draws from the step's key. Held within
    test_torch_train_graphs.py's tolerances (1e-5, and one step where JAX's
    gradient is flat, of which the EMA at rate 0.9 takes a tenth)."""
    got = torch.load(ranks["tmp"] / "out" / "program_fsdp.pt")
    x = {k[len("fsdp_p1_"):]: v for k, v in ranks["inputs"].items() if k.startswith("fsdp_p1_")}
    rates = [float(r) for r in RATES.split(",")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LFVDM_PALLAS_SKIPCONV", "xla")
        jmodel, jdiff = j_create(dict(CFG))
        mesh = j_mesh.make_mesh(jax.devices()[:2], fsdp=2)
        assert dict(mesh.shape) == {j_mesh.DP_AXIS: 1, j_mesh.FSDP_AXIS: 2}
        tx = j_make_optimizer(LR, WD)
        params = jax_params()
        placed = jax.device_put(params, j_sharding.fsdp_param_sharding(mesh, params,
                                                                       min_size=MIN_SIZE))
        state = j_init_train_state(placed, tx, rates)
        step = jax.jit(make_train_step(jmodel, jdiff, tx, rates))
        batch = {"x0": x["x0"], "frame_indices": x["frame_indices"].astype(np.int32),
                 "obs_mask": x["obs_mask"], "latent_mask": x["latent_mask"]}
        new, _ = step(state, j_sharding.shard_batch(mesh, batch),
                      j_sharding.put_batch_array(mesh, x["t"].astype(np.int32)),
                      j_sharding.put_batch_array(mesh, x["w"]), program_key("fsdp"))
        sharded = sum(len(leaf.sharding.device_set) == 2 and not leaf.sharding.is_fully_replicated
                      for leaf in jax.tree.leaves(new["params"]))
    assert sharded > 0  # some parameters lay over the fsdp axis
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    assert_state_matches(got, [to_np(state), to_np(new)], lr=LR, wd=WD, ema_flat_steps=True)


def test_two_rank_save_resumes_in_one_process_and_back(ranks):
    out, one = ranks["tmp"] / "out", ranks["one"]
    saved = torch.load(out / "fsdp.pt")
    model, diffusion = create_model_and_diffusion(CFG, device="cpu")
    resumed = TrainLoop(model=model, diffusion=diffusion, data=iter(()), batch_size=1,
                        max_frames=K, lr=LR, weight_decay=WD, ema_rate=RATES,
                        checkpoint_dir=str(out / "fsdp"), resume=True)
    assert _equal(resumed.state.state_dict(), saved) and resumed.step == 0
    assert _equal(torch.load(out / "resumed_under_two.pt"), one.state.state_dict())


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_loss_aware_sampler_gathers_in_rank_order(ranks):
    job, diffusion = ranks["job"], create_model_and_diffusion(CFG, device="cpu")[1]
    want = LossSecondMomentResampler(diffusion)
    for ts, losses in zip(job["sampler_ts"], job["sampler_losses"]):
        want.update_with_all_losses([int(t) for t in np.concatenate(ts)],
                                    [float(x) for x in np.concatenate(losses)])
    alone = LossSecondMomentResampler(diffusion)  # rank 0's rows without the gather
    for ts, losses in zip(job["sampler_ts"], job["sampler_losses"]):
        alone.update_with_local_losses(np.array(ts[0]), np.array(losses[0]))
    for r in ranks["results"]:
        assert r["sampler"] == [want._loss_history.tolist(), want._loss_counts.tolist()]
        assert r["sampler"][0] != alone._loss_history.tolist()


@pytest.fixture
def fake_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_resolve_device_takes_the_local_rank_card(fake_cards):
    assert device_lib.resolve_device("cuda") == torch.device("cuda")
    fake_cards.setenv("WORLD_SIZE", "4")
    fake_cards.setenv("LOCAL_RANK", "3")
    assert device_lib.resolve_device("cuda") == torch.device("cuda", 3)
    assert device_lib.resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert device_lib.resolve_device("cuda:1") == torch.device("cuda", 1)  # asked for by index
    assert device_lib.resolve_device("cpu") == torch.device("cpu")


def test_setup_distributed_joins_only_under_a_launcher(fake_cards):
    calls = []
    fake_cards.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    fake_cards.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    device_lib.setup_distributed(torch.device("cuda"))
    assert calls == []
    fake_cards.setenv("WORLD_SIZE", "2")
    fake_cards.setenv("RANK", "1")
    fake_cards.setenv("LOCAL_RANK", "1")
    device_lib.setup_distributed(device_lib.resolve_device("cuda"))
    assert calls == [("set_device", torch.device("cuda", 1)),
                     (("nccl",), {"init_method": "env://", "rank": 1, "world_size": 2})]
    calls.clear()
    device_lib.setup_distributed(torch.device("cpu"))
    assert calls == [(("gloo",), {"init_method": "env://", "rank": 1, "world_size": 2})]
