"""A ``torchrun``-style launch of the port's entry points: each process joins
the ``torch.distributed`` group the environment describes (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and takes the
card ``LOCAL_RANK`` names.

Two ``gloo`` processes on the CPU run ``video_sample.main`` on the tiny 64 px
reference ``.pt`` of test_torch_cli.py: the ranks write disjoint interleaved
shares of the videos whose union is every index. Then ``video_train.main``
raises on both ranks, naming ROADMAP A5 (data parallelism), and both exit.
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

from lfvdm_tpu_torch.utils import device as device_lib
from test_torch_cli import CFG64, SAMPLE_ARGS, TRAIN_ARGS, write_reference_pt

ROOT = Path(__file__).resolve().parents[1]

RANK_MAIN = """
import json, sys
from lfvdm_tpu_torch.scripts import video_sample, video_train
from lfvdm_tpu_torch.utils.device import process_index_and_count
run = video_sample.main(json.loads(sys.argv[1]))
out = {"group": process_index_and_count(), "written": [p.name for p in run["written"]]}
try:
    video_train.main(json.loads(sys.argv[2]))
    out["train"] = "trained"
except NotImplementedError as e:
    out["train"] = str(e)
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_shard_sampling_and_refuse_training(tmp_path):
    pt = tmp_path / "model.pt"
    write_reference_pt(pt, CFG64, dataset="synthetic", max_frames=4)
    sample_argv = [str(pt)] + SAMPLE_ARGS + ["--stop_index", "5",
                                             "--eval_dir", str(tmp_path / "ev")]
    train_argv = TRAIN_ARGS + ["--max_steps", "1", "--sample_interval", "0",
                               "--checkpoint_dir", str(tmp_path / "run")]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, json.dumps(sample_argv), json.dumps(train_argv)],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out[-3000:] + err[-3000:]
            results.append(json.loads(line[0][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert [r["group"] for r in results] == [[0, 2], [1, 2]]
    assert [r["written"] for r in results] == [
        ["sample_0000-0.npy", "sample_0002-0.npy", "sample_0004-0.npy"],
        ["sample_0001-0.npy", "sample_0003-0.npy"]]
    files = sorted(p.name for p in (tmp_path / "ev").rglob("sample_*.npy"))
    assert files == [f"sample_{i:04d}-0.npy" for i in range(5)]
    for rank, r in enumerate(results):
        assert "A5" in r["train"] and f"rank {rank} of 2" in r["train"], r["train"]
    assert not (tmp_path / "run").exists()


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
