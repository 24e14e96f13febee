#!/usr/bin/env python3
"""Which conditions a captured train step under DDP and FSDP2 needs on the
installed PyTorch, NCCL and card.

    python3 tools/group_capture_probe.py [--variants NAME ...]

Each variant runs in a process of its own (a capture that fails can leave
NCCL or the CUDA context unusable): a NCCL group of one rank on the first
card, the tiny config in f32 with cuDNN's deterministic algorithms, and
``tests/test_torch_group_graphs_cuda.py``'s ``group_captured_against_eager``
(a ``TrainProgram``'s eager steps, its capture and three replays, each held
bitwise against ``train_step`` on a twin state). The variants:

  ddp                 as the port runs it: DDP built on the capture stream,
                      ``DDP_EAGER_ITERATIONS`` (11) eager iterations;
  ddp_10_iterations   one eager iteration fewer;
  ddp_default_stream  DDP built on the default stream;
  fsdp                FSDP2 on a (1, 1) mesh, the warm-up alone;
  remat_dropout       one card, no group: dropout 0.1 under
                      ``use_checkpoint`` (``test_torch_train_graphs_cuda.py``'s
                      ``captured_against_eager``, three steps).

Every capture runs in ``torch.cuda.graph``'s default "global" error mode
with ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` as the environment leaves it.
Prints the versions, then one JSON line per variant (ok, or the error);
each variant's output goes to ``results/group_capture_probe.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = ("ddp", "ddp_10_iterations", "ddp_default_stream", "fsdp", "remat_dropout")

CHILD = r"""
import contextlib, json, sys, time, traceback
sys.path[:0] = [ROOT, ROOT + "/tests"]
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from lfvdm_tpu_torch.parallel import sharding
from lfvdm_tpu_torch.training import graphs
out = {"variant": VARIANT}
t0 = time.perf_counter()
try:
    if VARIANT == "remat_dropout":
        import test_torch_train_graphs_cuda as case
        from lfvdm_tpu_torch.config import flagship_config
        cfg = dict(flagship_config(tiny=True), dropout=0.1, use_checkpoint=True)
        program = case.captured_against_eager(cfg, B=2, K=5, steps=3)[0]
        out["rematerialised_draws"] = len(program.streams.calls)
    else:
        import test_torch_group_graphs_cuda as case
        if VARIANT == "ddp_10_iterations":
            graphs.DDP_EAGER_ITERATIONS = 10
        if VARIANT == "ddp_default_stream":
            sharding.on_capture_stream = lambda device: contextlib.nullcontext()
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="tcp://localhost:%d" % PORT, rank=0,
                                world_size=1)
        program = case.group_captured_against_eager(VARIANT.split("_")[0], anneal=20)[0]
        out["eager_steps"] = program.eager_steps
        dist.destroy_process_group()
    out["ok"], out["capture_s"] = True, program.capture_s
except Exception as e:
    out["ok"] = False
    out["error"] = (type(e).__name__ + ": " + str(e))[:600]
    traceback.print_exc()
out["s"] = time.perf_counter() - t0
print("RESULT " + json.dumps(out), flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("group_capture_probe: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "TORCH_NCCL_ASYNC_ERROR_HANDLING":
                          os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"),
                      "nvidia_smi": card.strip().splitlines()[0]}), flush=True)
    (ROOT / "results").mkdir(exist_ok=True)
    with open(ROOT / "results" / "group_capture_probe.log", "w") as log:
        for variant in args.variants:
            code = (CHILD.replace("ROOT", repr(str(ROOT))).replace("VARIANT", repr(variant))
                    .replace("PORT", str(free_port())))
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                               timeout=600, cwd=ROOT)
            log.write(f"==== {variant}: exit {p.returncode}\n{p.stdout}\n{p.stderr}\n")
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
            row = (json.loads(lines[0][len("RESULT "):]) if lines
                   else {"variant": variant, "ok": False, "exit": p.returncode})
            row["wall_s"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
