"""KV metrics logger with the mean across processes (counterpart of
lfvdm_tpu/utils/logger.py).

An OpenAI-baselines-style KV store: ``logkv`` (last value), ``logkv_mean``
(running mean), ``dumpkvs`` (the count-weighted mean across processes, then
emit and clear). ``configure`` adds the sinks: a ``metrics.jsonl`` in
``log_dir`` and wandb where it is installed (on rank 0 only); stdout always.
In one process the mean across processes is the value itself; with
``torch.distributed`` initialised it is one ``all_reduce`` of (value·count,
count) pairs over the union of every rank's keys (the per-quartile loss keys
differ between ranks).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .device import collective_device, process_index_and_count


def mpi_weighted_mean(local_name2valcount: dict) -> dict:
    """The count-weighted mean across processes of {name: (value, count)};
    a name a rank lacks counts 0 there."""
    if process_index_and_count()[1] == 1:
        return {name: val for name, (val, _count) in local_name2valcount.items()}
    import torch
    import torch.distributed as dist

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, sorted(local_name2valcount))
    names = sorted(set().union(*gathered))
    sums = torch.zeros(len(names), 2, dtype=torch.float64, device=collective_device())
    for i, name in enumerate(names):
        if name in local_name2valcount:
            val, count = local_name2valcount[name]
            sums[i, 0], sums[i, 1] = float(val) * float(count), float(count)
    dist.all_reduce(sums)
    sums = sums.cpu().tolist()
    return {name: s / max(c, 1e-12) for name, (s, c) in zip(names, sums)}


class Logger:
    def __init__(self):
        self.name2val: dict = {}
        self.name2cnt: dict = {}
        self._nondistributed: set = set()
        self._jsonl_path: Optional[str] = None
        self._use_wandb = False
        self._start_time = time.time()

    def configure(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                  wandb_kwargs: Optional[dict] = None):
        """Write ``metrics.jsonl`` into ``log_dir`` and, with ``use_wandb``,
        log to wandb from rank 0; without wandb installed, say so and keep
        stdout and JSONL."""
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        if use_wandb:
            if process_index_and_count()[0] != 0:
                return
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._use_wandb = True
            except ImportError:
                print("wandb not installed; logging to stdout/JSONL only")

    def logkv(self, key, val, distributed: bool = True):
        self.name2val[key] = val
        if not distributed:
            self._nondistributed.add(key)

    def logkv_mean(self, key, val, distributed: bool = True):
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val.get(key, 0.0), self.name2cnt.get(key, 0)
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1
        if not distributed:
            self._nondistributed.add(key)

    def dumpkvs(self) -> dict:
        """Reduce across processes, emit on rank 0, clear; returns what was
        emitted."""
        reducible = {
            name: (float(val), self.name2cnt.get(name, 1))
            for name, val in self.name2val.items()
            if name not in self._nondistributed and isinstance(val, (int, float))
        }
        out = mpi_weighted_mean(reducible)
        for name in self._nondistributed:
            if name in self.name2val:
                out[name] = self.name2val[name]

        if process_index_and_count()[0] == 0 and out:
            scalars = {k: v for k, v in out.items() if isinstance(v, (int, float))}
            line = " | ".join(f"{k} {v:.5g}" for k, v in sorted(scalars.items()))
            print(f"[{time.time() - self._start_time:8.1f}s] {line}", flush=True)
            if self._jsonl_path:
                with open(self._jsonl_path, "a") as f:
                    f.write(json.dumps({"_time": time.time(), **scalars}) + "\n")
            if self._use_wandb:
                import wandb

                wandb.log(out)

        self.name2val.clear()
        self.name2cnt.clear()
        self._nondistributed.clear()
        return out


logger = Logger()
