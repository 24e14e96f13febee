"""KV metrics logger, single-process (counterpart of lfvdm_tpu/utils/logger.py).

An OpenAI-baselines-style KV store: ``logkv`` (last value), ``logkv_mean``
(running mean), ``dumpkvs`` (print, then clear). The JAX package reduces the
KVs across processes and can also write JSONL and wandb; the port trains on
one card and prints them as they are.
"""

from __future__ import annotations

import time


class Logger:
    def __init__(self):
        self.name2val: dict = {}
        self.name2cnt: dict = {}
        self._start_time = time.time()

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val.get(key, 0.0), self.name2cnt.get(key, 0)
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> dict:
        """Emit and clear the KVs; returns what was emitted."""
        out = dict(self.name2val)
        scalars = {k: v for k, v in out.items() if isinstance(v, (int, float))}
        if scalars:
            line = " | ".join(f"{k} {v:.5g}" for k, v in sorted(scalars.items()))
            print(f"[{time.time() - self._start_time:8.1f}s] {line}", flush=True)
        self.name2val.clear()
        self.name2cnt.clear()
        return out


logger = Logger()
