"""Checkpoint save and resume with the run's config (counterpart of
lfvdm_tpu/training/checkpoint.py).

A checkpoint is the plain train state of ``TrainState.state_dict()``:
{params, ema: {rate: params}, adam: {count, exp_avg, exp_avg_sq},
schedule_count, step}, every tensor keyed by the model's parameter names.
Layout (``torch.save``, loaded with ``weights_only=True``):

  <dir>/config.json                 the run config (written once)
  <dir>/<step>/params.pt            the raw parameters
  <dir>/<step>/ema_<rate>.pt        one file per EMA rate
  <dir>/<step>/train_state.pt       Adam moments, counts and step

so that an eval loads one weight copy without reading the rest. Each EMA
copy is written and read at its stored dtype (bf16 under
``LFVDM_BF16_EMA``, else f32). In a
``torch.distributed`` group rank 0 writes (the state holds full tensors, the
same on every rank) and every rank waits at a barrier; each rank reads the
files itself on resume, so a run saved by N ranks resumes under any other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..utils.device import process_index_and_count


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _write_config(ckpt_dir: str, config: Optional[Dict]):
    path = os.path.join(ckpt_dir, "config.json")
    if config is not None and not os.path.exists(path):
        with open(path, "w") as f:
            json.dump({k: v for k, v in config.items()
                       if isinstance(v, (str, int, float, bool, list, tuple, type(None)))},
                      f, indent=2)


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    config: Optional[Dict] = None):
    """Save a train state at <ckpt_dir>/<step> (replacing one there); write
    config.json beside it if there is none yet. In a group every rank calls
    it: rank 0 writes, and all return once the files are in place."""
    rank, count = process_index_and_count()
    if rank == 0:
        _write(os.path.abspath(ckpt_dir), step, state, config)
    if count > 1:
        import torch.distributed as dist

        dist.barrier()


def _write(ckpt_dir: str, step: int, state: Dict[str, Any], config: Optional[Dict]):
    os.makedirs(ckpt_dir, exist_ok=True)
    _write_config(ckpt_dir, config)
    final = os.path.join(ckpt_dir, str(step))
    tmp = final + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_cpu(state["params"]), os.path.join(tmp, "params.pt"))
    for rate, params in state["ema"].items():
        torch.save(_cpu(params), os.path.join(tmp, f"ema_{rate}.pt"))
    torch.save({"adam": _cpu(state["adam"]), "schedule_count": int(state["schedule_count"]),
                "step": int(state["step"]), "ema_rates": list(state["ema"])},
               os.path.join(tmp, "train_state.pt"))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def find_latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest <step> directory under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]):
    ckpt_dir = os.path.abspath(ckpt_dir)
    if step is None:
        step = find_latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return ckpt_dir, step, os.path.join(ckpt_dir, str(step))


def load_config(ckpt_dir: str) -> Dict:
    with open(os.path.join(os.path.abspath(ckpt_dir), "config.json")) as f:
        return json.load(f)


def _config_or_empty(ckpt_dir: str) -> Dict:
    path = os.path.join(ckpt_dir, "config.json")
    return load_config(ckpt_dir) if os.path.exists(path) else {}


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None):
    """Restore (state, step, config) on the CPU; step None = the latest."""
    ckpt_dir, step, path = _step_dir(ckpt_dir, step)
    rest = _load(os.path.join(path, "train_state.pt"))
    state = {"params": _load(os.path.join(path, "params.pt")),
             "ema": {rate: _load(os.path.join(path, f"ema_{rate}.pt"))
                     for rate in rest["ema_rates"]},
             "adam": rest["adam"], "schedule_count": rest["schedule_count"],
             "step": rest["step"]}
    return state, step, _config_or_empty(ckpt_dir)


def load_ema_params(ckpt_dir: str, step: Optional[int] = None, rate: Optional[str] = None):
    """Restore ONE weight copy: the EMA at ``rate`` (default: the largest
    rate saved), or the raw parameters when ``rate="raw"`` or no EMA was
    saved, as f32 tensors, the parameters' dtype (a bf16 EMA copy is
    widened). Returns (params, picked rate or None, step, config)."""
    ckpt_dir, step, path = _step_dir(ckpt_dir, step)
    rates = sorted(f[len("ema_"):-len(".pt")] for f in os.listdir(path)
                   if f.startswith("ema_") and f.endswith(".pt"))
    if rates and str(rate) != "raw":
        picked = str(rate) if rate is not None else rates[-1]
        if picked not in rates:
            raise ValueError(f"EMA rate {picked} not in checkpoint ({rates})")
        params = {k: v.float() for k, v in _load(os.path.join(path, f"ema_{picked}.pt")).items()}
        # EMA(r) after N steps still weights the step-0 random init by r^N.
        init_frac = float(picked) ** max(step, 0)
        if init_frac > 0.05:
            print(f"WARNING: EMA({picked}) at step {step} still carries {init_frac:.0%} of "
                  "the INITIAL RANDOM weights — for short-horizon checkpoints sample "
                  "rate='raw' instead")
    else:
        picked = None
        params = _load(os.path.join(path, "params.pt"))
    return params, picked, step, _config_or_empty(ckpt_dir)
