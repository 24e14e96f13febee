"""Placement rules and wrappers for data-parallel and FSDP training, and the
row split of single-process evaluation (counterpart of
lfvdm_tpu/parallel/sharding.py).

JAX places each parameter with a ``NamedSharding`` and XLA inserts the
collectives. Here the model is wrapped (``wrap_for_training``):

- ``fsdp == 1``: ``DistributedDataParallel``, a full replica per rank whose
  gradients are averaged over the group (the reference's strategy, and what
  JAX's mesh does with an fsdp axis of one).
- ``fsdp > 1``: FSDP2 (``fully_shard``) on each ``ResBlock`` and
  ``FactorizedAttentionBlock``, then on the root, over the 2-D (dp, fsdp)
  mesh: HSDP, replicated over "dp" and sharded over "fsdp". A parameter is
  sharded on the axis JAX's rule picks (``fsdp_param_placement``). One that
  the rule keeps replicated cannot be placed so by FSDP2 on an fsdp axis
  wider than one rank: it goes in ``ignored_params``, and
  ``sync_replicated_grads`` averages its gradient by hand.

Parameters, gradients and their reductions stay f32 (no
``MixedPrecisionPolicy`` that changes a dtype); the U-Net casts to its
compute dtype inside, as it does unwrapped.

Each process loads only its own rows (``data/datasets.py``), so a training
batch needs no placement: the counterpart of ``shard_batch`` is the
identity there. In single-process evaluation ``split_rows`` hands each card
a contiguous block of rows.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ..utils.device import on_capture_stream
from .mesh import FSDP_AXIS


def fsdp_param_placement(params: Mapping[str, torch.Tensor], fsdp_size: int,
                         min_size: int = 2**16) -> Dict[str, Optional[int]]:
    """{name: the axis to shard over fsdp, or None to replicate}: JAX's rule.

    The largest axis that ``fsdp_size`` divides (the first of equal ones);
    parameters under ``min_size`` elements stay replicated (sharding them
    costs more in collective latency than it saves in memory), as does one
    that no axis of divides, and every one when ``fsdp_size`` is 1."""

    def rule(shape):
        if fsdp_size == 1 or math.prod(shape) < min_size:
            return None
        for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if shape[a] % fsdp_size == 0:
                return a
        return None

    return {name: rule(tuple(p.shape)) for name, p in params.items()}


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper (its
    parameter names carry no ``module.`` prefix); any other model itself."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model


def is_sharded(model: nn.Module) -> bool:
    """Whether ``fully_shard`` has been applied to ``model``."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def shard_model(model: nn.Module, mesh, min_size: int = 2**16) -> nn.Module:
    """FSDP2 over ``mesh`` (a (dp, fsdp) ``DeviceMesh``): ``fully_shard`` on
    each ResBlock and FactorizedAttentionBlock, then the root, in place.

    On an fsdp axis of one rank sharding is replication, so every parameter
    is placed (on its rule's axis, else axis 0) and FSDP2 reduces every
    gradient; on a wider one the replicated parameters are ignored by FSDP2
    (see the module docstring)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..models.unet import FactorizedAttentionBlock, ResBlock

    fsdp_size = mesh[FSDP_AXIS].size()
    named = dict(model.named_parameters())
    axes = fsdp_param_placement(named, fsdp_size, min_size)
    axis_of = {id(p): axes[n] for n, p in named.items()}
    ignored = ({p for n, p in named.items() if axes[n] is None} if fsdp_size > 1 else set())

    def placement(p):
        return Shard(axis_of.get(id(p)) or 0)

    kw = dict(mesh=mesh, shard_placement_fn=placement, ignored_params=ignored)
    for m in model.modules():
        if isinstance(m, (ResBlock, FactorizedAttentionBlock)):
            fully_shard(m, **kw)
    fully_shard(model, **kw)
    return model


def wrap_for_training(model: nn.Module, mesh, fsdp: int = 1,
                      min_size: int = 2**16) -> nn.Module:
    """The model as the train step runs it: unchanged without a ``mesh``
    (``TrainLoop`` builds one only in a group of more than one process, or
    takes the caller's), or already wrapped; ``DistributedDataParallel``
    with ``fsdp == 1``; ``shard_model`` with ``fsdp > 1``. On a card DDP is
    built on the device's capture stream, where the captured train step
    runs its warm-up and capture (``training/graphs.py``): PyTorch's
    condition for capturing DDP's whole backward."""
    from torch.nn.parallel import DistributedDataParallel

    if mesh is None or is_sharded(model) or isinstance(model, DistributedDataParallel):
        return model
    if fsdp == 1:
        device = next(model.parameters()).device
        if device.type != "cuda":
            return DistributedDataParallel(model)
        with on_capture_stream(device):
            return DistributedDataParallel(model, device_ids=[device.index])
    return shard_model(model, mesh, min_size)


@contextlib.contextmanager
def grad_sync(model: nn.Module, sync: bool):
    """Inside, the backward of ``model`` reduces gradients across ranks only
    when ``sync`` (the last microbatch); otherwise they accumulate locally
    (DDP's ``no_sync``, FSDP2's ``set_requires_gradient_sync``). The forward
    must run inside too."""
    from torch.nn.parallel import DistributedDataParallel

    if sync:
        yield
    elif isinstance(model, DistributedDataParallel):
        with model.no_sync():
            yield
    elif is_sharded(model):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


def sync_replicated_grads(model: nn.Module) -> None:
    """Average over the group the gradients FSDP2 does not reduce: those of
    the parameters ``shard_model`` left out of its groups. Nothing to do for
    any other model."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not is_sharded(model):
        return
    grads = [p.grad for p in model.parameters()
             if not isinstance(p, DTensor) and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of every gradient of the model over all ranks: FSDP2's
    sharded gradients (DTensors) through their global norm, the rest (the
    same on every rank) as they are. Every rank gets the same value."""
    from torch.distributed.tensor import DTensor

    sharded = [g for g in grads if isinstance(g, DTensor)]
    local = [g for g in grads if not isinstance(g, DTensor)]
    if not sharded:
        return torch.nn.utils.get_total_norm(local)
    parts = [torch.nn.utils.get_total_norm(sharded).full_tensor()]
    if local:
        parts.append(torch.nn.utils.get_total_norm(local).to(parts[0].device))
    return torch.linalg.vector_norm(torch.stack(parts))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective every rank must enter, in the
    same order); any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """What an elementwise update of ``t`` touches on this rank: a DTensor's
    local shard (under ``torch.no_grad()``, its storage itself), any other
    tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def place_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full tensor ``value`` (the same on every rank) laid out as
    ``like``: a DTensor's placements over its mesh (rank 0's value is
    broadcast), else on ``like``'s device and dtype."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        value = value.to(device=like.to_local().device, dtype=like.dtype)
        return distribute_tensor(value, like.device_mesh, like.placements)
    return value.to(like)


def row_blocks(n_rows: int, n_parts: int) -> List[slice]:
    """``n_parts`` contiguous equal blocks of ``n_rows`` rows, in order."""
    if n_rows % n_parts:
        raise ValueError(f"{n_rows} rows do not split into {n_parts} equal blocks")
    size = n_rows // n_parts
    return [slice(i * size, (i + 1) * size) for i in range(n_parts)]


def split_rows(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` (a tensor or array, rows first) as one contiguous block of rows
    per device, each on its device."""
    x = torch.as_tensor(x)
    return [x[rows].to(dev) for rows, dev in zip(row_blocks(len(x), len(devices)), devices)]
