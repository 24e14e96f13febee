"""Device meshes for data-parallel and FSDP training, and the device list of
single-process evaluation (counterpart of lfvdm_tpu/parallel/mesh.py).

A training mesh is a 2-D ``DeviceMesh`` of shape (dp, fsdp) over the ranks
of the ``torch.distributed`` group, one card per process, with the fsdp
axis innermost as in JAX (neighbouring ranks, the fastest links, share a
parameter's shards). The rendezvous is ``utils/device.py::setup_distributed``
(re-exported here).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..utils.device import setup_distributed  # noqa: F401  (the JAX module's name)

DP_AXIS = "dp"
FSDP_AXIS = "fsdp"


def best_mesh_shape(n_devices: int, fsdp: int = 1) -> Tuple[int, int]:
    """Split ``n_devices`` into (dp, fsdp); fsdp <= 1 is pure data parallel."""
    if fsdp <= 1:
        return (n_devices, 1)
    if n_devices % fsdp:
        raise ValueError(f"{n_devices} devices not divisible by fsdp={fsdp}")
    return (n_devices // fsdp, fsdp)


def make_mesh(fsdp: int = 1, device_type: str = "cuda"):
    """The (dp, fsdp) mesh over every rank of the process group (which must
    be joined), named ("dp", "fsdp"). ``device_type`` is the training
    device's: "cuda", or "cpu" for a gloo group on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = best_mesh_shape(dist.get_world_size(), fsdp)
    return init_device_mesh(device_type, shape, mesh_dim_names=(DP_AXIS, FSDP_AXIS))


def make_eval_mesh(dp_devices: int, batch_size: Optional[int] = None,
                   device="cuda") -> List[torch.device]:
    """The first ``dp_devices`` devices of ``device``'s type, validated, for
    single-process data-parallel evaluation (window sampling, I3D features).

    Raises up front when the request cannot deliver parallelism: more
    devices than visible (the CPU counts as one), or a batch size that is
    not a multiple (every batch would silently take the replicated
    fallback)."""
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if dp_devices > n:
        raise ValueError(f"--dp_devices {dp_devices} > {n} visible devices")
    if batch_size is not None and batch_size % dp_devices:
        raise ValueError(
            f"--batch_size {batch_size} must be a multiple of --dp_devices "
            f"{dp_devices}, or every batch runs replicated (no parallelism)")
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(dp_devices)]
    return [device] * dp_devices
