"""Device selection, precision and the process group for the port's entry
points."""

from __future__ import annotations

import contextlib
import os

import torch


def _group_size() -> int:
    """The world size a launcher such as ``torchrun`` set, 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; the default is the card.

    In a group of more than one process (``WORLD_SIZE`` > 1), a bare
    ``"cuda"`` is the card ``LOCAL_RANK`` names, so each process of a
    ``torchrun`` launch takes its own card. Raises when a CUDA device is
    asked for and none is present: the port never falls back to the CPU on
    its own. Pass ``device="cpu"`` for the plain PyTorch path (the tests do).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None and _group_size() > 1:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def setup_distributed(device) -> None:
    """Join the ``torch.distributed`` group a launcher describes (the
    counterpart of ``lfvdm_tpu.parallel.mesh.setup_distributed``).

    When ``WORLD_SIZE`` > 1 (``torchrun`` sets it, with ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), the process joins
    the group: ``nccl`` on a CUDA ``device`` (made the current card first),
    ``gloo`` on the CPU. Without a launcher, or in a process that has joined
    already, it does nothing.
    """
    import torch.distributed as dist

    if _group_size() <= 1 or dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=_group_size())


def process_index_and_count():
    """(rank, world size) of the ``torch.distributed`` process group, or
    (0, 1) without one (the counterpart of ``jax.process_index()`` and
    ``jax.process_count()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective_device() -> torch.device:
    """Where a collective's tensors must live: the current card under
    ``nccl``, the CPU under ``gloo``."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is true on any rank of the group (every rank must
    call it at the same point); ``flag`` itself in one process."""
    import torch.distributed as dist

    if process_index_and_count()[1] == 1:
        return flag
    t = torch.tensor([float(flag)], device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


@contextlib.contextmanager
def full_f32():
    """Inside, cuDNN convolutions and cuBLAS matrix products on the card run
    in full f32 (TF32 off); the settings are restored on exit. The evals run
    so: their scores are compared across papers."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


_CAPTURE_STREAMS = {}  # device -> the stream of every CUDA graph warm-up and capture there


def capture_stream(device) -> torch.cuda.Stream:
    """One warm-up and capture stream per device, made once on that device
    (the libraries keep a workspace per stream for the process's life). The
    captured sampling windows and train steps share it: ``torch.cuda.graph``'s
    own default stream lies on whichever card captured first."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def on_capture_stream(device):
    """Inside, the current stream is ``device``'s capture stream, which
    first waits for the work queued on ``device``'s current stream; on exit
    that stream waits for it. Where the warm-ups of captured programs run,
    and where DDP is built (``parallel/sharding.py``)."""
    main = torch.cuda.current_stream(device)
    stream = capture_stream(device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        yield stream
    main.wait_stream(stream)


def current(device):
    """Make ``device`` the current CUDA device inside; nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
