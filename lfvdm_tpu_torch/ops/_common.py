"""Checks shared by the kernel wrappers, and the operator library.

Each kernel is an operator of the ``lfvdm`` namespace (``torch.ops.lfvdm.*``),
so that PyTorch's tracers (``torch.export``, and later CUDA graph capture)
see it as one node. ``define`` gives it one implementation per dispatch key
of a ``torch.library.Library``: CUDA (the kernel's ctypes launch), CPU (the
plain version), Meta through ``register_fake`` (shapes and dtypes only, for
tracers) and Autograd (the autograd formula). The Autograd kernel is written
here rather than through ``torch.library.register_autograd``, whose generic
Python kernel cost 18-37 µs more host time per call than this one with
inputs that require grad, and ``torch.library.custom_op`` was dearer still
(``tools/op_dispatch_cost.py`` on the card; ``PERF.md``).

Each wrapper counts the launches of its kernel (``<wrapper>.launches``, and
``<wrapper>.launches_by_route`` for a kernel with routes), registered here
by ``counted``. ``launch_snapshot`` and ``add_launches`` read and add to
every counter at once: ``capture_graph``, through which the sampling,
serving and training programs capture their CUDA graphs, records the counts
its capture added and takes them back (a capture executes nothing), and the
program adds them again at every replay, so the counters count kernels
executed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.device import capture_stream, current, on_capture_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh: DType

LIB = torch.library.Library("lfvdm", "DEF")  # the namespace, defined once

_COUNTED = []  # the wrappers whose launches are counted, in registration order


def counted(wrapper, routes: Optional[Sequence[str]] = None):
    """Give ``wrapper`` its launch counter (and one per route) at 0, and
    register it with ``launch_snapshot``; returns it."""
    wrapper.launches = 0
    if routes is not None:
        wrapper.launches_by_route = dict.fromkeys(routes, 0)
    _COUNTED.append(wrapper)
    return wrapper


def reset_launch_counts():
    """Set every registered launch counter to 0."""
    for w in _COUNTED:
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)


LaunchCounts = Dict[Tuple[str, Optional[str]], int]


def launch_snapshot() -> LaunchCounts:
    """Every counter now: ``(name, None)`` for a kernel's launches and
    ``(name, route)`` for its launches on each route."""
    out = {}
    for w in _COUNTED:
        out[(w.__name__, None)] = w.launches
        for route, n in getattr(w, "launches_by_route", {}).items():
            out[(w.__name__, route)] = n
    return out


def launch_delta(after: LaunchCounts, before: LaunchCounts) -> LaunchCounts:
    """``after - before``, counter by counter."""
    return {key: n - before.get(key, 0) for key, n in after.items()}


def add_launches(delta: LaunchCounts, sign: int = 1):
    """Add ``sign * delta`` to the counters (``launch_snapshot``'s keys)."""
    by_name = {w.__name__: w for w in _COUNTED}
    for (name, route), n in delta.items():
        w = by_name[name]
        if route is None:
            w.launches += sign * n
        else:
            w.launches_by_route[route] += sign * n


def capture_graph(fn, device, *, pool=None, generators=()):
    """Run ``fn()`` eagerly on ``device``'s capture stream, the warm-up, then
    capture it there into a ``torch.cuda.CUDAGraph``, with ``device`` current
    for both. The warm-up is the step's real execution: the kernels build on
    first use, set their shared-memory attributes, and cuDNN picks its
    algorithms. The capture executes nothing, so the launch counts it adds
    are taken back and returned, for every replay to add again
    (``add_launches``). ``pool``: the graph memory pool to capture into;
    ``generators``: generators whose state the graph advances at each
    replay (``register_generator_state``), or a function called after the
    warm-up that returns them. Returns (graph, the warm-up's result, the
    captured result, the launch counts a replay adds). Raises if ``device``
    is no CUDA device or the capture fails: no caller falls back to eager
    on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"CUDA graphs capture on a CUDA device, not {device}")
    stream = capture_stream(device)
    if stream.device != device:
        raise RuntimeError(f"capture stream on {stream.device}, program on {device}")
    with current(device):
        with on_capture_stream(device):
            warm = fn()
        graph = torch.cuda.CUDAGraph()
        for generator in generators() if callable(generators) else generators:
            graph.register_generator_state(generator)
        before = launch_snapshot()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            captured = fn()
        delta = launch_delta(launch_snapshot(), before)
        add_launches(delta, -1)
    torch.cuda.synchronize(device)
    return graph, warm, captured, delta


def define(name: str, schema: str, *, cpu, cuda, fake, backward, setup_context):
    """Define operator ``lfvdm::<name><schema>`` with its implementations;
    returns its overload (``torch.ops.lfvdm.<name>.default``).
    ``setup_context(ctx, inputs, output)`` saves what ``backward(ctx,
    *grads)`` needs, as ``torch.library.register_autograd`` takes them;
    ``backward=None`` is an operator with no gradient (an optimizer step),
    whose Autograd kernel runs it below autograd and records nothing."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"lfvdm::{name}", fake, lib=LIB)
    op = getattr(torch.ops.lfvdm, name).default
    LIB.impl(name, _below_autograd(op) if backward is None
             else _autograd_kernel(op, backward, setup_context), "Autograd")
    return op


def _below_autograd(op):
    def kernel(*args):
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)

    return kernel


def _autograd_kernel(op, backward_fn, setup_context):
    """The operator's Autograd-key implementation: below autograd it runs the
    CPU or CUDA implementation; where grad is on and an input requires it,
    it records a node whose backward is ``backward_fn``."""

    class Node(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            with torch._C._AutoDispatchBelowAutograd():
                out = op(*args)
            setup_context(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return backward_fn(ctx, *grads)

    Node.__name__ = Node.__qualname__ = f"{op._opname}_node"

    def kernel(*args):
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            return Node.apply(*args)
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)

    return kernel


def _check_impl(impl: str):
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def _check_device(device: torch.device):
    """The operators run on CPU tensors (the plain version) and CUDA tensors
    (the kernel); any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {device}")


def _check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _replay_plain(plain, saved, g):
    """Gradients of ``plain`` at ``saved`` against cotangent ``g``: the
    kernels have no backward of their own, so their autograd formula
    differentiates the plain version, as the JAX package's ``custom_vjp``s
    differentiate their einsum oracles."""
    out, vjp = torch.func.vjp(plain, *saved)
    return vjp(g.to(out.dtype))
