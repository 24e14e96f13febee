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
"""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh: DType

LIB = torch.library.Library("lfvdm", "DEF")  # the namespace, defined once


def define(name: str, schema: str, *, cpu, cuda, fake, backward, setup_context):
    """Define operator ``lfvdm::<name><schema>`` with its implementations;
    returns its overload (``torch.ops.lfvdm.<name>.default``).
    ``setup_context(ctx, inputs, output)`` saves what ``backward(ctx,
    *grads)`` needs, as ``torch.library.register_autograd`` takes them."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"lfvdm::{name}", fake, lib=LIB)
    op = getattr(torch.ops.lfvdm, name).default
    LIB.impl(name, _autograd_kernel(op, backward, setup_context), "Autograd")
    return op


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
