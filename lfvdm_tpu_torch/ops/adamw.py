"""The single-pass AdamW and EMA update: its kernel, plain version and wrapper.

``fused_adamw_ema`` is the port's one update (``training/train_loop.py``
``update_state``), the counterpart of the JAX package's ``LFVDM_FUSED_OPT``
arm (``lfvdm_tpu/training/train_loop.py`` ``_fused_adamw_ema``, which
computes what its default optax chain does): one traversal that computes,
per element of every
parameter tensor, AdamW (optax's ``adamw``: bias-corrected moments, weight
decay added to the normalised update) and every EMA copy from the new
parameters, and writes p, m, v and each copy in place only where the step's
0-d ``finite`` flag is true (JAX's ``select``: a skipped step leaves every
bit). It replaces no Pallas kernel: JAX computes it as an XLA fusion of
``jax.tree.map``. CUDA source: ``csrc/fused_adamw_ema.cu``, a multi-tensor
apply whose tensor pointers and sizes travel as kernel arguments, so it
reads the model's own tensors (no flat copies) and needs no device-side
table that a new gradient would leave stale; it reads ``finite``, the Adam
count and the schedule's LR factor from device memory, so it runs inside a
captured step. The bound on the H100 is bytes: each element read once and
written once (p, m, v and each copy), g read once.

Types: parameters, gradients and moments f32; the EMA copies all f32 or all
bf16 (``LFVDM_BF16_EMA``), the arithmetic in f32 and each copy rounded to
its dtype. ``hyper`` carries the host scalars as PyTorch would pass Python
floats to f32 tensors: lr, wd, b1, 1 − b1, b2, 1 − b2, eps, then each rate
and each 1 − rate (differences taken in double).

The kernel is the operator ``torch.ops.lfvdm.fused_adamw_ema``
(``_common.define``), which mutates its first, third, fourth and fifth
arguments and returns nothing: the plain version for CPU tensors, the
kernel's launches for CUDA tensors (any other device raises), no fake
outputs, and no autograd formula (an optimizer step has no gradient).
``fused_adamw_ema.launches`` counts calls that launched the kernel, in the
CUDA implementation; ``fused_adamw_ema.launches_per_call`` is the number of
CUDA launches the last such call made (one per ``kMaxTensors`` tensors or
``kMaxBlocks`` chunks).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build
from ._common import _DTYPE_CODES, _check_device, _check_impl, _check_launch, counted, define

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_RATES = 4  # csrc/fused_adamw_ema.cu kMaxRates


def hyperparameters(lr: float, weight_decay: float, betas, eps: float,
                    rates: Sequence[float]) -> List[float]:
    """The ``hyper`` list of the operator."""
    b1, b2 = betas
    rates = [float(r) for r in rates]
    return [lr, weight_decay, b1, 1.0 - b1, b2, 1.0 - b2, eps] + rates + [1.0 - r for r in rates]


def fused_adamw_ema_plain(params, grads, exp_avg, exp_avg_sq, ema, finite, count, lr_factor,
                          hyper):
    """The update tensor by tensor in PyTorch, each new value selected
    against the old one on ``finite`` (JAX's ``jnp.where``). ``ema`` holds
    the copies rate by rate (``len(ema) / len(params)`` rates)."""
    n = len(params)
    n_rates = len(ema) // n if n else 0
    lr, wd, b1, omb1, b2, omb2, eps = hyper[:7]
    rates, omr = hyper[7:7 + n_rates], hyper[7 + n_rates:]
    step = count + 1
    c1, c2 = 1.0 - torch.pow(b1, step), 1.0 - torch.pow(b2, step)
    if lr_factor is not None:
        lr = lr * lr_factor
    for i, (p, g, m, v) in enumerate(zip(params, grads, exp_avg, exp_avg_sq)):
        m2 = (g * omb1).add_(m, alpha=b1)
        v2 = (g * g).mul_(omb2).add_(v, alpha=b2)
        u = (m2 / c1).div_((v2 / c2).sqrt_().add_(eps))
        if wd:
            u.add_(p, alpha=wd)
        p2 = p + u.mul_(-lr)
        for r in range(n_rates):
            e = ema[r * n + i]
            e2 = (e.float() * rates[r]).add_(p2, alpha=omr[r]).to(e.dtype)
            e.copy_(torch.where(finite, e2, e))
        m.copy_(torch.where(finite, m2, m))
        v.copy_(torch.where(finite, v2, v))
        p.copy_(torch.where(finite, p2, p))


def _check_kernel_inputs(params, grads, exp_avg, exp_avg_sq, ema, finite, count, lr_factor):
    n = len(params)
    if not (len(grads) == len(exp_avg) == len(exp_avg_sq) == n):
        raise ValueError("params, grads and both moments must be lists of one length")
    if n == 0:
        return torch.float32
    if len(ema) % n or len(ema) // n > MAX_RATES:
        raise ValueError(f"ema must hold 0 to {MAX_RATES} copies of {n} tensors, got {len(ema)}")
    dev = params[0].device
    ema_dtype = ema[0].dtype if ema else torch.float32
    if ema_dtype not in _DTYPE_CODES:
        raise TypeError(f"EMA copies must be float32 or bfloat16, got {ema_dtype}")
    for i, p in enumerate(params):
        group = [(p, torch.float32), (grads[i], torch.float32), (exp_avg[i], torch.float32),
                 (exp_avg_sq[i], torch.float32)]
        group += [(ema[r * n + i], ema_dtype) for r in range(len(ema) // n)]
        for t, dtype in group:
            if t.device != dev or t.dtype != dtype or t.numel() != p.numel() \
                    or not t.is_contiguous():
                raise ValueError(f"tensor {i}: every part must be a contiguous {dtype} tensor "
                                 f"of {p.numel()} elements on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
    for name, t, dtype in (("finite", finite, torch.bool), ("count", count, torch.int64),
                           ("lr_factor", lr_factor, torch.float32)):
        if t is not None and (t.device != dev or t.dtype != dtype or t.dim() != 0):
            raise ValueError(f"{name} must be a 0-d {dtype} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return ema_dtype


def _launch(params, grads, exp_avg, exp_avg_sq, ema, finite, count, lr_factor, hyper):
    ema_dtype = _check_kernel_inputs(params, grads, exp_avg, exp_avg_sq, ema, finite, count,
                                     lr_factor)
    n = len(params)
    if n == 0:
        return
    n_rates = len(ema) // n

    def pointers(tensors):
        return (_P * len(tensors))(*[t.data_ptr() for t in tensors])

    fn = _build.function("fused_adamw_ema", "lfvdm_fused_adamw_ema",
                         [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P])
    numel = (ctypes.c_longlong * n)(*[p.numel() for p in params])
    host = (ctypes.c_float * len(hyper))(*hyper)
    made = _I(0)
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_DTYPE_CODES[ema_dtype], n, n_rates, numel, pointers(params), pointers(grads),
                pointers(exp_avg), pointers(exp_avg_sq), pointers(ema) if ema else None,
                finite.data_ptr(), count.data_ptr(),
                None if lr_factor is None else lr_factor.data_ptr(), host,
                ctypes.byref(made), stream)
    _check_launch(rc, "fused_adamw_ema")
    # the kernel wrote through raw pointers: autograd's version counters
    # learn of it here, as they would from an in-place PyTorch op
    torch.autograd.graph.increment_version(list(params) + list(exp_avg) + list(exp_avg_sq)
                                           + list(ema))
    fused_adamw_ema.launches += 1
    fused_adamw_ema.launches_per_call = made.value


def _fake(params, grads, exp_avg, exp_avg_sq, ema, finite, count, lr_factor, hyper):
    return None


_op = define(
    "fused_adamw_ema",
    "(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] exp_avg, Tensor(c!)[] exp_avg_sq, "
    "Tensor(d!)[] ema, Tensor finite, Tensor count, Tensor? lr_factor, float[] hyper) -> ()",
    cpu=fused_adamw_ema_plain, cuda=_launch, fake=_fake, backward=None, setup_context=None)


def fused_adamw_ema(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                    exp_avg: Sequence[torch.Tensor], exp_avg_sq: Sequence[torch.Tensor],
                    emas: Sequence[Sequence[torch.Tensor]], finite: torch.Tensor,
                    count: torch.Tensor, *, lr: float, weight_decay: float,
                    rates: Sequence[float], lr_factor: Optional[torch.Tensor] = None,
                    betas=(0.9, 0.999), eps: float = 1e-8, impl: str = "auto"):
    """One AdamW step and every EMA update, in place, where ``finite``.

    ``params``, ``grads``, ``exp_avg``, ``exp_avg_sq``: f32 tensors, one per
    parameter (each rank's local tensors); ``emas``: one list per rate in
    ``rates``, laid out as ``params``; ``finite``: the step's 0-d bool flag;
    ``count``: the 0-d int64 Adam count before this update (the bias
    corrections use ``count + 1``; the caller advances it); ``lr_factor``:
    a 0-d f32 tensor the LR is multiplied by (the schedule's), or None. All
    on one device. Returns None."""
    _check_impl(impl)
    if len(emas) != len(rates):
        raise ValueError(f"{len(emas)} EMA copies for {len(rates)} rates")
    hyper = hyperparameters(lr, weight_decay, betas, eps, rates)
    ema = [t for copy in emas for t in copy]
    args = (list(params), list(grads), list(exp_avg), list(exp_avg_sq), ema, finite, count,
            lr_factor, hyper)
    with torch.no_grad():
        if impl == "plain":
            return fused_adamw_ema_plain(*args)
        if params:
            _check_device(params[0].device)
        _op(*args)


counted(fused_adamw_ema)
fused_adamw_ema.launches_per_call = 0
