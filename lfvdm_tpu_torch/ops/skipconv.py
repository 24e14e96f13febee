"""The fused up-path skip projection: its kernel, plain version and wrapper.

``skip_conv_stats`` replaces ``lfvdm_tpu/ops/skipconv.py::_kernel`` (the
Pallas kernel behind ``skip_conv_stats``): a 1x1 conv over the two-part
channel concat ``[x1 ‖ x2]`` of an up-path ResBlock, plus the residual, plus
the per-sample channel ``(Σy, Σy²)`` of the output in f32, which the next
ResBlock's GroupNorm takes as its statistics (``models/nn.py``
``channel_sums``). CUDA source: ``csrc/skip_conv_stats.cu``, a GEMM per
sample (64 pixels per block, the K loop reading x1 and x2 in place; bf16 on
the tensor cores through WMMA with double-buffered cp.async copies into
128-channel tiles, f32 and odd widths on a simpler element-wise loop) whose
epilogue adds the residual and bias and reduces the statistics into
per-tile partials, summed in a fixed order by a second small kernel. The bound on the H100 is bytes
(x1, x2 and resid read once, y written once): at the flagship shapes the
bf16 work sits far under the card's operations-per-byte balance. The design
never builds the concat and never re-reads y for the statistics.

Layouts are the port's NCHW (the JAX op flattens channels-last rows; its
``n_samples`` is the leading axis here):
  x1 (N, c1, *S), x2 (N, c2, *S), resid (N, F, *S) in one dtype (f32 or bf16)
  w  (F, c1 + c2) or the conv's (F, c1 + c2, 1, 1), b (F,), in that dtype
  -> y (N, F, *S) in resid's dtype, s1 and s2 (N, F) f32

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors (any other device raises); ``impl="plain"`` asks for the
plain version on any device. ``skip_conv_stats.launches`` counts kernel
launches. The backward is the JAX package's VJP (``skipconv.py``
``_vjp_bwd``) in plain PyTorch, as JAX computes it outside any kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import _DTYPE_CODES, _check_impl, _check_launch, _use_kernel

TILE_P = 64  # pixels per block of the kernel (csrc: kBN)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _flat(x1, x2, w, resid):
    n, c1 = x1.shape[:2]
    F = resid.shape[1]
    return (x1.reshape(n, c1, -1), x2.reshape(n, x2.shape[1], -1), w.reshape(F, -1),
            resid.reshape(n, F, -1))


def skip_conv_stats_plain(x1, x2, w, b, resid):
    """The op with f32 accumulation (lfvdm_tpu ``_fwd_xla``): y rounded to
    resid's dtype, the statistics from the unrounded f32 values."""
    x1f, x2f, w2, rf = _flat(x1, x2, w, resid)
    c1 = x1f.shape[1]
    y32 = (torch.matmul(w2[:, :c1].float(), x1f.float())
           + torch.matmul(w2[:, c1:].float(), x2f.float())
           + rf.float() + b.float()[None, :, None])
    return y32.to(resid.dtype).reshape(resid.shape), y32.sum(2), (y32 * y32).sum(2)


def _launch(x1, x2, w, b, resid):
    _check_kernel_inputs(x1, x2, w, b, resid)
    x1f, x2f, w2, rf = (t.contiguous() for t in _flat(x1, x2, w, resid))
    b = b.contiguous()
    N, c1, P = x1f.shape
    c2, F = x2f.shape[1], rf.shape[1]
    tiles = -(-P // TILE_P)
    y = torch.empty_like(rf)
    partial = torch.empty(2 * N * tiles * F, dtype=torch.float32, device=x1.device)
    s1 = torch.empty(N, F, dtype=torch.float32, device=x1.device)
    s2 = torch.empty_like(s1)
    fn = _build.function("skip_conv_stats", "lfvdm_skip_conv_stats",
                         [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        rc = fn(_DTYPE_CODES[x1.dtype], x1f.data_ptr(), x2f.data_ptr(), w2.data_ptr(),
                b.data_ptr(), rf.data_ptr(), y.data_ptr(), partial.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), N, c1, c2, F, P, tiles, stream)
    _check_launch(rc, "skip_conv_stats")
    skip_conv_stats.launches += 1
    return y.reshape(resid.shape), s1, s2


def _check_kernel_inputs(x1, x2, w, b, resid):
    dev, dtype = x1.device, x1.dtype
    for t in (x2, w, b, resid):
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {t.device} vs {dev}")
        if t.dtype != dtype:
            raise TypeError(f"inputs must share dtype {dtype}, got {t.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    n, c1, c2, F = x1.shape[0], x1.shape[1], x2.shape[1], resid.shape[1]
    if x2.shape[0] != n or resid.shape[0] != n or x1.shape[2:] != x2.shape[2:] \
            or resid.shape[2:] != x1.shape[2:]:
        raise ValueError(f"x1, x2, resid disagree: {x1.shape}, {x2.shape}, {resid.shape}")
    if w.numel() != F * (c1 + c2) or w.shape[0] != F or b.shape != (F,):
        raise ValueError(f"w must be ({F}, {c1 + c2}) and b ({F},), got {w.shape}, {b.shape}")
    if n > 65535:
        raise ValueError(f"the kernel takes at most 65535 samples, got {n}")


class _SkipConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, w, b, resid):
        if _use_kernel(x1.device):
            y, s1, s2 = _launch(x1, x2, w, b, resid)
        else:
            y, s1, s2 = skip_conv_stats_plain(x1, x2, w, b, resid)
        # The backward reads the ROUNDED output, as JAX saves out[0].
        ctx.save_for_backward(x1, x2, w, y)
        ctx.dtypes = (b.dtype, resid.dtype)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x1, x2, w, y = ctx.saved_tensors
        b_dtype, r_dtype = ctx.dtypes
        x1f, x2f, w2, yf = _flat(x1, x2, w, y)
        c1 = x1f.shape[1]
        # Stats cotangents broadcast over the pixels: dΣy/dy = 1, dΣy²/dy = 2y.
        g = (gy.reshape(yf.shape).float() + gs1[:, :, None]
             + 2.0 * yf.float() * gs2[:, :, None])
        g_c = g.to(x1.dtype)
        dx1 = torch.matmul(w2[:, :c1].t(), g_c).reshape(x1.shape)
        dx2 = torch.matmul(w2[:, c1:].t(), g_c).reshape(x2.shape)
        dw = torch.cat([torch.einsum("nfp,nkp->fk", g, x1f.float()),
                        torch.einsum("nfp,nkp->fk", g, x2f.float())], dim=1)
        db = g.sum(dim=(0, 2)).to(b_dtype)
        dresid = g.to(r_dtype).reshape(y.shape)
        return dx1, dx2, dw.to(w.dtype).reshape(w.shape), db, dresid


def skip_conv_stats(x1, x2, w, b, resid, *, impl: str = "auto"):
    """y = [x1 ‖ x2] ⋆ w + b + resid (a 1x1 conv over channels), plus the
    per-sample channel Σy and Σy² in f32. See the module docstring for
    layouts. Returns (y, s1, s2)."""
    _check_impl(impl)
    if impl == "plain":
        return skip_conv_stats_plain(x1, x2, w, b, resid)
    return _SkipConvStats.apply(x1, x2, w, b, resid)


skip_conv_stats.launches = 0
