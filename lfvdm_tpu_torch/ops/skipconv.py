"""The fused up-path skip projection: its kernel, plain version and wrapper.

``skip_conv_stats`` replaces ``lfvdm_tpu/ops/skipconv.py::_kernel`` (the
Pallas kernel behind ``skip_conv_stats``): a 1x1 conv over the two-part
channel concat ``[x1 ‖ x2]`` of an up-path ResBlock, plus the residual, plus
the per-sample channel ``(Σy, Σy²)`` of the output in f32, which the next
ResBlock's GroupNorm takes as its statistics (``models/nn.py``
``channel_sums``). CUDA source: ``csrc/skip_conv_stats.cu``, a GEMM per
sample whose epilogue adds the residual and bias and reduces the statistics
into per-tile partials, summed in a fixed order by a second small kernel.
It never builds the concat and never re-reads y for the statistics; the
bound on the H100 is bytes (x1, x2 and resid read once, y written once).

``plan`` picks one of two routes from the sizes, the dtype and alignment
(a rule, not a fallback on failure), and the C function refuses any plan
but its own:
  "bulk"     bf16, P % 8 == 0, c1 % 16 == 0, c2 % 16 == 0, 16-byte aligned
             data (every flagship shape): a persistent kernel for Hopper, a
             producer warpgroup feeding an mbarrier ring of async copies to
             8 mma.sync warps, w resident in shared memory (loaded once by
             bulk copies) where F <= 128 and K <= 384, the residual
             prefetched into a buffer of its own.
  "generic"  everything else (f32, odd widths, unaligned views): 64 x 64
             tiles, element-wise loads; bf16 on WMMA, f32 on plain FMAs.

Layouts are the port's NCHW (the JAX op flattens channels-last rows; its
``n_samples`` is the leading axis here):
  x1 (N, c1, *S), x2 (N, c2, *S), resid (N, F, *S) in one dtype (f32 or bf16)
  w  (F, c1 + c2) or the conv's (F, c1 + c2, 1, 1), b (F,), in that dtype
  -> y (N, F, *S) in resid's dtype, s1 and s2 (N, F) f32

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors (any other device raises); ``impl="plain"`` asks for the
plain version on any device. ``skip_conv_stats.launches`` counts kernel
launches, ``skip_conv_stats.launches_by_route`` splits them by route. The
backward is the JAX package's VJP (``skipconv.py`` ``_vjp_bwd``) in plain
PyTorch, as JAX computes it outside any kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._common import _DTYPE_CODES, _check_impl, _check_launch, _use_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUTES = ("generic", "bulk")  # by code: csrc/skip_conv_stats.cu bulk::Route

# The bulk route's constants (csrc/skip_conv_stats.cu, namespace bulk).
BM = 128                   # output channels per tile
BK = 64                    # K rows per slice
MAX_STAGES = 4
RESID_BUFS = 2
BAR_BYTES = 256
RED_BYTES = 2 * 2 * 2 * BM * 4
SMEM_MAX = 232448          # dynamic shared memory a block may use on the H100
W_RESIDENT_MAX_K = 384
H100_SMS = 132


class Plan(NamedTuple):
    """One launch: the route, the tile (BM channels x BN pixels), the ring's
    stages, whether w stays resident in shared memory, the pixel tiles per
    sample (``partial`` holds 2·N·p_tiles·F floats), the grid (CTAs of the
    persistent bulk kernel; blocks of the generic one) and the dynamic
    shared-memory bytes."""
    route: str
    bm: int
    bn: int
    stages: int
    w_resident: bool
    p_tiles: int
    grid: int
    smem: int

    def fields(self):
        """The 8 ints the C function checks, in its order."""
        return (ROUTES.index(self.route), self.bm, self.bn, self.stages,
                int(self.w_resident), self.p_tiles, self.grid, self.smem)


def _cdiv(a, b):
    return -(-a // b)


def _bulk_smem(bn, K, w_resident, stages):
    stage = (0 if w_resident else BM * (BK + 8) * 2) + BK * (bn + 8) * 2
    return (BAR_BYTES + RED_BYTES + (BM * (K + 8) * 2 if w_resident else 0) + stages * stage
            + RESID_BUFS * BM * (bn + 8) * 2)


@functools.lru_cache(maxsize=256)
def plan(N, c1, c2, F, P, dtype, *, aligned=True, sms=H100_SMS) -> Plan:
    """The launch plan of ``skip_conv_stats`` for these sizes and dtype on a
    card with ``sms`` SMs (the rule of csrc ``bulk::make_plan``, which
    refuses any other). ``aligned``: x1, x2, w, resid and y all start on
    16-byte boundaries."""
    if min(N, c1, c2, F, P, sms) < 1:
        raise ValueError(f"skip_conv_stats takes positive sizes, got {(N, c1, c2, F, P, sms)}")
    K = c1 + c2
    generic = Plan("generic", 64, 64, 1, False, _cdiv(P, 64), _cdiv(P, 64) * _cdiv(F, 64) * N, 0)
    if dtype != torch.bfloat16 or P % 8 or c1 % 16 or c2 % 16 or not aligned:
        return generic
    bn = 128 if P >= 128 else 64
    tiles = N * _cdiv(P, bn) * _cdiv(F, BM)
    if tiles > 2**31 - 1:
        return generic
    w_resident = F <= BM and K <= W_RESIDENT_MAX_K
    while True:
        stages = MAX_STAGES
        while stages > 2 and _bulk_smem(bn, K, w_resident, stages) > SMEM_MAX:
            stages -= 1
        if not w_resident or _bulk_smem(bn, K, w_resident, stages) <= SMEM_MAX:
            break
        w_resident = False
    return Plan("bulk", BM, bn, stages, w_resident, _cdiv(P, bn), min(tiles, sms),
                _bulk_smem(bn, K, w_resident, stages))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    y = torch.empty_like(rf)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x1f, x2f, w2, rf, y))
    p = plan(N, c1, c2, F, P, x1.dtype, aligned=aligned, sms=_sm_count(x1.device.index))
    partial = torch.empty(2 * N * p.p_tiles * F, dtype=torch.float32, device=x1.device)
    s1 = torch.empty(N, F, dtype=torch.float32, device=x1.device)
    s2 = torch.empty_like(s1)
    fn = _build.function("skip_conv_stats", "lfvdm_skip_conv_stats",
                         [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        rc = fn(_DTYPE_CODES[x1.dtype], x1f.data_ptr(), x2f.data_ptr(), w2.data_ptr(),
                b.data_ptr(), rf.data_ptr(), y.data_ptr(), partial.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), N, c1, c2, F, P, (ctypes.c_int * 8)(*p.fields()), stream)
    _check_launch(rc, f"skip_conv_stats ({p.route})")
    skip_conv_stats.launches += 1
    skip_conv_stats.launches_by_route[p.route] += 1
    return y.reshape(resid.shape), s1, s2


def library_plan(N, c1, c2, F, P, dtype, *, aligned=True, sms=H100_SMS) -> Plan:
    """The kernel library's own plan (csrc ``lfvdm_skip_conv_stats_plan``),
    which ``plan`` must equal; builds the kernel on first use."""
    fn = _build.function("skip_conv_stats", "lfvdm_skip_conv_stats_plan",
                         [_I, _I, _I, _I, _I, _I, _I, _I, _P])
    out = (ctypes.c_int * 8)()
    _check_launch(fn(_DTYPE_CODES[dtype], N, c1, c2, F, P, int(aligned), sms, out),
                  "skip_conv_stats plan")
    route, bm, bn, stages, w_res, p_tiles, grid, smem = out
    return Plan(ROUTES[route], bm, bn, stages, bool(w_res), p_tiles, grid, smem)


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
skip_conv_stats.launches_by_route = dict.fromkeys(ROUTES, 0)
