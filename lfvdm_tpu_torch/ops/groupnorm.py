"""The U-Net's GroupNorm, its scale-shift and SiLU in one pass: kernel,
plain version and wrapper.

``group_norm_silu`` replaces no Pallas kernel: the JAX package leaves
``GroupNorm32`` → ``* (1 + scale) + shift`` → SiLU to XLA, which fuses the
chain. Eager PyTorch does not: ``GroupNorm32`` reads its bf16 input into an
f32 copy, normalises that, casts back, and the scale, shift and SiLU each
make one more pass, some 16-34 bytes moved per element where the chain
needs 4. CUDA source: ``csrc/group_norm_silu.cu``. The bound on the H100 is
bytes (a few operations per element), so the kernel moves each element once
each way. A (sample, group) slab, in NCHW one contiguous run of (C/G)·H·W
elements, is split over a cluster of up to 8 small blocks (8 resident an SM,
so that one block's arithmetic overlaps another's memory traffic), which
keep what they can of it in registers, take its sum and sum of squares
about a pivot in one pass and add their parts through distributed shared
memory; the affine, scale and shift fold into one multiply-add per channel,
SiLU runs in f32, and y is rounded once to the output's dtype. What the
registers do not hold is read again to apply, from L2. With given
per-channel sums (the up path's input norms) nothing is read for
statistics and the slab streams through.

    y = silu(((x − mean_g)·rstd_g·γ + β)·(1 + scale[n, c]) + shift[n, c])

x (N, C, *S) in f32 or bf16; weight, bias (C,) f32; scale, shift optional,
each (N, C) or (N, C, 1, ...) in the output's dtype; s1, s2 optional f32
(N, C) channel sums (Σx, Σx²), from which the group variance is the
unanchored E[x²] − E[x]², clamped at 0; groups divide C; y (N, C, *S) in
``out_dtype`` (default x's).

The operator ``torch.ops.lfvdm.group_norm_silu`` (``_common.define``) runs
the plain version on CPU tensors, the kernel on CUDA tensors, gives tracers
the output's shape and dtype, and its autograd formula differentiates the
plain version. The model calls it only where no gradient is taken
(``models/unet.py``); ``group_norm_silu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._common import _DTYPE_CODES, _check_device, _check_launch, _replay_plain, counted, define

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SMEM_MAX = 48 * 1024  # shared memory a block takes without opting in; the channel table must fit


def group_affine(x, groups, weight, bias, eps, g_mean, g_var, out_dtype=None):
    """x normalised by its (N, G, 1) group statistics and scaled: the
    per-channel affine y = x·mul + add, broadcast from the groups."""
    N, C = x.shape[:2]
    G = groups
    mul = torch.rsqrt(g_var + eps) * weight.reshape(G, C // G)
    add = bias.reshape(G, C // G) - g_mean * mul
    bshape = (N, C) + (1,) * (x.ndim - 2)
    mul, add = mul.reshape(bshape), add.reshape(bshape)
    # add + x·mul in f32 in one pass over x (x is promoted as it is read)
    y = torch.addcmul(add, x, mul)
    return y.to(out_dtype or x.dtype)


def group_norm_plain(x, groups, weight, bias, eps, out_dtype=None, sums=None):
    """``models/nn.py`` ``GroupNorm32``: f32 statistics and normalisation,
    cast to ``out_dtype`` (default x's). ``sums``: per-(sample, channel) f32
    (Σx, Σx²), each (N, C); the group variance is then the unanchored
    E[x²] − E[x]² (lfvdm_tpu ``GroupNorm32``)."""
    if sums is None:
        y = F.group_norm(x.float(), groups, weight, bias, eps)
        return y.to(out_dtype or x.dtype)
    N, C = x.shape[:2]
    G = groups
    n_red = x[0, 0].numel() * (C // G)
    s1, s2 = sums
    g_mean = s1.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red  # (N, G, 1)
    g_var = (s2.reshape(N, G, C // G).sum(-1, keepdim=True) / n_red
             - g_mean.square()).clamp(min=0.0)
    return group_affine(x, G, weight, bias, eps, g_mean, g_var, out_dtype)


def _broadcast(t, x):
    """(N, C) or (N, C, 1, ...) as (N, C, 1, ...) against x."""
    return t.reshape(t.shape[:2] + (1,) * (x.ndim - 2))


def scale_shift_silu(h, scale=None, shift=None):
    """What follows the norm: ``* (1 + scale) + shift`` in h's dtype, then
    SiLU."""
    if scale is not None:
        h = h * (1 + _broadcast(scale, h))
    if shift is not None:
        h = h + _broadcast(shift, h)
    return F.silu(h)


def group_norm_silu_plain(x, weight, bias, scale=None, shift=None, s1=None, s2=None,
                          groups: int = 32, eps: float = 1e-5,
                          out_dtype: Optional[torch.dtype] = None):
    """The chain as the U-Net's modules compute it: ``GroupNorm32`` (rounded
    to the output dtype), then ``scale_shift_silu``."""
    sums = None if s1 is None else (s1, s2)
    return scale_shift_silu(group_norm_plain(x, groups, weight, bias, eps, out_dtype, sums),
                            scale, shift)


def _launch(x, weight, bias, scale, shift, s1, s2, groups, eps, out_dtype):
    out_dtype = out_dtype or x.dtype
    N, C = x.shape[:2]
    HW = x[0, 0].numel()
    _check_kernel_inputs(x, weight, bias, scale, shift, s1, s2, groups, out_dtype)
    x = x.contiguous()
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    ss_stride = 0
    if scale is not None or shift is not None:
        ss = [t.reshape(N, C) for t in (scale, shift) if t is not None]
        if any(t.stride(1) != 1 for t in ss) or len({t.stride(0) for t in ss}) > 1:
            ss = [t.contiguous() for t in ss]
        ss_stride = ss[0].stride(0)
        it = iter(ss)
        scale = next(it) if scale is not None else None
        shift = next(it) if shift is not None else None
    if s1 is not None:
        s1, s2 = s1.reshape(N, C).contiguous(), s2.reshape(N, C).contiguous()
    per_unit = 16 // x.element_size()
    vec = (HW % per_unit == 0 and x.data_ptr() % 16 == 0
           and y.data_ptr() % (per_unit * y.element_size()) == 0)
    fn = _build.function("group_norm_silu", "lfvdm_group_norm_silu",
                         [_I, _I, _P, _P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _L,
                          ctypes.c_float, _I, _P])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], x.data_ptr(), y.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), ptr(scale), ptr(shift), ss_stride, ptr(s1),
                ptr(s2), N, C, groups, HW, eps, int(vec), stream)
    _check_launch(rc, "group_norm_silu")
    group_norm_silu.launches += 1
    return y


def _check_kernel_inputs(x, weight, bias, scale, shift, s1, s2, groups, out_dtype):
    N, C = x.shape[:2]
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype} -> {out_dtype}")
    if x.dtype == torch.float32 and out_dtype != torch.float32:
        raise TypeError("the kernel does not narrow float32 input to bfloat16")
    if C % groups or weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{groups} groups of {C} channels, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if 2 * (C // groups) * 4 + 5 * 8 > SMEM_MAX:
        raise ValueError(f"{C // groups} channels a group is more than the kernel takes")
    if N * groups > 2**31 - 1 or (C // groups) * x[0, 0].numel() > 2**31 - 1:
        raise ValueError(f"too many groups or too large a group: {tuple(x.shape)}")
    for t in (weight, bias, scale, shift, s1, s2):
        if t is not None and t.device != x.device:
            raise ValueError(f"inputs on different devices: {t.device} vs {x.device}")
    for t in (scale, shift):
        if t is not None and (t.dtype != out_dtype or t.numel() != N * C):
            raise ValueError(f"scale and shift must be ({N}, {C}) in {out_dtype}, got "
                             f"{tuple(t.shape)} in {t.dtype}")
    for t in (s1, s2):
        if t is not None and (t.dtype != torch.float32 or t.numel() != N * C):
            raise ValueError(f"sums must be ({N}, {C}) float32, got {tuple(t.shape)} {t.dtype}")


def _fake(x, weight, bias, scale, shift, s1, s2, groups, eps, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype or x.dtype)


_TENSOR_ARGS = 7  # x, weight, bias, scale, shift, s1, s2; then groups, eps, out_dtype


def _setup_context(ctx, inputs, output):
    tensors = inputs[:_TENSOR_ARGS]
    ctx.present = tuple(t is not None for t in tensors)
    ctx.save_for_backward(*(t for t in tensors if t is not None))
    ctx.args = inputs[_TENSOR_ARGS:]


def _backward(ctx, g):
    present = ctx.present

    def plain(*tensors):
        it = iter(tensors)
        return group_norm_silu_plain(*(next(it) if p else None for p in present), *ctx.args)

    grads = iter(_replay_plain(plain, ctx.saved_tensors, g))
    return (*(next(grads) if p else None for p in present), None, None, None)


_op = define(
    "group_norm_silu",
    "(Tensor x, Tensor weight, Tensor bias, Tensor? scale, Tensor? shift, Tensor? s1,"
    " Tensor? s2, int groups, float eps, ScalarType? out_dtype) -> Tensor",
    cpu=lambda *a: group_norm_silu_plain(*a).contiguous(), cuda=_launch, fake=_fake,
    backward=_backward, setup_context=_setup_context)


def group_norm_silu(x, weight, bias, *, scale=None, shift=None, sums=None, groups: int = 32,
                    eps: float = 1e-5, out_dtype: Optional[torch.dtype] = None):
    """silu(GroupNorm(x)·(1 + scale) + shift) in one pass (see the module
    docstring); ``sums`` = (Σx, Σx²) per (sample, channel) in place of the
    statistics of x."""
    _check_device(x.device)
    s1, s2 = (None, None) if sums is None else sums
    return _op(x, weight, bias, scale, shift, s1, s2, groups, eps, out_dtype)


counted(group_norm_silu)
