"""The benchmark's fixed arithmetic: the H100's peaks, a kernel's least time,
the work of each port kernel from its shapes, and the reduction of a
``torch.profiler`` run to device time by kernel name.

Copied from ``chip_smoke.py`` (``bound``, ``temporal_work``,
``spatial_work``, the skip projection's and the update's counts,
``KERNEL_GROUPS``, ``device_kernels_ms``) so that later changes to the
program cannot move the benchmark's counts. Each input byte is counted once
and each output byte once, whatever a kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# The port's kernels, by the prefix of their CUDA function names, and the
# name of the wrapper whose launch counter counts them (ops/_common.py).
PORT_KERNELS = ("temporal_rpe_attention", "spatial_attention", "skip_conv_stats")
UPDATE_KERNEL = "fused_adamw_ema"

# Kernel-name groups for the device profiles, first match wins.
KERNEL_GROUPS = (
    ("port kernels", ("skip_conv_stats", "temporal_rpe_attention", "spatial_attention",
                      "reduce_partials")),
    ("optimizer and EMA", ("fused_adamw_ema", "multi_tensor", "foreach", "adam")),
    ("GroupNorm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                   "computeinternalgradients", "gammabeta")),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "fprop", "winograd")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("GEMM", ("gemm", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("concat and copies", ("cat", "copy", "memcpy", "memset")),
    ("elementwise and reductions", ("elementwise", "vectorized", "reduce", "unrolled")),
)


def bound_s(nbytes: float, flops: float, dtype_name: str = "bfloat16") -> float:
    """The least seconds the chip could take: the larger of the bytes over
    the HBM rate and the operations over the peak of ``dtype_name``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])


def temporal_work(B, H, T, D, F, esize):
    """(bytes, flops) of one ``temporal_rpe_attention`` launch: q, k, v, out
    and the three r tables once, the mask; five contractions over (t, s, f,
    d). D pixel sites, F features per head, T frames."""
    nbytes = (4 * B * H * T * F * D + 3 * B * H * T * T * F) * esize + B * T * 4
    return nbytes, 10 * B * H * T * T * F * D


def spatial_work(B, T, H, D, F, esize):
    """(bytes, flops) of one ``spatial_attention`` launch: q, k, v, out once;
    q kᵀ and attn v over D pixel tokens."""
    n = B * T * H
    return 4 * n * D * F * esize, 4 * n * D * D * F


def skip_conv_work(N, c1, c2, F, P, esize):
    """(bytes, flops) of one ``skip_conv_stats`` launch: x1, x2, the residual
    and y once, the weight and bias, the two f32 channel sums."""
    K = c1 + c2
    nbytes = (N * (c1 + c2 + 2 * F) * P + F * K + F) * esize + 2 * N * F * 4
    return nbytes, 2 * N * P * K * F


def update_work(n_elements, n_rates, ema_esize=4):
    """(bytes, flops) of one ``fused_adamw_ema`` call over ``n_elements``
    parameters: p, g, m, v read; p, m, v written; each EMA copy read and
    written."""
    return n_elements * (4 * 4 + 3 * 4 + n_rates * 2 * ema_esize), n_elements * 20


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_ops(prof):
    """{kernel or device-operation name: (seconds, count)} from a
    ``torch.profiler`` run. User-annotation ranges on the device timeline
    are left out: they would count their kernels twice."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        s = e.self_device_time_total / 1e6
        if s > 0:
            t, n = out.get(e.key, (0.0, 0))
            out[e.key] = (t + s, n + e.count)
    return out


def kernel_seconds(ops, prefix: str) -> float:
    """Device seconds of the launches whose name holds ``prefix_`` (the
    kernel's own functions: ``spatial_attention_kernel``,
    ``spatial_attention_mma_kernel``, ...; the profiler names them with
    their template arguments). ``skip_conv_stats`` also takes its
    ``reduce_partials_kernel``."""
    keys = (prefix + "_",) + (("reduce_partials_kernel",) if prefix == "skip_conv_stats" else ())
    return sum(s for name, (s, _) in ops.items() if any(k in name for k in keys))
