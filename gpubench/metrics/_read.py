"""What the metric readers share: a kernel's or the update's share of its
roofline, the share of the bf16 peak, and the device's idle share, from a
run's record."""

from __future__ import annotations

from yardstick import PEAK_FLOPS, PORT_KERNELS, UPDATE_KERNEL, bound_s, kernel_seconds, update_work


def kernel_roofline(run):
    """Σ least time of the port kernels' traced launches over their Σ
    device time, in %."""
    if not run.trace_ops or "kernel_least_s" not in run.work:
        return None
    device = sum(kernel_seconds(run.trace_ops, k) for k in PORT_KERNELS)
    return 100.0 * run.work["kernel_least_s"] / device if device > 0 else None


def update_roofline(run):
    if not run.trace_ops or not run.work.get("traced_steps"):
        return None
    device = kernel_seconds(run.trace_ops, UPDATE_KERNEL)
    nbytes, flops = update_work(run.counts["update_elements"], run.counts["ema_rates"])
    least = bound_s(nbytes, flops, "float32") * run.work["traced_steps"]
    return 100.0 * least / device if device > 0 else None


def mfu(run):
    """Model FLOPs of the units that finished in the untraced stretch over
    its seconds at the bf16 peak, in %."""
    flops, done = run.work.get("unit_flops"), run.untraced_units()
    if not flops or not done or run.t_end is None:
        return None
    return 100.0 * sum(flops[i] for i in done) / (run.untraced_seconds()
                                                    * PEAK_FLOPS["bfloat16"])


def idle_share(run):
    if not run.busy_s or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
