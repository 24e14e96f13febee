"""One cell of the benchmark run with the port's own spans and counters on
(``lfvdm_tpu_torch/utils/tracing.py``), read as per-layer numbers.

    python3 gpubench/port_spans.py --workload flagship.sample --seed 7 --seconds 50 --trace 1

Takes ``gpubench/run.py``'s arguments and runs the cell as it does, with
the port's recorder reset and turned on when the measured window opens
and off when it closes (``--recorder 0`` leaves it off: the same run
without the recorder, for its cost). The last line of standard output is
``run.py``'s result line with a ``port`` object added: the per-layer
numbers below, over the untraced stretch that the host-clock readers use
(the whole window with ``--trace 0``); each span's count and total
milliseconds; how much of the benchmark's outside measures the port's
spans account for; and with ``--trace 1`` the device's idle gaps by the
innermost benchmark (``gpubench.*``) or port (``lfvdm.*``) range on the
thread that enqueues the device work.

The benchmark's own runs leave the recorder off: reading these numbers in
``BENCHMARK.json``'s per-layer metrics takes the harness's ``Run`` to turn
the recorder on in a traced window, as ``PortRun`` does here.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run as bench  # noqa: E402  (first: its clock of the process's start)
import harness  # noqa: E402  (the module run.py's main takes its Run and result_line from)

DRIVER_HOST = ("driver.plan", "driver.gather", "driver.scatter")
DRIVER_COPIES = ("driver.upload", "driver.download")
DRIVER = DRIVER_HOST + DRIVER_COPIES + ("driver.wait",)


def records(run, whole=False):
    """The recorder's finished spans and its counts that began in the
    untraced stretch (``whole``: in the measured window), as (spans,
    counts); None where the port has no recorder or the window is open."""
    try:
        from lfvdm_tpu_torch.utils import tracing
    except ImportError:
        return None
    start = run.t_window if whole else run.t_untraced
    if start is None or run.t_end is None:
        return None
    lo, hi = start * 1e9, run.t_end * 1e9
    spans = [s for s in tracing.spans() if s.end_ns is not None and lo <= s.start_ns <= hi]
    return spans, [c for c in tracing.counts() if lo <= c.t_ns <= hi]


def _seconds(spans, names):
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9


def _counted(counts, name):
    return sum(c.n for c in counts if c.name == name)


def per_layer(run) -> dict:
    """The port's per-layer numbers of ``run`` (None where there is nothing
    to read):

    - ``driver_gather_scatter_ms_per_window``: Σ driver.plan, .gather and
      .scatter per window (``window.steps`` span);
    - ``driver_transfer_ms_per_window``: Σ driver.upload and .download per
      window;
    - ``loader_read_ms_per_batch``, ``loader_normalize_ms_per_batch``: Σ
      loader.read, Σ loader.normalize per ``loader.batches``;
    - ``loader_frames_used_share``: 100 × Σ train.frames / Σ loader.frames;
    - ``graph_captures``: Σ graph.captures in the whole measured window.
    """
    out = dict.fromkeys(("driver_gather_scatter_ms_per_window", "driver_transfer_ms_per_window",
                         "loader_read_ms_per_batch", "loader_normalize_ms_per_batch",
                         "loader_frames_used_share", "graph_captures"))
    got = records(run)
    if got is None:
        return out
    spans, counts = got
    windows = sum(1 for s in spans if s.name == "window.steps")
    if windows:
        out["driver_gather_scatter_ms_per_window"] = 1e3 * _seconds(spans, DRIVER_HOST) / windows
        out["driver_transfer_ms_per_window"] = 1e3 * _seconds(spans, DRIVER_COPIES) / windows
    batches = _counted(counts, "loader.batches")
    if batches:
        for name in ("read", "normalize"):
            out[f"loader_{name}_ms_per_batch"] = \
                1e3 * _seconds(spans, {f"loader.{name}"}) / batches
    made = _counted(counts, "loader.frames")
    if made:
        out["loader_frames_used_share"] = 100.0 * _counted(counts, "train.frames") / made
    whole = records(run, whole=True)
    if whole is not None and any(whole):
        out["graph_captures"] = _counted(whole[1], "graph.captures")
    return out


def _clipped(intervals, lo, hi):
    """Seconds of the union of ``intervals`` ((start, end) in seconds)
    inside [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def coverage(run) -> dict:
    """How far the port's spans account for the benchmark's outside
    measures in the untraced stretch:

    - ``driver_outside_ms_per_window``: the port's driver.* spans that lie
      outside the benchmark's ``window`` and ``decode`` spans, per window
      begun in the stretch; ``driver_outside_share``: the same over
      ``driver_host_ms_per_window`` (the benchmark's remainder), in %;
    - ``loader_busy_share``: the union of the loader thread's loader.read
      and loader.normalize spans over the stretch's seconds, in %;
      ``loader_put_wait_share``: its loader.put_wait spans, the same way.
    """
    out = {}
    got = records(run)
    if got is None:
        return out
    spans, _ = got
    lo, hi = run.t_untraced, run.t_end
    calls = [(t0, t0 + dt) for name in ("window", "decode") for t0, dt in run.spans.get(name, ())]
    n = run.span_count("window")
    if n:
        outside = [s for s in spans if s.name in DRIVER and not any(
            a <= s.start_ns / 1e9 and s.end_ns / 1e9 <= b for a, b in calls)]
        ms = 1e3 * _seconds(outside, DRIVER) / n
        host = harness.read_metrics(run, [{"name": "driver_host_ms_per_window", "unit": "ms"}])
        host = host["driver_host_ms_per_window"]["value"]
        out.update(driver_outside_ms_per_window=ms, driver_host_ms_per_window=host,
                   driver_outside_share=100.0 * ms / host if host > 0 else None)
    stretch = hi - lo
    every = records(run, whole=True)[0]  # a span begun before the stretch counts in part
    if stretch > 0 and any(s.name.startswith("loader.") for s in spans):
        def share(names):
            return 100.0 * _clipped([(s.start_ns / 1e9, s.end_ns / 1e9) for s in every
                                     if s.name in names], lo, hi) / stretch

        out.update(loader_busy_share=share({"loader.read", "loader.normalize"}),
                   loader_put_wait_share=share({"loader.put_wait"}))
    return out


def span_totals(run) -> dict:
    """{span name: [count, total ms]} over the untraced stretch."""
    got = records(run)
    totals = {}
    for s in (got[0] if got else ()):
        entry = totals.setdefault(s.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (s.end_ns - s.start_ns) / 1e6
    return totals


def idle_by_span(prof):
    """Seconds the device sat idle inside the trace, by the innermost
    ``gpubench.*`` or ``lfvdm.*`` host range around each gap ("other"
    outside them), as the harness's ``_idle_by_span`` splits them by
    ``gpubench.*`` alone. The port's ranges count only on the host side
    and only on the threads that hold the ``gpubench.*`` ranges (those
    that enqueue the device work; the loader thread's are read through
    ``per_layer``)."""
    from torch.autograd import DeviceType

    return split_gaps([(e.name, e.device_type == DeviceType.CUDA,
                        bool(getattr(e, "is_user_annotation", False)), e.thread,
                        e.time_range.start, e.time_range.end) for e in prof.events()])


def split_gaps(events):
    """``idle_by_span`` on (name, on the device, a user annotation, thread,
    start, end) tuples, times in microseconds."""
    device, bench, port = [], [], []
    lo, hi = float("inf"), float("-inf")
    for name, on_device, annotation, thread, start, end in events:
        lo, hi = min(lo, start), max(hi, end)
        if on_device and not annotation:
            device.append((start, end))
        elif name.startswith("gpubench."):
            bench.append((start, end, name[len("gpubench."):], on_device, thread))
        elif name.startswith("lfvdm.") and not on_device:
            port.append((start, end, name, thread))
    if not device:
        return {}
    threads = {r[4] for r in bench if not r[3]}
    ranges = [r[:3] for r in bench] + [r[:3] for r in port if r[3] in threads]
    device.sort()
    gaps, reach = {}, lo
    for s, e in device + [(hi, hi)]:
        if s > reach:
            mid = (s + reach) / 2
            inner = [r for r in ranges if r[0] <= mid <= r[1]]
            name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "other"
            gaps[name] = gaps.get(name, 0.0) + (s - reach) / 1e6
        reach = max(reach, e)
    return gaps


def report(run) -> dict:
    out = {"recorder": getattr(run, "recorder", False), "per_layer": per_layer(run),
           "coverage": coverage(run), "spans": span_totals(run)}
    gaps = getattr(run, "port_idle_gaps", None)
    if gaps is not None:
        total = sum(gaps.values())
        named = sum(v for k, v in gaps.items() if k.startswith("lfvdm."))
        out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])
        out["idle_in_port_spans_share"] = 100.0 * named / total if total > 0 else None
    return out


class PortRun(harness.Run):
    """The harness's run record, with the port's recorder on over the
    measured window (unless ``recorder`` is False) and the idle gaps also
    split by the port's ranges."""

    recorder = True

    def start_window(self):
        if self.recorder:
            from lfvdm_tpu_torch.utils import tracing

            tracing.reset()
            tracing.enable()
        super().start_window()

    def close_window(self):
        super().close_window()
        if self.recorder:
            from lfvdm_tpu_torch.utils import tracing

            tracing.disable()

    def reduce_trace(self):
        prof = getattr(self, "_prof", None)
        if prof is not None:
            self.port_idle_gaps = idle_by_span(prof)
        super().reduce_trace()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args, rest = parser.parse_known_args(argv)
    PortRun.recorder = bool(args.recorder)
    harness.Run = PortRun
    plain = harness.result_line
    harness.result_line = lambda run, count: dict(plain(run, count), port=report(run))
    return bench.main(rest)


if __name__ == "__main__":
    sys.exit(main())
