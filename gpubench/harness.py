"""The benchmark's driver: finds a cell's configuration, traffic mix, entry
and metrics by the names in ``BENCHMARK.json``, runs it once, and prints the
result line.

A cell is data: ``BENCHMARK.json`` names its configuration (a file of
sizes under ``gpubench/configs/``) and its traffic mix
(``gpubench/traffic/<traffic>.json``, whose ``entry`` names the program
entry point that serves it: ``gpubench/entries/<entry>.py``). Each metric
is a reader of its own, ``gpubench/metrics/<name>.py``, whose ``read(run)``
takes the number from the run's record (host clock, spans, counters, the
device trace) and returns None where it finds nothing to read.

A run: set-up (the program's kernels built or found, the model made on the
device from the seed, the cell's shapes warmed up), then the measured
window of ``--seconds``, then, with the program's state freed, the check of
what the window produced against the plain reference in
``gpubench/reference/``. ``--trace 1`` also records the spans into a
``torch.profiler`` trace over the first units of the window and reports the
per-layer metrics instead of the end-to-end ones: those from the device
trace over the traced units, those from the host clock (spans, model FLOPs
per second) over the rest of the window, the untraced stretch, where the
profiler adds nothing to the program's time.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lfvdm_tpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its workload entry, its
    configuration (the file's contents), its traffic mix and its metrics,
    end-to-end and per-layer, each with the path of its reader."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["limits"] = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def mine(m, reported):
        if "workloads" in m:
            return name in m["workloads"]
        return m.get("moves") in reported if reported is not None else True

    e2e = [m for m in bench["end_to_end"] if mine(m, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m, reported)]
    return dict(name=name, workload=w, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=layer, root=root)


class Run:
    """The record of one run: host-clock marks, spans, counts, the units of
    work the window finished, the device trace, and the checks."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 t_process: float):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), seconds, trace
        self.device, self.t_process = device, t_process
        self.t_window = self.t_end = None
        self.t_untraced = None  # where the untraced stretch of the window starts
        self.setup_s = None
        self.units = []  # (host time the unit finished, units of output: frames, steps, ...)
        self.attempted = self.failed = 0
        self.spans: Dict[str, list] = {}  # name -> [(host start, seconds)] in the window
        self.counts: Dict[str, float] = {}
        self.checks: Dict[str, tuple] = {}  # name -> (value, limit)
        self.work: Dict[str, object] = {}  # model FLOPs per unit, least kernel seconds, ...
        self.trace_ops = None  # {device op: (seconds, count)} over the traced units
        self.busy_s = self.window_s = None
        self.idle_gaps = None
        self.memory_peak_bytes = None
        self._profiler = None
        self._trace_start = None
        self._settle = 0

    # ---- spans and the trace ----

    @contextlib.contextmanager
    def span(self, name: str):
        """A span on the host clock around a call into a layer, kept while
        the window is open; inside a trace also a ``record_function`` range,
        so idle gaps on the device can be told by what the host was doing."""
        rf = None
        if self._profiler is not None:
            import torch

            rf = torch.profiler.record_function(f"gpubench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.t_window is not None and self.t_end is None:
                self.spans.setdefault(name, []).append((t0, time.perf_counter() - t0))
            if rf is not None:
                rf.__exit__(None, None, None)

    def span_total(self, name: str) -> float:
        """Seconds of the spans ``name`` that began in the untraced stretch."""
        return sum(dt for t0, dt in self.spans.get(name, ()) if t0 >= self.t_untraced)

    def span_count(self, name: str) -> int:
        return sum(1 for t0, _ in self.spans.get(name, ()) if t0 >= self.t_untraced)

    def start_window(self):
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t_process
        if self.trace:
            self.start_trace()
        else:
            self.t_untraced = self.t_window

    def close_window(self):
        """The window ends now (after a synchronise); a trace still running
        stops with it."""
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self.stop_trace()
        if self.t_untraced is None:  # the trace and its settling took the whole window
            self.t_untraced = self.t_end

    def remaining(self) -> float:
        return self.seconds - (time.perf_counter() - self.t_window)

    def finish_unit(self, amount: float, n: int = 1):
        """``n`` units that finished now, ``amount`` of output between them.
        In a trace, stops the trace once the traffic's ``trace_units`` have
        finished, and starts the untraced stretch ``settle_units`` units
        later (a loader that ran ahead while the trace stopped has caught
        up by then)."""
        self.units.append((time.perf_counter(), amount, n))
        traffic = self.cell["traffic"]
        if self._profiler is not None and sum(u[2] for u in self.units) >= \
                traffic.get("trace_units", 1):
            self.stop_trace()
            self._settle = traffic.get("settle_units", 0) + 1
        if self._settle:
            self._settle -= 1
            if not self._settle:
                self.t_untraced = time.perf_counter()

    def start_trace(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._profiler.start()
        self._trace_start = time.perf_counter()

    def stop_trace(self):
        import torch

        if self._profiler is None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._trace_start
        prof, self._profiler = self._profiler, None
        prof.stop()
        self._prof = prof

    def reduce_trace(self):
        """Device time by operation, busy seconds and the idle gaps by the
        host's span, from the trace (after the window)."""
        from yardstick import device_ops

        prof = getattr(self, "_prof", None)
        if prof is None:
            return
        self.trace_ops = device_ops(prof)
        self.busy_s = sum(s for s, _ in self.trace_ops.values())
        self.idle_gaps, extent = _idle_by_span(prof)
        if extent:
            self.window_s = extent
        del self._prof

    # ---- result ----

    def window_seconds(self) -> float:
        return self.t_end - self.t_window

    def untraced_seconds(self) -> float:
        """Seconds of the untraced stretch: the whole window in an untraced
        run, from the trace's stop to the window's end in a traced one."""
        return self.t_end - self.t_untraced

    def untraced_units(self) -> list:
        """Indices of the units that finished in the untraced stretch."""
        return [i for i, u in enumerate(self.units) if u[0] > self.t_untraced]

    def units_done(self) -> float:
        return sum(u[1] for u in self.units)


def _idle_by_span(prof):
    """Seconds the device sat idle inside the trace (between its operations,
    and before the first and after the last), by the innermost
    ``gpubench.*`` host range around each gap ("other" outside them), and
    the seconds from the trace's first event to its last (the traced
    window, without the profiler's own start and stop)."""
    from torch.autograd import DeviceType

    device, ranges, lo, hi = [], [], float("inf"), float("-inf")
    for e in prof.events():
        tr = e.time_range
        lo, hi = min(lo, tr.start), max(hi, tr.end)
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append((tr.start, tr.end))
        elif e.name.startswith("gpubench."):
            ranges.append((tr.start, tr.end, e.name[len("gpubench."):]))
    if not device:
        return {}, None
    device.sort()
    gaps, end = {}, lo
    for s, e in device + [(hi, hi)]:
        if s > end:
            mid = (s + end) / 2
            inner = [r for r in ranges if r[0] <= mid <= r[1]]
            name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "other"
            gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e6
        end = max(end, e)
    return gaps, (hi - lo) / 1e6


def read_metrics(run: Run, metrics) -> Dict[str, dict]:
    if str(HERE / "metrics") not in sys.path:
        sys.path.insert(0, str(HERE / "metrics"))
    out = {}
    for m in metrics:
        reader = _load(HERE / "metrics" / f"{m['name']}.py", f"gpubench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_info(run: Run, count: int) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": run.memory_peak_bytes}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        info["power_limit"] = None
    if run.trace:
        info["busy_s"] = run.busy_s
        info["window_s"] = run.window_s
    return info


def is_correct(run: Run) -> bool:
    """Every number compared within its limit (and at least one compared)."""
    return bool(run.checks) and all(v <= lim for v, lim in run.checks.values())


def result_line(run: Run, count: int) -> dict:
    correct = is_correct(run)
    metrics = read_metrics(run, run.cell["per_layer"] if run.trace else run.cell["end_to_end"])
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info(run, count)}
    if run.trace and run.trace_ops is not None:
        ops = sorted(run.trace_ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted((run.idle_gaps or {}).items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:120], s] for k, (s, _) in ops],
                            "idle_gaps": [[k, s] for k, s in gaps]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t_process: float) -> Run:
    """Set-up, window and check of ``cell`` on ``device``; returns the
    record. The entry module does the work (``run(run)`` then
    ``check(run)``); its program state is freed between the two."""
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    run = Run(cell, seed, seconds, trace, device, t_process)
    entry = _load(HERE / "entries" / f"{cell['traffic']['entry']}.py",
                  f"gpubench_entry_{cell['traffic']['entry']}")
    kept = entry.run(run)
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.reduce_trace()
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entry.check(run, kept)
    run.check_s = time.perf_counter() - t0
    return run

