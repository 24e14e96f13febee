"""The port's recorder of spans and counters.

A span marks a layer boundary on the host: its name, when it began and
ended (``time.perf_counter_ns``), the thread it ran on and the span that
caused it (the enclosing span on the same thread). A count is a number of
things at a boundary (bytes, frames, replays) with the time it was made,
so a reader can count over any stretch of time, as it filters spans.

The recorder is off by default. Off, ``span`` returns one shared no-op
after a single flag check and ``count`` returns at once: no clock read, no
allocation. ``enable()`` turns it on for the whole process. On, records go
into memory, up to ``CAPACITY`` spans and counts together; those past it
are refused and counted by ``dropped()``. While a ``torch.profiler`` is
running, each span also opens a ``record_function`` range named
``lfvdm.<name>``, so the span lies in the profiler's trace on its clock,
and an idle gap on the device can be put down to what the host was doing.

    from lfvdm_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    ...  # sample, train
    tracing.disable()
    for s in tracing.spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms")

``TrainLoop(profile_dir=...)`` turns the recorder on for the steps it
profiles, so the spans appear in the ``train_trace.json`` it writes.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18  # spans and counts kept at most between two resets


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    thread: int  # threading.get_ident() of the thread it ran on
    parent: int  # index in spans() of the enclosing span on its thread, or -1


class Count(NamedTuple):
    name: str
    t_ns: int
    n: float


_on = False
_spans: list = []  # [name, start_ns, end_ns, thread, parent] per span, in the order begun
_counts: List[Count] = []
_dropped = 0
_generation = 0  # bumped by reset(), so a span left open across it names no parent
_lock = threading.Lock()
_local = threading.local()  # .stack: (generation, index) of the open spans of this thread


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "record", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        start = time.perf_counter_ns()
        with _lock:
            if len(_spans) + len(_counts) >= CAPACITY:
                _dropped += 1
                self.record = None
            else:
                parent = stack[-1][1] if stack and stack[-1][0] == _generation else -1
                self.record = [self.name, start, None, threading.get_ident(), parent]
                stack.append((_generation, len(_spans)))
                _spans.append(self.record)
        self.range = None
        if getattr(_profiler, "_is_profiler_enabled", False):
            self.range = _profiler.record_function(f"lfvdm.{self.name}")
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.record is not None:
            self.record[2] = time.perf_counter_ns()
            _local.stack.pop()
        return False


def span(name: str):
    """A context manager around one piece of work at a layer boundary:
    recorded while the recorder is on, the shared no-op while it is off."""
    if not _on:
        return NO_SPAN
    return _Span(name)


def count(name: str, n: float = 1):
    """Record ``n`` of ``name`` now, while the recorder is on."""
    global _dropped
    if not _on:
        return
    record = Count(name, time.perf_counter_ns(), n)
    with _lock:
        if len(_spans) + len(_counts) >= CAPACITY:
            _dropped += 1
        else:
            _counts.append(record)


def enabled() -> bool:
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Forget every record and the dropped count (the on/off state stays)."""
    global _dropped, _generation
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0
        _generation += 1


def spans() -> List[Span]:
    """The spans recorded since the last reset, in the order they began;
    ``parent`` indexes this list."""
    with _lock:
        return [Span(*r) for r in _spans]


def counts() -> List[Count]:
    with _lock:
        return list(_counts)


def dropped() -> int:
    """Spans and counts refused since the last reset, the buffer being full."""
    return _dropped
