"""Milliseconds of sample_window (to its result on the card) per model call,
over the windows begun in the untraced stretch."""


def read(run):
    n, steps = run.span_count("window"), run.counts.get("steps_per_window")
    return 1e3 * run.span_total("window") / (n * steps) if n and steps else None
