"""Milliseconds of the codec's decode per decoded frame, over the decodes
begun in the untraced stretch."""


def read(run):
    n, frames = run.span_count("decode"), run.counts.get("frames_per_decode")
    return 1e3 * run.span_total("decode") / (n * frames) if n and frames else None
