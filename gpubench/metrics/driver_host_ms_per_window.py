"""Host milliseconds per window that sample_video spends outside its windows
and decodes (scheme planning, gathers, scatters and copies), over the
untraced stretch: its seconds less the window and decode spans begun in it,
per window begun in it."""


def read(run):
    n = run.span_count("window")
    if not n or run.t_end is None:
        return None
    return 1e3 * (run.untraced_seconds() - run.span_total("window")
                  - run.span_total("decode")) / n
