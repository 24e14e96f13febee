"""Milliseconds TrainLoop waits for the loader per step (two batches a
step), over the steps that finished in the untraced stretch."""


def read(run):
    n = len(run.untraced_units()) if run.t_end is not None else 0
    return 1e3 * run.span_total("data_wait") / n if n else None
