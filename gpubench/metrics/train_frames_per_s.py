"""B × K frames × the train steps the window ran, over its seconds (ending at
a synchronise after the last step)."""


def read(run):
    return run.units_done() / run.window_seconds() if run.units else None
