"""Generated frames finished over the measured window: each window's latent
frames × B, finished when its window returns (or its video's decode)."""


def read(run):
    return run.units_done() / run.window_seconds() if run.units else None
