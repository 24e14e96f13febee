"""Seconds from the start of the process to the start of the measured window."""


def read(run):
    return run.setup_s
