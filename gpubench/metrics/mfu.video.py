"""Model FLOPs of the window's finished work over its seconds at the bf16 peak, in %."""

from _read import mfu as read  # noqa: F401
