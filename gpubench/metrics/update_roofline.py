"""Share of its roofline (bytes-bound) of the fused AdamW+EMA kernel over
the traced steps, in %."""

from _read import update_roofline as read  # noqa: F401
