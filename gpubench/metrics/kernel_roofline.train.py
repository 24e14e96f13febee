"""Time-weighted roofline share of the three port kernels' traced launches, in %."""

from _read import kernel_roofline as read  # noqa: F401
