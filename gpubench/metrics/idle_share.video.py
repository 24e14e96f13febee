"""Share of the traced window in which no operation ran on the device, in %."""

from _read import idle_share as read  # noqa: F401
