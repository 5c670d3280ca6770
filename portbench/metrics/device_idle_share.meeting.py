"""Share of the traced window in which no kernel or copy ran on the
device: 1 - the union of device intervals over the window, in %."""

from portbench.harness.readers import idle_share as read  # noqa: F401
