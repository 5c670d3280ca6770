"""The beam kernel's share of its roofline: the sum over its launches in
the traced window of the frozen bound of each launch's shapes, over the
sum of their device time, in %."""

from portbench.harness.readers import beam_roofline as read  # noqa: F401
