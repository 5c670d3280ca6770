"""Kernel 2's (attention weights) share of its roofline: the frozen bound
of each launch's shapes summed over the traced window, over the device
time of its launches, in %."""

from portbench.harness.readers import attention_roofline as read  # noqa: F401
