"""Kernel 4's (whole encoder layer) share of its roofline: the frozen
bound of each layer call's shapes summed over the traced window, over the
device time of the kernels a layer call launches (products, score pass,
depthwise conv, elementwise passes), in %."""

from portbench.harness.readers import layer_roofline as read  # noqa: F401
