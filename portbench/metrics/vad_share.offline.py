"""Share of the requests' wall spent in the pipeline's VAD stage: the sum
of each result's timing["vad"] over the sum of request walls, in %."""

from portbench.harness.readers import vad_share as read  # noqa: F401
