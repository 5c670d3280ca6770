"""The decode's share of the chip's peak in the traced window: the least
time its operations need (the encoder over valid frames at the peak of the
configuration's encoder precision, the beam search's per-frame operations
at the float32 rate) over the window's wall, in %."""

from portbench.harness.readers import decode_mfu as read  # noqa: F401
