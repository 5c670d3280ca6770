"""Padding rows over all rows of the decode launches of the window's
requests, counted by the program (decode_pad_rows over decode_rows +
decode_pad_rows), in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.counter_share(t, "decode_pad_rows", "decode_rows")
