"""Share of the requests' wall in which the decoder uploads a batch or reads
one back (the program's decode_upload and decode_readback spans: the
pageable upload and the readback are where the host waits for the card),
over the window's request spans, in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("decode_upload", "decode_readback"))
