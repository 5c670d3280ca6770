"""Share of the requests' wall spent in suspect detection and filler
removal (the program's suspect span), over the window's request spans,
in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("suspect",))
