"""Share of the requests' wall spent restoring punctuation (the program's
punctuation span: the restorer's ViBERT passes and their host work; the
ViBERT built for the request is in the request's own time), over the
window's request spans, in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("punctuation",))
