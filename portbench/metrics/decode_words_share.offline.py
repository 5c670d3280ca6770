"""Share of the requests' wall spent building words from the beams on the
host (the program's decode_words span: beam_result_to_words over each
batch's rows), over the window's request spans, in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("decode_words",))
