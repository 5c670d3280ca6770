"""Share of the requests' wall in the diarization stage as the request
waits for it (the program's diarization span: the wait for the diarizer's
background pass, which overlaps the decode and is not counted here, then
the post-processing and the words' speakers), over the window's request
spans, in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("diarization",))
