"""Share of the requests' wall spent building the VAD (the program's
vad_build span: load_silero and Silero made on the card, every request),
over the window's request spans, in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("vad_build",))
