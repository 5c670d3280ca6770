"""Share of the requests' wall that no direct child span of the program's
request span covers (run() less load_audio, vad, plan, transcription,
merge_suspect and the stages after them), over the window's request spans,
in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.self_share(t)
