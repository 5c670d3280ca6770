"""Share of the requests' wall spent before run() starts: in
TranscriberPipeline's constructor, which builds the request's stage models
(the diarizer's facade, the DNSMOS analyzer and the punctuation restorer
with its ViBERT, each from its checkpoint's arrays onto the card). The
host clock's wall of each request less its request span, over the wall,
in %."""

from portbench.harness import program_spans


def read(t):
    return program_spans.outside_share(t)
