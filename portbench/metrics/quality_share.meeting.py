"""Share of the requests' wall in the quality stage as the request waits
for it (the program's quality span, in the request's thread: the join of
the DNSMOS pass). The pass itself runs in a background thread during the
decode (the quality_overlapped span, joined to the request's record); it
is left out, since it overlaps other spans of the request and the
profiler does not trace that thread. Over the window's request spans, in
%."""

from portbench.harness import program_spans


def read(t):
    return program_spans.share(t, ("quality",))
