"""The program's own spans and counters of the offline requests, for the
per-layer metrics that read them.

The program (sherpa_vietnamese_asr_tpu_torch/utils/trace.py) keeps each
finished request in memory: spans (name, start_ns, end_ns, parent's name) on
time.perf_counter_ns(), the clock of `setup_done` and the window here, and
counters. The window's records are those whose `request` span starts in
[setup_done, setup_done + window_s). Every reader returns None when the
program keeps no records, when their number differs from the window's
requests (the ring lost some, or a request failed) or when one is flagged
failed: a metric is missing, never a number from part of the window.
"""

from __future__ import annotations

import importlib


def finished():
    """The program's finished request records, or None (a program without
    request records)."""
    try:
        trace = importlib.import_module("sherpa_vietnamese_asr_tpu_torch.utils.trace")
    except ImportError:
        return None
    return trace.finished()


def _request(rec):
    """(start_ns, end_ns) of the record's request span."""
    return next((s, e) for name, s, e, parent in rec.spans if name == "request" and parent is None)


def records(t):
    """The window's records, or None."""
    reqs, got = t.get("requests"), finished()
    if not reqs or got is None:
        return None
    lo, hi = t["setup_done"], t["setup_done"] + t["window_s"]
    kept = [r for r in got if lo <= _request(r)[0] / 1e9 < hi]
    if len(kept) != len(reqs) or any(r.failed for r in kept):
        return None
    return kept


def _request_ns(recs):
    return sum(e - s for s, e in map(_request, recs))


def share(t, names):
    """100 x the spans named in `names` over the requests' spans, in %."""
    recs = records(t)
    if recs is None:
        return None
    spans = sum(e - s for r in recs for name, s, e, _ in r.spans if name in names)
    return 100.0 * spans / _request_ns(recs)


def self_share(t):
    """100 x the requests' time outside every direct child of `request`
    (each request's span less the union of its children's), in %."""
    recs = records(t)
    if recs is None:
        return None
    covered = 0
    for r in recs:
        lo, hi = _request(r)
        end = lo
        for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e, parent in r.spans
                           if parent == "request"):
            if e > end:
                covered += e - max(s, end)
                end = e
    return 100.0 * (1.0 - covered / _request_ns(recs))


def counter_share(t, part, rest):
    """100 x the counter `part` over `part` + `rest`, summed over the
    window's records, in %."""
    recs = records(t)
    if recs is None:
        return None
    a = sum(r.counters.get(part, 0) for r in recs)
    b = sum(r.counters.get(rest, 0) for r in recs)
    return 100.0 * a / (a + b) if a + b else None


def outside_share(t):
    """100 x the requests' wall (host clock, from the pipeline's
    construction to run()'s result) outside their request spans, over that
    wall, in %: what TranscriberPipeline's constructor costs a request."""
    recs = records(t)
    if recs is None:
        return None
    wall = sum(r["wall_s"] for r in t["requests"])
    return 100.0 * (1.0 - _request_ns(recs) / 1e9 / wall)
