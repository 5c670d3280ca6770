"""Audio seconds of every request completed in the window over the time
from the first request's start to the last one's end (host clock)."""


def read(t):
    reqs = t.get("requests")
    return sum(r["audio_s"] for r in reqs) / t["window_s"] if reqs else None
