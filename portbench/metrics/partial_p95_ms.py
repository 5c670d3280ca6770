"""95th percentile over every partial of every stream in the window: from
when the piece that completed its chunk was due on the real-time schedule
to when the step's tokens of that stream are on the host (host clock)."""

from portbench.harness.stats import percentile


def read(t):
    lat = t.get("partials")
    return 1e3 * percentile(lat, 95) if lat else None
