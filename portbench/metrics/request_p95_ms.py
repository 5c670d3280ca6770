"""95th percentile of every request's wall in the window, from its start
to its result on the host (host clock)."""

from portbench.harness.stats import percentile


def read(t):
    reqs = t.get("requests")
    return 1e3 * percentile([r["wall_s"] for r in reqs], 95) if reqs else None
