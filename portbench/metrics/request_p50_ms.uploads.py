"""Median request wall of the traced run's window (host clock)."""

from portbench.harness.stats import percentile


def read(t):
    reqs = t.get("requests")
    return 1e3 * percentile([r["wall_s"] for r in reqs], 50) if reqs else None
