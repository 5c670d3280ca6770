"""Median host wall of MultiStreamRecognizer.step() in the window."""

from portbench.harness.stats import percentile


def read(t):
    walls = t.get("step_walls")
    return 1e3 * percentile(walls, 50) if walls else None
