"""Percentiles of the end-to-end and per-layer metrics, and the time the
host's cyclic garbage collector takes inside the window."""

from __future__ import annotations

import gc
import time

import numpy as np


def percentile(values, q):
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class GcClock:
    """Counts the collector's passes by generation, and their seconds,
    while the `with` block runs."""

    def __init__(self):
        self.count, self.seconds, self._start = [0, 0, 0], [0.0, 0.0, 0.0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._start
            self._start = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def __str__(self):
        return "gc passes by generation " + " / ".join(map(str, self.count)) + ", seconds " + \
            " / ".join(f"{s:.4f}" for s in self.seconds)
