"""Percentiles of the end-to-end and per-layer metrics, the time the
host's cyclic garbage collector takes inside the window, and what the
process's CPU time went to over it."""

from __future__ import annotations

import gc
import resource
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


class HostClock:
    """The process's CPU seconds in user and kernel mode while the `with`
    block runs, and its peak resident memory (the kernel's share counts
    page faults, which weigh much in a sandboxed kernel)."""

    def __enter__(self):
        self._t = time.perf_counter()
        self._ru = resource.getrusage(resource.RUSAGE_SELF)
        return self

    def __exit__(self, *exc):
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.wall = time.perf_counter() - self._t
        self.user = ru.ru_utime - self._ru.ru_utime
        self.sys = ru.ru_stime - self._ru.ru_stime
        self.maxrss_gib = ru.ru_maxrss / 2**20

    def __str__(self):
        return (f"process cpu user {self.user:.3f} s sys {self.sys:.3f} s over {self.wall:.3f} s, "
                f"peak resident {self.maxrss_gib:.2f} GiB")
