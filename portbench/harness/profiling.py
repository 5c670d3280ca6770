"""Device time from torch.profiler, with a guard against lost events.

On the H100 the profiler can lose whole windows of device events in
bursts. A window is kept only when it saw device events and, for every
guarded kernel, as many launches as the benchmark's wrappers counted in
it; otherwise it is discarded and taken again after a pause, at most
WINDOWS times. When every try loses events the caller gets None and
reports the device metrics as missing, never a number from a partial
trace.
"""

from __future__ import annotations

import collections
import time

WINDOWS = 6
PAUSE_S = 1.0
WINDOW_SPAN = "portbench:window"
SPAN_PREFIX = "portbench:"


def union_s(intervals):
    """Length of the union of (start, end) microsecond intervals, seconds."""
    return sum(e - s for s, e in merged(intervals)) / 1e6


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def lost(device_names, expected):
    """Why a window is to be discarded, or None: no device event, or a
    guarded kernel (a name substring) seen another number of times than
    the wrappers counted."""
    if not device_names:
        return "no device event"
    counts = collections.Counter(device_names)
    for key, want in expected.items():
        seen = sum(n for name, n in counts.items() if key in name)
        if seen != want:
            return f"{seen} launches of {key}, {want} counted"
    return None


class Window:
    """One kept profiler window: device events [(name, start_us, end_us)],
    host spans [(name, start_us, end_us)] and the window's bounds."""

    def __init__(self, device, spans, start, end):
        self.device, self.spans, self.start, self.end = device, spans, start, end

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self):
        return union_s([(s, e) for _, s, e in self.device])

    def kernel_s(self, key):
        """Device seconds of the launches whose name contains key."""
        return sum(e - s for name, s, e in self.device if key in name) / 1e6

    def top_ops(self, n=10):
        per = collections.defaultdict(float)
        for name, s, e in self.device:
            per[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The n longest stretches with nothing on the device, each named by
        the innermost benchmark span the host was in at its middle."""
        busy = [(s, e) for s, e in merged([(s, e) for _, s, e in self.device])
                if e > self.start and s < self.end]
        edges = [self.start] + [x for s, e in busy for x in (s, e)] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in self.spans if s <= mid <= e]
            out.append([min(inside)[1] if inside else "other", (b - a) / 1e6])
        return out


def events_of(prof):
    """(device events, host spans) of a finished torch.profiler run."""
    import torch

    device, spans = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("Activity Buffer") or getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(SPAN_PREFIX):
                continue
            device.append((e.name, s, t))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], s, t))
    return device, spans


def _take_window(fn):
    """(device events, host spans, fn's counts) of one profiled call of fn,
    after a warm-up step that brings the card's tracing up."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        with torch.profiler.record_function(WINDOW_SPAN):
            counts = fn()
            torch.cuda.synchronize()
        prof.step()
    return (*events_of(prof), counts)


def profile(fn, pause_s=PAUSE_S, tries=WINDOWS, log=print):
    """Run fn() (which returns {kernel name substring: launches its wrappers
    counted}) under the profiler until a window keeps every event; returns
    (Window, fn's counts) or (None, None)."""
    import torch

    if not torch.cuda.is_available():  # no device to trace: the slice runs, nothing is kept
        return None, fn()
    for attempt in range(tries):
        device, spans, counts = _take_window(fn)
        why = lost([name for name, _, _ in device], counts)
        bounds = [(s, e) for name, s, e in spans if name == WINDOW_SPAN[len(SPAN_PREFIX):]]
        if why is None and bounds:
            return Window(device, spans, *bounds[0]), counts
        log(f"profiler window {attempt + 1} discarded: {why or 'no window span'}")
        time.sleep(pause_s)
    return None, None


def span(name):
    """A host span the profiler records (named in idle gaps)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)
