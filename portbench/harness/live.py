"""Live cells: N streams of the web service's MultiStreamRecognizer, fed
0.1 s pieces on a real-time schedule as websocket clients send them, every
ready slot stepped at once.

A partial's latency runs from when the piece that completed its chunk was
due on the schedule to when step() has returned that stream's tokens of the
step on the host. The benchmark wraps the program's fused_stream_step to
keep every step's encoder frames for the correctness check.

The kind "live" of a traffic file: `run` is one run of a cell, `control`
the control's checks on the streams a run would compare.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench.harness import check_live, profiling, stats, traffic, weights
from portbench.harness.offline import patched
from portbench.reference.host import StreamWindows

RATE = 16000


class LiveCell:
    def __init__(self, cfg, mix, seed, device, log=print):
        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        self.steps_seen = []  # (enc_out, mask) of each step while capturing
        self.capture = False
        self.fused_calls = 0

    @contextlib.contextmanager
    def wrappers(self, spans):
        from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming_online

        orig = streaming_online.fused_stream_step

        def fused_stream_step(*a, **kw):
            out = orig(*a, **kw)
            self.fused_calls += 1
            if self.capture:
                self.steps_seen.append((out[4], a[6] if len(a) > 6 else kw["mask"]))
            return out

        with patched(streaming_online, "fused_stream_step", fused_stream_step):
            yield

    def setup(self, seconds):
        from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import MultiStreamRecognizer

        self.model, self.weights = weights.asr_model(self.cfg, self.seed, self.device)
        self.streams = traffic.live_streams(self.mix, self.seed, seconds)
        self.rec = MultiStreamRecognizer(self.model, n_streams=self.mix["streams"])

    def warm(self):
        """A few steps of all slots at the cell's shape, then the slots are
        closed (open_stream zeroes a slot's state and context)."""
        rec, n = self.rec, self.mix["streams"]
        slots = [rec.open_stream() for _ in range(n)]
        need = StreamWindows().ready_at() + (self.mix["warm_steps"] - 1) * 64 * 160
        for slot, (_, samples) in zip(slots, self.streams):
            rec.accept_waveform(slot, samples[:need] * 0.5)
        while rec.ready_slots():
            rec.step()
        for slot in slots:
            rec.close_stream(slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds=None, max_steps=None, step_span=None):
        """Open every stream from its start, feed and step in real time until
        `seconds` have passed or `max_steps` steps ran. Returns a dict:
        partial latencies (s), step walls (s), served tokens per stream and
        chunk, steps, and the window (s)."""
        rec, piece = self.rec, int(self.mix["piece_s"] * RATE)
        slots = [rec.open_stream() for _ in self.streams]
        phases = [p for p, _ in self.streams]
        fed = [0] * len(slots)
        windows = [StreamWindows() for _ in slots]
        served = [[] for _ in slots]
        latencies, walls = [], []
        t0 = time.perf_counter()
        steps = 0
        span = step_span or (lambda: contextlib.nullcontext())

        def due(s, k):  # piece k of stream s (its samples [k piece, (k + 1) piece))
            return t0 + phases[s] + self.mix["piece_s"] * (k + 1)

        while True:
            now = time.perf_counter()
            if (seconds is not None and now - t0 >= seconds) or \
                    (max_steps is not None and steps >= max_steps):
                break
            for s, slot in enumerate(slots):
                while due(s, fed[s]) <= now:
                    k = fed[s]
                    rec.accept_waveform(slot, self.streams[s][1][k * piece: (k + 1) * piece])
                    fed[s] += 1
            if rec.ready_slots():
                t_s = time.perf_counter()
                with span():
                    out = rec.step()
                t_e = time.perf_counter()
                walls.append(t_e - t_s)
                steps += 1
                for slot, toks in out.items():
                    s = slots.index(slot)
                    ready_k = math.ceil(windows[s].ready_at() / piece) - 1
                    windows[s].take(self.streams[s][1])
                    latencies.append(t_e - due(s, ready_k))
                    served[s].append(list(toks))
                continue
            nxt = min(due(s, fed[s]) for s in range(len(slots)))
            time.sleep(max(0.0, nxt - time.perf_counter()))  # until the next piece is due
        window = time.perf_counter() - t0
        for slot in slots:
            rec.close_stream(slot)
        return {"latencies": latencies, "walls": walls, "served": served, "steps": steps,
                "window_s": window}

    def traced_slice(self, steps):
        """`steps` real-time steps under the profiler."""
        state = {}

        def fn():
            before = self.fused_calls
            state["run"] = self.run(max_steps=steps, step_span=lambda: profiling.span("step"))
            return {"logmel_kernel": self.fused_calls - before}

        window, _ = profiling.profile(fn, log=self.log)
        return window, state.get("run")


def run(cfg, mix, seed, seconds, trace, device, log):
    cell = LiveCell(cfg, mix, seed, device, log=log)
    t = {"cfg": cfg, "trace": trace}
    with cell.wrappers(spans=trace):
        cell.setup(seconds)
        cell.warm()
        t["setup_done"] = time.perf_counter()
        cell.capture = True
        with stats.GcClock() as gc_clock:
            run = cell.run(seconds=seconds)
        cell.capture = False
        t.update(partials=run["latencies"], step_walls=run["walls"], window_s=run["window_s"])
        lat, walls = run["latencies"], run["walls"]
        if lat:
            log(f"window: {run['steps']} steps, {len(lat)} partials in {run['window_s']:.3f} s; "
                f"rows a step {len(lat) / max(1, run['steps']):.3f}; step wall ms p50 "
                f"{1e3 * stats.percentile(walls, 50):.2f} p95 {1e3 * stats.percentile(walls, 95):.2f} "
                f"max {1e3 * max(walls):.2f}; partial ms p50 {1e3 * stats.percentile(lat, 50):.2f} "
                f"p95 {1e3 * stats.percentile(lat, 95):.2f} max {1e3 * max(lat):.2f}; {gc_clock}")
        if device.type == "cuda":
            torch.cuda.synchronize()
            t["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if trace:
            t["profile"], traced = cell.traced_slice(mix["trace_steps"])
            t["profiled_steps"] = traced["steps"] if traced else None
        enc = check_live.program_outputs(cell.steps_seen, len(cell.streams))
        del cell.model, cell.rec
        cell.steps_seen.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = check_live.judge(cfg, cell.weights, cell.streams, enc, run["served"], device)
    return t, checks, len(run["latencies"]), 0


def control(cfg, mix, seed, seconds, device):
    """The checks of the control on every stream of a live cell, over the
    whole chunks that `seconds` hold."""
    _, w = weights.asr_model(cfg, seed, device)
    streams = traffic.live_streams(mix, seed, seconds)
    chunks = [int(seconds / 0.64)] * len(streams)
    enc, served = check_live.control_outputs(cfg, w, streams, chunks, device, cfg["control"]["encoder"])
    return check_live.judge(cfg, w, streams, enc, served, device)
