"""One run of one cell: set-up, the measured window, the traced slice with
--trace 1, the correctness check, and the result line.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is a file found by its name in BENCHMARK.json (or in
portbench/held_back.json, for cells kept out of it):
portbench/configs/<config>.json, portbench/traffic/<traffic>.json,
portbench/metrics/<metric>.py (a `read(trace)` returning a number or
None) and portbench/limits/<workload>.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "sherpa_vietnamese_asr_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_bench(root=ROOT):
    """BENCHMARK.json with the cells and metrics of portbench/held_back.json
    (measured, kept for a later benchmark PR, run only when named) added."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    held = load_json(os.path.join(PB, "held_back.json"))
    return dict(bench, **{k: bench[k] + held[k] for k in ("workloads", "end_to_end", "per_layer")})


def spec(workload, root=ROOT):
    """(BENCHMARK.json and the held-back cells, the workload's entry, its
    config, traffic mix and limits)."""
    bench = load_bench(root)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(PB, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(PB, "limits", f"{workload}.json"))
    return bench, cell, cfg, mix, limits


def metrics_of(bench, workload, trace):
    """The cell's metric entries: end-to-end with --trace 0, per-layer with 1."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def reader(name):
    path = os.path.join(PB, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card():
    """(name, power limit as nvidia-smi prints it, or None)."""
    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = None
    return torch.cuda.get_device_name(0), limit


def run_offline(cfg, mix, seed, seconds, trace, device, log):
    import torch

    from portbench.harness import check_offline, offline, stats

    cell = offline.OfflineCell(cfg, mix, seed, device, log=log)
    t = {"cfg": cfg, "trace": trace}
    with tempfile.TemporaryDirectory(prefix="portbench-") as work, \
            offline.wrappers(cell.rec, spans=trace):
        cell.setup(work)
        cell.warm()
        t["setup_done"] = time.perf_counter()
        with stats.GcClock() as gc_clock, stats.HostClock() as host_clock:
            records, failed, attempted, window = cell.window(seconds)
        t.update(requests=records, window_s=window, rows=list(cell.rec.rows))
        walls = sorted(r["wall_s"] for r in records)
        if walls:
            by_file = {}
            for r in records:
                by_file.setdefault(r["audio_s"], []).append(r["wall_s"])
            log(f"window: {len(walls)} requests in {window:.3f} s, wall min {walls[0]:.4f} median "
                f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; {gc_clock}; "
                f"{len(t['rows'])} decode launches, {sum(r for r, _ in t['rows'])} real rows, "
                f"{sum(r['words'] for r in records)} words; order "
                + " ".join(str(int(r['audio_s'])) for r in records[:len(cell.pool)]))
            log(f"host: {host_clock}; median wall by file: " + " ".join(
                f"{int(d)} s {sorted(w)[len(w) // 2]:.4f} ({len(w)})" for d, w in sorted(by_file.items())))
        if device.type == "cuda":
            torch.cuda.synchronize()
            t["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if trace:
            t["profile"], t["launches"] = cell.traced_slice(attempted, mix["trace_requests"])
            keys = sorted({k for r in records for k in r["timing"]})
            log("mean request timing (s): " + " ".join(
                f"{k} {sum(r['timing'][k] for r in records) / max(1, len(records)):.4f}" for k in keys)
                + f"; wall {sum(r['wall_s'] for r in records) / max(1, len(records)):.4f}"
                + f"; words {sum(r['words'] for r in records) / max(1, len(records)):.1f}")
        got = {i: check_offline.program_outputs(cell.rec.captured[i]) for i in cell.sample}
        paths = {i: cell.pool[i][0] for i in cell.sample}
        del cell.model
        cell.rec.captured.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = check_offline.judge_all(cfg, cell.weights, cell.vad_weights,
                                         [(paths[i], got[i]) for i in cell.sample], device,
                                         cell.stage_refs())
        log(f"check: {len(cell.sample)} requests against the reference in "
            f"{time.perf_counter() - t_check:.3f} s")
    return t, checks, attempted, failed


def run_live(cfg, mix, seed, seconds, trace, device, log):
    import torch

    from portbench.harness import check_live, live, stats

    cell = live.LiveCell(cfg, mix, seed, device, log=log)
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


def measure(workload, seed, seconds, trace, device, t_start, root=ROOT, log=None, overrides=None):
    """Run the cell; returns the result dict (without printing it)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench, cell_entry, cfg, mix, limits = spec(workload, root)
    if overrides:
        cfg = dict(cfg, **overrides.get("config", {}))
        mix = dict(mix, **overrides.get("traffic", {}))
        limits = dict(limits, **overrides.get("limits", {}))
    device = torch.device(device)
    run = run_live if mix["kind"] == "live" else run_offline
    t, checks, attempted, failed = run(cfg, mix, seed, seconds, trace, device, log)
    t["setup_s"] = t["setup_done"] - t_start
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"])(t)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ok = failed == 0 and all(checks.get(k, float("inf")) <= lim for k, lim in limits.items())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": t.get("memory_peak_bytes", 0)}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        w = t.get("profile")
        if w is not None:
            dev.update(busy_s=w.busy_s, window_s=w.window_s)
            result["breakdown"] = {"device_ops": w.top_ops(), "idle_gaps": w.idle_gaps()}
    result["checks"] = {k: {"value": finite(checks.get(k, float("inf"))), "limit": lim}
                        for k, lim in limits.items()}
    return result


def worst(a, b):
    """The larger of two readings; nan wins."""
    return b if b != b or b > a else a


def finite(v):
    """A number for the JSON line; inf and nan as strings."""
    return v if v == v and abs(v) != float("inf") else str(v)


def main(argv, t_start):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        import sherpa_vietnamese_asr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program cannot be imported: {e}", file=sys.stderr)
        return 3
    bench, cell_entry, *_ = spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
        print(f"portbench: {args.workload} needs {cell_entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    name, limit = card()
    print(f"portbench: {name}, power limit {limit}", file=sys.stderr, flush=True)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
