"""One run of one cell: set-up, the measured window, the traced slice with
--trace 1, the correctness check, and the result line.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is a file found by its name in BENCHMARK.json (or in
portbench/held_back.json, for cells kept out of it):
portbench/configs/<config>.json, portbench/traffic/<traffic>.json,
portbench/metrics/<metric>.py (a `read(trace)` returning a number or
None) and portbench/limits/<workload>.json.

A traffic file's "kind" names the module that runs it,
portbench/harness/<kind>.py, which gives

    run(cfg, mix, seed, seconds, trace, device, log) -> (t, checks, attempted, failed)
    control(cfg, mix, seed, seconds, device) -> checks

`checks` maps each number compared to its reading ({name: float}; the
limits file says which count), `control` gives the control's readings on
what a run of that seed compares. `t` is what the metric readers read:
    "cfg", "trace"       the configuration as run, the --trace flag;
    "setup_done"         time.perf_counter() when the window opens;
    "requests"           each finished request of the window,
                         {"wall_s", "audio_s", "timing", ...};
    "window_s"           the window's length, first start to last end;
    "memory_peak_bytes"  torch.cuda.max_memory_allocated() after it (card);
and with --trace 1
    "profile"            the profiling.Window of the traced slice, or None;
    "launches"           what the wrappers recorded of its launches.
A kind may add keys of its own for its own readers (live: "partials",
"step_walls", "profiled_steps").
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

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


def kind(mix):
    """The module that runs the mix: portbench/harness/<kind>.py."""
    path = os.path.join(PB, "harness", f"{mix['kind']}.py")
    if not os.path.isfile(path):
        raise ValueError(f"portbench: traffic kind {mix['kind']!r} has no runner: {path} does not exist")
    return importlib.import_module(f"portbench.harness.{mix['kind']}")


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
    t, checks, attempted, failed = kind(mix).run(cfg, mix, seed, seconds, trace, device, log)
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
