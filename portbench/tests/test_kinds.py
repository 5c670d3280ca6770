"""A cell of a new kind of request is added by files alone: in a copy of
BENCHMARK.json and portbench/, a throwaway kind module, a configuration, a
traffic mix, limits, a metric reader and the CPU presets are written and
the cell is named in BENCHMARK.json; the copy's harness then runs the cell
(--trace 0 and 1) and its control on the CPU, and its own layout tests take
the cell, with no file that was there edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

WORKLOAD = "toy-f32.rows"
FILES = {
    "portbench/harness/toy.py": '''"""A throwaway kind: each request multiplies a row by the configuration's
matrix in float32 (the control: in bfloat16), judged against float64."""

import time

import torch

from portbench.harness import profiling


def _draw(cfg, mix, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(cfg["width"], cfg["width"], generator=g, dtype=torch.float64)
    return w, torch.randn(mix["requests"], cfg["width"], generator=g, dtype=torch.float64)


def _worst(w, xs, dtype):
    ref = xs @ w
    got = (xs.to(dtype) @ w.to(dtype)).double()
    return float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())


def run(cfg, mix, seed, seconds, trace, device, log):
    w, xs = _draw(cfg, mix, seed)
    t = {"cfg": cfg, "trace": trace, "setup_done": time.perf_counter()}
    records = []
    for x in xs:
        t0 = time.perf_counter()
        x.float() @ w.float()
        wall = time.perf_counter() - t0
        records.append({"wall_s": wall, "audio_s": 0.0, "timing": {"product": wall}})
    t.update(requests=records, window_s=sum(r["wall_s"] for r in records))
    if trace:
        t["profile"], t["launches"] = profiling.profile(lambda: {}, log=log)
    return t, {"rel_err": _worst(w, xs, torch.float32)}, len(records), 0


def control(cfg, mix, seed, seconds, device):
    w, xs = _draw(cfg, mix, seed)
    return {"rel_err": _worst(w, xs, torch.bfloat16)}
''',
    "portbench/metrics/product_ms.rows.py": '''def read(t):
    reqs = t.get("requests")
    return 1e3 * sum(r["timing"]["product"] for r in reqs) / len(reqs) if reqs else None
''',
    "portbench/configs/toy-f32.json": {"name": "toy-f32", "width": 512},
    "portbench/traffic/rows.json": {"kind": "toy", "requests": 256},
    "portbench/limits/toy-f32.rows.json": {"rel_err": 1e-5},
    "portbench/tests/presets/configs/toy-f32.json": {"tiny": {"width": 16}, "cpu_limits": {"rel_err": 1e-5},
                                                     "cpu_unread": []},
    "portbench/tests/presets/traffic/rows.json": {"short": {"requests": 8}, "shorter": {"requests": 4}},
}
CONFIG = {"name": "toy-f32", "source": "https://example.org/toy", "file": "portbench/configs/toy-f32.json",
          "reduced": [], "why": "a throwaway kind"}
CELL = {"name": WORKLOAD, "config": "toy-f32", "traffic": "rows", "chips": 1, "why": "a throwaway kind"}
METRIC = {"name": "product_ms.rows", "unit": "ms", "better": "lower", "source": "program_span",
          "layer": "toy: product", "moves": "request_p95_ms", "workloads": [WORKLOAD]}
RUN = """
import json, os, sys, time
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "portbench", "tests")]
import torch
import conftest
from portbench.harness import cell
o = conftest.overrides({w!r})
lines = [cell.measure({w!r}, 3, 0.5, trace, "cpu", time.perf_counter(), overrides=o) for trace in (False, True)]
_, entry, cfg, mix, _ = cell.spec({w!r})
mix = dict(mix, **conftest.preset("traffic", entry["traffic"])["shorter"])
control = cell.kind(mix).control(dict(cfg, **o["config"]), mix, 3, 0.5, torch.device("cpu"))
print(json.dumps({{"lines": lines, "control": control, "limits": o["limits"], "harness": cell.__file__}}))
"""


def digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_kind_is_added_by_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    for rel, body in FILES.items():
        assert rel not in before
        (tmp_path / rel).write_text(body if isinstance(body, str) else json.dumps(body))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(CONFIG)
    bench["workloads"].append(CELL)
    bench["per_layer"].append(METRIC)
    next(m for m in bench["end_to_end"] if m["name"] == "request_p95_ms")["workloads"].append(WORKLOAD)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    # The program from the repo, the benchmark from the copy (first on the path).
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1")

    out = subprocess.run([sys.executable, "-c", RUN.format(w=WORKLOAD), str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["harness"].startswith(str(tmp_path))
    for res, names in zip(got["lines"], ({"request_p95_ms", "setup_s"}, {"product_ms.rows"})):
        assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 8, res
        assert set(res["metrics"]) == names
        assert list(res)[-1] == "checks" and res["checks"]["rel_err"]["limit"] == 1e-5
    assert any(not got["control"][k] <= lim for k, lim in got["limits"].items()), got

    # The copy's own layout tests take the new cell: one short window a
    # --trace value, and its files found by name.
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                          "portbench/tests/test_layout.py", "-k", f"{WORKLOAD} or every_metric"],
                         capture_output=True, text=True, cwd=tmp_path, env=env)
    assert out.returncode == 0 and "3 passed" in out.stdout, out.stdout[-4000:] + out.stderr[-2000:]

    after = digests(tmp_path)
    assert {k for k in before if after[k] != before[k]} == {"BENCHMARK.json"}
