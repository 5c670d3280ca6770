"""Each cell's mix and metric readers through one short window on the tiny
preset with the program's plain twins (CPU); the result line parses and
holds the cell's metrics. The real command refuses to run without a card.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, overrides, preset
from portbench.harness import cell, profiling

BENCH = cell.load_bench(ROOT)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def fake_take_window(fn):
    """A profiler window whose device events are the launches the wrappers
    counted (1 ms each, 1 ms apart) and one copy."""
    counts = fn()
    dev, t = [("Memcpy HtoD", 0, 500)], 1000
    for key, n in counts.items():
        for _ in range(n):
            dev.append((key, t, t + 1000))
            t += 2000
    for name in ("product_kernel", "dwconv_kernel"):
        dev.append((name, t, t + 1000))
        t += 2000
    return dev, [("window", 0, t), ("transcription", 0, t)], counts


def short_run(workload, trace):
    return cell.measure(workload, 3, 1.0, trace, "cpu", time.perf_counter(), overrides=overrides(workload))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_runs_and_its_line_parses(workload, trace, monkeypatch):
    if trace:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(profiling, "_take_window", fake_take_window)
    res = json.loads(json.dumps(short_run(workload, bool(trace))))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in cell.metrics_of(BENCH, workload, bool(trace))}
    # What a CPU run cannot read (kernels that never launch there: their plain
    # twins run) is listed in the configuration's preset; test_kernel_readers
    # reads the kernels' metrics.
    unread = set(preset("configs", cell.spec(workload)[1]["config"])["cpu_unread"])
    assert set(res["metrics"]) == want - unread
    assert list(res["checks"])[-1] == list(res)[-1] or list(res)[-1] == "checks"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert len(res["breakdown"]["device_ops"]) <= 10


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cell.reader(m["name"]))
    for w in WORKLOADS:
        cell.spec(w)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "5000000000", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_the_command_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


def test_kernel_readers():
    w = profiling.Window([("attn_kernel", 0, 100), ("product_kernel", 100, 200),
                          ("attn_bf16_kernel", 200, 300)], [], 0, 1000)
    cfg = cell.spec("zipformer30m-fp32.longform")[2]
    t = {"profile": w, "cfg": cfg,
         "launches": {"attention": [(8, 1646, 4, 32)], "layer": [((8, 1664, 192), 4, 512, 31)]}}
    att = cell.reader("attention_roofline.fp32")(t)
    lay = cell.reader("layer_roofline.bf16")(t)
    assert att == pytest.approx(100 * 0.05622626e-3 / 100e-6, rel=1e-6)
    assert lay == pytest.approx(100 * 0.04508797e-3 / 200e-6, rel=1e-6)
    assert cell.reader("attention_roofline.fp32")(dict(t, profile=None)) is None
