"""Readings that the correctness limits are set from: the program's checked
numbers over many seeds, and the control's (the reference put in the
program's place, one precision step below the configuration's), all in
one process at the cell's own size.

    python3 portbench/readings.py --workload <name> --seeds 1 2 3 ... \
        --seconds <s> [--control-seeds 1 2 3]

One JSON line a seed: {"seed", "side": "program" | "control", "checks"},
or "error" in place of "checks" when the seed's run raised (the exit code
is then 1).
Needs the cell's CUDA device, like run.py.
"""

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def program_readings(workload, seed, seconds):
    from portbench.harness import cell

    res = cell.measure(workload, seed, seconds, False, "cuda", time.perf_counter())
    return {k: c["value"] for k, c in res["checks"].items()}


def control_readings(workload, seed, seconds):
    """The checks of the control on the requests (or streams) a run of this
    seed would compare."""
    import torch

    from portbench.harness import cell, check_live, traffic, weights

    _, _, cfg, mix, _ = cell.spec(workload)
    dev = torch.device("cuda")
    if mix["kind"] == "live":
        _, w = weights.asr_model(cfg, seed, dev)
        streams = traffic.live_streams(mix, seed, seconds)
        chunks = [int(seconds / 0.64)] * len(streams)
        enc, served = check_live.control_outputs(cfg, w, streams, chunks, dev, cfg["control"]["encoder"])
        return check_live.judge(cfg, w, streams, enc, served, dev)
    return offline_control_checks(cfg, mix, seed, dev)


def offline_control_checks(cfg, mix, seed, dev):
    """The checks of the control on the sampled requests of an offline cell.
    A stage model that follows the program from its own inputs (ViBERT, on
    the program's subword ids) reads them from the program's run of the same
    request."""
    import tempfile

    from portbench.harness import check_offline, offline

    oc = offline.OfflineCell(cfg, mix, seed, dev)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work, offline.wrappers(oc.rec, spans=False):
        oc.setup(work)
        if oc.stages:
            for i in oc.sample:
                oc.request(i)
        program = dict(oc.rec.captured)
        del oc.model
        requests = [(oc.pool[i][0], check_offline.control_outputs(
            cfg, oc.weights, oc.vad_weights, oc.pool[i][0], dev, cfg["control"], oc.stage_refs(),
            program.get(i))) for i in oc.sample]
        return check_offline.judge_all(cfg, oc.weights, oc.vad_weights, requests, dev, oc.stage_refs())


def main(argv):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    failed = 0
    for side, seeds, fn in (("program", a.seeds, program_readings), ("control", a.control_seeds, control_readings)):
        for seed in seeds:
            try:
                line = {"seed": seed, "side": side, "checks": fn(a.workload, seed, a.seconds)}
            except Exception as e:  # a seed that fails is a reading too; the others go on
                traceback.print_exc()
                line = {"seed": seed, "side": side, "error": f"{type(e).__name__}: {e}"}
                failed += 1
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
