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

    from portbench.harness import cell

    _, _, cfg, mix, _ = cell.spec(workload)
    return cell.kind(mix).control(cfg, mix, seed, seconds, torch.device("cuda"))


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
