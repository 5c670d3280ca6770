"""Count the torch.profiler windows that lose device events on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.profiler_loss \
        [--rounds 120] [--processes 2] [--modes default,keep]

Each process (one per mode and repeat, each its own CUDA context) runs
`rounds` rounds of:
  - one raw profiler window (tools/profile_slice._profile_window) of 7
    calls of kernel 2 (ops/attention.attention_weights at B 8, T 512, H 4,
    the probe's stack 2), lost if it saw no device event or another count
    than 7 launches of the kernel;
  - one raw window of 5 calls of a 2048 x 2048 float32 matmul, lost if it
    saw no device event;
  - one retaking profile_calls(expect=...) of kernel 2, which counts the
    windows it discarded and whether it raised;
  - 20 calls of kernel 2 outside the profiler.
Mode "keep" sets TEARDOWN_CUPTI=0 in the process's environment (the
profiler then keeps CUPTI between windows), "default" leaves it unset.
Each process prints a JSON line: raw windows, lost windows, the longest
run of consecutive lost windows, the retaking calls' discarded windows
and raises. The card's name and power limit come first, as nvidia-smi
prints them; the last line is a JSON object with every process's line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

KERNEL = "attn_kernel"
MODES = {"default": None, "keep": "0"}  # mode -> TEARDOWN_CUPTI


def longest_run(flags):
    """The longest run of consecutive True values in flags."""
    best = cur = 0
    for flag in flags:
        cur = cur + 1 if flag else 0
        best = max(best, cur)
    return best


def child(rounds):
    """One process's rounds (see the module docstring); its JSON line."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools import profile_slice, skew_bf16

    dev = torch.device("cuda")
    args = skew_bf16.port_args(skew_bf16.probe_inputs(np.random.default_rng(0), 8, 512, 4,
                                                      32, 4), 4, dev)
    a = torch.randn(2048, 2048, device=dev)

    def kernel():
        return attention.attention_weights(*args)

    kernel()
    torch.cuda.synchronize()
    lost, discarded, raised = [], 0, 0
    for _ in range(rounds):
        events = profile_slice._profile_window(kernel, 7)
        lost.append(not events or sum(KERNEL in e.name for e in events) != 7)
        lost.append(not profile_slice._profile_window(lambda: a @ a, 5))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                profile_slice.profile_calls(kernel, reps=7, expect=KERNEL)
            except RuntimeError:
                raised += 1
        discarded += out.getvalue().count("window discarded")
        for _ in range(20):
            kernel()
        torch.cuda.synchronize()
    return {"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"), "raw_windows": len(lost),
            "lost": sum(lost), "longest_lost_run": longest_run(lost),
            "retaking_calls": rounds, "discarded": discarded, "raised": raised}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--processes", type=int, default=2, help="processes a mode")
    ap.add_argument("--modes", default="default,keep")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.rounds)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    lines = []
    for _ in range(args.processes):
        for mode in args.modes.split(","):
            env = dict(os.environ)
            env.pop("TEARDOWN_CUPTI", None)
            if MODES[mode] is not None:
                env["TEARDOWN_CUPTI"] = MODES[mode]
            r = subprocess.run([sys.executable, "-m", __spec__.name, "--child",
                                "--rounds", str(args.rounds)], env=env,
                               capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stderr[-2000:], file=sys.stderr)
                return r.returncode
            line = {"mode": mode, **json.loads(r.stdout.strip().splitlines()[-1])}
            print(json.dumps(line), flush=True)
            lines.append(line)
    print(json.dumps({"processes": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
