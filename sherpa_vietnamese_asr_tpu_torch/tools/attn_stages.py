"""Split the attention-weights kernel's time by part on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.attn_stages [--rounds 10]

It builds csrc/attention_weights.cu alone once per SVT_ATTN_CUT mask (the
kernel's timing switch: 0 is the kernel as shipped, each other mask skips a
part of every step and gives wrong weights), one nvcc per build, all started
together. Then it times kernel 2 of every build at the four distinct
Zipformer-30M stack shapes of chip_smoke.py (B 8; T 1646 / 823 / 412 / 206;
H 4 / 4 / 4 / 8; qd 32, pd 4) on standard normal q, k, pq and position
rows, with chip_smoke.py's lens (full, half, 0, 64, 1, three quarters,
full, 17): each build's device time from torch.profiler over `rounds`
calls, which must see one launch a call. It prints each build's device ms
at each shape and what each skipped part costs (shipped minus cut), and
the card's name and power limit as nvidia-smi prints them. The last line is
a JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.ops import attention, cuda_lib
from sherpa_vietnamese_asr_tpu_torch.tools import skew_bf16
from sherpa_vietnamese_asr_tpu_torch.tools.beam_stages import build_entries

# build name -> SVT_ATTN_CUT mask (bits of csrc/attention_weights.cu kCut*)
CUTS = {"shipped": 0, "no global stores": 1, "no pass 2": 2, "no content product": 4,
        "no band": 8, "no key split": 16, "pass 1, no product or band": 14}
SHAPES = ((0, 1646, 4), (1, 823, 4), (2, 412, 4), (3, 206, 8))  # (stack, T, H)


def shape_args(t, heads, dev, batch=8, seed=0):
    """The wrappers' arguments at one shape (tools/skew_bf16's probe inputs,
    qd 32, pd 4) with chip_smoke.py's lens."""
    rng = np.random.default_rng(seed)
    q, k, p, pos, _ = skew_bf16.probe_inputs(rng, batch, t, heads, 32, 4)
    lens = np.asarray([t, t // 2, 0, 64, 1, (3 * t) // 4, t, 17], np.int32)[:batch]
    return skew_bf16.port_args((q, k, p, pos, lens), heads, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_stages: needs a CUDA card")
    dev = torch.device("cuda", 0)
    src = cuda_lib.CSRC_DIR / "attention_weights.cu"
    fns = build_entries({name: (src, [f"-DSVT_ATTN_CUT={mask}"]) for name, mask in CUTS.items()},
                        cuda_lib.BUILD_DIR.parent / "attn_stages", "svt_attention_weights")
    ms = {}
    for stack, t, heads in SHAPES:
        inputs = shape_args(t, heads, dev)
        row = {}
        for name, fn in fns.items():
            row[name] = skew_bf16.device_ms(
                lambda: attention._attention_weights_cuda(*inputs, entry=fn), args.rounds)[0]
        ms[f"stack{stack}"] = row
        print(f"stack {stack} T {t} H {heads}: " + ", ".join(
            f"{name} {v:.4f} ms" + ("" if name == "shipped" else
                                     f" (cost {row['shipped'] - v:+.4f})")
            for name, v in row.items()), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"card": smi, "rounds": args.rounds, "device_ms": ms}))


if __name__ == "__main__":
    main()
