"""Time the bf16-band attention kernel against kernel 2 and report their drift.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.skew_bf16 [--seed 0]
        [--rounds 7] [--batch 8] [--stacks stack0 ...] [--shape NAME:T:H:QD:PD ...]
        [--device cuda|cpu]

The port of the probe loop of benchmarks/_skewbf16.py. For each shape (by
default the probe's three Zipformer-30M stacks at 8 x 33 s: T 1664 / 896 /
512, H 4, qd 32, pd 4) it draws the probe's inputs from numpy's
default_rng(seed), in the probe's order: standard normal q, k [B*H, T, qd],
p [B*H, T, pd] and position table [H, 2T-1+128, pd], lens uniform in
[T/2, T]. The table enters through pos_emb with an identity projection, which
reproduces it exactly. It runs ops/attention.attention_weights (kernel 2) and
attention_weights_bf16band (kernel 5, the band rounded to bf16) on them and
prints, per shape:
  - each kernel's median CUDA-event time around its wrapper, the two taking
    turns a round, kernel 5's time over kernel 2's, and each kernel's own
    device time from torch.profiler, which must see one launch a call;
  - the max and mean |kernel 2 - kernel 5| of the bf16 weights;
  - each kernel against its plain twin: max abs and the largest ratio to
    the bf16 gate (2**-8 + 2**-12 of |twin| + 1e-6), which must be <= 1;
  - kernel 5's launches.
With --device cpu each wrapper runs its twin and nothing is timed. The card's
name and power limit come first, as nvidia-smi prints them; the last line is
a JSON object with the numbers. The exit code is 1 if a kernel is beyond its
gate or not finite.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.ops import attention

ROW_BLOCK = 128  # the probe's query block: its table has this many extra rows
STACKS = {  # name -> (T, H, qd, pd), the probe's stacks at 8 x 33 s
    "stack0": (1664, 4, 32, 4),
    "stack1": (896, 4, 32, 4),
    "stack2": (512, 4, 32, 4),
}
GATE = 2**-8 + 2**-12  # bf16 unit roundoff and float32 slack
KERNEL = "attn_kernel"  # the device kernel's name (both instantiations)


def probe_inputs(rng, batch, t, heads, qd, pd):
    """The probe's numpy inputs for one shape, drawn in its order."""
    bh = batch * heads
    q = rng.standard_normal((bh, t, qd)).astype(np.float32)
    k = rng.standard_normal((bh, t, qd)).astype(np.float32)
    p = rng.standard_normal((bh, t, pd)).astype(np.float32)
    pos = rng.standard_normal((heads, 2 * t - 1 + ROW_BLOCK, pd)).astype(np.float32)
    lens = rng.integers(t // 2, t + 1, size=batch).astype(np.int32)
    return q, k, p, pos, lens


def port_args(inputs, heads, dev):
    """The wrappers' arguments for the probe's inputs: q, k, pq as [B, T, H,
    d]; the table's rows 0..2T-2 (the rows the kernel reads) as a reversed
    pos_emb [2T-1, H*pd] with an identity pos_proj_weight."""
    import torch

    q, k, p, pos, lens = inputs
    b, t = lens.shape[0], q.shape[1]

    def heads_last(x):
        return torch.from_numpy(x).to(dev).reshape(b, heads, t, -1).permute(0, 2, 1, 3)

    pd = p.shape[-1]
    table = pos[:, : 2 * t - 1].transpose(1, 0, 2).reshape(2 * t - 1, heads * pd)
    pos_emb = torch.from_numpy(table[::-1].copy()).to(dev)  # a copy even at T 1
    return (heads_last(q), heads_last(k), heads_last(p),
            torch.eye(heads * pd, device=dev), pos_emb, torch.from_numpy(lens).to(dev))


def versus_twin(got, ref):
    """{max_abs, gate_ratio, finite} of a wrapper's weights against its twin."""
    import torch

    got = got.float()
    return {"max_abs": float((got - ref).abs().max()),
            "gate_ratio": float(((got - ref).abs() / (GATE * ref.abs() + 1e-6)).max()),
            "finite": bool(torch.isfinite(got).all())}


def time_turns(fns, rounds):
    """Median CUDA-event ms of each fn, the fns taking turns a round."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def device_ms(fn, reps):
    """(device ms of one call's attention kernel, launches of it seen) from
    torch.profiler over `reps` calls of fn; raises unless a profile window
    saw exactly `reps` launches of the kernel (profile_calls retakes a
    window that lost calls)."""
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    _, per_name, counts = profile_calls(fn, reps=reps, expect=KERNEL)
    names = [name for name in per_name if KERNEL in name]
    return sum(per_name[name] for name in names), sum(counts[name] for name in names)


def kernel_times(args, rounds):
    """({wrapper: median event ms}, {wrapper: device ms of its kernel},
    {wrapper: launches the profile saw}) of kernel 2 and kernel 5 on the
    same arguments."""
    fns = {"attention_weights": lambda: attention.attention_weights(*args),
           "attention_weights_bf16band": lambda: attention.attention_weights_bf16band(*args)}
    device = {name: device_ms(fn, rounds) for name, fn in fns.items()}
    return (time_turns(fns, rounds), {name: d[0] for name, d in device.items()},
            {name: d[1] for name, d in device.items()})


def probe_shape(name, shape, rng, batch, dev, rounds):
    """One shape's row: times, drift, each kernel against its twin."""
    import torch

    t, heads, qd, pd = shape
    args = port_args(probe_inputs(rng, batch, t, heads, qd, pd), heads, dev)
    before = attention.bf16band_launches
    with torch.no_grad():
        w2 = attention.attention_weights(*args).float()
        w5 = attention.attention_weights_bf16band(*args).float()
        drift = (w2 - w5).abs()
        row = {"name": name, "t": t, "heads": heads, "qd": qd, "pd": pd, "batch": batch,
               "lens": args[-1].tolist(),
               "drift_max": float(drift.max()), "drift_mean": float(drift.mean()),
               "band_f32": versus_twin(w2, attention.attention_weights_plain(*args)),
               "band_bf16": versus_twin(w5, attention.attention_weights_bf16band_plain(*args))}
        del w2, w5, drift
        row["kernel_ms"], row["device_ms"], row["device_launches"] = (
            (None, None, None) if dev.type == "cpu" else kernel_times(args, rounds))
    row["bf16band_launches"] = attention.bf16band_launches - before
    row["ok"] = all(row[k]["finite"] and row[k]["gate_ratio"] <= 1.0
                    for k in ("band_f32", "band_bf16"))
    return row


def print_row(row):
    ms, dev = row["kernel_ms"], row["device_ms"]
    k2, k5 = "attention_weights", "attention_weights_bf16band"
    times = ("times not measured (cpu)" if ms is None else
             f"kernel 2 {ms[k2]:.3f} ms, kernel 5 {ms[k5]:.3f} ms (kernel 5 / kernel 2 "
             f"{ms[k5] / ms[k2]:.3f}); device kernel 2 {dev[k2]:.4f} ms, kernel 5 "
             f"{dev[k5]:.4f} ms ({dev[k5] / dev[k2]:.3f}; launches seen "
             f"{row['device_launches'][k2]} / {row['device_launches'][k5]})")
    print(f"{row['name']}: B {row['batch']} T {row['t']} H {row['heads']} qd {row['qd']} "
          f"pd {row['pd']} lens {row['lens']}: {times}; |kernel 2 - kernel 5| max "
          f"{row['drift_max']:.3e} mean {row['drift_mean']:.3e}; vs twin: kernel 2 max "
          f"{row['band_f32']['max_abs']:.3e} (gate ratio {row['band_f32']['gate_ratio']:.4f}), "
          f"kernel 5 max {row['band_bf16']['max_abs']:.3e} (gate ratio "
          f"{row['band_bf16']['gate_ratio']:.4f}); kernel 5 launches "
          f"{row['bf16band_launches']}", flush=True)


def run(shapes, seed=0, batch=8, device="cuda", rounds=7):
    """Rows of probe_shape for {name: (T, H, qd, pd)}, one rng over all
    shapes in order (as the probe draws them)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_full_fp32

        use_full_fp32()  # the twins' content products in full float32
    rng = np.random.default_rng(seed)
    rows = []
    for name, shape in shapes.items():
        rows.append(probe_shape(name, shape, rng, batch, dev, rounds))
        print_row(rows[-1])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stacks", nargs="+", choices=sorted(STACKS), default=list(STACKS))
    ap.add_argument("--shape", action="append", default=[], metavar="NAME:T:H:QD:PD",
                    help="a shape in place of the stacks (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("skew_bf16: needs a CUDA card (or --device cpu)")
    shapes = {name: STACKS[name] for name in args.stacks}
    if args.shape:
        shapes = {}
        for spec in args.shape:
            name, *dims = spec.split(":")
            shapes[name] = tuple(int(x) for x in dims)
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"nvidia-smi: {card}")
    rows = run(shapes, args.seed, args.batch, args.device, args.rounds)
    print(json.dumps({"device": args.device, "card": card, "shapes": rows}))
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(row["ok"] for row in main()) else 1)
