"""Profile one warm transcription request of the port on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.profile_slice \
        [--dtype float32|bfloat16] [--seconds 95] [--long-seconds 600] \
        [--trace trace.json]

It builds the random-weight Zipformer-30M model (vocab 2000, beam 8) in the
given compute dtype; bfloat16 also carries the synthetic hotword table of
chip_smoke.py (the bf16 slice). It runs
TranscriberPipeline(path, model, {"bypass_vad": True}) on a
synthetic AM-tone WAV twice to warm up, then once under torch.profiler, and
prints:
  - the request's wall time and the pipeline's own `timing` split;
  - device busy time (the union of the card's kernel and copy intervals),
    its share of the wall time and the idle share (1 - busy / wall);
  - the device kernels by total time, with each one's share of busy time;
  - the warm wall time and real-time factor of a longer request;
  - the card's name and power limit, as nvidia-smi prints them.
The last line is a JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import numpy as np

SR = 16000


def am_tone(seconds, seed):
    """AM tone with light noise and a 1.5 s pause at 40 s (if long enough):
    speech-like enough to make words with random weights."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 280 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.02 * rng.standard_normal(len(t)))
    x[int(40 * SR): int(41.5 * SR)] = 0.0
    return x.astype(np.float32)


def synthetic_hotword_tables(vocab, device, n_phrases=30, seed=5):
    """A hotword table from 30 phrases over the synthetic vocab: 8 one-piece
    words (on random weights only a completed phrase keeps its credit, so
    these make the boost change the decode) and 22 longer ones, many sharing
    a prefix with an earlier one (S >= 128 states)."""
    from sherpa_vietnamese_asr_tpu_torch.ops.hotword import build_hotword_tables

    rng = np.random.default_rng(seed)
    seqs = [[int(tok)] for tok in rng.choice(np.arange(3, vocab), 8, replace=False)]
    longer = []
    for _ in range(n_phrases - len(seqs)):
        if longer and rng.random() < 0.4:
            base = longer[int(rng.integers(len(longer)))]
            longer.append(base[: int(rng.integers(1, len(base)))]
                          + rng.integers(3, vocab, int(rng.integers(2, 6))).tolist())
        else:
            longer.append(rng.integers(3, vocab, int(rng.integers(5, 10))).tolist())
    seqs += longer
    scores = rng.uniform(2.0, 4.0, len(seqs)).round(2).tolist()
    tables, _ = build_hotword_tables(seqs, scores, vocab)
    assert tables.next_state.shape[0] >= 128, tables.next_state.shape
    return tables.to(device)


def _busy_ms(intervals):
    """Length of the union of [start, end) microsecond intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _device_events(prof):
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")]


def profile_calls(fn, reps=20):
    """Device time of one call of fn() on the card, from torch.profiler over
    `reps` calls after one warm-up: (busy ms, {device kernel name: ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    per_name = collections.defaultdict(float)
    for e in events:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events]) / reps
    return busy, dict(per_name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seconds", type=float, default=95.0)
    ap.add_argument("--long-seconds", type=float, default=600.0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="write the profiled request's Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA card")
    dev = torch.device("cuda", 0)
    model = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype=args.dtype,
                             device=dev)
    if args.dtype == "bfloat16":
        model.hotword_tables = synthetic_hotword_tables(model.rnnt_cfg.vocab_size, dev)
    config = {"bypass_vad": True}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "request.wav")
        long_path = os.path.join(tmp, "long.wav")
        write_wav(path, am_tone(args.seconds, 3), SR)
        write_wav(long_path, am_tone(args.long_seconds, 4), SR)

        for _ in range(2):
            TranscriberPipeline(path, model, config=config).run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = TranscriberPipeline(path, model, config=config).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        TranscriberPipeline(long_path, model, config=config).run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TranscriberPipeline(long_path, model, config=config).run()
        torch.cuda.synchronize()
        long_wall = time.perf_counter() - t0

    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = _device_events(prof)
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    per_name = collections.defaultdict(float)
    for e in events:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[: args.top]

    wall_ms = wall * 1e3
    print(f"request {args.seconds} s: wall {wall_ms:.3f} ms, "
          f"timing {json.dumps(res['timing'])}")
    print(f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall), "
          f"idle share {1 - busy / wall_ms:.3f}, {len(events)} device events")
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  {name[:100]}")
    print(f"request {args.long_seconds} s warm: wall {long_wall:.3f} s, "
          f"{args.long_seconds / long_wall:.1f}x real time")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({
        "card": smi, "dtype": args.dtype, "request_s": args.seconds, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "timing": res["timing"],
        "top_kernels_ms": {name: ms for name, ms in top},
        "long_request_s": args.long_seconds, "long_wall_s": long_wall}))


if __name__ == "__main__":
    main()
