"""Profile one warm transcription request of the port on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.profile_slice \
        [--dtype float32|bfloat16] [--vad] [--diarize] [--punctuate] [--quality] \
        [--seconds 95] [--long-seconds 600] [--trace trace.json]

It builds the random-weight Zipformer-30M model (vocab 2000, beam 8) in the
given compute dtype; bfloat16 also carries the synthetic hotword table of
chip_smoke.py (the bf16 slice). It runs
TranscriberPipeline(path, model, {"bypass_vad": True}) -- with --vad the
default path, TranscriberPipeline(path, model, {}), whose Silero VAD runs on
the card with random weights; with --diarize also config
speaker_diarization and a full-width PureDiarizer (random weights) on the
card; with --punctuate config restore_punctuation and a full-width ViBERT
restorer, with --quality config quality_analysis and DNSMOS (both random
weights, on the card) -- on a synthetic AM-tone WAV twice to warm up, then
once under
torch.profiler, and prints:
  - the request's wall time and the pipeline's own `timing` split;
  - device busy time (the union of the card's kernel and copy intervals),
    its share of the wall time and the idle share (1 - busy / wall);
  - the device kernels by total time, with each one's share of busy time;
  - in bfloat16, the whole-layer kernel's device time split into products,
    score pass, depthwise conv and elementwise passes, and the wrapper's
    host time per layer (its "svt_encoder_layer" span, under the profiler)
    against the layer's device time;
  - the warm wall time and real-time factor of a longer request, and its
    device busy time and idle share from one more run under the profiler;
  - with --vad, the VAD's own device time (silero_vad_probs_streamed alone
    on audio of each request's length, under the profiler);
  - with --diarize, the requests' `diarization` timing key and one full
    superblock's device time by part (PyanNet, kernel 1, ResNet34, pooling +
    projection, the span's upload and the results' download, each alone
    between CUDA events, and the whole superblock);
  - the card's name and power limit, as nvidia-smi prints them.
The last line is a JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np

SR = 16000
LAYER_SPAN = "svt_encoder_layer"  # ops/encoder_layer's host range around one layer
# Device kernels of the whole-layer kernel (csrc/encoder_layer.cu) by part.
LAYER_PARTS = (("products", ("product_kernel",)), ("score pass", ("attn_bf16_kernel",)),
               ("depthwise conv", ("dwconv_kernel",)),
               ("elementwise", ("shadow_kernel", "nonlin_gate_kernel", "biasnorm_bypass_kernel")))


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

    # kernels and copies; not the device copies of record_function ranges
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")
            and not getattr(e, "is_user_annotation", False) and e.name != LAYER_SPAN]


def layer_split(per_name):
    """{part: device ms} of LAYER_PARTS from a {kernel name: ms} map."""
    return {part: sum(ms for name, ms in per_name.items() if any(k in name for k in keys))
            for part, keys in LAYER_PARTS}


def _warm_window():
    """A profiler schedule whose first step (tracing on, nothing kept) is a
    warm-up: the card's tracing comes up during it, and the next step is the
    one measured. Without it the first calls of a window could go unseen
    (whole calls missing from the count, PERF.md)."""
    from torch.profiler import schedule

    return schedule(wait=0, warmup=1, active=1, repeat=1)


PROFILE_WINDOWS = 6  # profiler windows tried before a lost window raises
LOST_WINDOW_PAUSE_S = 1.0  # wait after a lost window: losses come in bursts


def profile_calls(fn, reps=20, expect=None):
    """Device time of one call of fn() on the card, from torch.profiler over
    `reps` calls after a warm-up step: (busy ms, {device kernel name: ms},
    {device kernel name: launches seen over the `reps` calls}).

    fn must run on the card, so a window that saw no device event lost its
    events; with `expect` (a kernel name's substring, one launch a call) a
    window that saw another count than `reps` launches of it lost calls.
    On an H100 the profiler loses events in bursts of a few consecutive
    windows (PERF.md), so a lost window is discarded and taken again after
    a pause, at most PROFILE_WINDOWS windows, and then this raises."""
    for _ in range(PROFILE_WINDOWS):
        events = _profile_window(fn, reps)
        counts = collections.Counter(e.name for e in events)
        seen = None if expect is None else sum(
            n for name, n in counts.items() if expect in name)
        if events and seen in (None, reps):
            break
        print(f"profile window lost events: {len(events)} device events, "
              f"{seen} launches of {expect} in {reps} calls; window discarded", flush=True)
        time.sleep(LOST_WINDOW_PAUSE_S)
    else:
        raise RuntimeError(f"profiler lost events in each of {PROFILE_WINDOWS} windows: "
                           f"{seen} launches of {expect} in {reps} calls, {dict(counts)}")
    per_name = collections.defaultdict(float)
    for e in events:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events]) / reps
    return busy, dict(per_name), dict(counts)


def _profile_window(fn, reps):
    """The device events of `reps` calls of fn() after a warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=_warm_window()) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return _device_events(prof)


def _profiled_busy(fn):
    """(device busy ms, wall ms) of one call of fn() under the profiler,
    after a warm-up step. fn must run on the card: a window that saw no
    device event lost its events and is taken again after a pause, at most
    PROFILE_WINDOWS windows, and then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=_warm_window()) as prof:
            torch.ones(1, device="cuda").add_(1)  # the warm-up step
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
        events = _device_events(prof)
        if events:
            return _busy_ms([(e.time_range.start, e.time_range.end) for e in events]), wall * 1e3
        print("profile window lost events: 0 device events; window discarded", flush=True)
        time.sleep(LOST_WINDOW_PAUSE_S)
    raise RuntimeError(f"profiler lost events in each of {PROFILE_WINDOWS} windows")


def event_ms(fn, reps=5):
    """Milliseconds of one call of fn() on the card: CUDA events around
    `reps` back-to-back calls after a warm-up call, over reps. When the
    host enqueues faster than the card runs, this is the call's device
    time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def vad_device_ms(audio, dev):
    """Device time of the default VAD (random Silero weights, as the
    pipeline's) on `audio`: (busy ms, {device kernel name: ms}) a call."""
    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad

    vad = silero_vad.random_silero_vad(device=dev)
    busy, per_name, _ = profile_calls(
        lambda: silero_vad.silero_vad_probs_streamed(vad, audio), reps=3)
    return busy, per_name


def diarization_parts(diar, audio):
    """Device ms of one full superblock of `diar` (a PureDiarizer on the
    card) on the start of `audio`, by part, each part alone over the same
    inputs (event_ms): {"pyannet", "kernel 1", "resnet", "pooling +
    projection", "upload", "download", "superblock"}, plus "frames", the
    kernel's frame count."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    w = diar.superblock_windows
    sb_len = dp.superblock_samples(w)
    span = np.zeros(sb_len, np.int16)
    take = min(sb_len, len(audio))
    span[:take] = np.clip(np.rint(audio[:take] * 32768.0), -32768, 32767)
    dev = diar.device
    host = torch.from_numpy(span)
    if dev.type == "cuda":
        host = host.pin_memory()
    block = host.to(dev)
    msf = math.ceil(dp.NUM_SEG_FRAMES * 1680 / dp.CHUNK_SAMPLES)
    with torch.no_grad():
        x = block.to(torch.float32) / 32768.0
        windows = x.unfold(0, dp.CHUNK_SAMPLES, dp.STEP_SAMPLES)[:w]
        frames = fbank._frame_signal(x, dp._SB_FBANK).reshape(-1, dp._SB_FBANK.n_fft)
        frames = frames.contiguous()
        fb = dp._chunk_fbank(x, w)
        am = diar.seg_model(windows).argmax(dim=-1)
        weights, _ = dp._pool_weights(dp._powerset(dev)[am],
                                      diar.emb_cfg.out_time(dp.FRAMES_PER_CHUNK), msf)
        feat = diar.emb_model.resnet_frame_features(fb)
        outs = dp._superblock_body(diar.seg_model, diar.emb_model, block, w, msf, True)
        parts = {
            "pyannet": lambda: diar.seg_model(windows),
            "kernel 1": lambda: fbank.logmel(frames, dp._SB_FBANK),
            "resnet": lambda: diar.emb_model.resnet_frame_features(fb),
            "pooling + projection": lambda: diar.emb_model.project_embedding(
                masked_stats_pool(feat, weights)),
            "upload": lambda: host.to(dev, non_blocking=True),
            "download": lambda: [t.to("cpu", non_blocking=True) for t in outs],
            "superblock": lambda: dp._superblock_body(diar.seg_model, diar.emb_model,
                                                      block, w, msf, True),
        }
        out = {name: event_ms(fn, reps=50 if name in ("kernel 1", "upload", "download") else 5)
               for name, fn in parts.items()}
    out["frames"] = frames.shape[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--vad", action="store_true",
                    help="the default path: Silero VAD on (random weights)")
    ap.add_argument("--diarize", action="store_true",
                    help="speaker diarization on (full-width PureDiarizer, random weights)")
    ap.add_argument("--punctuate", action="store_true",
                    help="punctuation restoration on (full-width ViBERT, random weights)")
    ap.add_argument("--quality", action="store_true",
                    help="DNSMOS quality analysis on (random weights)")
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
    config = {} if args.vad else {"bypass_vad": True}
    stages = {}
    if args.diarize:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

        config["speaker_diarization"] = True
        stages["diarizer"] = PureDiarizer(device=dev)
    if args.punctuate:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import (
            build_punctuation_restorer,
        )

        config["restore_punctuation"] = True
        stages["punct_restorer"] = build_punctuation_restorer(device=dev)
    if args.quality:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

        config["quality_analysis"] = True
        stages["quality_analyzer"] = QualityAnalyzer(device=dev)

    def request(p):
        return TranscriberPipeline(p, model, config=config, **stages).run()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "request.wav")
        long_path = os.path.join(tmp, "long.wav")
        write_wav(path, am_tone(args.seconds, 3), SR)
        write_wav(long_path, am_tone(args.long_seconds, 4), SR)

        for _ in range(2):
            request(path)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=_warm_window()) as prof:
            torch.ones(1, device=dev).add_(1)  # the warm-up step
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            res = request(path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()

        request(long_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long_res = request(long_path)
        torch.cuda.synchronize()
        long_wall = time.perf_counter() - t0
        long_busy, long_profiled_ms = _profiled_busy(lambda: request(long_path))
        vad_ms = None
        if args.vad:
            vad_ms = {seconds: vad_device_ms(am_tone(seconds, seed), dev)
                      for seconds, seed in ((args.seconds, 3), (args.long_seconds, 4))}
        diar_parts = diarization_parts(stages["diarizer"], am_tone(args.long_seconds, 4)) \
            if args.diarize else None

    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = _device_events(prof)
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    per_name = collections.defaultdict(float)
    for e in events:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[: args.top]

    wall_ms = wall * 1e3
    layer = None
    spans = [e for e in prof.events()
             if e.name == LAYER_SPAN and e.device_type == torch.autograd.DeviceType.CPU]
    if spans:
        parts = layer_split(per_name)
        device = sum(parts.values())
        layer = {"layers": len(spans), "device_ms": parts,
                 "host_ms_per_layer": sum(e.time_range.elapsed_us() for e in spans)
                 / 1e3 / len(spans),
                 "device_ms_per_layer": device / len(spans)}
    print(f"request {args.seconds} s: wall {wall_ms:.3f} ms, "
          f"timing {json.dumps(res['timing'])}")
    print(f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall), "
          f"idle share {1 - busy / wall_ms:.3f}, {len(events)} device events")
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {100 * ms / busy:5.1f}%  {name[:100]}")
    if layer:
        print(f"whole-layer kernel: {layer['layers']} layers, device "
              f"{sum(layer['device_ms'].values()):.3f} ms: " + ", ".join(
                  f"{part} {ms:.3f} ms" for part, ms in layer["device_ms"].items()))
        print(f"whole-layer kernel per layer: host {layer['host_ms_per_layer']:.3f} ms "
              f"(wrapper span) vs device {layer['device_ms_per_layer']:.3f} ms")
    print(f"request {args.long_seconds} s warm: wall {long_wall:.3f} s, "
          f"{args.long_seconds / long_wall:.1f}x real time, "
          f"timing {json.dumps(long_res['timing'])}")
    print(f"request {args.long_seconds} s under the profiler: wall {long_profiled_ms:.3f} ms, "
          f"device busy {long_busy:.3f} ms, idle share {1 - long_busy / long_profiled_ms:.3f}")
    if vad_ms:
        for seconds, (busy_ms, per_name) in vad_ms.items():
            print(f"VAD alone, {seconds} s: device {busy_ms:.3f} ms: " + ", ".join(
                f"{name[:60]} {ms:.3f}" for name, ms in sorted(
                    per_name.items(), key=lambda kv: -kv[1])[:4]))
    if diar_parts:
        print("diarization, one superblock of "
              f"{stages['diarizer'].superblock_windows} windows, device ms by part: " + ", ".join(
                  f"{name} {ms:.3f}" for name, ms in diar_parts.items() if name != "frames")
              + f" (kernel 1 at F {diar_parts['frames']})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({
        "card": smi, "dtype": args.dtype, "request_s": args.seconds, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "timing": res["timing"],
        "top_kernels_ms": {name: ms for name, ms in top}, "layer_kernel": layer,
        "long_request_s": args.long_seconds, "long_wall_s": long_wall,
        "long_timing": long_res["timing"], "long_profiled_wall_ms": long_profiled_ms,
        "long_device_busy_ms": long_busy,
        "long_idle_share": 1 - long_busy / long_profiled_ms, "vad": args.vad,
        "vad_device_ms": vad_ms and {s: ms for s, (ms, _) in vad_ms.items()},
        "diarize": args.diarize, "diarization_parts_ms": diar_parts,
        "punctuate": args.punctuate, "quality": args.quality}))


if __name__ == "__main__":
    main()
