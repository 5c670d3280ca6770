"""Time ResNet34's convolutions on a CUDA card, full float32.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.conv_sweep [--batches 1 8 64]

For each stage's stride-1 3x3 convolution at the shapes the diarizer gives
it (998-frame windows: [B, C, F, T] = [B, 32, 80, 998], [B, 64, 40, 499],
[B, 128, 20, 250], [B, 256, 10, 125]) it prints the milliseconds of cuDNN's
convolution on the plain NCHW input, on the input with its time axis
zero-padded to a multiple of models.resnet_speaker.TIME_ALIGN (the output
sliced back, as the model runs it), and on channels_last tensors. Then the
whole ResNet34 frame encoder (random weights) at B 64, with the padding
off and on, in turns (off, on, on, off), and the largest difference of the
two outputs. Times are medians of CUDA-event timings after a warm-up call;
the last line is a JSON object with them and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np

STAGES = ((32, 80, 998), (64, 40, 499), (128, 20, 250), (256, 10, 125))


def time_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 64])
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from sherpa_vietnamese_asr_tpu_torch.models import resnet_speaker
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_full_fp32

    if not torch.cuda.is_available():
        raise SystemExit("conv_sweep: needs a CUDA card")
    use_full_fp32()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    align = resnet_speaker.TIME_ALIGN
    rows = []
    for c, f, t in STAGES:
        w = torch.randn(c, c, 3, 3, device=dev, generator=gen) / (3 * c ** 0.5)
        b = torch.randn(c, device=dev, generator=gen)
        w_cl = w.contiguous(memory_format=torch.channels_last)
        pad = (-t) % align
        for batch in args.batches:
            x = torch.randn(batch, c, f, t, device=dev, generator=gen)
            x_cl = x.contiguous(memory_format=torch.channels_last)
            row = {"shape": [batch, c, f, t],
                   "plain_ms": time_ms(lambda: F.conv2d(x, w, b, 1, 1)),
                   "padded_ms": time_ms(
                       lambda: F.conv2d(F.pad(x, (0, pad)), w, b, 1, 1)[..., :t]),
                   "channels_last_ms": time_ms(lambda: F.conv2d(x_cl, w_cl, b, 1, 1))}
            row["tflops_plain"] = 2 * 9 * c * c * batch * f * t / row["plain_ms"] / 1e9
            rows.append(row)
            print(f"conv 3x3 {row['shape']}: plain {row['plain_ms']:.3f} ms "
                  f"({row['tflops_plain']:.1f} TFLOP/s), time padded to x{align} "
                  f"{row['padded_ms']:.3f} ms, channels_last {row['channels_last_ms']:.3f} ms",
                  flush=True)

    model = resnet_speaker.random_resnet_speaker(device=dev)
    fb = torch.randn(64, 998, 80, device=dev, generator=gen)
    forward = {}
    outs = {}
    with torch.no_grad():
        for on in (False, True, True, False):
            resnet_speaker.TIME_ALIGN = align if on else 1
            outs[on] = model.resnet_frame_features(fb)
            forward.setdefault(on, []).append(time_ms(lambda: model.resnet_frame_features(fb)))
    resnet_speaker.TIME_ALIGN = align
    diff = float((outs[True] - outs[False]).abs().max() / outs[False].abs().max())
    print(f"ResNet34 frame features, B 64 x 998 frames: padding off {forward[False]} ms, "
          f"on {forward[True]} ms (in turns off, on, on, off); max |on - off| / max |off| "
          f"{diff:.2e}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"card": smi, "convs": rows, "resnet_b64_ms": {
        "padding_off": forward[False], "padding_on": forward[True]}, "max_rel_diff": diff}))


if __name__ == "__main__":
    main()
