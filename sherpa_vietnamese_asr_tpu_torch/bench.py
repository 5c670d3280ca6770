# Benchmark of the port: what a user of the package gets on one card.
#
# Port of the repository's bench.py (which imports the JAX package and
# stays as it is). It prints ONE JSON line of the same shape: the headline
# metric / value / unit / vs_baseline and an "extras" list of the other
# configurations a user runs:
#   - rtfx_zipformer30m_beam8_bf16_per_chip: chunked-decode RTFx of the
#     bfloat16 tier (kernels 1, 4 and 3);
#   - rtfx_zipformer30m_beam8_fp32_per_chip: the float32 tier that
#     `transcribe` runs by default (default_tier: true; kernels 1, 2 and
#     3). It is full float32 with TF32 refused, not the JAX package's
#     3-pass bf16 "high", hence the other name;
#   - rtfx_full_pipeline_<m>min_per_chip: TranscriberPipeline with
#     diarization, punctuation and DNSMOS over an m-minute file (10 by
#     default), warm, each stage built once, the result held to
#     check_contract.
# The decode batch is what `transcribe` uses (calibration.resolve_max_batch,
# 8 unless a calibration says otherwise) or SVT_BENCH_BATCH. Extras are
# best-effort within SVT_BENCH_BUDGET_S (520 s): a failure becomes a
# {"metric", "skipped": "<Type>: <msg>"} entry and the headline still
# prints. Random weights from fixed seeds; no checkpoint is read.
#
#   python -m sherpa_vietnamese_asr_tpu_torch.cli bench [--device cuda]
#
# Baselines, as the repository's bench.py states them (BASELINE.md, the
# reference on a 6C/12T CPU):
#   ASR: 1 h transcribed in 77.1 s with the 2-worker pool => 46.7x.
#   Full pipeline, 10 min: ASR 77.1/6 + ViBERT 5.12 + diar seg 17.6 +
#     diar emb 52.2 ~= 87.8 s => 6.83x.

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import traceback

import numpy as np
import torch

ASR_BASELINE_RTFX = 3600.0 / 77.1
FULL_BASELINE_RTFX = 600.0 / (77.1 / 6 + 5.12 + 17.6 + 52.2)
SAMPLE_RATE = 16000


def bench_device(device) -> torch.device:
    """The bench's device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch twins on the CPU")
    return device


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def asr_model(dtype, device):
    """Zipformer-30M, beam 8, vocab 2000, random weights (seed 0)."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model

    return random_asr_model(vocab_size=2000, beam_size=8, compute_dtype=dtype, device=device)


def bench_batch(device) -> int:
    """SVT_BENCH_BATCH, else the decode batch of a user's `transcribe`."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import resolve_max_batch

    env = os.environ.get("SVT_BENCH_BATCH")
    return int(env) if env else resolve_max_batch({}, device=device)


def measure_asr(dtype, batch=None, n_batches=None, model=None, chunk_sec=30.0,
                pad_sec=33.0, device="cuda"):
    """Steady-state chunked-decode RTFx of one tier.

    Every timed batch is enqueued (fbank_batch + decode_feats, the decoder's
    own functions), then every num_tokens is read back; the window ends
    after the device has finished. Returns {"rtfx", "batch", "n_batches",
    "tokens", "wall_s"}."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import decode_feats, fbank_batch

    device = bench_device(device)
    if n_batches is None:
        n_batches = 5 if device.type == "cuda" else 1
    if batch is None:
        batch = bench_batch(device)
    if model is None:
        model = asr_model(dtype, device)
    n = int(chunk_sec * SAMPLE_RATE)
    n_pad = int(pad_sec * SAMPLE_RATE)
    rng = np.random.default_rng(0)
    # Speech-shaped synthetic audio (AM tones + noise); a distinct batch per
    # iteration so no caching layer can elide work.
    t = np.arange(n) / SAMPLE_RATE
    base = (0.3 * np.sin(2 * np.pi * 220 * t)
            * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)

    def mk_batch():
        out = np.zeros((batch, n_pad), np.float32)
        for i in range(batch):
            out[i, :n] = base + 0.05 * rng.standard_normal(n)
        return torch.from_numpy(out).to(model.device)

    batches = [mk_batch() for _ in range(n_batches + 1)]
    lens = np.full((batch,), n, np.int32)
    n_frames = torch.from_numpy((lens + 80) // 160).to(model.device)

    def launch(audio):
        with torch.no_grad():
            result, _ = decode_feats(fbank_batch(audio), n_frames, model)
        return result

    int(launch(batches[0]).num_tokens.sum())  # warm-up
    _synchronize(model.device)
    t0 = time.perf_counter()
    results = [launch(b) for b in batches[1:]]
    total_tokens = sum(int(r.num_tokens.sum()) for r in results)
    _synchronize(model.device)
    dt = time.perf_counter() - t0
    assert total_tokens > 0
    return {"rtfx": chunk_sec * batch * n_batches / dt, "batch": batch,
            "n_batches": n_batches, "tokens": total_tokens, "wall_s": dt}


def full_pipeline_audio(dur):
    """dur seconds of two alternating 6 s "speakers" (5 s tones, 1 s gaps)
    and noise at 0.01, as the repository's bench.py builds them."""
    t = np.arange(SAMPLE_RATE * dur) / SAMPLE_RATE
    x = np.zeros(SAMPLE_RATE * dur, np.float32)
    for k in range(dur // 6):
        f0 = 180.0 if k % 2 == 0 else 320.0
        am = 2.1 if k % 2 == 0 else 3.3
        s, e = k * 6 * SAMPLE_RATE, (k * 6 + 5) * SAMPLE_RATE
        tt = t[s:e]
        x[s:e] = (0.3 * np.sin(2 * np.pi * f0 * tt)
                  * (0.5 + 0.5 * np.sin(2 * np.pi * am * tt)))
    x += 0.01 * np.random.default_rng(0).standard_normal(len(x)).astype(np.float32)
    return x


def default_stages(device):
    """The persistent stages of a server: the diarization facade, the
    punctuation restorer and the DNSMOS analyzer on `device`."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import build_punctuation_restorer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    return dict(diarizer=SpeakerDiarizer(backend_kwargs={"device": device}),
                punct_restorer=build_punctuation_restorer(device=device),
                quality_analyzer=QualityAnalyzer(device=device))


def check_contract(res, dur):
    """A silently broken stage must fail the bench, not produce a number:
    the result-dict contract the reference guarantees."""
    assert res is not None, "pipeline returned None"
    segs = res["segments"]
    assert segs, "no segments produced"
    for s in segs:
        assert s.get("text"), "segment with empty text"
        assert 0 <= s["start"] <= s["end"] <= dur + 1.0
    n_words = sum(len(s.get("raw_words", [])) for s in segs)
    assert n_words > 0, "no words decoded"
    assert abs(res["duration_sec"] - dur) < 1.0
    assert res["asr_confidence"] is not None
    # diarization ran: speaker labels present
    assert res["has_speaker_diarization"], "diarization produced nothing"
    assert res["speaker_segments_raw"], "no speaker segments"
    # DNSMOS ran and is in the MOS range
    q = res["quality_info"]
    assert q is not None, "quality analysis missing"
    for k in ("dnsmos_sig", "dnsmos_bak", "dnsmos_ovrl"):
        assert 0.0 <= q[k] <= 5.0, f"DNSMOS {k} out of range: {q[k]}"
    # punctuation ran (timing recorded; text assembled)
    assert res["timing"]["punctuation"] >= 0.0
    assert res["text"], "empty transcript"


def measure_full_pipeline(minutes=10.0, model=None, stages=None, device="cuda"):
    """End-to-end TranscriberPipeline RTFx, warm, with persistent stages:
    the default float32 ASR tier + pure diarization + punctuation + DNSMOS
    on a synthetic two-speaker file. The wall is the host clock around
    run(), which returns host data. Returns {"rtfx", "batch", "wall_s",
    "warm_wall_s", "duration_s"}."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    device = bench_device(device)
    dur = int(minutes * 60)
    if model is None:
        model = asr_model("float32", device)
    if stages is None:
        stages = default_stages(device)
    cfg = {"speaker_diarization": True, "restore_punctuation": True,
           "quality_analysis": True}
    with tempfile.TemporaryDirectory(prefix="svt_bench_") as tmp:
        path = os.path.join(tmp, "full.wav")
        write_wav(path, full_pipeline_audio(dur), SAMPLE_RATE)

        batch = []

        def run():
            t0 = time.perf_counter()
            pipeline = TranscriberPipeline(path, model, config=cfg, **stages)
            res = pipeline.run()
            dt = time.perf_counter() - t0
            check_contract(res, dur)
            batch.append(pipeline.max_batch)
            return dt

        warm = run()  # first-use costs: kernel library, cuDNN plans
        dt = run()
    return {"rtfx": dur / dt, "batch": batch[-1], "wall_s": dt, "warm_wall_s": warm,
            "duration_s": dur}


def main(argv=None):
    """Run the three measurements and print the JSON line; returns it as a
    dict."""
    p = argparse.ArgumentParser(
        prog="svt-torch bench",
        description="decode RTFx of both tiers and full-pipeline RTFx, one JSON line")
    p.add_argument("--device", default="cuda",
                   help="torch device; the default needs a card, 'cpu' runs "
                        "every kernel's plain PyTorch twin")
    p.add_argument("--n-batches", type=int, default=None,
                   help="timed batches a tier (default: 5 on a card, 1 on the CPU)")
    p.add_argument("--minutes", type=float, default=10.0,
                   help="length of the full-pipeline file")
    args = p.parse_args(argv)
    device = bench_device(args.device)
    budget = float(os.environ.get("SVT_BENCH_BUDGET_S", "520"))
    t_start = time.time()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    bf16 = measure_asr("bfloat16", n_batches=args.n_batches, device=device)
    out = {
        "metric": "rtfx_zipformer30m_beam8_bf16_per_chip",
        "value": round(bf16["rtfx"], 2),
        "unit": "audio_sec/wall_sec",
        "vs_baseline": round(bf16["rtfx"] / ASR_BASELINE_RTFX, 3),
        "batch": bf16["batch"],
        "device": name,
        "extras": [],
    }

    # Extras are best-effort within the time budget: the headline always
    # prints, and a failure is reported, never dropped.
    def add(metric, fn, baseline, **tags):
        if time.time() - t_start > budget:
            out["extras"].append({"metric": metric, "skipped": "time_budget"})
            return
        try:
            r = fn()
            v = r.pop("rtfx")
            out["extras"].append({
                "metric": metric, "value": round(v, 2), "unit": "audio_sec/wall_sec",
                "vs_baseline": round(v / baseline, 3), **tags, **r})
        except Exception as e:  # never break the headline line
            traceback.print_exc()
            out["extras"].append({"metric": metric,
                                  "skipped": f"{type(e).__name__}: {e}"})

    add("rtfx_zipformer30m_beam8_fp32_per_chip",
        lambda: measure_asr("float32", n_batches=args.n_batches, device=device),
        ASR_BASELINE_RTFX, default_tier=True)
    if os.environ.get("SVT_BENCH_FULL", "1") != "0":
        add(f"rtfx_full_pipeline_{args.minutes:g}min_per_chip",
            lambda: measure_full_pipeline(args.minutes, device=device),
            FULL_BASELINE_RTFX)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
