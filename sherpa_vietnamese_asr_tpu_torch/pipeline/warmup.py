# Warm-up: run every serving stage once at request shapes before real work.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/warmup.py, with the same STAGES
# and the same return value, {stage: seconds | None}. The JAX package warms
# by compiling its jitted programs into the persistent compilation cache.
# The port compiles nothing per shape: on the card, warming means building
# the CUDA kernel library once (ops/cuda_lib.library(), under its lock) and
# giving each stage its first call at request shapes, which pays cuBLAS's and
# cuDNN's first-use heuristics, the caching allocator's first reservations
# and the models' uploads before a request does. Two consumers:
#   * `serve --warmup`: before the server accepts requests;
#   * `warmup`: one-shot, e.g. after an install.
#
# Every stage is independent and failure-isolated, as in the reference: a
# stage that raises is logged and reported as None, and the others run on.
# Stages whose checkpoints are missing run on loudly flagged random weights
# (models/assets), as the pipeline's own stages do. jobs > 1 runs the stages
# on a thread pool, as the JAX package does; the default is 1, since every
# stage runs on the same card.

from __future__ import annotations

import time

import numpy as np

STAGES = ("decode", "vad", "streaming", "diarization", "punctuation",
          "quality", "senko")


def warmup_programs(model, models_dir=None, stages=STAGES, log=print,
                    streamer=None, jobs=1):
    """Run each stage once on the model's device. Returns {stage: seconds |
    None}. `models_dir` is a directory the diarization and punctuation
    stages read their ONNX files from (then the asset registry, else random
    weights); `streamer` is the server's MultiStreamRecognizer, else a new
    one over `model`."""
    device = model.device
    timings = {}
    pending = []
    if device.type == "cuda":
        from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

        t0 = time.time()
        cuda_lib.library()
        log(f"[warmup] kernel library: {time.time() - t0:.1f}s")

    def stage(name, fn):
        if name not in stages:
            return

        def run():
            t0 = time.time()
            try:
                fn()
                if device.type == "cuda":
                    import torch

                    torch.cuda.synchronize(device)
                timings[name] = time.time() - t0
                log(f"[warmup] {name}: {timings[name]:.1f}s")
            except Exception as e:  # stage-isolated by design
                timings[name] = None
                log(f"[warmup] {name} skipped ({e})")

        if jobs > 1:
            pending.append(run)
        else:
            run()

    def _decode():
        from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import resolve_max_batch
        from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

        warm_batch = resolve_max_batch({}, device=device)
        log(f"[warmup] decode batch {warm_batch}")
        dec = BatchedChunkDecoder(model, max_batch=warm_batch)
        dummy = np.zeros(16000 * 34, np.float32)
        dec.decode_spans(dummy, [(0, 16000 * 30)])

    def _streaming():
        if streamer is not None:
            s = streamer
        else:
            from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import (
                MultiStreamRecognizer,
            )

            s = MultiStreamRecognizer(model)
        slot = s.open_stream()
        s.accept_waveform(slot, np.zeros(16000 * 2, np.float32))
        while s.ready_slots():
            s.step()
        s.close_stream(slot)

    def _diarization():
        from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

        PureDiarizer(model_dir=models_dir, device=device).process(_warm_audio(70))

    def _punctuation():
        from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import (
            build_punctuation_restorer,
        )

        r = build_punctuation_restorer(model_dir=models_dir, device=device)
        # One real multi-chunk restore (the JAX package also walks every
        # minibatch shape first, for its compiler).
        r.restore(" ".join("xin chao cac ban hom nay troi dep qua"
                           .split() * 40))

    def _vad():
        # The transcriber's default VAD: the blocked Silero pass on the
        # model's device, the checkpoint from the asset registry or random.
        from sherpa_vietnamese_asr_tpu_torch.models import assets, convert, silero_vad

        loaded = assets.load_silero()
        if loaded is not None:
            state, cfg = loaded
            vad = convert.silero_from_numpy(state, cfg, device=device)
        else:
            assets.warn_random("Silero VAD")
            vad = silero_vad.random_silero_vad(device=device)
        silero_vad.silero_vad_probs_streamed(vad, _warm_audio(61)).cpu()

    def _quality():
        from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

        QualityAnalyzer(device=device).analyze_speech(_warm_audio(12))

    def _senko():
        from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import (
            SenkoCamppDiarizer,
        )

        SenkoCamppDiarizer(device=device).process(_warm_audio(70))

    stage("decode", _decode)
    stage("vad", _vad)
    stage("streaming", _streaming)
    stage("diarization", _diarization)
    stage("punctuation", _punctuation)
    stage("quality", _quality)
    stage("senko", _senko)
    if pending:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futures = [ex.submit(fn) for fn in pending]
            for f in futures:
                f.result()
    return timings


def _warm_audio(seconds):
    n = 16000 * seconds
    audio = np.zeros(n + 16000 * 5, np.float32)
    audio[:n] = 0.05 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000.0)
    return audio
