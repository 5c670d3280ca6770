# Device calibration and decode batch sizing.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/calibration.py:
#   * run_device_calibration: every stage of _stage_specs (fbank, the
#     Zipformer-30M encoder at true size, DNSMOS) on two backends, "cpu"
#     (every kernel's plain PyTorch twin) and "cuda" (the hand-written
#     kernels: kernel 1 for the fbank stage, kernel 2 in the encoder) when the
#     host has a card, on identical inputs and weights; a stage is accepted
#     for the card when it is >= SPEEDUP_MIN faster and its outputs are within
#     STAGE_TOLERANCES of the CPU's. Same report layout as the JAX package's.
#   * autotune_max_batch: the batched chunk decode (fbank -> encoder -> beam
#     search, kernels 1-3) timed at each candidate batch size.
#   * resolve_max_batch (an explicit value wins, then the calibration
#     report's recommendation, then the heuristic), auto_batch_size (the
#     memory-tiered heuristic of every stage) and hbm_budget_mb, over
#     torch.cuda.mem_get_info: the card's free memory, None on the CPU, so
#     that "auto" resolves to the default there as the JAX package does on
#     its CPU backend.
#   * the full-pipeline calibration (make_calibration_wav, run_pipeline_once,
#     compare_pipeline_runs, run_full_pipeline_calibration): one
#     TranscriberPipeline run on the card and one on the CPU, in this
#     process (the JAX package runs its CPU pass in a child process because
#     its backend is pinned at first use; a torch model names its device).

from __future__ import annotations

import json
import time

import numpy as np
import torch

SPEEDUP_MIN = 1.20  # reference GPU_STAGE_SPEEDUP_MIN (calibration.py:41)

# Per-stage tolerances (reference calibration.py:70-103 pattern)
STAGE_TOLERANCES = {
    "fbank": {"max_abs": 5e-2, "rel_l2": 1e-3},
    "encoder": {"max_abs": 5e-2, "rel_l2": 5e-3},
    "segmentation": {"max_abs": 5e-2, "rel_l2": 5e-3},
    "embedding": {"max_abs": 5e-2, "rel_l2": 5e-3},
    "campp": {"max_abs": 5e-2, "rel_l2": 5e-3},
    "vibert": {"max_abs": 5e-2, "rel_l2": 5e-3},
    "dnsmos": {"max_abs": 5e-2, "rel_l2": 5e-3},
}


def output_diff(a, b):
    """max_abs + rel_l2 between two outputs (reference _output_diff :1057)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    max_abs = float(np.max(np.abs(a - b))) if a.size else 0.0
    denom = float(np.linalg.norm(a)) + 1e-12
    rel_l2 = float(np.linalg.norm(a - b)) / denom
    return {"max_abs": max_abs, "rel_l2": rel_l2}


def within_tolerance(diff, stage):
    tol = STAGE_TOLERANCES.get(stage, {"max_abs": 5e-2, "rel_l2": 5e-3})
    return diff["max_abs"] <= tol["max_abs"] and \
        diff["rel_l2"] <= tol["rel_l2"]


def _time_fn(fn, warmup=1, iters=3):
    """Mean seconds of fn() after warm-up; fn returns host arrays, so each
    call ends when the device's work has."""
    for _ in range(warmup):
        out = fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def _stage_specs(rng):
    """[(name, make(device) -> callable returning numpy)] with realistic
    sample inputs (reference :675-797); every stage builds the same weights
    and inputs on each device."""
    specs = []

    # fbank: 30 s chunk batch (kernel 1 on a CUDA tensor)
    audio = rng.standard_normal((4, 16000 * 30)).astype(np.float32) * 0.1

    def fbank_stage(device):
        from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fb
        from sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref import ASR_FBANK

        x = torch.from_numpy(audio).to(device)
        return lambda: fb.compute_fbank(x, ASR_FBANK).cpu().numpy()

    specs.append(("fbank", fbank_stage))

    # encoder at true 30M size (kernel 2 on the card)
    feats = rng.standard_normal((2, 500, 80)).astype(np.float32)

    def encoder_stage(device):
        from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model

        model = random_asr_model(vocab_size=100, device=device)
        x = torch.from_numpy(feats).to(device)
        ln = torch.full((2,), 500, dtype=torch.int64, device=device)
        return lambda: model.encoder(x, ln)[0].cpu().numpy()

    specs.append(("encoder", encoder_stage))

    # dnsmos
    clips = rng.standard_normal((3, 144160)).astype(np.float32) * 0.1

    def dnsmos_stage(device):
        from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import random_dnsmos

        model = random_dnsmos(seed=0, device=device)
        x = torch.from_numpy(clips).to(device)

        def run():
            with torch.no_grad():
                return model(x).cpu().numpy()
        return run

    specs.append(("dnsmos", dnsmos_stage))
    return specs


def hbm_budget_mb(device=None):
    """Free memory of the card in MB (torch.cuda.mem_get_info), or None on
    a CPU device or a host without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free / (1024 * 1024))


def auto_batch_size(stage, default, budget_mb=None, device=None):
    """Memory-tiered heuristic batch size of a stage, from the free memory
    of `device` unless `budget_mb` is given; `default` where there is no
    card."""
    if budget_mb is None:
        budget_mb = hbm_budget_mb(device)
    if budget_mb is None:
        return int(default)
    stage_key = (stage or "").lower()
    if "embedding" in stage_key:
        for floor, batch in ((10000, 32), (6000, 24), (3000, 16)):
            if budget_mb >= floor:
                return batch
        return 8
    if "punct" in stage_key or "vibert" in stage_key:
        for floor, batch in ((6000, 32), (2500, 16)):
            if budget_mb >= floor:
                return batch
        return 8
    if "campp" in stage_key or "speaker" in stage_key:
        for floor, batch in ((10000, 128), (7000, 96), (3500, 64)):
            if budget_mb >= floor:
                return batch
        return 32
    if budget_mb >= 7000:
        return max(default, 64)
    if budget_mb >= 3500:
        return max(default, 32)
    return min(default, 16)


def resolve_max_batch(config, report_path=None, device=None):
    """The decode batch size: an explicit max_batch > 0 wins (an absent key
    keeps 8); 0, None or a negative value ("auto") takes
    recommended.max_batch from the calibration report
    (config["calibration_report"], else calibration_report.json), else the
    heuristic over `device`'s free memory."""
    explicit = int((config or {}).get("max_batch", 8) or 0)
    if explicit > 0:
        return explicit
    path = report_path or (config or {}).get("calibration_report") \
        or "calibration_report.json"
    try:
        with open(path, encoding="utf-8") as f:
            report = json.load(f)
        rec = ((report.get("recommended") or {}).get("max_batch"))
        if rec:
            return int(rec)
    except (OSError, ValueError):
        pass
    return auto_batch_size("decode", 8, device=device)


def autotune_max_batch(model=None, candidates=(4, 8, 16, 32, 48, 64),
                       chunk_sec=None, progress_callback=None, device="cuda"):
    """Time the batched chunk decode (fbank -> encoder -> beam search) at
    each candidate batch size and pick the one with the lowest seconds per
    chunk (reference _tune_gpu_batch, core/calibration.py:968). Each
    candidate gets a warm-up call and two timed ones; a failing candidate
    (out of memory at a large batch) is recorded and skipped. `model`
    defaults to a random Zipformer-30M on `device`; the decode runs on the
    model's device."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import (
        SAMPLE_RATE,
        decode_feats,
        fbank_batch,
    )

    if model is None:
        from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model

        model = random_asr_model(vocab_size=500, device=device)
    dev = model.device
    if chunk_sec is None:
        chunk_sec = 33.0
    pad_len = int(chunk_sec * SAMPLE_RATE)
    rng = np.random.default_rng(0)
    attempts = []
    best = None
    for i, cand in enumerate(sorted(set(int(c) for c in candidates))):
        if progress_callback:
            progress_callback(
                f"PHASE:Calibration|batch {cand}|{i * 100 // len(candidates)}")
        try:
            audio = torch.from_numpy(
                rng.standard_normal((cand, pad_len)).astype(np.float32) * 0.1).to(dev)
            n_frames = torch.full((cand,), (pad_len + 80) // 160, dtype=torch.int32,
                                  device=dev)

            def run():
                with torch.no_grad():
                    res, _ = decode_feats(fbank_batch(audio), n_frames, model)
                res.num_tokens.cpu()

            t, _ = _time_fn(run, warmup=1, iters=2)
            attempt = {"batch": cand, "ok": True,
                       "elapsed_sec": round(t, 5),
                       "sec_per_item": round(t / cand, 6),
                       "items_per_sec": round(cand / t, 2)}
        except (RuntimeError, ValueError) as e:  # torch.OutOfMemoryError is a RuntimeError
            attempt = {"batch": cand, "ok": False, "error": str(e)[:200]}
        attempts.append(attempt)
        if attempt["ok"] and (best is None
                              or attempt["sec_per_item"]
                              < best["sec_per_item"]):
            best = attempt
    return {"attempts": attempts,
            "best_batch": best["batch"] if best else None,
            "hbm_free_mb": hbm_budget_mb(dev)}


def calibration_devices():
    """{backend name: torch device}: "cpu", and "cuda" on a host with a
    card."""
    devices = {"cpu": torch.device("cpu")}
    if torch.cuda.is_available():
        devices["cuda"] = torch.device("cuda", torch.cuda.current_device())
    return devices


def run_device_calibration(report_path=None, progress_callback=None):
    """Benchmark each stage on every backend of the host (calibration_devices);
    gate the card's use on speedup >= SPEEDUP_MIN AND numeric tolerance
    against the CPU. A backend that fails a stage records the error in the
    report, as the reference does. Returns the report dict (also written to
    report_path when given)."""
    rng = np.random.default_rng(0)
    devices = calibration_devices()
    accel_name = "cuda" if "cuda" in devices else None
    report = {"devices": {k: (torch.cuda.get_device_name(v) if v.type == "cuda"
                              else str(v)) for k, v in devices.items()},
              "speedup_min": SPEEDUP_MIN, "stages": {}}
    for i, (name, make) in enumerate(_stage_specs(rng)):
        if progress_callback:
            progress_callback(f"PHASE:Calibration|{name}|{i * 30}")
        entry = {}
        outputs = {}
        for dev_name, dev in devices.items():
            try:
                fn = make(dev)
                t, out = _time_fn(fn)
                entry[dev_name] = {"time_sec": round(t, 5)}
                outputs[dev_name] = out
            except Exception as e:  # recorded per backend, as in the reference
                entry[dev_name] = {"error": str(e)[:200]}
        if "cpu" in outputs and accel_name in outputs:
            diff = output_diff(outputs["cpu"], outputs[accel_name])
            speedup = (entry["cpu"]["time_sec"]
                       / max(entry[accel_name]["time_sec"], 1e-9))
            entry["diff"] = {k: round(v, 6) for k, v in diff.items()}
            entry["speedup"] = round(speedup, 3)
            entry["accepted"] = bool(speedup >= SPEEDUP_MIN
                                     and within_tolerance(diff, name))
        report["stages"][name] = entry

    if accel_name:
        accepted = [n for n, e in report["stages"].items()
                    if e.get("accepted")]
        report["accelerated_stages"] = accepted
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    if progress_callback:
        progress_callback("PHASE:Calibration|Done|100")
    return report


# ---------------------------------------------------------------------------
# Full-pipeline calibration: one real end-to-end run per device + compare
# (reference core/calibration.py:1395-1560: the reference transcribes a
# bundled 10-min sample once per provider and gates acceptance on wall
# speedup AND output parity).
# ---------------------------------------------------------------------------

def make_calibration_wav(path, minutes=10.0, sr=16000):
    """Synthetic two-speaker sample (alternating 6 s AM-tone 'speakers' with
    1 s gaps + noise floor) — the stand-in for the reference's bundled
    calibration WAV (reference core/calibration.py:1372-1393)."""
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    dur = int(minutes * 60)
    t = np.arange(sr * dur) / sr
    x = np.zeros(sr * dur, np.float32)
    for k in range(dur // 6):
        f0 = 180.0 if k % 2 == 0 else 320.0
        am = 2.1 if k % 2 == 0 else 3.3
        s, e = k * 6 * sr, (k * 6 + 5) * sr
        tt = t[s:e]
        x[s:e] = (0.3 * np.sin(2 * np.pi * f0 * tt)
                  * (0.5 + 0.5 * np.sin(2 * np.pi * am * tt)))
    x += 0.005 * np.random.default_rng(0).standard_normal(len(x)).astype(
        np.float32)
    write_wav(path, x.astype(np.float32), sr)
    return path


def run_pipeline_once(wav_path, model_spec=None, config=None,
                      progress_callback=None, device="cuda"):
    """One full TranscriberPipeline run on `device` -> the reference's
    run-summary shape (core/calibration.py:1395-1478): elapsed/rtf/timing/
    text_chars/segments/speaker counts/asr_confidence."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        TINY_ZIPFORMER,
        load_asr_model,
        random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    spec = dict(model_spec or {})
    if spec.get("model_dir"):
        model = load_asr_model(spec["model_dir"], device=device)
    elif spec.get("tiny"):
        model = random_asr_model(vocab_size=int(spec.get("vocab_size", 200)),
                                 seed=int(spec.get("seed", 0)),
                                 zip_cfg=TINY_ZIPFORMER, device=device)
    else:
        model = random_asr_model(vocab_size=int(spec.get("vocab_size", 2000)),
                                 seed=int(spec.get("seed", 0)), device=device)
    cfg = {"speaker_diarization": True, "restore_punctuation": True,
           "quality_analysis": False, **(config or {})}
    t0 = time.monotonic()
    res = TranscriberPipeline(wav_path, model, config=cfg,
                              progress_callback=progress_callback).run()
    elapsed = time.monotonic() - t0
    duration = float(res.get("duration_sec") or 0)
    segments = res.get("segments") or []
    text = res.get("text") or ""
    speakers = {s.get("speaker") for s in segments
                if isinstance(s, dict) and s.get("speaker")}
    return {
        "backend": model.device.type,
        "elapsed_sec": round(elapsed, 3),
        "duration_sec": duration,
        "rtf": round(elapsed / duration, 5) if duration else None,
        "timing": res.get("timing") or {},
        "asr_confidence": res.get("asr_confidence"),
        "text_chars": len(text),
        "segments": len(segments),
        "speaker_turns": len(res.get("speaker_segments_raw") or []),
        "speaker_count": len(speakers),
    }


def compare_pipeline_runs(cpu_run, acc_run, confidence_tol=1e-4):
    """Port of reference _compare_runs (core/calibration.py:1479-1523):
    wall/stage speedups + parity gates (text chars within max(20, 0.2%),
    identical speaker counts/turns, confidence delta < confidence_tol).
    Card-vs-CPU transcripts on random weights flip near-tied beam steps,
    so `calibrate --full` exposes --confidence-tol for rehearsals without
    real checkpoints."""
    cpu_el = float(cpu_run.get("elapsed_sec") or 0)
    acc_el = float(acc_run.get("elapsed_sec") or 0)
    speedup = (cpu_el / acc_el) if cpu_el > 0 and acc_el > 0 else None
    stage_speedups = {}
    ct, gt = cpu_run.get("timing") or {}, acc_run.get("timing") or {}
    for key in sorted(set(ct) | set(gt)):
        c, g = float(ct.get(key) or 0), float(gt.get(key) or 0)
        stage_speedups[key] = round(c / g, 3) if c > 0 and g > 0 else None
    cpu_chars = int(cpu_run.get("text_chars") or 0)
    text_delta = int(acc_run.get("text_chars") or 0) - cpu_chars
    text_ok = abs(text_delta) <= max(20, int(cpu_chars * 0.002))
    spk_count_delta = (int(acc_run.get("speaker_count") or 0)
                       - int(cpu_run.get("speaker_count") or 0))
    spk_turn_delta = (int(acc_run.get("speaker_turns") or 0)
                      - int(cpu_run.get("speaker_turns") or 0))
    conf_delta = None
    if (cpu_run.get("asr_confidence") is not None
            and acc_run.get("asr_confidence") is not None):
        conf_delta = (float(acc_run["asr_confidence"])
                      - float(cpu_run["asr_confidence"]))
    parity_ok = (text_ok and spk_count_delta == 0 and spk_turn_delta == 0
                 and (conf_delta is None or abs(conf_delta) < confidence_tol))
    faster = bool(speedup and speedup >= 1.05)
    return {
        "wall_speedup": round(speedup, 3) if speedup else None,
        "stage_speedups": stage_speedups,
        "text_chars_delta": text_delta,
        "text_tolerance_ok": text_ok,
        "speaker_count_delta": spk_count_delta,
        "speaker_turn_delta": spk_turn_delta,
        "confidence_delta": conf_delta,
        "parity_ok": parity_ok,
        "accel_faster": faster,
        "accepted": bool(parity_ok and faster),
    }


def run_full_pipeline_calibration(wav_path=None, minutes=10.0,
                                  model_spec=None, config=None,
                                  confidence_tol=1e-4,
                                  progress_callback=None, device="cuda"):
    """Full-pipeline CPU-vs-card calibration (reference
    core/calibration.py:1524-1560 flow): the whole pipeline once on
    `device` and once on the CPU, on the same WAV and weights; compare
    wall/stage speedups and output parity. Returns {cpu_run, accel_run,
    compare}. Without wav_path a synthetic sample is written to a
    temporary directory and removed afterwards."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        if wav_path is None:
            wav_path = make_calibration_wav(os.path.join(tmp, "calibration.wav"),
                                            minutes=minutes)
        if progress_callback:
            progress_callback("PHASE:Calibration|Full pipeline (accelerator)|5")
        acc_run = run_pipeline_once(wav_path, model_spec=model_spec,
                                    config=config, device=device)
        if progress_callback:
            progress_callback("PHASE:Calibration|Full pipeline (CPU)|50")
        cpu_run = run_pipeline_once(wav_path, model_spec=model_spec,
                                    config=config, device="cpu")
    report = {"cpu_run": cpu_run, "accel_run": acc_run,
              "compare": compare_pipeline_runs(cpu_run, acc_run,
                                               confidence_tol)}
    if progress_callback:
        progress_callback("PHASE:Calibration|Done|100")
    return report
