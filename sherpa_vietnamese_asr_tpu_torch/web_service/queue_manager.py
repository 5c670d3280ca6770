# Copied from sherpa_vietnamese_asr_tpu/web_service/queue_manager.py (host-only; only the package path changes).
# Queue manager: strict FIFO, one file at a time, over the TPU pipeline.
#
# Behavioral port of reference web_service/queue_manager.py:
#   * strict FIFO with a single in-flight job (:161-287) — the TPU pipeline
#     already batches internally, so serializing files keeps HBM bounded
#     exactly as the reference serialized CPU jobs;
#   * WAV conversion step (ffmpeg with realtime progress when present; the
#     pure-python WAV path otherwise) (:26-158);
#   * slider -> confidence mapping for punctuation/case (:355-368):
#     punct = 0.5 - (slider-1)*(1.3/9), case = -1.5 + (slider-1)*(2.0/9),
#     bypass when punct slider <= 1;
#   * progress relayed to the DB and to registered subscribers (WebSocket
#     push in server.py), with queue-position broadcast.

from __future__ import annotations

import json
import logging
import os
import threading
import traceback

logger = logging.getLogger(__name__)


def slider_to_confidences(punct_slider, case_slider):
    """(1-10, 1-10) sliders -> (punct_confidence, case_confidence, bypass)."""
    punct_slider = max(1, min(10, int(punct_slider)))
    case_slider = max(1, min(10, int(case_slider)))
    punct_conf = 0.5 - (punct_slider - 1) * (1.3 / 9)
    case_conf = -1.5 + (case_slider - 1) * (2.0 / 9)
    return punct_conf, case_conf, punct_slider <= 1


def convert_to_wav(input_path, output_path, progress_callback=None,
                   timeout=600):
    """Pre-convert any container to 16 kHz mono PCM WAV via ffmpeg with
    realtime percent progress parsed from `-progress pipe:1` out_time_us
    lines (reference queue_manager.py:84-158). Returns the output path, or
    None when ffmpeg is unavailable (the WAV fast path / gated decode in
    utils/audio_io.py then handles the original file)."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    total_us = 0
    ffprobe = shutil.which("ffprobe")
    if ffprobe is not None:
        try:
            out = subprocess.run(
                [ffprobe, "-v", "error", "-show_entries", "format=duration",
                 "-of", "csv=p=0", input_path],
                capture_output=True, text=True, timeout=60)
            total_us = int(float(out.stdout.strip()) * 1_000_000)
        except (ValueError, subprocess.SubprocessError):
            pass
    cmd = [ffmpeg, "-hide_banner", "-nostdin", "-loglevel", "error", "-y",
           "-i", input_path, "-vn", "-ar", "16000", "-ac", "1",
           "-acodec", "pcm_s16le", "-progress", "pipe:1", output_path]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    last_pct = -1
    assert proc.stdout is not None
    for raw in proc.stdout:
        line = raw.decode("utf-8", errors="replace").strip()
        if line.startswith("out_time_us=") and total_us > 0 \
                and progress_callback:
            try:
                pct = min(99, int(line.split("=")[1]) * 100 // total_us)
            except ValueError:
                continue
            if pct > last_pct:
                last_pct = pct
                progress_callback(
                    f"PHASE:Convert|Converting audio|{pct}")
    _, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError("ffmpeg convert failed: "
                           f"{stderr.decode(errors='replace')[-400:]}")
    return output_path


class QueueManager:
    """One job at a time; jobs run in a worker thread.

    Args:
        db: web_service.database.Database.
        model_provider: callable(model_name) -> AsrModel or (a, b) tuple.
        upload_dir: where stored files live.
        pipeline_factory: optional callable(file_path, model, config,
            progress_callback, cancel_check) -> object with .run(); defaults
            to TranscriberPipeline.
    """

    def __init__(self, db, model_provider, upload_dir,
                 pipeline_factory=None, default_model="zipformer-30m-rnnt-6000h"):
        self.db = db
        self.model_provider = model_provider
        self.upload_dir = upload_dir
        self.pipeline_factory = pipeline_factory
        self.default_model = default_model
        self.paused = False
        self._lock = threading.Lock()
        self._current_file_id = None
        self._cancel_requested = set()
        self._worker = None
        self._subscribers = []  # callables(event: dict)

    # -- events ----------------------------------------------------------------
    def subscribe(self, fn):
        self._subscribers.append(fn)

    def _emit_event(self, event):
        for fn in list(self._subscribers):
            try:
                fn(event)
            except Exception:
                pass

    # -- public API ---------------------------------------------------------------
    def add_to_queue(self, file_id, session_id, config):
        self.db.add_to_queue(file_id, session_id, dict(config or {}))
        self.db.update_file(file_id, status="queued")
        self._broadcast_positions()
        self.process_next()
        return self.db.get_queue_position(file_id)

    def cancel(self, file_id):
        item = self.db.get_queue_item(file_id)
        if not item:
            return False
        if item["status"] == "waiting":
            self.db.set_queue_status(file_id, "cancelled")
            self.db.update_file(file_id, status="cancelled")
            self._broadcast_positions()
            return True
        if item["status"] == "processing":
            self._cancel_requested.add(file_id)
            return True
        return False

    def pause(self):
        self.paused = True

    def resume(self):
        self.paused = False
        self.process_next()

    @property
    def current_file_id(self):
        return self._current_file_id

    def process_next(self):
        """Start the next waiting job if idle (strict FIFO, 1 at a time)."""
        with self._lock:
            if self.paused or self._current_file_id is not None:
                return
            item = self.db.get_next_queue_item()
            if item is None:
                return
            self._current_file_id = item["file_id"]
            self.db.set_queue_status(item["file_id"], "processing")
            self.db.update_file(item["file_id"], status="processing")
            self._worker = threading.Thread(
                target=self._process_item, args=(item,), daemon=True)
            self._worker.start()

    def wait_idle(self, timeout=None):
        w = self._worker
        if w is not None:
            w.join(timeout)

    # -- internals -------------------------------------------------------------------
    def _broadcast_positions(self):
        for item in self.db.get_waiting_queue():
            if item["status"] == "waiting":
                self._emit_event({
                    "type": "queue_position",
                    "file_id": item["file_id"],
                    "position": self.db.get_queue_position(item["file_id"]),
                })

    def _build_pipeline_config(self, config):
        from sherpa_vietnamese_asr_tpu_torch.utils.config import validate_config

        punct_conf, case_conf, bypass = slider_to_confidences(
            config.get("punctuation_confidence", 5),
            config.get("case_confidence", 5))
        raw_threshold = config.get("diarization_threshold")
        threshold = (int(raw_threshold) / 100.0 if raw_threshold is not None
                     else 0.6)
        raw_num = int(config.get("num_speakers", 0))
        return validate_config({
            "restore_punctuation": True,
            "bypass_restorer": bypass,
            "punctuation_confidence": punct_conf,
            "case_confidence": case_conf,
            "speaker_diarization": config.get("speaker_diarization", True),
            "speaker_model": config.get("speaker_model", "pure_ort"),
            "num_speakers": 0 if raw_num <= 0 else raw_num,
            "diarization_threshold": threshold,
            "rover_mode": config.get("model") == "rover-voting",
            "preprocess_rms_normalize": config.get("rms_normalize", False),
            "bypass_vad": config.get("bypass_vad", False),
            "max_batch": config.get("max_batch", 8),
        })

    def _process_item(self, item):
        file_id = item["file_id"]
        try:
            config = json.loads(item["config_json"] or "{}")
            file_rec = self.db.get_file(file_id)
            path = os.path.join(self.upload_dir, file_rec["stored_filename"])

            def progress_callback(message):
                if message.startswith("PHASE:"):
                    parts = message.split("|")
                    phase = parts[0][len("PHASE:"):]
                    msg = parts[1] if len(parts) > 1 else ""
                    try:
                        pct = int(parts[2]) if len(parts) > 2 else 0
                    except ValueError:
                        pct = 0
                    self.db.update_queue_progress(
                        file_id, pct, f"{phase}: {msg}")
                    self._emit_event({"type": "progress", "file_id": file_id,
                                      "phase": phase, "message": msg,
                                      "percent": pct})

            def cancel_check():
                return file_id in self._cancel_requested

            # Pre-convert non-WAV uploads to 16 kHz mono WAV (reference
            # queue_manager.py:84-158): pipeline reads the fast WAV path
            # and /api/files/{id}/audio serves the converted copy.
            if not path.lower().endswith(".wav"):
                wav_path = path.rsplit(".", 1)[0] + ".wav"
                try:
                    converted = wav_path if os.path.exists(wav_path) else \
                        convert_to_wav(path, wav_path, progress_callback)
                    if converted:
                        path = converted
                except RuntimeError as e:
                    logger.warning("convert failed, using original: %s", e)

            model_name = config.get("model", self.default_model)
            model = self.model_provider(model_name)
            pipeline_config = self._build_pipeline_config(config)
            if self.pipeline_factory is not None:
                pipeline = self.pipeline_factory(
                    path, model, pipeline_config, progress_callback,
                    cancel_check)
            else:
                from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
                    TranscriberPipeline,
                )
                pipeline = TranscriberPipeline(
                    path, model, pipeline_config,
                    progress_callback=progress_callback,
                    cancel_check=cancel_check)
            result = pipeline.run()

            if result is None:  # cancelled
                self.db.set_queue_status(file_id, "cancelled")
                self.db.update_file(file_id, status="cancelled")
                self._emit_event({"type": "cancelled", "file_id": file_id})
            else:
                from sherpa_vietnamese_asr_tpu_torch.pipeline.asr_json import (
                    serialize_segments,
                )
                data = serialize_segments(
                    result.get("segments", []),
                    model_name=model_name,
                    duration_sec=result.get("duration_sec", 0.0),
                    timing=result.get("timing"),
                    overlap_segments=result.get("overlap_segments"))
                data["text"] = result.get("text", "")
                data["asr_confidence"] = result.get("asr_confidence")
                data["quality_info"] = result.get("quality_info")
                self.db.update_file(
                    file_id, status="completed",
                    asr_result_json=json.dumps(data, ensure_ascii=False),
                    duration_sec=result.get("duration_sec"),
                    model_used=model_name,
                    completed_at=__import__("datetime").datetime.now()
                    .isoformat())
                self.db.set_queue_status(file_id, "completed")
                self._emit_event({"type": "completed", "file_id": file_id})
        except Exception as e:
            logger.error("queue job failed: %s", e)
            traceback.print_exc()
            self.db.set_queue_status(file_id, "error")
            self.db.update_file(file_id, status="error")
            self._emit_event({"type": "error", "file_id": file_id,
                              "message": str(e)})
        finally:
            self._cancel_requested.discard(file_id)
            with self._lock:
                self._current_file_id = None
            self._broadcast_positions()
            self.process_next()
