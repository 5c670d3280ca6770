# TranscriberPipeline — the batch transcription entry point.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/transcriber.py for the ASR-only
# configuration: same constructor shape (file_path, model, config,
# progress_callback, cancel_check), same PHASE progress protocol and
# .asr_phase file, same result contract. Stage order:
#   load audio -> [VAD from a caller's vad_prob_fn, or bypass_vad] ->
#   silence-aware 30 s/3 s chunk plan -> batched decode -> overlap merge ->
#   suspect detect -> filler removal -> pause segmentation -> result.
# Stages not ported yet raise NotImplementedError instead of being skipped:
# the built-in Silero VAD, ROVER, diarization, punctuation, DNSMOS quality,
# WPE preprocessing, overlap separation and resume checkpoints.

from __future__ import annotations

import os
import time

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models.registry import AsrModel
from sherpa_vietnamese_asr_tpu_torch.pipeline import chunking, vad as vad_mod
from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder
from sherpa_vietnamese_asr_tpu_torch.pipeline.merge import (
    merge_chunks_with_overlap,
    split_long_segments,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.suspect import (
    remove_filler_words,
    suspect_detect,
)
from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import is_int16_exact, load_audio

SAMPLE_RATE = 16000

# config flags of the JAX pipeline whose stages are not ported yet
_UNPORTED_FLAGS = ("speaker_diarization", "quality_analysis", "preprocess_wpe",
                   "overlap_separation", "enable_resume")


def segment_words_by_pause(all_words, max_words=15, pause_sec=0.8):
    """Close a segment on a >0.8 s gap or after 15 words; segments carry
    their raw_words slice."""
    segments = []
    cur, start, start_idx = [], -1.0, 0
    for i, w in enumerate(all_words):
        if start < 0:
            start, start_idx = w["start"], i
        cur.append(w["text"])
        pause = (i < len(all_words) - 1
                 and all_words[i + 1]["start"] - w["end"] > pause_sec)
        if pause or len(cur) > max_words:
            segments.append({"text": " ".join(cur).strip(), "start": start,
                             "end": w["end"],
                             "raw_words": all_words[start_idx: i + 1]})
            cur, start = [], -1.0
    if cur:
        segments.append({"text": " ".join(cur).strip(), "start": start,
                         "end": all_words[-1]["end"],
                         "raw_words": all_words[start_idx:]})
    return segments


def fix_overlapping_segments(segments):
    """Clip each segment's end (and raw_words times) to the next segment's
    start."""
    for i in range(len(segments) - 1):
        nxt = segments[i + 1]["start"]
        if segments[i]["end"] > nxt:
            segments[i]["end"] = nxt
        for w in segments[i].get("raw_words", []):
            if w["end"] > nxt:
                w["end"] = nxt
            if w["start"] > nxt:
                w["start"] = nxt
    return segments


class TranscriberPipeline:
    """Offline long-form transcription pipeline (PyTorch).

    Args:
        file_path: audio file (WAV natively; others via ffmpeg if present).
        model: AsrModel bundle.
        config: dict. Supported keys: bypass_vad, skip_preprocessing,
            preprocess_rms_normalize, max_batch (default 8),
            decode_transfer_dtype ("float32" | "int16").
        progress_callback: callable(str) receiving "PHASE:<Name>|<msg>|<pct>".
        cancel_check: callable() -> bool.
        vad_prob_fn: callable(audio) -> per-window speech probabilities;
            required unless config["bypass_vad"] is set.
    """

    def __init__(self, file_path, model: AsrModel, config=None,
                 progress_callback=None, cancel_check=None,
                 vad_prob_fn=None):
        if isinstance(model, (tuple, list)):
            raise NotImplementedError("ROVER (a model pair) is not ported yet")
        self.file_path = file_path
        self.model = model
        self.config = dict(config or {})
        for flag in _UNPORTED_FLAGS:
            if self.config.get(flag, False):
                raise NotImplementedError(f"config {flag!r} is not ported yet")
        if (self.config.get("restore_punctuation", False)
                and not self.config.get("bypass_restorer", False)):
            raise NotImplementedError("punctuation restoration is not ported yet")
        # An absent key keeps 8; 0, None or a negative value means "auto" in
        # the JAX package (pipeline/calibration.resolve_max_batch).
        max_batch = self.config.get("max_batch", 8)
        if max_batch is None or int(max_batch) <= 0:
            raise NotImplementedError(
                f"config max_batch={max_batch!r} asks for automatic batch sizing, "
                "which needs the calibration report (pipeline/calibration.py): "
                "not ported yet; pass a positive max_batch")
        self.max_batch = int(max_batch)
        self.progress_callback = progress_callback
        self.cancel_check = cancel_check
        self.vad_prob_fn = vad_prob_fn
        self._phase_file = str(file_path) + ".asr_phase"

    def _decoder(self, transfer_dtype=None):
        return BatchedChunkDecoder(self.model, max_batch=self.max_batch,
                                   transfer_dtype=transfer_dtype)

    # -- progress protocol --
    def _emit(self, message: str):
        if self.progress_callback:
            self.progress_callback(message)
        if message.startswith("PHASE:"):
            try:
                with open(self._phase_file, "w", encoding="utf-8") as f:
                    f.write(message)
            except OSError:
                pass

    def _cancelled(self):
        return self.cancel_check is not None and self.cancel_check()

    def run(self):
        t0 = time.time()
        timing = {"transcription": 0.0, "alignment": 0.0, "vad": 0.0,
                  "preprocessing": 0.0}
        try:
            return self._run(t0, timing)
        finally:
            try:
                os.remove(self._phase_file)
            except OSError:
                pass

    def _run(self, t0, timing):
        self._emit("PHASE:LoadAudio|Loading audio|0")
        t_load = time.time()
        audio = load_audio(self.file_path, SAMPLE_RATE,
                           progress_callback=self._emit)
        timing["load_audio"] = time.time() - t_load
        total_samples = len(audio)
        if self._cancelled():
            return None

        # ---- VAD -> concat -> chunk plan ----
        bypass = self.config.get("bypass_vad", False)
        if not bypass and self.vad_prob_fn is None:
            raise NotImplementedError(
                "the built-in Silero VAD is not ported yet: pass "
                "config={'bypass_vad': True} or a vad_prob_fn")
        t_vad = time.time()
        vad_probs = None
        try:
            if bypass:
                raise RuntimeError("VAD_BYPASSED_BY_USER")
            self._emit("PHASE:VAD|Detecting speech|0")

            def cached_prob_fn(a):
                nonlocal vad_probs
                vad_probs = np.asarray(self.vad_prob_fn(a))
                return vad_probs

            segs = vad_mod.get_vad_segments(audio, cached_prob_fn,
                                            progress_callback=self._emit)
            self._emit(f"PHASE:VAD|Found {len(segs)} speech segments|100")
            if not self.config.get("skip_preprocessing", False):
                try:
                    from sherpa_vietnamese_asr_tpu_torch.pipeline.preprocessing \
                        import preprocess_audio
                    t_pre = time.time()
                    audio = preprocess_audio(
                        audio, segs, SAMPLE_RATE,
                        enable_rms_normalize=self.config.get(
                            "preprocess_rms_normalize", False),
                        progress_callback=self._emit)
                    timing["preprocessing"] = time.time() - t_pre
                except Exception:
                    pass
            segs = chunking.merge_vad_gaps(segs)
            concat_audio, offset_map = vad_mod.concat_speech(audio, segs)
        except Exception as e:
            if str(e) != "VAD_BYPASSED_BY_USER":
                self._emit(f"PHASE:LoadAudio|VAD failed ({e}); "
                           "silence-based chunking|60")
            concat_audio = audio
            offset_map = [(0, 0, total_samples)]
        timing["vad"] = time.time() - t_vad
        if self._cancelled():
            return None

        silent = chunking.find_silent_regions(concat_audio)
        plan = chunking.plan_chunks(len(concat_audio), silent)

        # ---- Batched decode ----
        t_dec = time.time()
        self._emit("PHASE:Transcription|Transcribing|0")
        # Lossless int16 upload for audio decoded from 16-bit PCM.
        transfer_dtype = self.config.get("decode_transfer_dtype")
        if transfer_dtype is None and is_int16_exact(concat_audio):
            transfer_dtype = "int16"
        decoder = self._decoder(transfer_dtype)
        spans = [(s, e) for s, e, _ in plan]
        chunk_words = decoder.decode_spans(
            concat_audio, spans, progress_callback=self._emit,
            cancel_check=self.cancel_check)
        for words in chunk_words:
            for w in words:
                w["start"] = vad_mod.map_concat_time(w["start"], offset_map)
                w["end"] = vad_mod.map_concat_time(w["end"], offset_map)

        chunk_results = []
        for (s, e, ov), words in zip(plan, chunk_words):
            chunk_results.append({
                "text": " ".join(w["text"] for w in words),
                "words": words,
                "audio_start_abs": s / SAMPLE_RATE,
                "audio_end_abs": e / SAMPLE_RATE,
                "overlap_sec": ov / SAMPLE_RATE,
            })
        timing["transcription"] = time.time() - t_dec
        if self._cancelled():
            return None

        # ---- Merge overlaps, suspects, fillers ----
        t_merge = time.time()
        all_words, full_text = merge_chunks_with_overlap(chunk_results)
        all_words = suspect_detect(all_words, audio, disagree_indices=None,
                                   vad_probs=vad_probs)
        all_words = remove_filler_words(all_words)
        full_text = " ".join(w["text"] for w in all_words)
        if full_text:
            full_text = full_text.capitalize()
        timing["merge_suspect"] = time.time() - t_merge
        return self._finish(t0, timing, total_samples, all_words, full_text)

    def _finish(self, t0, timing, total_samples, all_words, full_text):
        """Pause segmentation and result assembly."""
        if self._cancelled():
            return None
        t_align = time.time()
        self._emit("PHASE:Align|Aligning timestamps|0")
        final_segments = segment_words_by_pause(all_words)
        final_segments = fix_overlapping_segments(final_segments)
        final_segments = split_long_segments(final_segments, max_duration=12.0,
                                             preserve_raw_words=True)
        timing["alignment"] += time.time() - t_align
        self._emit("PHASE:Align|Done|100")

        self._emit("PHASE:Complete|Done|100")
        total = time.time() - t0
        word_probs = [w.get("prob") for w in all_words
                      if w.get("prob") is not None]
        device = self.model.device
        return {
            "text": full_text,
            "segments": final_segments,
            "timing": {
                "transcription": timing["transcription"],
                "restoration": 0.0,
                "total": total,
                "upload_convert": 0.0,
                "transcription_detail": timing["transcription"],
                "sentence_segmentation": 0.0,
                "punctuation": 0.0,
                "alignment": timing["alignment"],
                "diarization": 0.0,
                "quality": 0.0,
                "load_audio": timing.get("load_audio", 0.0),
                "vad": timing.get("vad", 0.0),
                "merge_suspect": timing.get("merge_suspect", 0.0),
                "quality_overlapped": 0.0,
            },
            "paragraphs": [],
            "has_speaker_diarization": False,
            "speaker_segments_raw": [],
            "duration_sec": total_samples / SAMPLE_RATE,
            "speaker_names": {},
            "asr_confidence": (float(np.mean(word_probs))
                               if word_probs else None),
            "quality_info": None,
            "execution_provider": device.type,
            "stage_execution_providers": {},
            "asr_provider_info": {"backend": "torch", "device": str(device)},
            "overlap_segments": [],
        }
