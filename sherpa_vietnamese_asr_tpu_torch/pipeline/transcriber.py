# TranscriberPipeline — the batch transcription entry point.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/transcriber.py: same
# constructor shape (file_path, model, config, progress_callback,
# cancel_check, diarizer), same PHASE progress protocol, .asr_phase file,
# resume checkpoint and result contract. Stage order:
#   load audio -> [resume from a checkpoint] -> VAD (Silero on the model's
#   device, a caller's vad_prob_fn, or bypass_vad) -> [preprocess] ->
#   [diarization facade started in the background] -> [DNSMOS quality in a
#   background thread, on its own CUDA stream] -> silence-aware 30 s/3 s
#   chunk plan -> batched decode [per-chunk WPE] [-> ROVER over a model
#   pair] -> overlap merge -> suspect detect -> filler removal -> [quality
#   result] -> [speaker diarization [-> overlap separation: Conv-TasNet on
#   the diarizer's 2-speaker overlap regions and a re-decode of each
#   separated stream with the first model]] -> [punctuation, then sentences
#   aligned to words (and speakers)] or pause segmentation [-> words split
#   by speaker] -> result.
# max_batch 0, None or a negative value resolves once, on the model's
# device (pipeline/calibration.resolve_max_batch). overlap_separation
# without speaker_diarization does nothing, as in the JAX package.
#
# One difference in behaviour: the JAX pipeline catches a failure of the
# diarization (overlap separation and its re-decodes included), punctuation
# or quality stage, logs it and returns a result without speakers, overlap
# segments, punctuation or quality. Here it propagates out of run(), so a
# stage that fails on the card can never end in a run that looks
# successful.

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.registry import AsrModel
from sherpa_vietnamese_asr_tpu_torch.pipeline import chunking, vad as vad_mod
from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_post as dp
from sherpa_vietnamese_asr_tpu_torch.pipeline.alignment import (
    align_sentences,
    align_sentences_with_speakers,
    build_pause_hints,
    split_sentences,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import resolve_max_batch
from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder
from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import (
    SPEAKER_EMBEDDING_MODELS,
    SpeakerDiarizer,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.merge import (
    merge_chunks_with_overlap,
    split_long_segments,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.preprocessing import (
    adaptive_peak_limit,
    apply_wpe_dereverberation,
    preprocess_audio,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.rover import (
    rebuild_disagree_indices,
    rover_merge_words,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.suspect import (
    remove_filler_words,
    suspect_detect,
)
from sherpa_vietnamese_asr_tpu_torch.utils import trace
from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import is_int16_exact, load_audio

SAMPLE_RATE = 16000


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
        model: AsrModel bundle, or (model_a, model_b) for ROVER.
        config: dict. Supported keys: bypass_vad, skip_preprocessing,
            preprocess_rms_normalize, preprocess_wpe, enable_resume,
            hotword_phrases (ROVER's hotword bonus), max_batch (default 8;
            0, None or negative: automatic), calibration_report,
            decode_transfer_dtype ("float32" | "int16"),
            speaker_diarization (with speaker_model, num_speakers,
            diarization_threshold, diarize_overlap_decode,
            overlap_separation and _overlap_separator: an
            overlap.OverlapSeparator, else one on the model's device),
            restore_punctuation (with bypass_restorer,
            punctuation_confidence, case_confidence, prefer_int8),
            quality_analysis (with quality_overlap_decode).
        progress_callback: callable(str) receiving "PHASE:<Name>|<msg>|<pct>".
        cancel_check: callable() -> bool.
        vad_prob_fn: callable(audio) -> per-window speech probabilities;
            default: Silero VAD on the model's device (the checkpoint from
            models/assets, else loudly flagged random weights).
        diarizer: a PureDiarizer (its raw segments are post-processed here)
            or a SpeakerDiarizer facade; with config speaker_diarization and
            no diarizer, a facade on the model's device.
        punct_restorer: a pipeline.punctuation.PunctuationRestorer; with
            config restore_punctuation and none given, one from
            build_punctuation_restorer on the model's device.
        quality_analyzer: a pipeline.quality.QualityAnalyzer; with config
            quality_analysis and none given, one on the model's device.
    """

    def __init__(self, file_path, model: AsrModel, config=None,
                 progress_callback=None, cancel_check=None,
                 vad_prob_fn=None, punct_restorer=None, diarizer=None,
                 quality_analyzer=None):
        self.file_path = file_path
        if isinstance(model, (tuple, list)):
            self.model, self.model_b = model[0], model[1]
        else:
            self.model, self.model_b = model, None
        self.config = dict(config or {})
        # An absent key keeps 8; 0, None or a negative value means "auto".
        self.max_batch = resolve_max_batch(self.config, device=self.model.device)
        self.progress_callback = progress_callback
        self.cancel_check = cancel_check
        self.vad_prob_fn = vad_prob_fn
        self.punct_restorer = punct_restorer
        self.diarizer = diarizer
        self.quality_analyzer = quality_analyzer
        # Callers that pass only the config dict get the facade.
        if (self.diarizer is None
                and self.config.get("speaker_diarization", False)):
            model_key = self.config.get("speaker_model", "pure_ort")
            model_id = model_key if model_key in SPEAKER_EMBEDDING_MODELS \
                else "community1_pure_ort"
            self.diarizer = SpeakerDiarizer(
                embedding_model_id=model_id,
                num_clusters=int(self.config.get("num_speakers", 0)) or -1,
                threshold=float(self.config.get("diarization_threshold", 0.6)),
                backend_kwargs={"device": self.model.device})
        if (self.quality_analyzer is None
                and self.config.get("quality_analysis", False)):
            from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer
            self.quality_analyzer = QualityAnalyzer(device=self.model.device)
        if (self.punct_restorer is None
                and self.config.get("restore_punctuation", False)
                and not self.config.get("bypass_restorer", False)):
            from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import (
                build_punctuation_restorer,
            )
            self.punct_restorer = build_punctuation_restorer(
                confidence=float(self.config.get("punctuation_confidence", 0.3)),
                case_confidence=float(self.config.get("case_confidence", 0.0)),
                prefer_int8=bool(self.config.get("prefer_int8", False)),
                device=self.model.device)
        self._quality_bg = None
        self._phase_file = str(file_path) + ".asr_phase"

    def _decoder(self, transfer_dtype=None, chunk_transform=None):
        return BatchedChunkDecoder(self.model, max_batch=self.max_batch,
                                   transfer_dtype=transfer_dtype,
                                   model_b=self.model_b,
                                   chunk_transform=chunk_transform)

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
        # One request of utils/trace: each timing key below is the duration
        # of the span of its name (alignment: of both alignment spans).
        timing = {"transcription": 0.0, "punctuation": 0.0, "alignment": 0.0,
                  "quality": 0.0, "vad": 0.0, "preprocessing": 0.0}
        with trace.request(self.file_path) as req:
            try:
                return self._run(req.start_ns, timing)
            finally:
                try:
                    os.remove(self._phase_file)
                except OSError:
                    pass

    # -- resume checkpoints (opt-in via config enable_resume) --
    @property
    def _ckpt_path(self):
        return str(self.file_path) + ".asr_ckpt.json"

    def _load_checkpoint(self):
        if not self.config.get("enable_resume", False):
            return None
        try:
            with open(self._ckpt_path, "r", encoding="utf-8") as f:
                ck = json.load(f)
            if ck.get("version") == 1 and ck.get("stage") == "decoded":
                return ck
        except (OSError, ValueError):
            pass
        return None

    def _save_checkpoint(self, all_words, full_text, concat_len, vad_probs):
        if not self.config.get("enable_resume", False):
            return
        try:
            with open(self._ckpt_path, "w", encoding="utf-8") as f:
                json.dump({
                    "version": 1, "stage": "decoded",
                    "full_text": full_text,
                    "all_words": all_words,
                    "concat_len": concat_len,
                    "vad_probs": (np.asarray(vad_probs, np.float32)
                                  .round(4).tolist()
                                  if vad_probs is not None else None),
                }, f, ensure_ascii=False)
        except (OSError, TypeError):
            pass

    def _clear_checkpoint(self):
        try:
            os.remove(self._ckpt_path)
        except OSError:
            pass

    def _run(self, t0_ns, timing):
        self._emit("PHASE:LoadAudio|Loading audio|0")
        with trace.span("load_audio") as sp:
            audio = load_audio(self.file_path, SAMPLE_RATE,
                               progress_callback=self._emit)
        timing["load_audio"] = sp.seconds
        total_samples = len(audio)
        if self._cancelled():
            return None

        ckpt = self._load_checkpoint()
        if ckpt is not None:
            self._emit("PHASE:Transcription|Resuming from checkpoint|100")
            return self._finish(
                t0_ns, timing, audio, total_samples, ckpt["all_words"],
                ckpt["full_text"], audio[: ckpt.get("concat_len", total_samples)])

        # ---- VAD -> concat -> chunk plan ----
        with trace.span("vad") as sp_vad:
            vad_probs = None
            try:
                if self.config.get("bypass_vad", False):
                    raise RuntimeError("VAD_BYPASSED_BY_USER")
                prob_fn = self.vad_prob_fn or self._default_vad_prob_fn()
                self._emit("PHASE:VAD|Detecting speech|0")

                def cached_prob_fn(a):
                    nonlocal vad_probs
                    vad_probs = np.asarray(prob_fn(a))
                    return vad_probs

                segs = vad_mod.get_vad_segments(audio, cached_prob_fn,
                                                progress_callback=self._emit)
                self._emit(f"PHASE:VAD|Found {len(segs)} speech segments|100")
                if not self.config.get("skip_preprocessing", False):
                    try:
                        with trace.span("preprocessing") as sp:
                            audio = preprocess_audio(
                                audio, segs, SAMPLE_RATE,
                                enable_rms_normalize=self.config.get(
                                    "preprocess_rms_normalize", False),
                                progress_callback=self._emit)
                        timing["preprocessing"] = sp.seconds
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
        timing["vad"] = sp_vad.seconds
        if self._cancelled():
            return None

        # ---- Diarization overlapped with decode ----
        # Diarization needs only the audio: the facade starts its backend
        # now, so its superblocks interleave with decode batches on the card
        # and its host-side clustering rides the decode wait. _finish()
        # consumes the result.
        if (self._diarize() and self.config.get("diarize_overlap_decode", True)
                and isinstance(self.diarizer, SpeakerDiarizer)):
            self._emit("PHASE:Transcription|Transcribing "
                       "(diarization in background)|0")
            self.diarizer.start_background(audio)

        # ---- DNSMOS quality overlapped with decode ----
        # analyze_speech needs only the speech-only audio: a thread runs it
        # on its own CUDA stream while the decode's batches run on the
        # default one; _finish() waits for it.
        if (self.quality_analyzer is not None
                and self.config.get("quality_overlap_decode", True)):
            self._start_quality(concat_audio)

        with trace.span("plan"):
            silent = chunking.find_silent_regions(concat_audio)
            plan = chunking.plan_chunks(len(concat_audio), silent)

        # ---- Batched decode (shared fbank in ROVER mode) ----
        with trace.span("transcription") as sp:
            is_rover = self.model_b is not None
            label = "Transcribing (ROVER)" if is_rover else "Transcribing"
            self._emit(f"PHASE:Transcription|{label}|0")
            chunk_transform = None
            if self.config.get("preprocess_wpe", False):
                def chunk_transform(chunk):
                    try:
                        return adaptive_peak_limit(
                            apply_wpe_dereverberation(chunk))
                    except Exception:
                        return chunk
            # Lossless int16 upload for audio decoded from 16-bit PCM, unless a
            # float-valued chunk transform runs.
            transfer_dtype = self.config.get("decode_transfer_dtype")
            if (transfer_dtype is None and chunk_transform is None
                    and is_int16_exact(concat_audio)):
                transfer_dtype = "int16"
            decoder = self._decoder(transfer_dtype, chunk_transform)
            spans = [(s, e) for s, e, _ in plan]
            decoded = decoder.decode_spans(
                concat_audio, spans, progress_callback=self._emit,
                cancel_check=self.cancel_check)
            if is_rover:
                words_a_lists, words_b_lists = decoded
                hotword_phrases = self.config.get("hotword_phrases") or []
                chunk_words = []
                for wa, wb in zip(words_a_lists, words_b_lists):
                    for w in wa + wb:
                        w["start"] = vad_mod.map_concat_time(w["start"], offset_map)
                        w["end"] = vad_mod.map_concat_time(w["end"], offset_map)
                    merged, _ = rover_merge_words(wa, wb, hotword_phrases)
                    chunk_words.append(merged)
            else:
                chunk_words = decoded
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
        timing["transcription"] = sp.seconds
        if self._cancelled():
            return None

        # ---- Merge overlaps, suspects, fillers ----
        with trace.span("merge_suspect") as sp:
            with trace.span("merge"):
                all_words, full_text = merge_chunks_with_overlap(chunk_results)
            disagree = rebuild_disagree_indices(all_words) if is_rover else None
            with trace.span("suspect"):
                all_words = suspect_detect(all_words, audio,
                                           disagree_indices=disagree,
                                           vad_probs=vad_probs)
                all_words = remove_filler_words(all_words)
            full_text = " ".join(w["text"] for w in all_words)
            if full_text:
                full_text = full_text.capitalize()
        timing["merge_suspect"] = sp.seconds

        self._save_checkpoint(all_words, full_text, len(concat_audio),
                              vad_probs)
        return self._finish(t0_ns, timing, audio, total_samples, all_words,
                            full_text, concat_audio)

    def _start_quality(self, concat_audio):
        analyzer = self.quality_analyzer
        device = analyzer.device
        qbg = {"done": threading.Event()}
        ready = None
        if device.type == "cuda":  # all the caller enqueued so far: the weights' upload
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        record = trace.current()

        def worker():
            try:
                with trace.joined(record), trace.span("quality_overlapped") as sp:
                    try:
                        if ready is None:
                            qbg["result"] = analyzer.analyze_speech(concat_audio)
                        else:
                            stream = torch.cuda.Stream(device)
                            stream.wait_event(ready)
                            with torch.cuda.stream(stream):
                                qbg["result"] = analyzer.analyze_speech(concat_audio)
                            stream.synchronize()
                    except Exception as e:  # re-raised by _finish
                        qbg["error"] = e
                qbg["sec"] = sp.seconds
            finally:
                qbg["done"].set()

        qbg["thread"] = threading.Thread(target=worker, daemon=True,
                                         name="svt-quality-bg")
        self._quality_bg = qbg
        qbg["thread"].start()

    def _quality(self, concat_audio, timing):
        """quality_info: the background pass's result when it ran, else
        analyze_speech now; timing keys quality (what the stage cost the
        pipeline) and quality_overlapped (the background pass's own time)."""
        with trace.span("quality") as sp:
            qbg, self._quality_bg = self._quality_bg, None
            quality_info = None
            if qbg is not None:
                self._emit("PHASE:QualityAnalysis|Analyzing audio quality|0")
                qbg["done"].wait()
                if "error" in qbg:
                    raise qbg["error"]
                quality_info = qbg.get("result")
                self._emit("PHASE:QualityAnalysis|Done|100")
            if quality_info is None:
                self._emit("PHASE:QualityAnalysis|Analyzing audio quality|0")
                quality_info = self.quality_analyzer.analyze_speech(concat_audio)
                self._emit("PHASE:QualityAnalysis|Done|100")
        timing["quality"] = sp.seconds
        if qbg is not None:
            timing["quality_overlapped"] = qbg.get("sec", 0.0)
        return quality_info

    def _punctuate(self, full_text, all_words, word_speaker, timing):
        """(text, segments): the restored text and its sentences aligned
        to the words, split by speaker when diarized."""
        with trace.span("punctuation") as sp:
            self._emit("PHASE:Punctuation|Restoring punctuation|0")
            pause_hints = build_pause_hints(all_words, word_speaker=word_speaker)
            full_text = self.punct_restorer.restore(full_text, pause_hints=pause_hints)
        timing["punctuation"] = sp.seconds
        with trace.span("alignment") as sp:
            self._emit("PHASE:Align|Aligning timestamps|0")
            sentences = split_sentences(full_text)
            if word_speaker is not None:
                names = [dp.speaker_name(s) for s in word_speaker]
                segments = align_sentences_with_speakers(sentences, all_words,
                                                         word_speaker, names)
                segments = dp.smooth_speaker_boundary_fragments(segments)
            else:
                segments = align_sentences(sentences, all_words)
        timing["alignment"] = sp.seconds
        return full_text, segments

    def _diarize(self):
        return (self.config.get("speaker_diarization", False)
                and self.diarizer is not None)

    def _finish(self, t0_ns, timing, audio, total_samples, all_words, full_text,
                concat_audio):
        """Quality, speaker diarization, punctuation and alignment (or pause
        segmentation) and result assembly. Entered either from a live
        decode or from a resume checkpoint."""
        quality_info = None
        if self.quality_analyzer is not None:
            quality_info = self._quality(concat_audio, timing)
        raw_speaker_segments = None
        speaker_segments_raw = []
        overlap_segments = []
        word_speaker = None
        if self._diarize() and all_words:
            with trace.span("diarization") as sp:
                self._emit("PHASE:Diarization|Detecting speakers|0")

                def diar_progress(pct, total=100):
                    self._emit(f"PHASE:Diarization|Detecting speakers|{pct}")

                # The facade returns post-processed [Segment]; a raw backend
                # returns [{"start","end","speaker"}] that still needs the
                # post-processing (gap merge, NaturalTurn, fragment resolve).
                if isinstance(self.diarizer, SpeakerDiarizer):
                    raw_speaker_segments = self.diarizer.process(
                        audio, progress_callback=diar_progress, asr_words=all_words)
                else:
                    raw = self.diarizer.process(audio, progress_callback=diar_progress)
                    raw_speaker_segments = dp.post_process_diarization_segments(
                        [dp.Segment(s["start"], s["end"], s["speaker"]) for s in raw],
                        asr_words=all_words)
                speaker_segments_raw = [{
                    "speaker": dp.speaker_name(s.speaker),
                    "speaker_id": s.speaker,
                    "start": s.start, "end": s.end,
                    "duration": s.end - s.start,
                } for s in raw_speaker_segments]
                word_speaker = dp.speaker_labels_for_words(all_words,
                                                           raw_speaker_segments)
                self._emit("PHASE:Diarization|Done|100")
                if self.config.get("overlap_separation", False):
                    overlap_segments = self._run_overlap_separation(
                        audio, raw_speaker_segments, timing)
            timing["diarization"] = sp.seconds
        if self._cancelled():
            return None
        final_segments = []
        if (self.config.get("restore_punctuation", False)
                and not self.config.get("bypass_restorer", False)
                and self.punct_restorer is not None and full_text):
            full_text, final_segments = self._punctuate(full_text, all_words,
                                                        word_speaker, timing)
        with trace.span("alignment") as sp:
            if not final_segments:
                self._emit("PHASE:Align|Aligning timestamps|0")
                final_segments = segment_words_by_pause(all_words)
                if raw_speaker_segments is not None:
                    final_segments = dp.process_with_transcription(
                        final_segments, raw_speaker_segments)
                    final_segments = dp.smooth_speaker_boundary_fragments(final_segments)
            final_segments = fix_overlapping_segments(final_segments)
            final_segments = split_long_segments(final_segments, max_duration=12.0,
                                                 preserve_raw_words=True)
        timing["alignment"] += sp.seconds
        self._emit("PHASE:Align|Done|100")

        self._emit("PHASE:Complete|Done|100")
        total = (time.perf_counter_ns() - t0_ns) / 1e9
        word_probs = [w.get("prob") for w in all_words
                      if w.get("prob") is not None]
        device = self.model.device
        result = {
            "text": full_text,
            "segments": final_segments,
            "timing": {
                "transcription": timing["transcription"],
                "restoration": timing["punctuation"],
                "total": total,
                "upload_convert": 0.0,
                "transcription_detail": timing["transcription"],
                "sentence_segmentation": 0.0,
                "punctuation": timing["punctuation"],
                "alignment": timing["alignment"],
                "diarization": timing.get("diarization", 0.0),
                "quality": timing["quality"],
                "load_audio": timing.get("load_audio", 0.0),
                "vad": timing.get("vad", 0.0),
                "merge_suspect": timing.get("merge_suspect", 0.0),
                "quality_overlapped": timing.get("quality_overlapped", 0.0),
            },
            "paragraphs": [],
            "has_speaker_diarization": bool(speaker_segments_raw),
            "speaker_segments_raw": speaker_segments_raw,
            "duration_sec": total_samples / SAMPLE_RATE,
            "speaker_names": {},
            "asr_confidence": (float(np.mean(word_probs))
                               if word_probs else None),
            "quality_info": quality_info,
            "execution_provider": device.type,
            "stage_execution_providers": {},
            "asr_provider_info": {"backend": "torch", "device": str(device)},
            "overlap_segments": overlap_segments,
        }
        self._clear_checkpoint()
        return result

    def _run_overlap_separation(self, audio, raw_speaker_segments, timing):
        """Conv-TasNet separation of the diarizer's 2-speaker overlap
        regions and a re-decode of each stream with the first model (as the
        JAX pipeline's _run_overlap_separation). Returns the parallel
        segments of the result's overlap_segments."""
        overlap_regions = list(getattr(self.diarizer, "overlap_regions", None) or [])
        if not overlap_regions:
            return []
        with trace.span("overlap_separation") as sp:
            self._emit(f"PHASE:OverlapSep|Separating overlaps "
                       f"({len(overlap_regions)} regions)|0")
            from sherpa_vietnamese_asr_tpu_torch.pipeline.overlap import OverlapSeparator

            sep = (self.config.get("_overlap_separator")
                   or OverlapSeparator(device=self.model.device))
            seg_dicts = [{"start": s.start, "end": s.end, "speaker": s.speaker}
                         for s in raw_speaker_segments]
            results = sep.process(
                audio, seg_dicts, overlap_regions,
                progress_callback=lambda pct: self._emit(
                    f"PHASE:OverlapSep|Separating overlaps|{int(pct)}"))
            decoder = BatchedChunkDecoder(self.model, max_batch=self.max_batch)
            ov_segments = []
            for ri, reg in enumerate(results):
                self._emit(f"PHASE:OverlapSep|Re-ASR overlap "
                           f"{ri + 1}/{len(results)}|"
                           f"{int(50 + (ri + 1) / max(1, len(results)) * 40)}")
                for spk, spk_audio in reg["audio_per_speaker"].items():
                    real_s = reg["real_start_per_speaker"][spk]
                    real_e = reg["real_end_per_speaker"][spk]
                    words = decoder.decode_spans(spk_audio.astype(np.float32),
                                                 [(0, len(spk_audio))])[0]
                    shift = reg["start"] - real_s
                    kept = [dict(w, start=w["start"] + shift, end=w["end"] + shift)
                            for w in words
                            if real_s <= (w["start"] + w["end"]) / 2 <= real_e]
                    text = " ".join(w["text"] for w in kept if w.get("text")).strip()
                    if not text:
                        continue
                    ov_segments.append({
                        "speaker": f"Người nói {spk + 1}",
                        "speaker_id": int(spk),
                        "start": reg["start"], "end": reg["end"],
                        "text": text, "raw_words": kept, "overlap": True,
                    })
        timing["overlap_separation"] = sp.seconds
        self._emit(f"PHASE:OverlapSep|Done "
                   f"({len(ov_segments)} parallel segments)|100")
        return ov_segments

    def _default_vad_prob_fn(self):
        """Silero VAD on the model's device: the checkpoint from the asset
        registry when present, else a loudly flagged random-weight model."""
        from sherpa_vietnamese_asr_tpu_torch.models import assets, convert, silero_vad

        device = self.model.device
        with trace.span("vad_build"):
            loaded = assets.load_silero()
            if loaded is not None:
                state, cfg = loaded
                vad = convert.silero_from_numpy(state, cfg, device=device)
            else:
                assets.warn_random("Silero VAD")
                vad = silero_vad.random_silero_vad(device=device)

        def prob_fn(a):
            with trace.span("vad_probs"):
                return silero_vad.silero_vad_probs_streamed(vad, a).cpu().numpy()

        return prob_fn
