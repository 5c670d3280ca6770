# Diarization facade: backend registry/dispatch and the high-level
# run_diarization orchestration.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/diarization.py (the registry,
# SpeakerDiarizer over the PureDiarizer and Senko CAM++ backends with its
# background pass, diarize_and_remap and run_diarization), with one
# difference: a failed background pass is re-run synchronously once, as in
# the JAX package, but a failure of that run raises instead of being
# retried again or swallowed. The background thread sets the backend's CUDA
# device before its first launch.

from __future__ import annotations

import time

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_post import (
    Segment,
    post_process_diarization_segments,
    process_with_transcription,
    speaker_name,
)

SPEAKER_EMBEDDING_MODELS = {
    "community1_pure_ort": {
        "name": "Pyannote Community-1 (ResNet34-LM + PLDA + VBx)",
        "backend": "pure",
        "size": "~32 MB",
        "language": "Multilingual",
        "accuracy": "Excellent",
        "sample_rate": 16000,
        "description": "Community-1 replica: ResNet34-LM + PLDA + VBx, "
                       "batched model stages on the card",
    },
    "pure_ort": {  # alias used by pipeline config defaults
        "name": "Pyannote Community-1 (alias)",
        "backend": "pure",
        "sample_rate": 16000,
    },
    "senko_campp": {
        "name": "Senko CAM++",
        "backend": "senko",
        "size": "~27 MB",
        "language": "Multilingual (ZH+EN)",
        "accuracy": "Good",
        "sample_rate": 16000,
        "has_threshold": False,
        "description": "Senko pipeline — CAM++ 192-dim + pyannote VAD + "
                       "spectral clustering + mer_cos merge",
    },
    "senko_campp_optimized": {
        "name": "Senko CAM++ (Optimized)",
        "backend": "senko",
        "sample_rate": 16000,
        "has_threshold": False,
        "description": "Batched CAM++ + fbank-once windows + VAD step 5 s "
                       "(the only Senko variant here: batching is native)",
    },
}


def get_available_models():
    return dict(SPEAKER_EMBEDDING_MODELS)


def get_default_threshold(model_id):
    return 0.6


class SpeakerDiarizer:
    """Backend dispatch + shared post-processing."""

    def __init__(self, embedding_model_id="community1_pure_ort",
                 num_clusters=-1, num_threads=6, threshold=0.6,
                 backend_kwargs=None):
        self.model_id = embedding_model_id
        self.num_clusters = num_clusters
        self.threshold = threshold
        self.backend_kwargs = backend_kwargs or {}
        self._backend = None
        self._bg = None

    def initialize(self):
        info = SPEAKER_EMBEDDING_MODELS.get(self.model_id,
                                            SPEAKER_EMBEDDING_MODELS[
                                                "community1_pure_ort"])
        if info.get("backend") == "senko":
            from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import (
                SenkoCamppDiarizer,
            )
            self._backend = SenkoCamppDiarizer(
                num_speakers=self.num_clusters, **self.backend_kwargs)
        else:
            from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import (
                PureDiarizer,
            )
            self._backend = PureDiarizer(
                num_speakers=self.num_clusters, threshold=self.threshold,
                **self.backend_kwargs)
        return self

    @property
    def overlap_regions(self):
        return getattr(self._backend, "overlap_regions", [])

    def start_background(self, audio):
        """Kick off the transcript-independent backend pass in a thread.

        Diarization needs only audio (reference asr_engine.py:2606 runs it
        strictly after decode; here it OVERLAPS the decode phase: the
        superblocks are enqueued on the card between decode batches while
        the host-side clustering/VBx work rides the decode wait). The next
        process() call consumes the result; word-dependent post-processing
        still happens there, after ASR words exist."""
        import threading

        import torch

        if self._backend is None:
            self.initialize()
        bg = {"done": threading.Event()}
        device = self._backend.device

        def worker():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                bg["raw"] = self._backend.process(audio,
                                                  progress_callback=None)
            except Exception as e:  # surfaced (or retried) in process()
                bg["err"] = e
            finally:
                bg["done"].set()

        bg["thread"] = threading.Thread(target=worker, daemon=True,
                                        name="svt-diarize-bg")
        self._bg = bg
        bg["thread"].start()

    def process(self, audio, progress_callback=None, asr_words=None):
        """Run the backend and post-process. Returns [Segment].

        If start_background() ran, its result is consumed instead of
        recomputing; a failed background pass is re-run once synchronously,
        and a failure of that run raises."""
        if self._backend is None:
            self.initialize()
        raw = None
        if self._bg is not None:
            bg, self._bg = self._bg, None
            bg["done"].wait()
            raw = bg.get("raw")
        if raw is None:
            raw = self._backend.process(audio,
                                        progress_callback=progress_callback)
        segments = [Segment(s["start"], s["end"], s["speaker"]) for s in raw]
        return post_process_diarization_segments(segments,
                                                 asr_words=asr_words)

    def unload(self):
        self._backend = None


def diarize_and_remap(segments, raw_segments):
    """Word-level speaker assignment over ALL raw_words, remapped onto the
    pre-split sentences (reference _diarize_and_remap :1592-1631)."""
    all_words = []
    for seg in segments:
        all_words.extend(seg.get("raw_words", []))
    if not all_words:
        return process_with_transcription(segments, raw_segments)
    all_words.sort(key=lambda w: w.get("start", 0))
    one = [{
        "text": " ".join(w.get("text", "") for w in all_words),
        "start": all_words[0].get("start", 0),
        "end": all_words[-1].get("end", 0),
        "raw_words": all_words,
    }]
    diar_results = process_with_transcription(one, raw_segments)
    if len(segments) <= 1:
        return diar_results

    word_speaker = {}
    for dseg in diar_results:
        spk = (dseg.get("speaker"), dseg.get("speaker_id"))
        for w in dseg.get("raw_words", []):
            word_speaker[id(w)] = spk

    # Remap per original sentence: majority speaker of its words, splitting
    # when a sentence spans speakers.
    out = []
    for seg in segments:
        rws = seg.get("raw_words", [])
        if not rws:
            out.append(dict(seg))
            continue
        groups = []
        cur_spk, cur = None, []
        for w in rws:
            spk = word_speaker.get(id(w), (speaker_name(0), 0))
            if spk != cur_spk:
                if cur:
                    groups.append((cur_spk, cur))
                cur_spk, cur = spk, [w]
            else:
                cur.append(w)
        if cur:
            groups.append((cur_spk, cur))
        if len(groups) == 1:
            item = dict(seg)
            item["speaker"], item["speaker_id"] = groups[0][0]
            out.append(item)
        else:
            words_text = seg.get("text", "").split()
            total = len(rws)
            pi = 0
            for gi, ((name, sid), gwords) in enumerate(groups):
                if gi == len(groups) - 1:
                    g_text = " ".join(words_text[pi:])
                else:
                    num = int(round(len(gwords) / total * len(words_text)))
                    num = max(num, 1) if pi < len(words_text) else 0
                    g_text = " ".join(words_text[pi: pi + num])
                    pi += num
                if not g_text.strip():
                    continue
                out.append({**seg, "text": g_text,
                            "start": gwords[0].get("start", seg.get("start")),
                            "end": gwords[-1].get("end", seg.get("end")),
                            "speaker": name, "speaker_id": sid,
                            "raw_words": gwords})
    return out


def run_diarization(audio, segments, speaker_model_id="community1_pure_ort",
                    num_speakers=0, num_threads=6, threshold=0.6,
                    progress_callback=None, cancel_check=None,
                    backend_kwargs=None):
    """High-level orchestration (reference :1634-1777).

    Args:
        audio: float32 waveform @16 kHz (the reference takes a path; decode
            is the caller's job here).
        segments: transcribed segments with raw_words.

    Returns (speaker_segments_raw, elapsed_sec, result_segments).
    """
    emit = progress_callback or (lambda m: None)
    start = time.time()
    all_words = []
    for seg in segments or []:
        all_words.extend(seg.get("raw_words", []) or [])

    emit("PHASE:Diarization|Initializing model|0")
    diarizer = SpeakerDiarizer(
        embedding_model_id=speaker_model_id,
        num_clusters=-1 if num_speakers <= 0 else num_speakers,
        num_threads=num_threads, threshold=threshold,
        backend_kwargs=backend_kwargs).initialize()

    def backend_progress(pct, total=100):
        emit(f"PHASE:Diarization|Detecting speakers|{int(pct)}")

    raw_segments = diarizer.process(np.asarray(audio, np.float32),
                                    progress_callback=backend_progress,
                                    asr_words=all_words or None)
    speaker_segments_raw = [{
        "speaker": speaker_name(s.speaker), "speaker_id": s.speaker,
        "start": s.start, "end": s.end, "duration": s.duration,
    } for s in raw_segments]
    emit("PHASE:Diarization|Assigning speakers|90")
    results = diarize_and_remap(segments, raw_segments)
    diarizer.unload()
    emit("PHASE:Diarization|Done|100")
    return speaker_segments_raw, time.time() - start, results
