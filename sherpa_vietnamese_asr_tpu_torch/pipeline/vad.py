# Copied from sherpa_vietnamese_asr_tpu/pipeline/vad.py (host numpy; only the package path changes).
# VAD segmentation: speech-probability post-processing and segment extraction.
#
# Behavioral port of the reference's VAD stage (reference core/vad_utils.py):
#   * probs -> segments state machine with min-silence / min-speech rules
#     (vad_utils.py:120-156)
#   * get_vad_segments pipeline: auto-boost quiet audio to -23 dBFS, retry at
#     threshold 0.3, full-audio fallback, padding, merge-close-segments
#     (vad_utils.py:158-260)
# The model inference itself is TPU-batched (models/silero_vad.py); this module
# is host-side interval logic operating on the returned probability array.

from __future__ import annotations

import numpy as np

WINDOW_SIZE = 512
_VAD_BOOST_TARGET = 0.071  # -23 dBFS (vad_utils.py:202)


def probs_to_segments(probs, sample_rate=16000, threshold=0.5,
                      min_silence_ms=300, min_speech_ms=250):
    """Speech probabilities -> [(start_window, end_window)].

    Mirrors the reference state machine (core/vad_utils.py:120-156): a segment
    ends only after min_silence_ms below threshold; segments shorter than
    min_speech_ms are dropped; the trailing open segment is closed at the end.
    """
    probs = np.asarray(probs)
    if probs.size == 0:
        return []
    min_silence_w = int(min_silence_ms * sample_rate / 1000 / WINDOW_SIZE)
    min_speech_w = int(min_speech_ms * sample_rate / 1000 / WINDOW_SIZE)

    segments = []
    is_speech = False
    start = 0
    silence = 0
    for i, p in enumerate(probs):
        if p >= threshold:
            if not is_speech:
                start = i
                is_speech = True
            silence = 0
        elif is_speech:
            silence += 1
            if silence >= min_silence_w:
                end = i - silence + 1
                if end - start >= min_speech_w:
                    segments.append((start, end))
                is_speech = False
                silence = 0
    if is_speech:
        end = len(probs)
        if end - start >= min_speech_w:
            segments.append((start, end))
    return segments


def get_vad_segments(audio, prob_fn, sample_rate=16000, threshold=0.2,
                     min_silence_ms=100, min_speech_ms=250, padding_ms=1000,
                     merge_gap_ms=250, auto_boost=True, fallback_full=True,
                     progress_callback=None):
    """Full VAD stage: returns [(start_sample, end_sample)] speech regions.

    Args:
        audio: float32 [L] waveform.
        prob_fn: callable(audio_float32) -> per-window probabilities; the
            TPU model (models/silero_vad.py) or any substitute in tests.

    Mirrors reference core/vad_utils.py:158-260 (boost copy for VAD only,
    retry with threshold 0.3 / relaxed min_speech, full-audio fallback,
    padding, merge of close segments).
    """
    total = len(audio)
    if total < WINDOW_SIZE:
        return [(0, total)] if fallback_full else []

    audio_for_vad = audio
    if auto_boost:
        peak = float(np.max(np.abs(audio)))
        if 1e-6 < peak < _VAD_BOOST_TARGET:
            audio_for_vad = (audio * (_VAD_BOOST_TARGET / peak)).astype(np.float32)

    if progress_callback:
        progress_callback("PHASE:VAD|Analyzing audio|0")
    probs = np.asarray(prob_fn(audio_for_vad))
    segments = probs_to_segments(probs, sample_rate, threshold,
                                 min_silence_ms, min_speech_ms)
    if not segments:
        if progress_callback:
            progress_callback("PHASE:VAD|Retrying with lower threshold|95")
        segments = probs_to_segments(probs, sample_rate, threshold=0.3,
                                     min_silence_ms=100, min_speech_ms=150)
    if not segments:
        return [(0, total)] if fallback_full else []

    pad = int(padding_ms * sample_rate / 1000)
    result = [(max(0, s * WINDOW_SIZE - pad),
               min(total, e * WINDOW_SIZE + pad)) for s, e in segments]

    if merge_gap_ms > 0 and len(result) > 1:
        gap = int(merge_gap_ms * sample_rate / 1000)
        merged = [result[0]]
        for s, e in result[1:]:
            if s - merged[-1][1] < gap:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        result = merged
    return result


def concat_speech(audio, segments):
    """Concatenate speech segments, dropping silence.

    Returns (concat_audio, offset_map) where offset_map is a list of
    (concat_start_sample, original_start_sample, length) used to map
    timestamps back (reference core/asr_engine.py:617-675).
    """
    parts, offset_map, pos = [], [], 0
    for s, e in segments:
        offset_map.append((pos, s, e - s))
        parts.append(audio[s:e])
        pos += e - s
    if not parts:
        return audio.copy(), [(0, 0, len(audio))]
    return np.concatenate(parts), offset_map


def map_concat_time(concat_time, offset_map, sample_rate=16000):
    """Concat-space seconds -> original-audio seconds (asr_engine.py:646-675)."""
    sample = int(concat_time * sample_rate)
    for cstart, ostart, length in offset_map:
        if cstart <= sample < cstart + length:
            return (ostart + (sample - cstart)) / sample_rate
    if offset_map:
        if sample < offset_map[0][0]:
            return offset_map[0][1] / sample_rate
        last = offset_map[-1]
        return (last[1] + last[2]) / sample_rate
    return concat_time
