"""Host rules of the transcription pipeline, frozen: how a request's file
becomes speech segments, chunk spans and decoder rows, and how a live
stream's audio becomes step windows. Numpy only.

The rules follow the reference application's transcriber (audio load with
the quiet-audio boost; VAD post-processing with -23 dBFS boost, retry at
0.3, 1 s padding and 250 ms merge; peak limit; VAD gaps of 5 s or less
merged; 30 s / 3 s chunk plan snapped to silences; snip_edges=False fbank
frames), as the PyTorch port implements them.
"""

from __future__ import annotations

import wave

import numpy as np

SAMPLE_RATE = 16000
VAD_WINDOW = 512
VAD_BOOST_TARGET = 0.071
OVERLAP_SAMPLES = 3 * SAMPLE_RATE
CHUNK_SAMPLES = 30 * SAMPLE_RATE
MAX_VAD_GAP = 5 * SAMPLE_RATE


def read_request_audio(path) -> np.ndarray:
    """A mono 16-bit 16 kHz WAV as float32 k / 32768, boosted to a 0.95
    peak when its peak is under 0.5 (the pipeline's load rule)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1 or w.getframerate() != SAMPLE_RATE:
            raise ValueError(f"{path}: expected mono 16-bit {SAMPLE_RATE} Hz PCM")
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    audio = pcm.astype(np.float32) / np.float32(32768.0)
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if 0.0 < peak < 0.5:
        audio = audio / peak * 0.95
    return np.ascontiguousarray(audio, np.float32)


def vad_input(audio: np.ndarray) -> np.ndarray:
    """What the VAD model sees: quiet audio boosted to -23 dBFS."""
    peak = float(np.max(np.abs(audio)))
    if 1e-6 < peak < VAD_BOOST_TARGET:
        return (audio * (VAD_BOOST_TARGET / peak)).astype(np.float32)
    return audio


def probs_to_segments(probs, threshold, min_silence_ms, min_speech_ms):
    probs = np.asarray(probs)
    min_silence_w = int(min_silence_ms * SAMPLE_RATE / 1000 / VAD_WINDOW)
    min_speech_w = int(min_speech_ms * SAMPLE_RATE / 1000 / VAD_WINDOW)
    segments, is_speech, start, silence = [], False, 0, 0
    for i, p in enumerate(probs):
        if p >= threshold:
            if not is_speech:
                start, is_speech = i, True
            silence = 0
        elif is_speech:
            silence += 1
            if silence >= min_silence_w:
                end = i - silence + 1
                if end - start >= min_speech_w:
                    segments.append((start, end))
                is_speech, silence = False, 0
    if is_speech and len(probs) - start >= min_speech_w:
        segments.append((start, len(probs)))
    return segments


def speech_segments(total, probs):
    """[(start, end)] sample spans of speech from the window probabilities."""
    if total < VAD_WINDOW:
        return [(0, total)]
    segments = probs_to_segments(probs, 0.2, 100, 250)
    if not segments:
        segments = probs_to_segments(probs, 0.3, 100, 150)
    if not segments:
        return [(0, total)]
    pad = SAMPLE_RATE  # 1000 ms
    spans = [(max(0, s * VAD_WINDOW - pad), min(total, e * VAD_WINDOW + pad))
             for s, e in segments]
    gap = SAMPLE_RATE // 4  # 250 ms
    merged = [spans[0]]
    for s, e in spans[1:]:
        if s - merged[-1][1] < gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def peak_limit(audio, target=0.95):
    peak = float(np.max(np.abs(audio))) if len(audio) else 0.0
    return audio * (target / peak) if peak > target else audio


def merge_gaps(segments, max_gap=MAX_VAD_GAP):
    if len(segments) <= 1:
        return list(segments)
    merged = [segments[0]]
    for s, e in segments[1:]:
        if s - merged[-1][1] <= max_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def concat(audio, segments):
    if not segments:
        return audio.copy()
    return np.concatenate([audio[s:e] for s, e in segments])


def silent_regions(audio, threshold=0.01, min_sec=0.3):
    frame = SAMPLE_RATE // 100
    n = len(audio) // frame
    if n == 0:
        return []
    rms = np.sqrt(np.mean(audio[: n * frame].reshape(n, frame) ** 2, axis=1))
    silent = rms < threshold
    d = np.diff(silent.astype(np.int8))
    starts = list(np.where(d == 1)[0] + 1)
    ends = list(np.where(d == -1)[0] + 1)
    if silent[0]:
        starts.insert(0, 0)
    if silent[-1]:
        ends.append(n)
    min_frames = int(min_sec / 0.01)
    return [(int(s) * frame, min(int(e) * frame, len(audio)))
            for s, e in zip(starts, ends) if e - s >= min_frames]


def chunk_spans(total, silences):
    """[(start, end)] of the 30 s / 3 s plan, boundaries snapped to the
    closest silence midpoint within 2 s, never within 20 s of the last."""
    bounds, pos = [0], 0
    while pos + CHUNK_SAMPLES < total:
        target = pos + CHUNK_SAMPLES
        lo, hi = max(0, target - 2 * SAMPLE_RATE), min(total, target + 2 * SAMPLE_RATE)
        best, best_d = target, float("inf")
        for s, e in silences:
            if e >= lo and s <= hi:
                mid = (s + e) // 2
                if abs(mid - target) < best_d:
                    best, best_d = mid, abs(mid - target)
        if best <= pos + 20 * SAMPLE_RATE:
            best = target
        bounds.append(best)
        pos = best
    bounds.append(total)
    return [(bounds[0], bounds[1])] + [
        (max(0, s - OVERLAP_SAMPLES), e) for s, e in zip(bounds[1:-1], bounds[2:])]


def request_plan(audio, probs):
    """(concat audio, chunk spans) of one request from its audio and VAD
    probabilities."""
    segs = speech_segments(len(audio), probs)
    cleaned = peak_limit(audio)
    speech = concat(cleaned, merge_gaps(segs))
    return speech, chunk_spans(len(speech), silent_regions(speech))


def fbank_frames(n_samples):
    """snip_edges=False frame count of n samples (10 ms shift)."""
    return (n_samples + 80) // 160


class StreamWindows:
    """A live stream's step windows, by the web service's slot rule: 68
    fbank frames a window, 64 consumed a step starting at frame f0, the
    buffer trimmed to keep 400 samples before the cursor."""

    CHUNK_FRAMES = 64
    WINDOW = (3 + 64 - 1) * 160 + 280  # samples of a window at f0 = 3

    def __init__(self):
        self.base = 0    # global sample of the buffer's start
        self.cursor = 0  # fbank frame of the next step in the buffer

    def ready_at(self) -> int:
        """Samples the stream must have received for the next step."""
        return self.base + 160 * (self.cursor + self.CHUNK_FRAMES) + 280

    def take(self, audio):
        """(window [WINDOW] float32, f0) of the next step; advances."""
        win = np.zeros(self.WINDOW, np.float32)
        piece = audio[self.base: self.base + self.WINDOW]
        win[: len(piece)] = piece
        f0 = self.cursor
        self.cursor += self.CHUNK_FRAMES
        keep_from = max(0, self.cursor * 160 - 400)
        self.base += keep_from
        self.cursor -= keep_from // 160
        return win, f0
