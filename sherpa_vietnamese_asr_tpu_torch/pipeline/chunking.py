# Copied from sherpa_vietnamese_asr_tpu/pipeline/chunking.py (host numpy; only the package path changes).
# Long-form chunk planning: silence detection, split-point search, 30 s/3 s
# overlap chunk plans over silence-stripped concat audio.
#
# Behavioral port of the reference planner (reference core/asr_engine.py:
# find_silent_regions :521, find_best_split_point :557, VAD-gap merge +
# boundary walk :2117-2204). On TPU the resulting chunks are padded and
# decoded as ONE batched program (pipeline/transcriber.py) instead of the
# reference's 2-thread worker pool.

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
OVERLAP_SEC = 3.0
OVERLAP_SAMPLES = int(OVERLAP_SEC * SAMPLE_RATE)
CHUNK_SEC = 30
MAX_VAD_GAP_SAMPLES = 5 * SAMPLE_RATE


def find_silent_regions(audio, sample_rate=SAMPLE_RATE, threshold=0.01,
                        min_silence_duration=0.3):
    """RMS-energy silence detection over 10 ms frames.

    Returns [(start_sample, end_sample)] regions at least
    min_silence_duration long. Mirrors reference core/asr_engine.py:521-556.
    """
    frame = int(sample_rate * 0.01)
    n = len(audio) // frame
    if n == 0:
        return []
    energies = np.sqrt(np.mean(
        audio[: n * frame].reshape(n, frame) ** 2, axis=1))
    silent = energies < threshold
    min_frames = int(min_silence_duration / 0.01)

    diff = np.diff(silent.astype(np.int8))
    starts = list(np.where(diff == 1)[0] + 1)
    ends = list(np.where(diff == -1)[0] + 1)
    if silent[0]:
        starts.insert(0, 0)
    if silent[-1]:
        ends.append(n)

    out = []
    for s, e in zip(starts, ends):
        if e - s >= min_frames:
            out.append((int(s) * frame, min(int(e) * frame, len(audio))))
    return out


def find_best_split_point(target, total, silent_regions,
                          search_window=2 * SAMPLE_RATE):
    """Pick the silent-region midpoint closest to target within the window."""
    lo = max(0, target - search_window)
    hi = min(total, target + search_window)
    best, best_d = target, float("inf")
    for s, e in silent_regions:
        if e >= lo and s <= hi:
            mid = (s + e) // 2
            d = abs(mid - target)
            if d < best_d:
                best, best_d = mid, d
    return best


def merge_vad_gaps(segments, max_gap=MAX_VAD_GAP_SAMPLES):
    """Merge VAD segments whose gap is <= max_gap (asr_engine.py:2117-2130)."""
    if len(segments) <= 1:
        return list(segments)
    merged = [segments[0]]
    for s, e in segments[1:]:
        if s - merged[-1][1] <= max_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def plan_chunks(total_samples, silent_regions, chunk_sec=CHUNK_SEC,
                overlap_samples=OVERLAP_SAMPLES):
    """Boundary walk -> [(actual_start, end, overlap_at_start)] in samples.

    Boundaries target chunk_sec spacing, snapped to nearby silence midpoints
    but never closer than 20 s to the previous boundary; every chunk after the
    first starts overlap_samples early (asr_engine.py:2141-2163).
    """
    seg = chunk_sec * SAMPLE_RATE
    boundaries = [0]
    pos = 0
    while pos + seg < total_samples:
        target = pos + seg
        split = find_best_split_point(target, total_samples, silent_regions)
        if split <= pos + 20 * SAMPLE_RATE:
            split = target
        boundaries.append(split)
        pos = split
    boundaries.append(total_samples)

    plan = []
    for i in range(len(boundaries) - 1):
        start, end = boundaries[i], boundaries[i + 1]
        if i == 0:
            plan.append((start, end, 0))
        else:
            actual = max(0, start - overlap_samples)
            plan.append((actual, end, start - actual))
    return plan


def chunk_long_segment(seg_start, seg_end, max_sec=30, overlap_sec=OVERLAP_SEC,
                       sample_rate=SAMPLE_RATE):
    """Split one long segment into equal chunks with pairwise overlap
    (asr_engine.py:581-614). Returns [(start, end, overlap_at_start)]."""
    import math

    duration = (seg_end - seg_start) / sample_rate
    if duration <= max_sec:
        return [(seg_start, seg_end, 0)]
    n = math.ceil(duration / max_sec)
    chunk_len = int(((duration + (n - 1) * overlap_sec) / n) * sample_rate)
    step = chunk_len - int(overlap_sec * sample_rate)
    chunks = []
    for i in range(n):
        start = seg_start + i * step
        end = min(start + chunk_len, seg_end)
        if i == n - 1:
            end = seg_end
        chunks.append((start, end, 0 if i == 0 else int(overlap_sec * sample_rate)))
    return chunks
