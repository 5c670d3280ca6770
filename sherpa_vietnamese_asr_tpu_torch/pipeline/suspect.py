# Copied from sherpa_vietnamese_asr_tpu/pipeline/suspect.py (host numpy; only the package path changes).
# Suspect-word detection, filler removal, and dual-model disagreement.
#
# Behavioral port of reference core/asr_engine.py:1584-1865:
#   * remove_filler_words — drop isolated Vietnamese filler tokens;
#   * compute_disagree_indices — SequenceMatcher alignment between the main
#     model's words and a second model's text;
#   * suspect_detect — flag words via "disagree OR (tsallis_max > 0.04 AND
#     margin_min < 0.6)" plus gap acoustics (energy peaks, energy range,
#     cached VAD max) between consecutive words.
# All host-side numpy/string logic; the entropy inputs are produced on-device
# by ops/beam_search.py in the same decoding pass.

from __future__ import annotations

from difflib import SequenceMatcher

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.pipeline.merge import normalize_word

FILLER_WORDS = {"à", "ờ", "ừ", "ơ", "uh", "um"}

TSALLIS_TH = 0.04
MARGIN_TH = 0.6
ENTROPY_TH = 0.10
GAP_MIN_MS = 200
GAP_VAD_TH = 0.90
GAP_ERANGE_TH = 0.04
GAP_LONG_MS = 500
GAP_PEAKS_TH = 3


def remove_filler_words(words):
    """Drop standalone filler words (asr_engine.py:1587-1609)."""
    return [w for w in words if w["text"].lower() not in FILLER_WORDS]


def count_energy_peaks(audio_segment, sr=16000, threshold_factor=1.0):
    """Syllable-peak count from a smoothed RMS energy envelope
    (asr_engine.py:1619-1647). Returns peak times in seconds."""
    from scipy.signal import find_peaks

    frame_len = int(sr * 0.010)
    hop = int(sr * 0.005)
    n = max(1, (len(audio_segment) - frame_len) // hop + 1)
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    idx = np.minimum(idx, len(audio_segment) - 1)
    energy = np.sqrt(np.mean(audio_segment[idx] ** 2, axis=1))

    kernel = np.hanning(7)
    kernel /= kernel.sum()
    smooth = np.convolve(energy, kernel, mode="same")
    non_sil = smooth[smooth > smooth.max() * 0.05]
    if non_sil.size == 0:
        return []
    threshold = non_sil.mean() * threshold_factor
    min_dist = int(90 / (hop / sr * 1000))
    peaks, _ = find_peaks(smooth, distance=min_dist, height=threshold,
                          prominence=threshold * 0.3)
    return (peaks * hop / sr).tolist()


def gap_energy_range(audio_segment, sr=16000):
    """Max-min frame RMS within a gap (asr_engine.py:1651-1678)."""
    if len(audio_segment) < 50:
        return 0.0
    frame_len = int(sr * 0.010)
    hop = int(sr * 0.005)
    n = max(1, (len(audio_segment) - frame_len) // hop + 1)
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    idx = np.minimum(idx, len(audio_segment) - 1)
    e = np.sqrt(np.mean(audio_segment[idx] ** 2, axis=1))
    return float(e.max() - e.min())


def compute_disagree_indices(words_main, words_other_text):
    """Indices in words_main where a second model disagrees
    (asr_engine.py:1683-1711)."""
    main = [normalize_word(w["text"]) for w in words_main]
    other = [normalize_word(w) for w in words_other_text]
    disagree = set()
    for tag, i1, i2, j1, j2 in SequenceMatcher(None, main, other).get_opcodes():
        if tag == "equal":
            continue
        disagree.update(range(i1, i2))
        if tag == "insert":
            if i1 > 0:
                disagree.add(i1 - 1)
            if i1 < len(main):
                disagree.add(i1)
    return disagree


def suspect_detect(all_words, audio, disagree_indices=None, vad_probs=None,
                   sr=16000):
    """Tag suspect words with '_suspect_level' = 'warning'.

    Signals (asr_engine.py:1711-1865): model disagreement; tsallis_max >
    0.04 AND margin_min < 0.6 (Shannon fallback > 0.10; tsallis-only > 0.12);
    gap acoustics between words (>=200 ms gap with VAD max >= 0.9, energy
    range >= 0.04, and either gap >= 500 ms or >= 3 energy peaks).
    """
    n = len(all_words)
    if n < 2:
        return all_words

    has_tsallis = any(w.get("tsallis_max") is not None for w in all_words)
    has_margin = any(w.get("margin_min") is not None for w in all_words)
    has_entropy = any(w.get("entropy_norm") is not None for w in all_words)
    has_disagree = bool(disagree_indices)

    flags = [False] * n
    for i, w in enumerate(all_words):
        if has_disagree and i in disagree_indices:
            flags[i] = True
            continue
        if has_tsallis:
            ts, mg = w.get("tsallis_max"), w.get("margin_min")
            if ts is not None and ts > TSALLIS_TH:
                if has_margin and mg is not None:
                    if mg < MARGIN_TH:
                        flags[i] = True
                elif ts > 0.12:
                    flags[i] = True
        elif has_entropy:
            ent = w.get("entropy_norm")
            if ent is not None and ent > ENTROPY_TH:
                flags[i] = True

    gap_suspects = set()
    for i in range(n - 1):
        wc, wn = all_words[i], all_words[i + 1]
        gap_ms = (wn["start"] - wc["end"]) * 1000
        if gap_ms < GAP_MIN_MS:
            continue
        gs, ge = int(wc["end"] * sr), int(wn["start"] * sr)
        if gs >= ge or gs < 0 or ge > len(audio):
            continue
        gap_audio = audio[gs:ge]
        if len(gap_audio) < 80:
            continue
        peaks = count_energy_peaks(gap_audio, sr)
        erange = gap_energy_range(gap_audio, sr)
        vad_max = 0.0
        if vad_probs is not None and len(vad_probs):
            w0 = max(0, min(gs // 512, len(vad_probs) - 1))
            w1 = max(w0 + 1, min(ge // 512, len(vad_probs)))
            seg = vad_probs[w0:w1]
            if len(seg):
                vad_max = float(np.max(seg))
        if (vad_max >= GAP_VAD_TH
                and (gap_ms >= GAP_LONG_MS or len(peaks) >= GAP_PEAKS_TH)
                and erange >= GAP_ERANGE_TH):
            gap_suspects.add(i)
            wc["gap_after_ms"] = int(gap_ms)
            wn["gap_before_ms"] = int(gap_ms)

    for i in range(n):
        if flags[i]:
            all_words[i]["_suspect_level"] = "warning"
        elif i in gap_suspects or (i > 0 and i - 1 in gap_suspects):
            all_words[i]["_suspect_level"] = "warning"
    return all_words
