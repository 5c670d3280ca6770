# Copied from sherpa_vietnamese_asr_tpu/pipeline/preprocessing.py (host numpy; only the package path changes).
# Audio preprocessing: per-segment RMS normalization, WPE dereverberation,
# adaptive peak limiting.
#
# Behavioral port of reference core/audio_preprocessing.py:
#   * per_segment_rms_normalize (:46-140): per-VAD-segment gain toward the
#     median segment RMS, clamped to +-20 dB, with 5 ms crossfades;
#   * WPE dereverberation (:157-216): single-channel weighted prediction
#     error, fft 512 / hop 128 / taps 10 / delay 3 / 3 iterations, applied
#     per <=30 s chunk. The reference calls nara-wpe; this is a first-party
#     numpy implementation of the same delayed-linear-prediction algorithm;
#   * adaptive_peak_limit (:226-246) and the preprocess_audio entry (:250).

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def compute_segment_rms(audio_segment):
    if len(audio_segment) == 0:
        return 0.0
    return float(np.sqrt(np.mean(audio_segment ** 2)))


def per_segment_rms_normalize(audio, vad_segments, sample_rate=16000,
                              min_segment_ms=100, max_gain_db=20.0,
                              crossfade_ms=5):
    """Scale each VAD segment toward the median segment RMS."""
    if len(vad_segments) == 0:
        return audio
    min_samples = int(min_segment_ms * sample_rate / 1000)
    max_gain = 10 ** (max_gain_db / 20.0)
    xfade = int(crossfade_ms * sample_rate / 1000)

    seg_rms = []
    for s, e in vad_segments:
        if e - s < min_samples:
            continue
        rms = compute_segment_rms(audio[s:e])
        if rms > 1e-8:
            seg_rms.append((s, e, rms))
    if not seg_rms:
        return audio
    target = float(np.median([r for _, _, r in seg_rms]))
    if target < 1e-8:
        return audio

    gain_map = np.ones(len(audio), np.float32)
    for s, e, rms in seg_rms:
        gain = np.clip(target / rms, 1.0 / max_gain, max_gain)
        gain_map[s:e] = gain

    if xfade > 0:
        for s, e, _ in seg_rms:
            fade_len = min(xfade, (e - s) // 4)
            if fade_len > 0 and s > 0:
                gain_map[s: s + fade_len] = np.linspace(
                    gain_map[max(0, s - 1)], gain_map[s], fade_len,
                    dtype=np.float32)
            if fade_len > 0 and e < len(audio):
                gain_map[e - fade_len: e] = np.linspace(
                    gain_map[e - 1], gain_map[min(len(audio) - 1, e)],
                    fade_len, dtype=np.float32)
    return audio * gain_map


def _stft(x, size=512, shift=128):
    n = 1 + max(0, (len(x) - size)) // shift
    idx = np.arange(n)[:, None] * shift + np.arange(size)[None, :]
    win = np.blackman(size + 1)[:-1].astype(np.float64)
    frames = x[np.minimum(idx, len(x) - 1)] * win
    return np.fft.rfft(frames, axis=-1)  # [T, F]


def _istft(spec, size=512, shift=128, length=None):
    frames = np.fft.irfft(spec, n=size, axis=-1)
    win = np.blackman(size + 1)[:-1].astype(np.float64)
    t = spec.shape[0]
    out_len = (t - 1) * shift + size
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    for i in range(t):
        out[i * shift: i * shift + size] += frames[i] * win
        norm[i * shift: i * shift + size] += win ** 2
    # Relative floor: edge samples where the synthesis window vanishes must
    # not be amplified (modified spectra are not self-consistent there).
    out = out / np.maximum(norm, 1e-2 * norm.max() + 1e-12)
    if length is not None:
        out = out[:length] if len(out) >= length else np.pad(
            out, (0, length - len(out)))
    return out


def apply_wpe_dereverberation(audio, sample_rate=16000, fft_size=512,
                              hop_size=128, taps=10, delay=3, iterations=3):
    """Single-channel WPE: iteratively estimate a delayed linear-prediction
    filter per frequency bin and subtract predicted late reverberation."""
    audio = np.asarray(audio, np.float64)
    if len(audio) < fft_size * 2:
        return audio.astype(np.float32)
    spec = _stft(audio, fft_size, hop_size).T  # [F, T]
    f, t = spec.shape
    if t <= taps + delay + 1:
        return audio.astype(np.float32)

    # Build delayed tap stack: X_tilde[f, k, t] = X[f, t - delay - k]
    x_tilde = np.zeros((f, taps, t), np.complex128)
    for k in range(taps):
        shift_k = delay + k
        x_tilde[:, k, shift_k:] = spec[:, : t - shift_k]

    y = spec.copy()
    for _ in range(iterations):
        p2 = np.abs(y) ** 2  # [F, T]
        # Relative power floor (nara-wpe get_power_inverse behavior):
        # silent frames must not get unbounded weights.
        lam = np.maximum(p2, 1e-2 * p2.mean(axis=-1, keepdims=True) + 1e-12)
        xw = x_tilde / lam[:, None, :]
        r = np.einsum("fkt,flt->fkl", xw, x_tilde.conj())
        p = np.einsum("fkt,ft->fk", xw, spec.conj())
        trace = np.einsum("fkk->f", r.real) / taps
        r += (1e-6 * trace[:, None, None] + 1e-12) * np.eye(taps)[None]
        g = np.linalg.solve(r, p[..., None])[..., 0]  # [F, taps]
        y = spec - np.einsum("fk,fkt->ft", g.conj(), x_tilde)

    out = _istft(y.T, fft_size, hop_size, length=len(audio))
    return out.astype(np.float32)


def adaptive_peak_limit(audio, target_peak=0.95):
    peak = float(np.max(np.abs(audio))) if len(audio) else 0.0
    if peak > target_peak:
        audio = audio * (target_peak / peak)
    return audio


def preprocess_audio(audio, vad_segments, sample_rate=16000,
                     enable_rms_normalize=True, progress_callback=None):
    """RMS normalize (per segment) then peak limit; WPE is applied per chunk
    by the decoder when enabled."""
    result = audio.copy()
    if enable_rms_normalize and len(vad_segments) > 0:
        if progress_callback:
            progress_callback("PHASE:Preprocess|Normalizing loudness|50")
        result = per_segment_rms_normalize(result, vad_segments, sample_rate)
    result = adaptive_peak_limit(result)
    if progress_callback:
        progress_callback("PHASE:Preprocess|Done|100")
    return result
