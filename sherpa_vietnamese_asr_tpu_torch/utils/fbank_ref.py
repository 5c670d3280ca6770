# Copied from sherpa_vietnamese_asr_tpu/utils/fbank_ref.py (host numpy; only the package path changes).
# Kaldi-compatible log-mel filterbank — numpy reference implementation.
#
# This is the numeric ORACLE for the TPU fbank kernels in ops/fbank.py.
# It mirrors kaldi-native-fbank (knf) exactly for the three configurations the
# reference app uses (see the reference app's docs):
#   * ASR config        — reference core/asr_engine.py:698-721 (Povey window,
#     snip_edges=False, low=20, high=7600, no scaling, no CMVN)
#   * ResNet-emb config — reference core/speaker_diarization_pure_ort.py:271-304
#     (Hamming window, snip_edges=True, high=Nyquist, x32768 scale, CMVN)
#   * CAM++ config      — reference core/speaker_diarization_senko_campp_optimized.py:35-61
#     (Povey window, snip_edges=True, high=Nyquist, x32768 scale, CMVN,
#      mel floor 1.0 before log)
#
# The snip_edges=False reflection framing follows the validated browser port
# (reference offline_pwa/static/js/pure-ort-asr-worker.js:461-520) which the
# reference project ships as a second algorithm spec for this stage.

from __future__ import annotations

import dataclasses

import numpy as np

FLT_EPSILON = float(np.finfo(np.float32).eps)  # 1.1920928955078125e-07


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Parameters of the Kaldi fbank pipeline (dither is always 0)."""

    sample_rate: int = 16000
    frame_length: int = 400   # 25 ms
    frame_shift: int = 160    # 10 ms
    n_fft: int = 512
    num_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 7600.0  # <= 0 means Nyquist + high_freq
    window: str = "povey"      # "povey" | "hamming" | "hann"
    snip_edges: bool = False
    preemph: float = 0.97
    remove_dc: bool = True
    input_scale: float = 1.0   # 32768.0 for WeSpeaker-style models
    cmvn: bool = False         # per-utterance mean subtraction
    log_floor: float = FLT_EPSILON  # floor on mel energies before log


# The three configurations used by the reference application.
ASR_FBANK = FbankConfig(snip_edges=False, high_freq=7600.0)
RESNET_EMB_FBANK = FbankConfig(
    snip_edges=True, window="hamming", high_freq=0.0,
    input_scale=32768.0, cmvn=True,
)
CAMPP_FBANK = FbankConfig(
    snip_edges=True, window="povey", high_freq=0.0,
    input_scale=32768.0, cmvn=True, log_floor=1.0,
)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def kaldi_mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Kaldi-exact triangular mel filterbank matrix, shape (num_bins, n_fft//2+1).

    Weights are triangular in the MEL domain (not Hz), matching
    kaldi/src/feat/mel-computations.cc. The Nyquist column is always zero.
    """
    high_freq = cfg.high_freq
    nyquist = 0.5 * cfg.sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    low_mel = mel_scale(cfg.low_freq)
    high_mel = mel_scale(high_freq)
    mel_delta = (high_mel - low_mel) / (cfg.num_bins + 1)

    n_bins_fft = cfg.n_fft // 2  # Kaldi excludes the Nyquist bin
    fft_freqs = np.arange(n_bins_fft, dtype=np.float64) * (cfg.sample_rate / cfg.n_fft)
    fft_mels = mel_scale(fft_freqs)  # (n_bins_fft,)

    bins = np.arange(cfg.num_bins, dtype=np.float64)
    left = low_mel + bins * mel_delta          # (num_bins,)
    center = left + mel_delta
    right = center + mel_delta

    m = fft_mels[None, :]  # (1, n_bins_fft)
    up = (m - left[:, None]) / mel_delta
    down = (right[:, None] - m) / mel_delta
    weights = np.where((m > left[:, None]) & (m < right[:, None]),
                       np.minimum(up, down), 0.0)
    out = np.zeros((cfg.num_bins, cfg.n_fft // 2 + 1), dtype=np.float32)
    out[:, :n_bins_fft] = weights.astype(np.float32)
    return out


def feature_window(cfg: FbankConfig) -> np.ndarray:
    """Kaldi feature window function (float32)."""
    n = cfg.frame_length
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window == "povey":
        w = np.power(0.5 - 0.5 * np.cos(a * i), 0.85)
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window == "hann":
        w = 0.5 - 0.5 * np.cos(a * i)
    else:
        raise ValueError(f"unknown window {cfg.window!r}")
    return w.astype(np.float32)


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.frame_length:
            return 0
        return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift
    return int((num_samples + cfg.frame_shift // 2) // cfg.frame_shift)


def frame_start_indices(n_frames: int, cfg: FbankConfig) -> np.ndarray:
    """First sample index of each frame (may be negative for snip_edges=False)."""
    starts = np.arange(n_frames, dtype=np.int64) * cfg.frame_shift
    if not cfg.snip_edges:
        starts += cfg.frame_shift // 2 - cfg.frame_length // 2
    return starts


def reflect_index(idx: np.ndarray, length: int) -> np.ndarray:
    """Kaldi edge reflection: -1 -> 0, length -> length-1, etc."""
    idx = np.asarray(idx, dtype=np.int64)
    if length <= 1:
        return np.zeros_like(idx)
    # One reflection pass is enough for frame_length << length; loop for tiny inputs.
    for _ in range(64):
        neg = idx < 0
        over = idx >= length
        if not (neg.any() or over.any()):
            break
        idx = np.where(neg, -idx - 1, idx)
        idx = np.where(idx >= length, 2 * length - 1 - idx, idx)
    return idx


def extract_frames(audio: np.ndarray, cfg: FbankConfig) -> np.ndarray:
    """Extract (and scale) raw frames, shape (n_frames, frame_length), float32."""
    audio = np.asarray(audio, dtype=np.float32) * np.float32(cfg.input_scale)
    n = len(audio)
    f = num_frames(n, cfg)
    if f == 0:
        return np.empty((0, cfg.frame_length), dtype=np.float32)
    starts = frame_start_indices(f, cfg)
    idx = starts[:, None] + np.arange(cfg.frame_length, dtype=np.int64)[None, :]
    if not cfg.snip_edges:
        idx = reflect_index(idx, n)
    return audio[idx]


def process_frames(frames: np.ndarray, cfg: FbankConfig) -> np.ndarray:
    """DC removal + preemphasis + window, per Kaldi ProcessWindow order."""
    frames = frames.astype(np.float32).copy()
    if cfg.remove_dc:
        frames -= frames.mean(axis=1, keepdims=True)
    if cfg.preemph != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - np.float32(cfg.preemph) * prev
    frames *= feature_window(cfg)[None, :]
    return frames


def compute_fbank(audio: np.ndarray, cfg: FbankConfig = ASR_FBANK) -> np.ndarray:
    """Full fbank: returns (n_frames, num_bins) float32 log-mel features."""
    frames = extract_frames(audio, cfg)
    if frames.shape[0] == 0:
        return np.empty((0, cfg.num_bins), dtype=np.float32)
    frames = process_frames(frames, cfg)
    padded = np.zeros((frames.shape[0], cfg.n_fft), dtype=np.float32)
    padded[:, : cfg.frame_length] = frames
    spec = np.fft.rfft(padded.astype(np.float64))
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    mel = power @ kaldi_mel_banks(cfg).T
    feats = np.log(np.maximum(mel, np.float32(cfg.log_floor))).astype(np.float32)
    if cfg.cmvn:
        feats -= feats.mean(axis=0, keepdims=True)
    return feats
