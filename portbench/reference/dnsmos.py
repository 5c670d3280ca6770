"""DNSMOS P.835 (sig_bak_ovr), plain: 9.01 s of raw 16 kHz speech -> the
three raw scores (SIG, BAK, OVRL) before Microsoft's polynomial mapping.

Written from Microsoft's DNS-Challenge DNSMOS (dnsmos_local.py and the
sig_bak_ovr model): the audio never normalised (the model is level
sensitive) and zero-padded to 144,160 samples; frames of 320 samples every
160 under a symmetric Hann window; the power spectrum; 120 triangular mel
bins on the HTK scale up to 8 kHz, floored at 1e-10; log10; four 3x3
convolutions (32, 32, 32, 64 channels, zero padding 1), each with ReLU and
a 2x2 max-pool that drops an odd last row or column; the mean over time and
frequency; a dense layer of 64 with ReLU; the 3 scores. Weights by the
names convs.<i>.weight / .bias, dense1.*, head.*; the mel bank is made here.

The pipeline's quality stage scores the speech-only audio in up to three
windows, centred at 15, 50 and 85% of it (speech_windows).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

LENGTH = 144160
MIN_SAMPLES = 8000


def speech_windows(speech, positions=(0.15, 0.50, 0.85)):
    """The windows the quality stage scores: [N, 144160] float32 (N 0-3)."""
    n = len(speech)
    out = []
    if n >= MIN_SAMPLES:
        for pos in positions:
            start = max(0, int(n * pos) - LENGTH // 2)
            end = min(n, start + LENGTH)
            if end - start >= MIN_SAMPLES:
                w = np.zeros(LENGTH, np.float32)
                w[: end - start] = speech[start:end]
                out.append(w)
    return np.stack(out) if out else np.zeros((0, LENGTH), np.float32)


@functools.lru_cache(maxsize=4)
def _tables(device, n_fft, n_mels, rate):
    """(symmetric Hann [n_fft], HTK mel bank [n_fft // 2 + 1, n_mels])."""
    i = np.arange(n_fft)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * i / (n_fft - 1))
    htk = 2595.0 * np.log10(1.0 + np.array([0.0, rate / 2]) / 700.0)
    hz = 700.0 * (10.0 ** (np.linspace(htk[0], htk[1], n_mels + 2) / 2595.0) - 1.0)
    edge = np.floor((n_fft + 1) * hz / rate).astype(int)
    k = np.arange(n_fft // 2 + 1)[:, None]
    lo, c, hi = edge[None, :-2], edge[None, 1:-1], edge[None, 2:]
    up = np.where((k >= lo) & (k < c), (k - lo) / np.maximum(c - lo, 1), 0.0)
    down = np.where((k >= c) & (k < hi), (hi - k) / np.maximum(hi - c, 1), 0.0)
    return (torch.tensor(hann, dtype=torch.float32, device=device),
            torch.tensor(up + down, dtype=torch.float32, device=device))


def forward(P: Precision, w, widths, audio):
    """[B, 144160] -> [B, 3] raw (SIG, BAK, OVRL)."""
    hann, mel = _tables(audio.device, widths["n_fft"], widths["n_mels"], widths["sample_rate"])
    frames = audio.unfold(1, widths["n_fft"], widths["hop"]) * hann
    spec = torch.fft.rfft(frames, dim=2)
    power = spec.real ** 2 + spec.imag ** 2
    with P.active():
        x = torch.log10(torch.clamp_min(P.matmul(power, mel), 1e-10))[:, None]
        for i in range(len(widths["channels"])):
            x = F.max_pool2d(torch.relu(P.conv2d(x, w[f"convs.{i}.weight"], w[f"convs.{i}.bias"],
                                                 padding=1)), 2)
        x = torch.relu(P.linear(x.mean(dim=(2, 3)), w["dense1.weight"], w["dense1.bias"]))
        return P.linear(x, w["head.weight"], w["head.bias"])
