"""Kaldi log-mel fbank of the ASR models, plain: 25 ms Povey windows every
10 ms, snip_edges=False (frames centred on 160 f + 80, Kaldi reflection at
both ends), DC removal, pre-emphasis 0.97, a 512-point real FFT, the power
spectrum, 80 triangular mel bins from 20 to 7600 Hz (Kaldi's mel scale, the
Nyquist bin excluded), log with a float32-epsilon floor. No dither, no
scaling, no CMVN.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference.precision import Precision

FRAME, SHIFT, N_FFT, BINS = 400, 160, 512, 80
LOW_HZ, HIGH_HZ, RATE = 20.0, 7600.0, 16000
EPS = float(np.finfo(np.float32).eps)


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def _tables(device):
    """(Povey window [400], mel bank [257, 80]) on `device`."""
    i = np.arange(FRAME, dtype=np.float64)
    window = np.power(0.5 - 0.5 * np.cos(2.0 * math.pi / (FRAME - 1) * i), 0.85)
    lo, hi = _mel(LOW_HZ), _mel(HIGH_HZ)
    delta = (hi - lo) / (BINS + 1)
    fft_mel = _mel(np.arange(N_FFT // 2) * (RATE / N_FFT))[None, :]
    left = lo + np.arange(BINS)[:, None] * delta
    up = (fft_mel - left) / delta
    down = (left + 2 * delta - fft_mel) / delta
    bank = np.zeros((BINS, N_FFT // 2 + 1), np.float32)
    bank[:, : N_FFT // 2] = np.where((fft_mel > left) & (fft_mel < left + 2 * delta),
                                     np.minimum(up, down), 0.0)
    return (torch.from_numpy(window.astype(np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(bank.T)).to(device))


def frame_count(n: int) -> int:
    return (n + SHIFT // 2) // SHIFT


def fbank(P: Precision, audio: torch.Tensor) -> torch.Tensor:
    """[L] float32 on a device -> [frame_count(L), 80]."""
    n = audio.shape[0]
    f = frame_count(n)
    window, bank = _tables(audio.device)
    idx = (torch.arange(f, device=audio.device)[:, None] * SHIFT
           + (SHIFT // 2 - FRAME // 2) + torch.arange(FRAME, device=audio.device)[None, :])
    for _ in range(4):  # reflection: -1 -> 0, n -> n - 1
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    frames = audio[idx]
    frames = frames - frames.mean(dim=1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames * window
    spec = torch.fft.rfft(frames, n=N_FFT, dim=1)
    power = spec.real * spec.real + spec.imag * spec.imag
    with P.active():
        mel = P.matmul(power, bank)
    return torch.log(torch.clamp_min(mel, EPS))
