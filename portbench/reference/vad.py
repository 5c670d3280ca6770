"""Silero VAD, plain: per-512-sample-window speech probabilities of a whole
file in one pass.

Each window is 64 samples of the previous window's context (zeros for the
first) and its 512 samples; STFT magnitude as products with the cos and sin
bases (256-sample frames, hop 128), sqrt(re^2 + im^2 + 1e-9); four k=3
same-padded Conv1d + ReLU over the frames; mean over frames; one LSTM call over
all windows of the file (gate order i, f, g, o); sigmoid of a linear head.
The file is rounded to int16 first, as the pipeline uploads it.

Weights by name: stft_cos, stft_sin [129, 256]; encoder.{i}.weight/bias;
lstm.weight_ih_l0 / weight_hh_l0 / bias_ih_l0 / bias_hh_l0; head.weight/bias.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import Precision

WINDOW, CONTEXT, FILTER, HOP = 512, 64, 256, 128


def quantized(audio: np.ndarray, device) -> torch.Tensor:
    pcm = np.clip(np.rint(np.asarray(audio, np.float32) * 32768.0), -32768, 32767)
    return torch.from_numpy(pcm.astype(np.float32) / np.float32(32768.0)).to(device)


def window_features(P: Precision, W, windows):
    """[N, 576] -> [N, 128]."""
    frames = windows.unfold(1, FILTER, HOP)                   # [N, 3, 256]
    re = P.matmul(frames, W["stft_cos"].t())
    im = P.matmul(frames, W["stft_sin"].t())
    h = torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)  # [N, 129, 3]
    for i in range(4):
        h = torch.relu(P.conv1d(h, W[f"encoder.{i}.weight"], W[f"encoder.{i}.bias"],
                                padding=1))
    return h.mean(dim=2)


def lstm(P: Precision, W, feats):
    """The recurrence over all windows of the file: one torch LSTM call
    (cuDNN on a card), its input and weights rounded as P says."""
    d = W["lstm.weight_hh_l0"].shape[1]
    cell = torch.nn.LSTM(feats.shape[1], d, batch_first=True, device=feats.device)
    with torch.no_grad():
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            w = W[f"lstm.{name}"]
            getattr(cell, name).copy_(P.round(w) if w.dim() == 2 else w)
    cell.flatten_parameters()
    hs, _ = cell(P.round(feats)[None])
    return hs[0]


def speech_probs(P: Precision, W, audio: np.ndarray, device) -> torch.Tensor:
    """[len // 512] probabilities of the VAD input `audio` (host float32)."""
    x = quantized(audio, device)
    n = x.shape[0] // WINDOW
    if n == 0:
        return x.new_zeros(0)
    wins = x[: n * WINDOW].reshape(n, WINDOW)
    ctx = torch.cat([wins.new_zeros(1, CONTEXT), wins[:-1, -CONTEXT:]])
    with P.active():
        feats = torch.cat([window_features(P, W, torch.cat([ctx[i: i + 4096], wins[i: i + 4096]], 1))
                           for i in range(0, n, 4096)])
        hs = lstm(P, W, feats)
        return torch.sigmoid(P.linear(hs, W["head.weight"], W["head.bias"]))[:, 0]
