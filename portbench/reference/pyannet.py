"""PyanNet, the segmentation model of pyannote/speaker-diarization-community-1,
plain: a 10 s window of 16 kHz audio -> 589 frames of log-probabilities over
the 7 powerset classes of at most 3 speakers (at most 2 at once).

Written from pyannote.audio's PyanNet and SincNet (Ravanelli and Bengio's
parametrised sinc band-pass filters, as asteroid-filterbanks' ParamSincFB
builds them): instance norm of the waveform; 80 sinc band-pass filters of
251 taps at stride 10; |x|; max-pool 3; instance norm; LeakyReLU 0.01; two
blocks of a 5-tap convolution of 60 channels, max-pool 3, instance norm and
LeakyReLU; 4 bidirectional LSTM layers of 128; two linears of 128 with
LeakyReLU; the classifier; log-softmax. Weights by the upstream state-dict
names (sincnet.conv1d.0.low_hz_, lstm.weight_ih_l0_reverse, linear.0.weight,
classifier.bias, ...).

Departures, each computing the same function: the LSTM runs as one product of
the inputs for all steps and a loop of recurrent products, both directions
of a layer stacked in one batched product; the sinc filters' denominator
adds 1e-8 to 2 x band (band >= 50 Hz), as the ONNX export does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

WINDOW = 160000
STEP = 16000
FRAMES = 589
EPS = 1e-5

# The powerset classes of 3 speakers with at most 2 active: {}, {0}, {1},
# {2}, {0, 1}, {0, 2}, {1, 2}.
POWERSET = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                     [1, 1, 0], [1, 0, 1], [0, 1, 1]], np.float32)


def window_starts(n_samples):
    """Start samples of the 10 s windows every 1 s over a recording, the
    last one the first that reaches past its end (zero-padded)."""
    starts, s = [], 0
    while True:
        starts.append(s)
        if s + WINDOW > n_samples:
            return starts
        s += STEP


def _instance_norm(x, weight, bias):
    mu = x.mean(dim=2, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=2, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * weight[:, None] + bias[:, None]


def sinc_filters(w, widths):
    """[filters, 1, taps] band-pass filters from the learnt band edges."""
    rate, k = widths["sample_rate"], widths["sinc_kernel"]
    low = widths["min_low_hz"] + w["sincnet.conv1d.0.low_hz_"].abs()
    high = torch.clamp(low + widths["min_band_hz"] + w["sincnet.conv1d.0.band_hz_"].abs(),
                       widths["min_low_hz"], rate / 2)
    band = high - low                                                 # [F, 1]
    half = (k - 1) // 2
    n = 2 * math.pi * torch.arange(-half, 0, dtype=torch.float32, device=low.device)[None, :] / rate
    i = np.arange(k, dtype=np.float64)
    hamming = torch.from_numpy((0.54 - 0.46 * np.cos(2 * np.pi * i / (k - 1)))[:half]
                               .astype(np.float32)).to(low.device)
    left = (torch.sin(high * n) - torch.sin(low * n)) / (n / 2) * hamming
    taps = torch.cat([left, 2 * band, left.flip(1)], dim=1) / (2 * band + 1e-8)
    return taps[:, None, :]


def _lstm(P: Precision, w, x, layers, hidden):
    """Bidirectional LSTM (PyTorch's gate order i, f, g, o), batch first."""
    b, t, _ = x.shape
    for layer in range(layers):
        sfx = [f"_l{layer}", f"_l{layer}_reverse"]
        w_ih = torch.stack([w["lstm.weight_ih" + s] for s in sfx])            # [2, 4H, I]
        w_hh = torch.stack([w["lstm.weight_hh" + s] for s in sfx])            # [2, 4H, H]
        bias = torch.stack([w["lstm.bias_ih" + s] + w["lstm.bias_hh" + s] for s in sfx])
        seq = torch.stack([x, x.flip(1)])                                     # [2, B, T, I]
        gx = P.matmul(seq, w_ih.transpose(1, 2)[:, None]) + bias[:, None, None, :]
        h = x.new_zeros(2, b, hidden)
        c = x.new_zeros(2, b, hidden)
        out = []
        for step in range(t):
            g = gx[:, :, step] + P.matmul(h, w_hh.transpose(1, 2))
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        hs = torch.stack(out, dim=2)                                          # [2, B, T, H]
        x = torch.cat([hs[0], hs[1].flip(1)], dim=-1)
    return x


def forward(P: Precision, w, widths, windows):
    """windows [B, 160000] float32 -> [B, 589, 7] log-probabilities."""
    with P.active():
        x = _instance_norm(windows[:, None, :], w["sincnet.wav_norm1d.weight"],
                           w["sincnet.wav_norm1d.bias"])
        x = P.conv1d(x, sinc_filters(w, widths), stride=widths["sinc_stride"])
        x = F.max_pool1d(x.abs(), widths["pool"])
        x = F.leaky_relu(_instance_norm(x, w["sincnet.norm1d.0.weight"], w["sincnet.norm1d.0.bias"]), 0.01)
        for i in (1, 2):
            x = P.conv1d(x, w[f"sincnet.conv1d.{i}.weight"], w[f"sincnet.conv1d.{i}.bias"])
            x = F.max_pool1d(x, widths["pool"])
            x = F.leaky_relu(_instance_norm(x, w[f"sincnet.norm1d.{i}.weight"],
                                            w[f"sincnet.norm1d.{i}.bias"]), 0.01)
        x = _lstm(P, w, x.transpose(1, 2), widths["lstm_layers"], widths["lstm_hidden"])
        for i in (0, 1):
            x = F.leaky_relu(P.linear(x, w[f"linear.{i}.weight"], w[f"linear.{i}.bias"]), 0.01)
        return torch.log_softmax(P.linear(x, w["classifier.weight"], w["classifier.bias"]), dim=-1)
