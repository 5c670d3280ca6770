"""The speaker embedding of pyannote/speaker-diarization-community-1, plain:
WeSpeaker's ResNet34 over the Kaldi fbank of a 10 s window, statistics
pooled under each speaker's frames of that window, projected to 256.

Written from WeSpeaker (wenet-e2e/wespeaker: its Kaldi fbank at 80 bins,
ResNet34 of basic blocks, the statistics pooling and the "seg_1" linear)
and from pyannote's embedding step of the Community-1 pipeline (the fbank
centred per window; each speaker's frames of the segmentation, frames where
two speakers talk left out when the speaker has enough frames alone; the
mask taken at the embedding's frame rate by the nearest frame; a speaker
with no frame has no embedding). Weights by the export's names
(resnet.conv1.weight, resnet.layer2.0.bn1.running_var,
resnet.layer2.0.shortcut.0.weight, resnet.seg_1.bias, ...); every
BatchNorm runs on its running statistics after its convolution.

Fbank: 25 ms frames every 10 ms inside the window (snip_edges), samples
scaled by 32768, DC removed, pre-emphasis 0.97, a Hamming window, a 512-point
power spectrum, 80 triangular bins on Kaldi's mel scale from 20 Hz to 8 kHz,
the log floored at float32 epsilon; a window keeps its first 998 frames.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision
from portbench.reference.pyannet import FRAMES, POWERSET

WINDOW_FRAMES = 998
FRAME, SHIFT, N_FFT = 400, 160, 512
BN_EPS = 1e-5
MIN_SAMPLES = 1680  # the shortest speech an embedding is made of


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def _tables(device, bins):
    i = np.arange(FRAME, dtype=np.float64)
    hamming = 0.54 - 0.46 * np.cos(2.0 * math.pi * i / (FRAME - 1))
    lo, hi = _mel(20.0), _mel(8000.0)
    delta = (hi - lo) / (bins + 1)
    fft_mel = _mel(np.arange(N_FFT // 2) * (16000 / N_FFT))[None, :]
    left = lo + np.arange(bins)[:, None] * delta
    tri = np.minimum((fft_mel - left) / delta, (left + 2 * delta - fft_mel) / delta)
    bank = np.zeros((bins, N_FFT // 2 + 1))
    bank[:, : N_FFT // 2] = np.where((fft_mel > left) & (fft_mel < left + 2 * delta), tri, 0.0)
    return (torch.from_numpy(hamming.astype(np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(bank.T, np.float32)).to(device))


def fbank(P: Precision, windows, bins=80):
    """[B, 160000] -> [B, 998, bins] log-mel, centred per window."""
    hamming, bank = _tables(windows.device, bins)
    frames = (windows * 32768.0).unfold(1, FRAME, SHIFT)[:, :WINDOW_FRAMES]
    frames = frames - frames.mean(dim=2, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
    spec = torch.fft.rfft(frames * hamming, n=N_FFT, dim=2)
    power = spec.real ** 2 + spec.imag ** 2
    with P.active():
        mel = P.matmul(power, bank)
    feats = torch.log(torch.clamp_min(mel, float(np.finfo(np.float32).eps)))
    return feats - feats.mean(dim=1, keepdim=True)


def _conv_bn(P, w, conv, bn, x, stride):
    x = P.conv2d(x, w[conv + ".weight"], stride=stride, padding=w[conv + ".weight"].shape[-1] // 2)
    scale = w[bn + ".weight"] / torch.sqrt(w[bn + ".running_var"] + BN_EPS)
    return (x - w[bn + ".running_mean"][:, None, None]) * scale[:, None, None] + w[bn + ".bias"][:, None, None]


def frame_features(P: Precision, w, widths, feats):
    """[B, 998, M] fbank -> [B, 8 C x M / 8, T'] frame features, the channel
    major."""
    with P.active():
        x = torch.relu(_conv_bn(P, w, "resnet.conv1", "resnet.bn1", feats.transpose(1, 2)[:, None], 1))
        for stage, n_blocks in enumerate(widths["blocks"]):
            for b in range(n_blocks):
                pre = f"resnet.layer{stage + 1}.{b}"
                stride = 2 if stage > 0 and b == 0 else 1
                h = torch.relu(_conv_bn(P, w, pre + ".conv1", pre + ".bn1", x, stride))
                h = _conv_bn(P, w, pre + ".conv2", pre + ".bn2", h, 1)
                if pre + ".shortcut.0.weight" in w:
                    x = _conv_bn(P, w, pre + ".shortcut.0", pre + ".shortcut.1", x, stride)
                x = torch.relu(h + x)
    b, c, f, t = x.shape
    return x.reshape(b, c * f, t)


def speaker_masks(classes, t_feat):
    """Each speaker's frame weights at the embedding's rate and whether the
    speaker has an embedding, from the segmentation's classes [B, 589]:
    ([B, 3, t_feat] float32, [B, 3] bool)."""
    active = torch.from_numpy(POWERSET).to(classes.device)[classes.long()]   # [B, 589, 3]
    alone = active * (active.sum(dim=2, keepdim=True) < 2)
    min_frames = math.ceil(FRAMES * MIN_SAMPLES / 160000)
    used = torch.where((alone.sum(dim=1) > min_frames)[:, None, :], alone, active)
    idx = torch.clamp(torch.arange(t_feat, device=classes.device) * FRAMES // t_feat, max=FRAMES - 1)
    mask = used[:, idx, :].transpose(1, 2)
    has = (used.sum(dim=1) >= 1) & (mask.sum(dim=2) >= 1)
    return mask * has[..., None], has


def pooled(P: Precision, w, feats, mask):
    """Weighted mean and standard deviation of the frame features [B, D, T]
    under each speaker's weights [B, S, T], projected: [B, S, embed]."""
    v1 = mask.sum(dim=2) + 1e-8
    mean = torch.einsum("bdt,bst->bsd", feats, mask) / v1[..., None]
    dx2 = (feats[:, None] - mean[..., None]) ** 2
    v2 = (mask ** 2).sum(dim=2)
    var = torch.einsum("bsdt,bst->bsd", dx2, mask) / (v1 - v2 / v1 + 1e-8)[..., None]
    stats = torch.cat([mean, torch.sqrt(torch.clamp_min(var, 0.0))], dim=-1)
    with P.active():
        return P.linear(stats, w["resnet.seg_1.weight"], w["resnet.seg_1.bias"])


def out_frames(t):
    for _ in range(3):
        t = (t - 1) // 2 + 1
    return t


def embeddings(P: Precision, w, widths, windows, classes):
    """([B, 3, embed], has [B, 3]) of windows [B, 160000] under the
    segmentation's classes [B, 589]."""
    feats = frame_features(P, w, widths, fbank(P, windows, widths["num_mels"]))
    mask, has = speaker_masks(classes, feats.shape[-1])
    return pooled(P, w, feats, mask), has
