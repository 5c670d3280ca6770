# DNSMOS P.835 (sig_bak_ovr) quality model in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/dnsmos.py: 9.01 s of raw 16 kHz
# audio (144160 samples, never peak-normalised: the model is
# level-sensitive) -> frames of 320 every 160 samples under a symmetric Hann
# window -> rfft power -> 120 HTK mels floored at 1e-10 -> log10 -> four
# 3x3 "SAME" convolutions (padding 1), each with ReLU and a 2x2 max-pool that
# floors odd sizes -> global mean -> dense 64 + ReLU -> 3 raw scores (SIG,
# BAK, OVRL), which pipeline/quality.py maps through Microsoft's polynomial
# fit. Convolutions are NCHW with [O, I, 3, 3] kernels; the mel matrix is a
# [161, 120] buffer. On the card the products and cuDNN convolutions run in
# full float32 (models.zipformer.use_full_fp32); the forward refuses to run
# with TF32 on.

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    _check_full_fp32,
    use_full_fp32,
)

INPUT_SAMPLES = 144160  # 9.01 s @ 16 kHz


@dataclasses.dataclass(frozen=True)
class DnsmosConfig:
    n_fft: int = 320
    hop: int = 160
    n_mels: int = 120
    sample_rate: int = 16000
    channels: tuple = (32, 32, 32, 64)
    dense: int = 64


def _mel_matrix(cfg: DnsmosConfig) -> np.ndarray:
    """HTK-style mel filterbank [n_mels, n_fft // 2 + 1] (copied from the
    JAX package)."""
    n_spec = cfg.n_fft // 2 + 1
    f_max = cfg.sample_rate / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), cfg.n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((cfg.n_fft + 1) * hz / cfg.sample_rate).astype(int)
    fb = np.zeros((cfg.n_mels, n_spec), np.float32)
    for m in range(1, cfg.n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[m - 1, k] = (hi - k) / (hi - c)
    return fb


class Dnsmos(nn.Module):
    def __init__(self, cfg: DnsmosConfig = DnsmosConfig()):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("mel", torch.from_numpy(_mel_matrix(cfg).T.copy()))
        # jnp.hanning: the symmetric window (torch's default is periodic)
        self.register_buffer("window", torch.hann_window(
            cfg.n_fft, periodic=False, dtype=torch.float64).float(), persistent=False)
        chans = (1,) + tuple(cfg.channels)
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, padding=1)
                                   for i in range(len(cfg.channels)))
        self.dense1 = nn.Linear(cfg.channels[-1], cfg.dense)
        self.head = nn.Linear(cfg.dense, 3)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def to(self, *args, **kwargs) -> "Dnsmos":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio: [B, 144160] raw float32 -> [B, 3] raw (SIG, BAK, OVRL)."""
        cfg = self.cfg
        if audio.device.type == "cuda":
            _check_full_fp32()
        frames = audio.unfold(1, cfg.n_fft, cfg.hop) * self.window   # [B, T, K]
        power = torch.fft.rfft(frames).abs() ** 2
        mel = torch.clamp_min(power @ self.mel, 1e-10)
        x = torch.log10(mel)[:, None]                                # [B, 1, T, M]
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2)
        x = x.mean(dim=(2, 3))
        x = F.relu(self.dense1(x))
        return self.head(x)


def random_dnsmos(cfg: DnsmosConfig = DnsmosConfig(), seed: int = 0, device="cuda",
                  generator: torch.Generator | None = None) -> Dnsmos:
    """Random weights with the JAX package's init scheme
    (init_dnsmos_params): conv kernels N(0, 1/(9 c_in)), dense weights
    N(0, 1/d_in), biases zero, the mel matrix fixed. Values come from
    `generator`, or from a CPU generator seeded with `seed`; the model goes
    to `device`, the card by default (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = Dnsmos(cfg)
    with torch.no_grad():
        for module in (*model.convs, model.dense1, model.head):
            w = module.weight
            w.normal_(generator=generator).mul_(1.0 / math.sqrt(math.prod(w.shape[1:])))
            module.bias.zero_()
    return model.to(device)
