# PyanNet segmentation model (pyannote Community-1) in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/pyannet.py with the same order of
# operations (pyannet_forward): instance norm of the waveform -> SincConv
# (stride 10) -> abs -> max-pool 3 -> instance norm + LeakyReLU 0.01 -> two
# conv-5 blocks (conv, max-pool 3, instance norm, LeakyReLU) -> 4-layer
# bidirectional LSTM(128) -> 2 x (Linear + LeakyReLU) -> classifier ->
# log-softmax over the 7 powerset classes. A 160,000-sample window gives
# 589 frames.
#
# The module tree mirrors pyannote.audio's PyanNet, so its state-dict keys
# are the upstream names (sincnet.conv1d.0.low_hz_, lstm.weight_ih_l0,
# linear.0.weight, ...) that segmentation-community-1.onnx carries. The JAX
# package has no Pallas kernel here (an XLA convolution and a lax.scan), so
# the port runs library calls: cuDNN convolutions and the cuDNN LSTM, in full
# float32 on the card (models.zipformer.use_full_fp32). The LSTM's second
# bias is held at zero: the JAX model has one gate bias, which sits in
# bias_ih.

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

NUM_SEG_FRAMES = 589
CHUNK_SAMPLES = 160000
POWERSET_CLASSES = 7


@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dim: int = 128
    num_classes: int = POWERSET_CLASSES
    sample_rate: int = 16000
    min_low_hz: float = 30.0
    min_band_hz: float = 50.0


def _mel_band_edges(cfg: PyanNetConfig) -> np.ndarray:
    """[sinc_filters + 1] mel-spaced band edges in Hz (pyannote SincConv's
    initial low_hz_ / band_hz_)."""
    high_hz = cfg.sample_rate / 2 - (cfg.min_low_hz + cfg.min_band_hz)
    mel = np.linspace(2595 * np.log10(1 + 30.0 / 700),
                      2595 * np.log10(1 + high_hz / 700), cfg.sinc_filters + 1)
    return 700 * (10 ** (mel / 2595) - 1)


class _SincConv(nn.Module):
    """Learnable band edges (low_hz_, band_hz_), each [sinc_filters, 1]."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        hz = _mel_band_edges(cfg)
        self.low_hz_ = nn.Parameter(torch.tensor(hz[:-1, None], dtype=torch.float32))
        self.band_hz_ = nn.Parameter(torch.tensor(np.diff(hz)[:, None], dtype=torch.float32))


class _SincNet(nn.Module):
    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.wav_norm1d = _Affine(1)
        self.conv1d = nn.ModuleList([
            _SincConv(cfg),
            nn.Conv1d(cfg.sinc_filters, cfg.conv_channels, cfg.conv_kernel),
            nn.Conv1d(cfg.conv_channels, cfg.conv_channels, cfg.conv_kernel)])
        self.norm1d = nn.ModuleList([_Affine(cfg.sinc_filters),
                                     _Affine(cfg.conv_channels),
                                     _Affine(cfg.conv_channels)])


class _Affine(nn.Module):
    """InstanceNorm1d(affine=True)'s parameters: weight and bias [C]."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def _instance_norm(x: torch.Tensor, p: _Affine, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over time with the biased
    variance, then the affine. x: [B, C, T]."""
    mu = x.mean(dim=2, keepdim=True)
    var = (x - mu).square().mean(dim=2, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return out * p.weight[:, None] + p.bias[:, None]


class PyanNet(nn.Module):
    def __init__(self, cfg: PyanNetConfig = PyanNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.sincnet = _SincNet(cfg)
        self.lstm = nn.LSTM(cfg.conv_channels, cfg.lstm_hidden,
                            num_layers=cfg.lstm_layers, bidirectional=True,
                            batch_first=True)
        self.linear = nn.ModuleList([
            nn.Linear(2 * cfg.lstm_hidden, cfg.linear_dim),
            nn.Linear(cfg.linear_dim, cfg.linear_dim)])
        self.classifier = nn.Linear(cfg.linear_dim, cfg.num_classes)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def to(self, *args, **kwargs) -> "PyanNet":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
            self.lstm.flatten_parameters()
        return self.eval()

    def sinc_filters(self) -> torch.Tensor:
        """[sinc_filters, 1, sinc_kernel] band-pass filters from the band
        edges (the JAX package's _sinc_filters: side taps divided by
        2*pi*t/2, the centre tap 2*band, every tap over 2*band)."""
        cfg = self.cfg
        sinc = self.sincnet.conv1d[0]
        low = cfg.min_low_hz + torch.abs(sinc.low_hz_)               # [F, 1]
        high = torch.clamp(low + cfg.min_band_hz + torch.abs(sinc.band_hz_),
                           cfg.min_low_hz, cfg.sample_rate / 2)
        band = (high - low)[:, 0]
        n = (cfg.sinc_kernel - 1) // 2
        t = (torch.arange(-n, 0, dtype=torch.float32, device=low.device)[None, :]
             / cfg.sample_rate)
        window = torch.from_numpy(
            np.hamming(cfg.sinc_kernel)[:n].astype(np.float32)).to(low.device)[None, :]
        left = ((torch.sin(2 * math.pi * high * t) - torch.sin(2 * math.pi * low * t))
                / (2 * math.pi * t / 2)) * window
        center = 2 * band[:, None]
        filters = torch.cat([left, center, left.flip(dims=[1])], dim=1)
        filters = filters / (2 * band[:, None] + 1e-8)
        return filters[:, None, :]

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio: [B, 160000] -> [B, 589, 7] log-softmax powerset scores."""
        cfg = self.cfg
        if audio.device.type == "cuda":
            _check_full_fp32()
        sn = self.sincnet
        x = _instance_norm(audio[:, None, :], sn.wav_norm1d)        # [B, 1, T]
        x = F.conv1d(x, self.sinc_filters(), stride=cfg.sinc_stride)
        x = F.max_pool1d(torch.abs(x), cfg.pool)
        x = F.leaky_relu(_instance_norm(x, sn.norm1d[0]), 0.01)
        for conv, norm in zip(sn.conv1d[1:], sn.norm1d[1:]):
            x = F.max_pool1d(conv(x), cfg.pool)
            x = F.leaky_relu(_instance_norm(x, norm), 0.01)
        x, _ = self.lstm(x.transpose(1, 2))                          # [B, T', 2H]
        for lin in self.linear:
            x = F.leaky_relu(lin(x), 0.01)
        return F.log_softmax(self.classifier(x), dim=-1)


def random_pyannet(cfg: PyanNetConfig = PyanNetConfig(), seed: int = 0,
                   device="cuda",
                   generator: torch.Generator | None = None) -> PyanNet:
    """Random weights with the JAX package's init scheme: mel-spaced band
    edges, identity norms, conv, LSTM and linear weights N(0, 1/fan_in),
    biases zero. Values come from `generator`, or from a CPU generator
    seeded with `seed`; the model goes to `device`, the card by default
    (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = PyanNet(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("sincnet.conv1d.0.", "sincnet.wav_norm1d.",
                                "sincnet.norm1d.")):
                continue  # band edges and norms keep their constructed values
            if name.rsplit(".", 1)[-1].startswith("bias"):
                p.zero_()
            else:
                p.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(math.prod(p.shape[1:])))
    return model.to(device)
