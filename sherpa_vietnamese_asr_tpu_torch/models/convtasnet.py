# Conv-TasNet (Libri2Mix sepclean 16k) 2-speaker separation in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/convtasnet.py
# (convtasnet_separate, :89-155): mixture [B, T] -> two estimated sources
# [B, 2, T]. The module keeps asteroid's tree, so its state-dict keys are the
# export's initializer names (encoder.filterbank._filters,
# masker.bottleneck.0.gamma, masker.TCN.3.shared_block.3.weight, ...):
# encoder Conv1d(1, N, L, stride) + ReLU on the mixture zero-padded to a full
# frame grid, global layer norm over (T, C) with the biased variance, a
# 1x1 bottleneck, X blocks x R repeats of [1x1 conv, PReLU, gLN, depthwise
# conv with dilation 2^(i mod X), PReLU, gLN] with residual and skip 1x1
# convs, PReLU + 1x1 conv + ReLU masks, and the decoder's frame synthesis
# with overlap-add.
#
# Two sums run in another order than the JAX function's, within float32
# rounding: the depthwise convolution is its kernel's shifted products
# (x[t - d] w0 + x[t] w1 + x[t + d] w2, a few elementwise kernels on the
# card instead of a grouped cuDNN convolution), and the overlap-add is
# conv_transpose1d instead of a scatter-add on the frame grid.
#
# Inference only. On the card the module runs on cuDNN and cuBLAS in full
# float32: .to(cuda) turns TF32 off (models.zipformer.use_full_fp32) and the
# forward raises on a CUDA input if it is back on.

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    _check_full_fp32,
    use_full_fp32,
)

GLN_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class ConvTasNetConfig:
    n_filters: int = 512   # N
    kernel: int = 32       # L
    stride: int = 16
    bottleneck: int = 128  # B
    hidden: int = 512      # H
    skip: int = 128        # Sc
    conv_kernel: int = 3   # P
    n_blocks: int = 8      # X
    n_repeats: int = 3     # R
    n_src: int = 2


TINY_CONVTASNET = ConvTasNetConfig(n_filters=64, bottleneck=32, hidden=64,
                                   skip=32, n_blocks=2, n_repeats=1)


class GlobLN(nn.Module):
    """asteroid gLN: gamma and beta [1, C, 1]."""

    def __init__(self, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x):  # [B, C, T]
        mu = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mu).square().mean(dim=(1, 2), keepdim=True)
        return (x - mu) * torch.rsqrt(var + GLN_EPS) * self.gamma + self.beta


class _Filterbank(nn.Module):
    def __init__(self, n_filters, kernel):
        super().__init__()
        self.filterbank = nn.Module()
        self.filterbank._filters = nn.Parameter(torch.zeros(n_filters, 1, kernel))


def _depthwise(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Depthwise 'same' convolution as shifted products: [B, C, T]."""
    k, d = conv.kernel_size[0], conv.dilation[0]
    total = d * (k - 1)
    xp = F.pad(x, (total // 2, total - total // 2))
    t = x.shape[-1]
    w = conv.weight[:, 0, :]                                   # [C, K]
    out = xp[..., :t] * w[:, 0, None]
    for j in range(1, k):
        out = out + xp[..., j * d: j * d + t] * w[:, j, None]
    return out + conv.bias[:, None]


class Conv1DBlock(nn.Module):
    def __init__(self, cfg: ConvTasNetConfig, dilation: int):
        super().__init__()
        h = cfg.hidden
        self.shared_block = nn.Sequential(
            nn.Conv1d(cfg.bottleneck, h, 1), nn.PReLU(), GlobLN(h),
            nn.Conv1d(h, h, cfg.conv_kernel, dilation=dilation, groups=h),
            nn.PReLU(), GlobLN(h))
        self.res_conv = nn.Conv1d(h, cfg.bottleneck, 1)
        self.skip_conv = nn.Conv1d(h, cfg.skip, 1)

    def forward(self, x):
        sb = self.shared_block
        y = sb[2](F.prelu(sb[0](x), sb[1].weight))
        y = sb[5](F.prelu(_depthwise(y, sb[3]), sb[4].weight))
        return self.res_conv(y), self.skip_conv(y)


class _Masker(nn.Module):
    def __init__(self, cfg: ConvTasNetConfig):
        super().__init__()
        self.bottleneck = nn.Sequential(GlobLN(cfg.n_filters),
                                        nn.Conv1d(cfg.n_filters, cfg.bottleneck, 1))
        self.TCN = nn.ModuleList([Conv1DBlock(cfg, 2 ** (i % cfg.n_blocks))
                                  for i in range(cfg.n_repeats * cfg.n_blocks)])
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(cfg.skip, cfg.n_src * cfg.n_filters, 1))


class ConvTasNet(nn.Module):
    def __init__(self, cfg: ConvTasNetConfig = ConvTasNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Filterbank(cfg.n_filters, cfg.kernel)
        self.masker = _Masker(cfg)
        self.decoder = _Filterbank(cfg.n_filters, cfg.kernel)

    @property
    def device(self) -> torch.device:
        return self.encoder.filterbank._filters.device

    def to(self, *args, **kwargs) -> "ConvTasNet":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    @torch.no_grad()
    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        """mixture [B, T] float32 -> [B, n_src, T] estimated sources."""
        if mixture.device.type == "cuda":
            _check_full_fp32()
        cfg = self.cfg
        b, t = mixture.shape
        pad = (-(t - cfg.kernel)) % cfg.stride if t >= cfg.kernel else cfg.kernel - t
        x = F.pad(mixture, (0, pad))[:, None, :]                # a full frame grid
        w = torch.relu(F.conv1d(x, self.encoder.filterbank._filters,
                                stride=cfg.stride))            # [B, N, F]
        mk = self.masker
        h = mk.bottleneck(w)
        skip = 0.0
        for blk in mk.TCN:
            res, sk = blk(h)
            skip = skip + sk
            h = h + res
        m = mk.mask_net[1](F.prelu(skip, mk.mask_net[0].weight))  # [B, S*N, F]
        n_frames = m.shape[-1]
        masks = torch.relu(m.view(b, cfg.n_src, cfg.n_filters, n_frames))
        src = (w[:, None] * masks).reshape(b * cfg.n_src, cfg.n_filters, n_frames)
        out = F.conv_transpose1d(src, self.decoder.filterbank._filters,
                                 stride=cfg.stride)            # [B*S, 1, T_pad]
        return out.view(b, cfg.n_src, -1)[:, :, :t]


def random_convtasnet(cfg: ConvTasNetConfig = ConvTasNetConfig(), seed: int = 0,
                      device="cuda", generator: torch.Generator | None = None
                      ) -> ConvTasNet:
    """Random weights with the JAX package's init scheme: convolutions
    N(0, 1/fan_in) (the encoder's over its L taps, the depthwise ones over
    P), the decoder N(0, 1/N), biases zero, gLN identity, PReLU 0.25. Values
    come from `generator`, or from a CPU generator seeded with `seed`; the
    model goes to `device`, the card by default (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = ConvTasNet(cfg)
    with torch.no_grad():
        for fb, scale in ((model.encoder, 1.0 / math.sqrt(cfg.kernel)),
                          (model.decoder, 1.0 / math.sqrt(cfg.n_filters))):
            fb.filterbank._filters.normal_(generator=generator).mul_(scale)
        for m in model.masker.modules():
            if isinstance(m, nn.Conv1d):
                m.weight.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(math.prod(m.weight.shape[1:])))
                m.bias.zero_()
    return model.to(device)
