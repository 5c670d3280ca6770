# CAM++ speaker embedding (3D-Speaker campplus_cn_en_common_200k) in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/campplus.py (campp_embed,
# :136-254): 80-dim fbank [B, T, 80] -> 192-dim speaker embedding. The
# module keeps the upstream 3D-Speaker tree, so its state-dict keys are the
# export's initializer names (head.conv1.weight, xvector.tdnn.linear.weight,
# xvector.block1.tdnnd1.cam_layer.linear1.bias, ...) and the tensors are in
# torch layout: the FCM front-end sees the fbank as a one-channel image
# [B, 1, F, T] (its strides act on the frequency axis only), the TDNN part
# runs on [B, C, T].
#
# The optional [B, T] mask reproduces the JAX function's masked batches: it
# subsamples with the stride-2 TDNN as mask[:, :2*t2:2], and it weighs the
# CAM layers' global mean and 100-frame segment pooling (ceil mode, masked
# frames only) and the statistics pooling (unbiased std, n/(n-1) with
# n >= 2, clamped at 0). The convolutions see the input as it is given:
# frames after a window's end are zeros at the input only, and after
# BatchNorm and ReLU they are not zero, so they reach valid frames through
# the convolutions exactly as in the reference. The CAM gate is computed once
# a segment and repeated over its frames (the per-frame gate of the JAX
# function has the same value on every frame of a segment).
#
# Inference only; BatchNorm runs on its running statistics. The JAX package
# has no Pallas kernel here (XLA convolutions); on the card the module runs
# on cuDNN and cuBLAS in full float32: .to(cuda) turns TF32 off
# (models.zipformer.use_full_fp32) and the forward raises on a CUDA input if
# it is back on.

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

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class CamppConfig:
    num_mels: int = 80
    m_channels: int = 32          # FCM width
    init_channels: int = 128      # TDNN output channels
    growth_rate: int = 32
    bn_size: int = 4              # bottleneck = bn_size * growth_rate
    block_layers: tuple = (12, 24, 16)
    dilations: tuple = (1, 2, 2)
    kernel: int = 3
    seg_len: int = 100            # CAM segment pooling length
    embed_dim: int = 192

    @property
    def bottleneck(self) -> int:
        return self.bn_size * self.growth_rate


TINY_CAMPP = CamppConfig(m_channels=8, init_channels=32, growth_rate=8,
                         bn_size=2, block_layers=(2, 2), dilations=(1, 2),
                         embed_dim=32)


def _bn(x: torch.Tensor, bn) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, bn.eps)


class _BnRelu(nn.Module):
    """3D-Speaker get_nonlinear: a child named `batchnorm` (and a ReLU)."""

    def __init__(self, channels, affine=True):
        super().__init__()
        self.batchnorm = nn.BatchNorm1d(channels, eps=BN_EPS, affine=affine)


class _FcmBlock(nn.Module):
    """BasicResBlock: stride (stride, 1) on [B, C, F, T]."""

    def __init__(self, c_in, c_out, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, (stride, 1), 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.shortcut = nn.Sequential()
        if stride != 1 or c_in != c_out:
            self.shortcut = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, (stride, 1), bias=False),
                nn.BatchNorm2d(c_out, eps=BN_EPS))

    def forward(self, x):
        out = torch.relu(_bn(self.conv1(x), self.bn1))
        out = _bn(self.conv2(out), self.bn2)
        sc = _bn(self.shortcut[0](x), self.shortcut[1]) if len(self.shortcut) else x
        return torch.relu(out + sc)


class _Head(nn.Module):
    def __init__(self, mc):
        super().__init__()
        self.conv1 = nn.Conv2d(1, mc, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mc, eps=BN_EPS)
        self.layer1 = nn.Sequential(_FcmBlock(mc, mc, 2), _FcmBlock(mc, mc, 1))
        self.layer2 = nn.Sequential(_FcmBlock(mc, mc, 2), _FcmBlock(mc, mc, 1))
        self.conv2 = nn.Conv2d(mc, mc, 3, (2, 1), 1, bias=False)
        self.bn2 = nn.BatchNorm2d(mc, eps=BN_EPS)

    def forward(self, x):  # [B, 1, F, T] -> [B, C * F / 8, T]
        x = torch.relu(_bn(self.conv1(x), self.bn1))
        for blk in (*self.layer1, *self.layer2):
            x = blk(x)
        x = torch.relu(_bn(self.conv2(x), self.bn2))
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)


class _Linear(nn.Module):
    """A `linear` Conv1d child and a `nonlinear` BatchNorm(-ReLU) child, as
    the TDNN, transition and dense layers of the upstream tree have them."""

    def __init__(self, c_in, c_out, bn_ch, kernel=1, stride=1, affine=True):
        super().__init__()
        self.linear = nn.Conv1d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                                bias=False)
        self.nonlinear = _BnRelu(bn_ch, affine=affine)


class _CamLayer(nn.Module):
    def __init__(self, bn_ch, out_ch, kernel, dilation):
        super().__init__()
        self.linear_local = nn.Conv1d(bn_ch, out_ch, kernel,
                                      padding=(kernel - 1) // 2 * dilation,
                                      dilation=dilation, bias=False)
        self.linear1 = nn.Conv1d(bn_ch, bn_ch // 2, 1)
        self.linear2 = nn.Conv1d(bn_ch // 2, out_ch, 1)


class _DenseLayer(nn.Module):
    def __init__(self, in_ch, growth, bn_ch, kernel, dilation):
        super().__init__()
        self.nonlinear1 = _BnRelu(in_ch)
        self.linear1 = nn.Conv1d(in_ch, bn_ch, 1, bias=False)
        self.nonlinear2 = _BnRelu(bn_ch)
        self.cam_layer = _CamLayer(bn_ch, growth, kernel, dilation)


class Campp(nn.Module):
    def __init__(self, cfg: CamppConfig = CamppConfig()):
        super().__init__()
        self.cfg = cfg
        self.head = _Head(cfg.m_channels)
        xv = nn.Module()
        xv.tdnn = _Linear(cfg.m_channels * (cfg.num_mels // 8), cfg.init_channels,
                          cfg.init_channels, kernel=5, stride=2)
        c = cfg.init_channels
        for i, (n_layers, dil) in enumerate(zip(cfg.block_layers, cfg.dilations)):
            block = nn.Module()
            for j in range(n_layers):
                setattr(block, f"tdnnd{j + 1}", _DenseLayer(
                    c, cfg.growth_rate, cfg.bottleneck, cfg.kernel, dil))
                c += cfg.growth_rate
            setattr(xv, f"block{i + 1}", block)
            setattr(xv, f"transit{i + 1}", _Linear(c, c // 2, c))
            c //= 2
        xv.out_nonlinear = _BnRelu(c)
        xv.dense = _Linear(2 * c, cfg.embed_dim, cfg.embed_dim, affine=False)
        self.xvector = xv

    @property
    def device(self) -> torch.device:
        return self.head.conv1.weight.device

    def to(self, *args, **kwargs) -> "Campp":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    @torch.no_grad()
    def forward(self, fbank: torch.Tensor, mask: torch.Tensor | None = None):
        """fbank [B, T, num_mels] (CMVN applied by the caller), mask an
        optional [B, T] validity mask -> [B, embed_dim]."""
        if fbank.device.type == "cuda":
            _check_full_fp32()
        cfg, xv = self.cfg, self.xvector
        h = self.head(fbank.transpose(1, 2)[:, None])            # [B, C*F', T]
        h = torch.relu(_bn(xv.tdnn.linear(h), xv.tdnn.nonlinear.batchnorm))
        b, _, t2 = h.shape
        if mask is not None:
            msk = mask[:, : 2 * t2: 2].to(h.dtype)
            if msk.shape[1] < t2:
                msk = F.pad(msk, (0, t2 - msk.shape[1]))
        else:
            msk = torch.ones((b, t2), dtype=h.dtype, device=h.device)
        msk = msk[:, None, :]                                    # [B, 1, T2]
        count = msk.sum(dim=2)                                   # [B, 1]
        n_seg = -(-t2 // cfg.seg_len)
        seg_pad = n_seg * cfg.seg_len - t2
        seg_count = F.pad(msk, (0, seg_pad)).reshape(b, 1, n_seg, cfg.seg_len).sum(3)
        seg_count = seg_count.clamp_min(1e-6)                    # [B, 1, n_seg]

        for i, n_layers in enumerate(cfg.block_layers):
            block = getattr(xv, f"block{i + 1}")
            for j in range(n_layers):
                layer = getattr(block, f"tdnnd{j + 1}")
                x1 = torch.relu(_bn(h, layer.nonlinear1.batchnorm))
                x2 = torch.relu(_bn(layer.linear1(x1), layer.nonlinear2.batchnorm))
                cam = layer.cam_layer
                y = cam.linear_local(x2)
                xm = x2 * msk
                mean = xm.sum(dim=2, keepdim=True) / count.clamp_min(1e-6)[..., None]
                seg = F.pad(xm, (0, seg_pad)).reshape(b, -1, n_seg, cfg.seg_len).sum(3)
                ctx = mean + seg / seg_count                     # [B, C, n_seg]
                gate = torch.sigmoid(cam.linear2(torch.relu(cam.linear1(ctx))))
                gate = gate.repeat_interleave(cfg.seg_len, dim=2)[..., :t2]
                h = torch.cat([h, y * gate], dim=1)
            tr = getattr(xv, f"transit{i + 1}")
            h = tr.linear(torch.relu(_bn(h, tr.nonlinear.batchnorm)))

        h = torch.relu(_bn(h, xv.out_nonlinear.batchnorm))
        n = count.clamp_min(1e-6)
        mean = (h * msk).sum(dim=2) / n
        var = (h * h * msk).sum(dim=2) / n - mean * mean
        n_valid = count.clamp_min(2.0)
        var = var * n_valid / (n_valid - 1.0)
        stats = torch.cat([mean, torch.sqrt(var.clamp_min(0.0))], dim=1)
        emb = F.linear(stats, xv.dense.linear.weight[:, :, 0])
        return _bn(emb, xv.dense.nonlinear.batchnorm)


def random_campp(cfg: CamppConfig = CamppConfig(), seed: int = 1, device="cuda",
                 generator: torch.Generator | None = None) -> Campp:
    """Random weights with the JAX package's init scheme: convolutions and
    linears N(0, 1/fan_in), biases zero, BatchNorm at identity statistics.
    Values come from `generator`, or from a CPU generator seeded with `seed`;
    the model goes to `device`, the card by default (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = Campp(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                m.weight.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(math.prod(m.weight.shape[1:])))
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device)
