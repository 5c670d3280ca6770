# ResNet34 speaker-embedding frame encoder (wespeaker ResNet34-LM, as
# pyannote Community-1 wraps it) in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/resnet_speaker.py. The module
# keeps the upstream wespeaker layout: the [B, T, 80] fbank enters as a
# one-channel image [B, 1, F, T], conv kernels are [O, I, kF, kT], and the
# state-dict keys are the export's names (resnet.conv1.weight,
# resnet.layer2.0.shortcut.1.running_var, resnet.seg_1.weight, ...).
# Stages of (3, 4, 6, 3) blocks with 32/64/128/256 channels, stride 2 on
# the first block of the last three. Frame features come out in the JAX
# package's order, [B, C * F', T'] with the channel major; masked statistics
# pooling (ops/stats_pool.py) and the final 5120 -> 256 projection (seg_1,
# the split Gemm) turn them into one embedding per (chunk, speaker).
#
# Inference only: each BatchNorm is folded into the convolution before it
# (eval statistics), so a block runs two cuDNN convolutions with bias. The
# JAX package has no Pallas kernel here (XLA convolutions); on the card the
# convolutions run in full float32, and the forward refuses to run with TF32
# on (models.zipformer.use_full_fp32). Each stride-1 convolution sees its
# time axis zero-padded to a multiple of TIME_ALIGN and its output sliced
# back, which computes the same values: on an NVIDIA H100, cuDNN's float32
# kernels at the third stage's width of 250 frames run 11-17x slower for
# batches of 8 or more than at 256, and elsewhere the pad costs 5-20%
# (tools/conv_sweep.py).

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
TIME_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class ResNetSpeakerConfig:
    num_mels: int = 80
    base_channels: int = 32
    blocks: tuple = (3, 4, 6, 3)
    embed_dim: int = 256

    @property
    def frame_feature_dim(self) -> int:
        return self.base_channels * 8 * (self.num_mels // 8)  # 256 * 10

    def out_time(self, t: int) -> int:
        """Output frame count for t input frames (3 stride-2 stages,
        k=3 / pad=1 convs: t -> (t-1)//2 + 1 per stage)."""
        for _ in range(3):
            t = (t - 1) // 2 + 1
        return t


TINY_RESNET = ResNetSpeakerConfig(base_channels=8, blocks=(1, 1, 1, 1),
                                  embed_dim=32)


class _Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.shortcut = nn.Sequential()
        if stride != 1 or c_in != c_out:
            self.shortcut = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                nn.BatchNorm2d(c_out, eps=BN_EPS))


class _ResNet(nn.Module):
    def __init__(self, cfg: ResNetSpeakerConfig):
        super().__init__()
        bc = cfg.base_channels
        self.conv1 = nn.Conv2d(1, bc, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(bc, eps=BN_EPS)
        c_in = bc
        for stage, n_blocks in enumerate(cfg.blocks):
            c_out = bc * (2 ** stage)
            blocks = []
            for b in range(n_blocks):
                blocks.append(_Block(c_in, c_out, 2 if (stage > 0 and b == 0) else 1))
                c_in = c_out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.seg_1 = nn.Linear(2 * cfg.frame_feature_dim, cfg.embed_dim)


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """(weight, bias) of conv followed by bn with its running statistics."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return (conv.weight * scale[:, None, None, None],
            bn.bias - bn.running_mean * scale)


class ResNetSpeaker(nn.Module):
    def __init__(self, cfg: ResNetSpeakerConfig = ResNetSpeakerConfig()):
        super().__init__()
        self.cfg = cfg
        self.resnet = _ResNet(cfg)
        self._folded = (None, None)  # (key, [(weight, bias, stride, padding)])

    @property
    def device(self) -> torch.device:
        return self.resnet.seg_1.weight.device

    def to(self, *args, **kwargs) -> "ResNetSpeaker":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    def folded_convs(self):
        """Every convolution with its BatchNorm folded in, in forward order:
        conv1, then per block conv1, conv2 and (where it has one) the
        shortcut. Built on first use and kept until a parameter or buffer is
        moved or changed in place."""
        tensors = list(self.parameters()) + list(self.buffers())
        key = tuple((id(t), t.data_ptr(), t._version) for t in tensors)
        if self._folded[0] != key:
            r = self.resnet
            convs = [(r.conv1, r.bn1)]
            for stage in range(len(self.cfg.blocks)):
                for blk in getattr(r, f"layer{stage + 1}"):
                    convs += [(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)]
                    if len(blk.shortcut):
                        convs.append((blk.shortcut[0], blk.shortcut[1]))
            with torch.no_grad():
                folded = [(*_fold(c, bn), c.stride, c.padding) for c, bn in convs]
            self._folded = (key, folded)
        return self._folded[1]

    def resnet_frame_features(self, fbank: torch.Tensor) -> torch.Tensor:
        """[B, T, M] fbank -> [B, C * M', T'] frame features."""
        if fbank.device.type == "cuda":
            _check_full_fp32()
        convs = iter(self.folded_convs())

        def conv(x):
            w, b, stride, padding = next(convs)
            pad = (-x.shape[-1]) % TIME_ALIGN if stride == (1, 1) else 0
            if pad:
                return F.conv2d(F.pad(x, (0, pad)), w, b, stride, padding)[..., : x.shape[-1]]
            return F.conv2d(x, w, b, stride, padding)

        x = torch.relu(conv(fbank.transpose(1, 2)[:, None]))         # [B, C, F, T]
        for stage in range(len(self.cfg.blocks)):
            for blk in getattr(self.resnet, f"layer{stage + 1}"):
                h = conv(torch.relu(conv(x)))
                x = torch.relu(h + (conv(x) if len(blk.shortcut) else x))
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)

    def project_embedding(self, stats: torch.Tensor) -> torch.Tensor:
        """[..., 2D] pooled statistics -> [..., embed_dim]."""
        return self.resnet.seg_1(stats)


def random_resnet_speaker(cfg: ResNetSpeakerConfig = ResNetSpeakerConfig(),
                          seed: int = 1, device="cuda",
                          generator: torch.Generator | None = None) -> ResNetSpeaker:
    """Random weights with the JAX package's init scheme: convolutions and
    the projection N(0, 1/fan_in), BatchNorm at identity statistics, the
    projection's bias zero. Values come from `generator`, or from a CPU
    generator seeded with `seed`; the model goes to `device`, the card by
    default (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = ResNetSpeaker(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(math.prod(m.weight.shape[1:])))
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device)
