# Zipformer2 encoder as PyTorch modules.
#
# Port of sherpa_vietnamese_asr_tpu/models/zipformer.py (same architecture,
# configs and numerics): Conv2dSubsampling (+ConvNeXt) -> 6 encoder stacks at
# downsampling factors (1,2,4,8,4,2) with bypass-combined outputs ->
# full-dim concat -> final x2 downsample. BiasNorm, SwooshL/SwooshR,
# attention weights shared between two self-attention modules, a
# single-head NonlinAttention and two convolution modules per layer.
#
# Linear weights are torch's [out, in]; models/convert.py maps the JAX
# package's [in, out] trees onto these modules. Padding masks carry
# per-sequence lengths. The attention weights come from
# ops/attention.attention_weights (a hand-written kernel on CUDA).
#
# Two compute tiers, as in the JAX package: float32 (full fp32, no TF32), and
# bfloat16, where master weights stay float32 and every product casts its
# operands per use. In bfloat16 a stack runs either the plain layer
# (ZipformerLayer.forward, the JAX package's encoder_layer in bf16) or the
# whole-layer kernel ops/encoder_layer.encoder_layer on a 128-padded
# sequence; use_layer_kernel() decides.

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.ops.attention import attention_weights
from sherpa_vietnamese_asr_tpu_torch.ops.encoder_layer import (
    R as LAYER_ROWS,
    encoder_layer,
)


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    num_features: int = 80
    # Per-stack settings (6 stacks)
    num_encoder_layers: Sequence[int] = (2, 2, 3, 4, 3, 2)
    downsampling_factor: Sequence[int] = (1, 2, 4, 8, 4, 2)
    encoder_dim: Sequence[int] = (192, 256, 256, 256, 256, 256)
    ffn_dim: Sequence[int] = (512, 768, 768, 768, 768, 768)
    num_heads: Sequence[int] = (4, 4, 4, 8, 4, 4)
    cnn_module_kernel: Sequence[int] = (31, 31, 15, 15, 15, 31)
    query_head_dim: int = 32
    pos_head_dim: int = 4
    value_head_dim: int = 12
    pos_dim: int = 48
    # dtype of the relative-position scores on the plain (CPU) path; the
    # CUDA attention kernel always computes them in float32.
    pos_dtype: str = "bfloat16"
    # Kept for field-name parity with the JAX config; this package always
    # takes the attention kernel on CUDA.
    attention_kernel: str = "auto"
    # Whole-layer kernel (ops/encoder_layer.py): "auto" takes it for every
    # stack on CUDA in bfloat16, "never"/"always" force (see
    # use_layer_kernel).
    layer_kernel: str = "auto"
    # Conv2dSubsampling channels
    embed_layer1_channels: int = 8
    embed_layer2_channels: int = 32
    embed_layer3_channels: int = 128
    # "float32" or "bfloat16" (the JAX package's serving tier).
    compute_dtype: str = "float32"
    # Kept for field-name parity; float32 here is always full fp32 (no TF32).
    matmul_precision: str = "high"

    @property
    def output_dim(self) -> int:
        return max(self.encoder_dim)

    def output_length(self, t_in: int) -> int:
        """fbank frames T -> encoder output frames (50Hz embed, final /2)."""
        t = (t_in - 7) // 2
        return (t + 1) // 2


ZIPFORMER_30M = ZipformerConfig()
ZIPFORMER_68M = ZipformerConfig(
    encoder_dim=(192, 256, 384, 512, 384, 256),
    ffn_dim=(512, 768, 1024, 1536, 1024, 768),
)


# ---------------------------------------------------------------------------
# Activations / normalization
# ---------------------------------------------------------------------------

def swoosh_l(x):
    """SwooshL(x) = log(1 + exp(x-4)) - 0.08x - 0.035."""
    return torch.logaddexp(torch.zeros_like(x), x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    """SwooshR(x) = log(1 + exp(x-1)) - 0.08x - 0.313261687."""
    return torch.logaddexp(torch.zeros_like(x), x - 1.0) - 0.08 * x - 0.313261687


class BiasNorm(nn.Module):
    """x * exp(log_scale) / rms(x - bias). No per-channel affine scale."""

    def __init__(self, d, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.log_scale = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x):
        d = x - self.bias
        rms = torch.sqrt(torch.mean(d * d, dim=-1, keepdim=True) + 1e-12)
        return x * (torch.exp(self.log_scale) / rms)


def _linear(d_in, d_out, device, bias=True):
    return nn.Linear(d_in, d_out, bias=bias, device=device)


def _lin(linear: nn.Linear, x, dt):
    """The JAX package's linear() in compute dtype dt: float32 is the module
    itself; bfloat16 rounds the product to bf16, then adds the bias in bf16."""
    if dt == torch.float32:
        return linear(x)
    y = x.to(dt) @ linear.weight.to(dt).t()
    return y if linear.bias is None else y + linear.bias.to(dt)


def _conv(conv: nn.Conv2d, x, dt):
    """Conv2d in compute dtype dt; bfloat16 adds the bias in bf16 after the
    rounded convolution, like the JAX package's embed."""
    if dt == torch.float32:
        return conv(x)
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y + conv.bias.to(dt)[:, None, None]


def use_full_fp32():
    """The float32 tier's policy on CUDA: products and convolutions in full
    float32, never TF32 (cuDNN convolutions default to TF32). These are
    process-wide torch.backends flags; AsrModel.to() sets them once when a
    model is placed on a card, and the encoder refuses to run with them on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_full_fp32():
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "the float32 tier runs without TF32: call "
            "models.zipformer.use_full_fp32() before running on CUDA")


# ---------------------------------------------------------------------------
# Conv2dSubsampling (+ ConvNeXt)   T -> (T-7)//2, 80 freq -> 19
# ---------------------------------------------------------------------------

class EncoderEmbed(nn.Module):
    def __init__(self, cfg: ZipformerConfig, device=None):
        super().__init__()
        c1, c2, c3 = (cfg.embed_layer1_channels, cfg.embed_layer2_channels,
                      cfg.embed_layer3_channels)
        freq_out = (((cfg.num_features - 1) // 2) - 1) // 2  # 80 -> 19
        # conv1: k3x3, time valid, freq same-pad
        self.conv1 = nn.Conv2d(1, c1, 3, padding=(0, 1), device=device)
        self.conv2 = nn.Conv2d(c1, c2, 3, stride=2, device=device)
        self.conv3 = nn.Conv2d(c2, c3, 3, stride=(1, 2), device=device)
        self.convnext_dw = nn.Conv2d(c3, c3, 7, padding=3, groups=c3,
                                     device=device)
        self.convnext_pw1 = _linear(c3, 3 * c3, device)
        self.convnext_pw2 = _linear(3 * c3, c3, device)
        self.out = _linear(c3 * freq_out, cfg.encoder_dim[0], device)
        self.out_norm = BiasNorm(cfg.encoder_dim[0], device)

    def forward(self, x, out_lens, dt=torch.float32):
        """[B, T, 80] -> [B, (T-7)//2, encoder_dim[0]] float32.

        out_lens: [B] valid output frames; frames past them are zeroed before
        the ConvNeXt block so its padded conv sees what an exact-length run
        would. dt: compute dtype of the convolutions and linears.
        """
        h = swoosh_r(_conv(self.conv1, x[:, None], dt))  # [B, C1, T-2, F]
        h = swoosh_r(_conv(self.conv2, h, dt))
        h = swoosh_r(_conv(self.conv3, h, dt))           # [B, C3, T', F']
        t_mask = torch.arange(h.shape[2], device=h.device)[None, :] \
            < out_lens[:, None]
        h = torch.where(t_mask[:, None, :, None], h, 0.0)
        g = _conv(self.convnext_dw, h, dt).permute(0, 2, 3, 1)  # [B, T', F', C3]
        g = _lin(self.convnext_pw2, swoosh_l(_lin(self.convnext_pw1, g, dt)), dt)
        h = h + g.permute(0, 3, 1, 2)
        b, c, bt, f = h.shape
        # flatten as [B, T', C*F'] (channel-major, like the JAX package)
        h = h.permute(0, 2, 1, 3).reshape(b, bt, c * f)
        return self.out_norm(_lin(self.out, h, dt).float())


# ---------------------------------------------------------------------------
# Relative positional encoding (CompactRelPositionalEncoding)
# ---------------------------------------------------------------------------

def _padded_rev_pos_emb(t: int, t_pad: int, pos_dim: int,
                        r: int = LAYER_ROWS) -> np.ndarray:
    """[2*t_pad-1+r, pos_dim] REVERSED, zero-extended position table of the
    whole-layer kernel: row j' holds offset o = (t_pad-1) - j' for the
    original offsets |o| < t, zeros elsewhere."""
    pe = compact_rel_pos_emb(t, pos_dim)
    full = np.zeros((2 * t_pad - 1 + r, pos_dim), np.float32)
    full[t_pad - t: t_pad - t + 2 * t - 1] = pe[::-1]
    return full


def compact_rel_pos_emb(t: int, pos_dim: int) -> np.ndarray:
    """[2T-1, pos_dim] compact relative positional embedding (numpy)."""
    x = np.arange(-(t - 1), t, dtype=np.float64)[:, None]  # [2T-1, 1]
    compression = math.sqrt(pos_dim)
    xc = compression * np.sign(x) * (np.log(np.abs(x) + compression)
                                     - math.log(compression))
    x_atan = np.arctan(xc / compression)
    freqs = np.arange(1, pos_dim // 2 + 1, dtype=np.float64)[None, :]
    pe = np.zeros((2 * t - 1, pos_dim), dtype=np.float32)
    pe[:, 0::2] = np.cos(x_atan * freqs)
    pe[:, 1::2] = np.sin(x_atan * freqs)
    return pe


# ---------------------------------------------------------------------------
# Encoder layer submodules
# ---------------------------------------------------------------------------

class FeedForward(nn.Module):
    def __init__(self, d, hidden, device=None):
        super().__init__()
        self.in_proj = _linear(d, hidden, device)
        self.out_proj = _linear(hidden, d, device)

    def forward(self, x, dt=torch.float32):
        h = swoosh_l(_lin(self.in_proj, x, dt))
        return _lin(self.out_proj, h, dt).float()


class SelfAttention(nn.Module):
    def __init__(self, d, heads, vd, device=None):
        super().__init__()
        self.heads, self.vd = heads, vd
        self.in_proj = _linear(d, heads * vd, device)
        self.out_proj = _linear(heads * vd, d, device)

    def forward(self, x, attn_w, dt=torch.float32):
        """attn_w: [B, H, S, T] keys-major."""
        b, t, _ = x.shape
        v = _lin(self.in_proj, x, dt).reshape(b, t, self.heads, self.vd)
        out = torch.einsum("bhst,bshd->bthd", attn_w.to(dt), v)
        return _lin(self.out_proj, out.reshape(b, t, self.heads * self.vd),
                    dt).float()


class NonlinAttention(nn.Module):
    """Gated single-head attention (uses head 0's weights)."""

    def __init__(self, d, device=None):
        super().__init__()
        hidden = 3 * d // 4
        self.in_proj = _linear(d, 3 * hidden, device)
        self.out_proj = _linear(hidden, d, device)

    def forward(self, x, attn_w1, dt=torch.float32):
        """attn_w1: [B, S, T] keys-major."""
        s, v, y = _lin(self.in_proj, x, dt).chunk(3, dim=-1)
        v = torch.tanh(s) * v
        out = torch.einsum("bst,bsd->btd", attn_w1.to(dt), v) * y
        return _lin(self.out_proj, out, dt).float()


class ConvModule(nn.Module):
    """GLU-style gate, depthwise conv over time (same pad), SwooshR."""

    def __init__(self, d, kernel, device=None):
        super().__init__()
        self.in_proj = _linear(d, 2 * d, device)
        self.dw_weight = nn.Parameter(torch.empty(d, 1, kernel, device=device))
        self.dw_bias = nn.Parameter(torch.zeros(d, device=device))
        self.out_proj = _linear(d, d, device)

    def forward(self, x, pad_mask, dt=torch.float32):
        v, g = _lin(self.in_proj, x, dt).chunk(2, dim=-1)
        h = v * torch.sigmoid(g)
        h = h.masked_fill(pad_mask[:, :, None], 0.0)
        k = self.dw_weight.shape[-1]
        f32 = dt == torch.float32  # bf16 adds the bias after the rounded conv
        h = F.conv1d(h.transpose(1, 2), self.dw_weight.to(dt),
                     self.dw_bias if f32 else None,
                     padding=(k - 1) // 2, groups=h.shape[-1]).transpose(1, 2)
        if not f32:
            h = h + self.dw_bias.to(dt)
        return _lin(self.out_proj, swoosh_r(h), dt).float()


def _bypass(scale, x_orig, x):
    return x_orig + (x - x_orig) * torch.clamp(scale, 0.0, 1.0)


class ZipformerLayer(nn.Module):
    def __init__(self, d, ff, heads, kernel, cfg: ZipformerConfig,
                 device=None):
        super().__init__()
        qd, pd, vd = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim
        self.cfg, self.heads = cfg, heads
        self.attn_in_proj = _linear(d, heads * (2 * qd + pd), device)
        self.attn_pos_proj = _linear(cfg.pos_dim, heads * pd, device,
                                     bias=False)
        self.self_attn1 = SelfAttention(d, heads, vd, device)
        self.self_attn2 = SelfAttention(d, heads, vd, device)
        self.ff1 = FeedForward(d, (ff * 3) // 4, device)
        self.ff2 = FeedForward(d, ff, device)
        self.ff3 = FeedForward(d, (ff * 5) // 4, device)
        self.nonlin_attn = NonlinAttention(d, device)
        self.conv1 = ConvModule(d, kernel, device)
        self.conv2 = ConvModule(d, kernel, device)
        self.norm = BiasNorm(d, device)
        self.bypass_scale = nn.Parameter(torch.full((d,), 0.5, device=device))
        self.bypass_mid_scale = nn.Parameter(
            torch.full((d,), 0.5, device=device))
        self._kernel_layout = (None, None)  # (key, tensors)

    def attention_weights(self, x, pos_emb, lens, dt=torch.float32):
        """Shared weights [B, H, S, T] keys-major, in dt."""
        b, t, _ = x.shape
        h, qd, pd = self.heads, self.cfg.query_head_dim, self.cfg.pos_head_dim
        proj = _lin(self.attn_in_proj, x, dt)
        q = proj[..., : h * qd].reshape(b, t, h, qd)
        k = proj[..., h * qd: 2 * h * qd].reshape(b, t, h, qd)
        pq = proj[..., 2 * h * qd:].reshape(b, t, h, pd)
        w = attention_weights(q, k, pq, self.attn_pos_proj.weight.t(),
                              pos_emb, lens,
                              pos_dtype=getattr(torch, self.cfg.pos_dtype))
        return w.to(dt)

    def forward(self, x, pos_emb, lens, pad_mask):
        """The plain layer (the JAX package's encoder_layer) in the config's
        compute dtype. x: [B, T, D] float32."""
        dt = getattr(torch, self.cfg.compute_dtype)
        x_orig = x
        attn_w = self.attention_weights(x, pos_emb, lens, dt)
        x = x + self.ff1(x, dt)
        x = x + self.nonlin_attn(x, attn_w[:, 0], dt)
        x = x + self.self_attn1(x, attn_w, dt)
        x = x + self.conv1(x, pad_mask, dt)
        x = x + self.ff2(x, dt)
        x = _bypass(self.bypass_mid_scale, x_orig, x)
        x = x + self.self_attn2(x, attn_w, dt)
        x = x + self.conv2(x, pad_mask, dt)
        x = x + self.ff3(x, dt)
        x = self.norm(x)
        return _bypass(self.bypass_scale, x_orig, x)

    def kernel_layout(self):
        """(flat, w_pos): the whole-layer kernel's operands, built on first
        use and kept until a parameter is moved or changed in place.

        flat: 42 contiguous tensors in the TPU kernel's order (bf16 weights
        [d_in, d_out] and [n] biases; depthwise kernels [K, D]; float32 norm
        bias, log-scale [1] and bypass scales). w_pos: [pos_dim, H*pd] f32.
        """
        params = list(self.parameters())
        key = tuple((id(p), p.data_ptr(), p._version) for p in params)
        if self._kernel_layout[0] != key:
            with torch.no_grad():
                self._kernel_layout = (key, self._build_kernel_layout())
        return self._kernel_layout[1]

    def _build_kernel_layout(self):
        b16, f32 = torch.bfloat16, torch.float32

        def lin(m):
            return [m.weight.detach().t().to(b16).contiguous(),
                    m.bias.detach().to(b16).contiguous()]

        def conv(c):
            return (lin(c.in_proj)
                    + [c.dw_weight.detach()[:, 0, :].t().to(b16).contiguous(),
                       c.dw_bias.detach().to(b16).contiguous()]
                    + lin(c.out_proj))

        flat = (lin(self.attn_in_proj)
                + lin(self.nonlin_attn.in_proj) + lin(self.nonlin_attn.out_proj)
                + lin(self.self_attn1.in_proj) + lin(self.self_attn1.out_proj)
                + lin(self.self_attn2.in_proj) + lin(self.self_attn2.out_proj)
                + lin(self.ff1.in_proj) + lin(self.ff1.out_proj)
                + lin(self.ff2.in_proj) + lin(self.ff2.out_proj)
                + lin(self.ff3.in_proj) + lin(self.ff3.out_proj)
                + conv(self.conv1) + conv(self.conv2)
                + [self.norm.bias.detach().to(f32).clone(),
                   self.norm.log_scale.detach().reshape(1).to(f32).clone(),
                   self.bypass_mid_scale.detach().to(f32).clone(),
                   self.bypass_scale.detach().to(f32).clone()])
        w_pos = self.attn_pos_proj.weight.detach().t().to(f32).contiguous()
        return tuple(flat), w_pos


# ---------------------------------------------------------------------------
# Down/upsampling between stacks
# ---------------------------------------------------------------------------

class SimpleDownsample(nn.Module):
    """[B, T, D] -> [B, ceil(T/ds), D]; softmax-weighted average in groups
    (the tail pads by repeating the last frame)."""

    def __init__(self, ds, device=None):
        super().__init__()
        self.ds = ds
        self.weights = nn.Parameter(torch.zeros(ds, device=device))

    def forward(self, x):
        if self.ds == 1:
            return x
        b, t, d = x.shape
        pad = (-t) % self.ds
        if pad:
            x = torch.cat([x, x[:, -1:, :].expand(b, pad, d)], dim=1)
        w = torch.softmax(self.weights, dim=0)
        return torch.einsum("bgkd,k->bgd", x.reshape(b, -1, self.ds, d), w)


def simple_upsample(x, ds):
    return x if ds == 1 else torch.repeat_interleave(x, ds, dim=1)


def _convert_channels(x, d):
    cur = x.shape[-1]
    if d == cur:
        return x
    if d < cur:
        return x[..., :d]
    return F.pad(x, (0, d - cur))


def _clamp_tail(x, lens):
    """Replace padded tail frames with copies of the last valid frame, as an
    exact-length run's repeat-last-frame downsample padding would see."""
    t = x.shape[1]
    idx = torch.minimum(torch.arange(t, device=x.device)[None, :],
                        torch.clamp_min(lens[:, None] - 1, 0))
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


class Stack(nn.Module):
    def __init__(self, i, cfg: ZipformerConfig, device=None):
        super().__init__()
        d, ff = cfg.encoder_dim[i], cfg.ffn_dim[i]
        self.ds = cfg.downsampling_factor[i]
        self.layers = nn.ModuleList(
            ZipformerLayer(d, ff, cfg.num_heads[i], cfg.cnn_module_kernel[i],
                           cfg, device)
            for _ in range(cfg.num_encoder_layers[i]))
        self.downsample = SimpleDownsample(self.ds, device)
        self.out_bypass_scale = nn.Parameter(
            torch.full((d,), 0.5, device=device))


def use_layer_kernel(cfg: ZipformerConfig, stack_idx: int, t_ds: int,
                     device_type: str) -> bool:
    """Whether stack `stack_idx` (t_ds frames) runs the whole-layer kernel.

    The JAX gate's meaning: "never" and "always" force; "auto" takes it on
    an accelerator in bfloat16 only. Its other conditions (a VMEM estimate,
    heads > 4, t_pad < 384) are limits of the TPU's VMEM and per-block
    overhead, not of this card, so "auto" on CUDA in bfloat16 takes the
    kernel on every stack. stack_idx and t_ds stay in the signature for that
    reason: they no longer change the answer.
    """
    if cfg.layer_kernel == "never":
        return False
    if cfg.layer_kernel == "always":
        return True
    if device_type == "cpu":
        return False
    return cfg.compute_dtype == "bfloat16"


class ZipformerEncoder(nn.Module):
    def __init__(self, cfg: ZipformerConfig = ZIPFORMER_30M, device=None):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: expected "
                             "'float32' or 'bfloat16'")
        self.cfg = cfg
        self.encoder_embed = EncoderEmbed(cfg, device)
        self.stacks = nn.ModuleList(Stack(i, cfg, device)
                                    for i in range(len(cfg.num_encoder_layers)))
        self.downsample_output = SimpleDownsample(2, device)

    def forward(self, x, x_lens):
        """x: [B, T, 80] float32 fbank; x_lens: [B] valid frames.

        Returns (encoder_out [B, T_out, output_dim] float32, out_lens [B]).
        """
        if x.device.type == "cuda":
            _check_full_fp32()
        with torch.no_grad():
            return self._forward(x, x_lens)

    def _forward(self, x, x_lens):
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        lens = torch.clamp_min(torch.div(x_lens - 7, 2, rounding_mode="floor"),
                               0)
        h = self.encoder_embed(x, lens, dt)  # [B, T', D0] float32
        t_full = h.shape[1]
        outputs = []
        for i, stack in enumerate(self.stacks):
            ds = stack.ds
            h = _clamp_tail(_convert_channels(h, cfg.encoder_dim[i]), lens)
            h_orig = h
            hs = stack.downsample(h)
            t_ds = hs.shape[1]
            stack_lens = torch.div(lens + ds - 1, ds, rounding_mode="floor")
            if use_layer_kernel(cfg, i, t_ds, h.device.type):
                tp = -(-t_ds // LAYER_ROWS) * LAYER_ROWS
                rev = torch.from_numpy(
                    _padded_rev_pos_emb(t_ds, tp, cfg.pos_dim)).to(h.device)
                hs_p = F.pad(hs, (0, 0, 0, tp - t_ds))
                for layer in stack.layers:
                    hs_p = encoder_layer(layer, hs_p, rev, stack_lens)
                hs = hs_p[:, :t_ds]
            else:
                pad_mask = torch.arange(t_ds, device=h.device)[None, :] \
                    >= stack_lens[:, None]
                pos_emb = torch.from_numpy(
                    compact_rel_pos_emb(t_ds, cfg.pos_dim)).to(h.device)
                for layer in stack.layers:
                    hs = layer(hs, pos_emb, stack_lens, pad_mask)
            hs = simple_upsample(hs, ds)[:, :t_full]
            h = _bypass(stack.out_bypass_scale, h_orig, hs) if ds != 1 else hs
            outputs.append(h)
        # Full-dim output: concat feature slices, newest stack first.
        pieces = [outputs[-1]]
        cur = cfg.encoder_dim[-1]
        for i in range(len(outputs) - 2, -1, -1):
            d = cfg.encoder_dim[i]
            if d > cur:
                pieces.append(outputs[i][..., cur:d])
                cur = d
        full = torch.cat(pieces, dim=-1)
        if full.shape[-1] < cfg.output_dim:
            full = F.pad(full, (0, cfg.output_dim - full.shape[-1]))
        # Final x2 downsample to 25 Hz (tail clamped for the boundary group)
        out = self.downsample_output(_clamp_tail(full, lens))
        out_lens = torch.div(lens + 1, 2, rounding_mode="floor")
        mask = torch.arange(out.shape[1], device=out.device)[None, :] \
            < out_lens[:, None]
        return torch.where(mask[:, :, None], out, 0.0), out_lens
