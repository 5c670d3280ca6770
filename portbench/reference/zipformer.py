"""Zipformer2 encoder (icefall's Zipformer2, as the sherpa-onnx Vietnamese
models export it), plain float32, one utterance at its exact length.

Conv2dSubsampling (three 3x3 convs with SwooshR, a 7x7 depthwise ConvNeXt
block with SwooshL, a linear to the first width, BiasNorm) at 50 Hz; six
stacks at downsampling factors (1, 2, 4, 8, 4, 2), each a softmax-weighted
downsample, its layers and a repeat upsample with a bypass; the widest
stacks' channels concatenated; a final x2 downsample to 25 Hz.

A layer: relative-position attention weights (content q.k plus a compact
relative position embedding projected per head; stored in bfloat16 where
the configuration's "attention_weights" says so, as the published
kernel stores them) shared by a nonlinear attention and two
self-attentions; three feed-forwards (SwooshL); two
convolution modules (GLU gate, depthwise conv, SwooshR); a mid and an
outer bypass; BiasNorm.

Weights by name, as the PyTorch module tree names them:
encoder_embed.*, stacks.{i}.layers.{j}.*, stacks.{i}.downsample.weights,
stacks.{i}.out_bypass_scale, downsample_output.weights.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision


def swoosh_l(x):
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(W, name, x):
    d = x - W[f"{name}.bias"]
    return x * torch.exp(W[f"{name}.log_scale"]) / torch.sqrt((d * d).mean(-1, keepdim=True) + 1e-12)


def lin(P: Precision, W, name, x):
    return P.linear(x, W[f"{name}.weight"], W.get(f"{name}.bias"))


@functools.lru_cache(maxsize=64)
def rel_pos_table(t: int, pos_dim: int) -> np.ndarray:
    """[2T-1, pos_dim] compact relative position embedding of offsets
    -(T-1) .. T-1: log-compressed offsets through atan, then cos/sin of
    pos_dim / 2 frequencies."""
    x = np.arange(-(t - 1), t, dtype=np.float64)[:, None]
    c = math.sqrt(pos_dim)
    xc = c * np.sign(x) * (np.log(np.abs(x) + c) - math.log(c))
    ang = np.arctan(xc / c) * np.arange(1, pos_dim // 2 + 1, dtype=np.float64)[None, :]
    pe = np.zeros((2 * t - 1, pos_dim), np.float32)
    pe[:, 0::2] = np.cos(ang)
    pe[:, 1::2] = np.sin(ang)
    return pe


def embed(P, W, cfg, feats):
    """[1, T, 80] -> [1, (T-7)//2, D0]."""
    p = "encoder_embed"
    h = swoosh_r(P.conv2d(feats[:, None], W[f"{p}.conv1.weight"], W[f"{p}.conv1.bias"], padding=(0, 1)))
    h = swoosh_r(P.conv2d(h, W[f"{p}.conv2.weight"], W[f"{p}.conv2.bias"], stride=2))
    h = swoosh_r(P.conv2d(h, W[f"{p}.conv3.weight"], W[f"{p}.conv3.bias"], stride=(1, 2)))
    g = P.conv2d(h, W[f"{p}.convnext_dw.weight"], W[f"{p}.convnext_dw.bias"], padding=3,
                 groups=h.shape[1]).permute(0, 2, 3, 1)
    g = lin(P, W, f"{p}.convnext_pw2", swoosh_l(lin(P, W, f"{p}.convnext_pw1", g)))
    h = h + g.permute(0, 3, 1, 2)
    b, c, t, f = h.shape
    h = h.permute(0, 2, 1, 3).reshape(b, t, c * f)  # channel-major features
    return bias_norm(W, f"{p}.out_norm", lin(P, W, f"{p}.out", h))


def attention(P, W, name, x, heads, cfg):
    """[B, H, T, S] weights: softmax over keys s of q_t.k_s + pq_t.Wpos
    pe(t - s)."""
    b, t, _ = x.shape
    qd, pd = cfg["query_head_dim"], cfg["pos_head_dim"]
    proj = lin(P, W, f"{name}.attn_in_proj", x)
    q = proj[..., : heads * qd].reshape(b, t, heads, qd)
    k = proj[..., heads * qd: 2 * heads * qd].reshape(b, t, heads, qd)
    pq = proj[..., 2 * heads * qd:].reshape(b, t, heads, pd)
    pe = torch.from_numpy(rel_pos_table(t, cfg["pos_dim"])).to(x.device)
    pos = P.linear(pe, W[f"{name}.attn_pos_proj.weight"]).reshape(2 * t - 1, heads, pd)
    band = P.einsum("bthd,mhd->bhtm", pq, pos)                # [B, H, T, 2T-1]
    ar = torch.arange(t, device=x.device)
    idx = (ar[:, None] - ar[None, :] + t - 1).expand(b, heads, t, t)
    scores = P.einsum("bthd,bshd->bhts", q, k) + torch.gather(band, 3, idx)
    w = torch.softmax(scores, dim=-1)
    return w.to(torch.bfloat16).float() if cfg.get("attention_weights") == "bfloat16" else w


def conv_module(P, W, name, x):
    v, g = lin(P, W, f"{name}.in_proj", x).chunk(2, dim=-1)
    h = (v * torch.sigmoid(g)).transpose(1, 2)
    w = W[f"{name}.dw_weight"]
    h = P.conv1d(h, w, W[f"{name}.dw_bias"], padding=(w.shape[-1] - 1) // 2,
                 groups=h.shape[1]).transpose(1, 2)
    return lin(P, W, f"{name}.out_proj", swoosh_r(h))


def feed_forward(P, W, name, x):
    return lin(P, W, f"{name}.out_proj", swoosh_l(lin(P, W, f"{name}.in_proj", x)))


def self_attention(P, W, name, x, a, heads, vd):
    b, t, _ = x.shape
    v = lin(P, W, f"{name}.in_proj", x).reshape(b, t, heads, vd)
    out = P.einsum("bhts,bshd->bthd", a, v).reshape(b, t, heads * vd)
    return lin(P, W, f"{name}.out_proj", out)


def nonlin_attention(P, W, name, x, a0):
    s, v, y = lin(P, W, f"{name}.in_proj", x).chunk(3, dim=-1)
    return lin(P, W, f"{name}.out_proj", P.einsum("bts,bsd->btd", a0, torch.tanh(s) * v) * y)


def bypass(scale, x_orig, x):
    return x_orig + (x - x_orig) * torch.clamp(scale, 0.0, 1.0)


def layer(P, W, name, x, heads, cfg):
    x_orig = x
    a = attention(P, W, name, x, heads, cfg)
    x = x + feed_forward(P, W, f"{name}.ff1", x)
    x = x + nonlin_attention(P, W, f"{name}.nonlin_attn", x, a[:, 0])
    x = x + self_attention(P, W, f"{name}.self_attn1", x, a, heads, cfg["value_head_dim"])
    x = x + conv_module(P, W, f"{name}.conv1", x)
    x = x + feed_forward(P, W, f"{name}.ff2", x)
    x = bypass(W[f"{name}.bypass_mid_scale"], x_orig, x)
    x = x + self_attention(P, W, f"{name}.self_attn2", x, a, heads, cfg["value_head_dim"])
    x = x + conv_module(P, W, f"{name}.conv2", x)
    x = x + feed_forward(P, W, f"{name}.ff3", x)
    return bypass(W[f"{name}.bypass_scale"], x_orig, bias_norm(W, f"{name}.norm", x))


def downsample(weights, x, ds):
    """Softmax-weighted mean of groups of ds frames; the last group padded
    by repeating the last frame."""
    if ds == 1:
        return x
    b, t, d = x.shape
    pad = (-t) % ds
    if pad:
        x = torch.cat([x, x[:, -1:].expand(b, pad, d)], dim=1)
    return torch.einsum("bgkd,k->bgd", x.reshape(b, -1, ds, d), torch.softmax(weights, 0))


def channels(x, d):
    cur = x.shape[-1]
    return x if d == cur else (x[..., :d] if d < cur else F.pad(x, (0, d - cur)))


def merge_stacks(outputs, dims, out_dim):
    """The widest channels of the stacks, newest stack first."""
    pieces, cur = [outputs[-1]], dims[-1]
    for i in range(len(outputs) - 2, -1, -1):
        if dims[i] > cur:
            pieces.append(outputs[i][..., cur: dims[i]])
            cur = dims[i]
    full = torch.cat(pieces, dim=-1)
    return F.pad(full, (0, out_dim - full.shape[-1])) if full.shape[-1] < out_dim else full


def encoder(P: Precision, W, cfg, feats):
    """[T, 80] fbank of one utterance -> [ceil(((T-7)//2)/2), max width]."""
    dims = cfg["encoder_dim"]
    with P.active():
        h = embed(P, W, cfg, feats[None])
        t_full = h.shape[1]
        outputs = []
        for i, n_layers in enumerate(cfg["num_encoder_layers"]):
            ds = cfg["downsampling_factor"][i]
            h = channels(h, dims[i])
            hs = downsample(W[f"stacks.{i}.downsample.weights"], h, ds)
            for j in range(n_layers):
                hs = layer(P, W, f"stacks.{i}.layers.{j}", hs, cfg["num_heads"][i], cfg)
            hs = torch.repeat_interleave(hs, ds, dim=1)[:, :t_full] if ds > 1 else hs
            h = bypass(W[f"stacks.{i}.out_bypass_scale"], h, hs) if ds != 1 else hs
            outputs.append(h)
        full = merge_stacks(outputs, dims, max(dims))
        return downsample(W["downsample_output.weights"], full, 2)[0]


def output_frames(t_fbank: int) -> int:
    return (max(0, (t_fbank - 7) // 2) + 1) // 2
