"""The streaming Zipformer2 step, plain float32: one 0.64 s chunk (64 fbank
frames with a 7-frame lookback, 32 frames at 50 Hz) of a batch of streams
against carried left-context caches, the same weights as the offline
encoder (portbench.reference.zipformer).

Per layer the state holds, at the stack's rate, the last L frames
(L = 128 / ds) of the layer input (keys and queries), of x after ff1 (the
nonlinear attention's values), after the nonlinear attention and after the
mid bypass (the two self-attentions' values), and the last kernel - 1
inputs of each convolution module, whose depthwise convolution is causal.
The embed keeps the last 7 fbank frames and 6 ConvNeXt input frames; its
7x7 ConvNeXt is causal in time. Attention is the chunk's queries against
cache and chunk keys, the position of (query t, key s) clipped to
[0, L + C - 1]; nothing is masked (the zero caches of the first chunks and
the chunk's future keys included).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import Precision
from portbench.reference.zipformer import (
    bias_norm,
    bypass,
    channels,
    downsample,
    feed_forward,
    lin,
    merge_stacks,
    rel_pos_table,
    swoosh_l,
    swoosh_r,
)

CHUNK, LEFT, LOOKBACK, TAIL = 32, 128, 7, 6
CACHES = ("key", "na", "v1", "v2")


def zero_state(cfg, batch, device):
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    stacks = []
    for i, n_layers in enumerate(cfg["num_encoder_layers"]):
        d, k = cfg["encoder_dim"][i], cfg["cnn_module_kernel"][i]
        cache = max(LEFT // cfg["downsampling_factor"][i], 1)
        stacks.append([dict({c: z(batch, cache, d) for c in CACHES},
                            conv1=z(batch, k - 1, d), conv2=z(batch, k - 1, d))
                       for _ in range(n_layers)])
    f_out = ((cfg["num_features"] - 3) // 2 + 1 - 3) // 2 + 1
    return {"fbank": z(batch, LOOKBACK, cfg["num_features"]),
            "convnext": z(batch, cfg["embed_layer3_channels"], TAIL, f_out),
            "stacks": stacks}


def _embed(P, W, x, tail):
    p = "encoder_embed"
    h = swoosh_r(P.conv2d(x[:, None], W[f"{p}.conv1.weight"], W[f"{p}.conv1.bias"], padding=(0, 1)))
    h = swoosh_r(P.conv2d(h, W[f"{p}.conv2.weight"], W[f"{p}.conv2.bias"], stride=2))
    h = swoosh_r(P.conv2d(h, W[f"{p}.conv3.weight"], W[f"{p}.conv3.bias"], stride=(1, 2)))
    full = torch.cat([tail, h], dim=2)
    g = P.conv2d(full, W[f"{p}.convnext_dw.weight"], W[f"{p}.convnext_dw.bias"],
                 padding=(0, 3), groups=full.shape[1]).permute(0, 2, 3, 1)
    g = lin(P, W, f"{p}.convnext_pw2", swoosh_l(lin(P, W, f"{p}.convnext_pw1", g)))
    h = h + g.permute(0, 3, 1, 2)
    b, c, t, f = h.shape
    h = h.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return bias_norm(W, f"{p}.out_norm", lin(P, W, f"{p}.out", h)), full[:, :, -TAIL:]


def _attention(P, W, name, cache, x, heads, cfg):
    """[B, H, C, L+C] weights of the chunk's queries."""
    qd, pd = cfg["query_head_dim"], cfg["pos_head_dim"]
    full = torch.cat([cache, x], dim=1)
    b, s, _ = full.shape
    c = x.shape[1]
    proj = lin(P, W, f"{name}.attn_in_proj", full)
    q = proj[:, -c:, : heads * qd].reshape(b, c, heads, qd)
    k = proj[..., heads * qd: 2 * heads * qd].reshape(b, s, heads, qd)
    pq = proj[:, -c:, 2 * heads * qd:].reshape(b, c, heads, pd)
    pe = torch.from_numpy(rel_pos_table(s, cfg["pos_dim"])[s - 1:]).to(x.device)  # offsets 0 .. s-1
    pos = P.linear(pe, W[f"{name}.attn_pos_proj.weight"]).reshape(s, heads, pd)
    band = P.einsum("bthd,ohd->bhto", pq, pos)
    off = np.clip((s - c + np.arange(c)[:, None]) - np.arange(s)[None, :], 0, s - 1)
    idx = torch.from_numpy(off).to(x.device).expand(b, heads, c, s)
    return torch.softmax(P.einsum("bthd,bshd->bhts", q, k) + torch.gather(band, 3, idx), dim=-1)


def _attend(P, W, name, a, src, c, heads, vd):
    b = src.shape[0]
    v = lin(P, W, f"{name}.in_proj", src).reshape(b, -1, heads, vd)
    out = P.einsum("bhts,bshd->bthd", a, v).reshape(b, c, heads * vd)
    return lin(P, W, f"{name}.out_proj", out)


def _causal_conv(P, W, name, src):
    v, g = lin(P, W, f"{name}.in_proj", src).chunk(2, dim=-1)
    h = (v * torch.sigmoid(g)).transpose(1, 2)
    h = P.conv1d(h, W[f"{name}.dw_weight"], W[f"{name}.dw_bias"], groups=h.shape[1]).transpose(1, 2)
    return lin(P, W, f"{name}.out_proj", swoosh_r(h))


def _layer(P, W, name, st, x, heads, cfg):
    c, keep = x.shape[1], st["key"].shape[1]
    x_orig = x
    a = _attention(P, W, name, st["key"], x, heads, cfg)
    x = x + feed_forward(P, W, f"{name}.ff1", x)
    na_src = torch.cat([st["na"], x], 1)
    s_g, v, y = lin(P, W, f"{name}.nonlin_attn.in_proj", na_src).chunk(3, dim=-1)
    na = P.einsum("bts,bsd->btd", a[:, 0], torch.tanh(s_g) * v) * y[:, -c:]
    x = x + lin(P, W, f"{name}.nonlin_attn.out_proj", na)
    v1_src = torch.cat([st["v1"], x], 1)
    x = x + _attend(P, W, f"{name}.self_attn1", a, v1_src, c, heads, cfg["value_head_dim"])
    conv1 = torch.cat([st["conv1"], x], 1)
    x = x + _causal_conv(P, W, f"{name}.conv1", conv1)
    x = x + feed_forward(P, W, f"{name}.ff2", x)
    x = bypass(W[f"{name}.bypass_mid_scale"], x_orig, x)
    v2_src = torch.cat([st["v2"], x], 1)
    x = x + _attend(P, W, f"{name}.self_attn2", a, v2_src, c, heads, cfg["value_head_dim"])
    conv2 = torch.cat([st["conv2"], x], 1)
    x = x + _causal_conv(P, W, f"{name}.conv2", conv2)
    x = x + feed_forward(P, W, f"{name}.ff3", x)
    x = bypass(W[f"{name}.bypass_scale"], x_orig, bias_norm(W, f"{name}.norm", x))
    k = st["conv1"].shape[1]
    return x, {"key": torch.cat([st["key"], x_orig], 1)[:, -keep:], "na": na_src[:, -keep:],
               "v1": v1_src[:, -keep:], "v2": v2_src[:, -keep:],
               "conv1": conv1[:, -k:], "conv2": conv2[:, -k:]}


def step(P: Precision, W, cfg, state, fbank_chunk):
    """fbank_chunk [B, 64, 80] -> (encoder frames [B, 16, max width], new
    state)."""
    dims = cfg["encoder_dim"]
    with P.active():
        x = torch.cat([state["fbank"], fbank_chunk], 1)
        new = {"fbank": x[:, -LOOKBACK:]}
        h, new["convnext"] = _embed(P, W, x, state["convnext"])
        h = h[:, -CHUNK:]
        outputs, stacks = [], []
        for i, n_layers in enumerate(cfg["num_encoder_layers"]):
            ds = cfg["downsampling_factor"][i]
            h = channels(h, dims[i])
            hs = downsample(W[f"stacks.{i}.downsample.weights"], h, ds)
            layer_states = []
            for j in range(n_layers):
                hs, ls = _layer(P, W, f"stacks.{i}.layers.{j}", state["stacks"][i][j], hs,
                                cfg["num_heads"][i], cfg)
                layer_states.append(ls)
            stacks.append(layer_states)
            hs = torch.repeat_interleave(hs, ds, dim=1)[:, : h.shape[1]] if ds > 1 else hs
            h = bypass(W[f"stacks.{i}.out_bypass_scale"], h, hs) if ds != 1 else hs
            outputs.append(h)
        new["stacks"] = stacks
        full = merge_stacks(outputs, dims, max(dims))
        return downsample(W["downsample_output.weights"], full, 2), new
