# Streaming Zipformer: the chunked causal encoder with carried state.
#
# Port of sherpa_vietnamese_asr_tpu/models/zipformer_streaming.py, on the
# modules of models/zipformer.py (the offline and the streaming encoder share
# one set of weights). One step takes 2 * chunk_frames new fbank frames and
# carries an explicit state of tensors on the model's device:
#   * per layer: left-context caches at the stack's rate of the layer input
#     (keys and queries), of x after ff1 (the nonlin attention's values), of
#     x after the nonlin attention and after bypass_mid (the two
#     self-attentions' values), and the last kernel-1 inputs of each
#     convolution module (the causal depthwise convolution's left context);
#   * the embed: the last 7 fbank frames and the last 6 ConvNeXt input
#     frames, kept [B, C3, 6, F'] in this package's NCHW layout (the JAX
#     package keeps them NHWC; models/convert.streaming_state_from_numpy
#     maps one onto the other). The 7-tap ConvNeXt is causal: 6 frames of
#     left context from the tail, none on the right.
# Attention is rectangular, [B, H, C, L+C] queries-major: the chunk's
# queries against cache + chunk keys, positions gathered at
# clip(t - s, 0, S-1). As in the JAX package, neither the zero-filled cache
# of the first chunks nor future keys inside the chunk are masked.
#
# The streaming attention, the causal convolutions and the greedy decode
# are plain jnp in the JAX package, outside any Pallas kernel, so they are
# plain PyTorch here; the step reaches no hand-written kernel (kernel 1 runs
# in front of it, in pipeline/streaming_online.fused_stream_step).

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    ConvModule,
    EncoderEmbed,
    SelfAttention,
    ZipformerConfig,
    ZipformerEncoder,
    ZipformerLayer,
    _bypass,
    _check_full_fp32,
    _conv,
    _convert_channels,
    _lin,
    compact_rel_pos_emb,
    simple_upsample,
    swoosh_l,
    swoosh_r,
)

LAYER_CACHES = ("key_cache", "na_cache", "v1_cache", "v2_cache")
CONVNEXT_TAIL = 6  # left context of the causal 7-tap ConvNeXt


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    chunk_frames: int = 32      # embed-rate (50 Hz) frames per step = 0.64 s
    left_frames: int = 128      # embed-rate left-context frames
    fbank_lookback: int = 7     # fbank frames consumed by the embed convs


def embed_freq_dim(cfg: ZipformerConfig) -> int:
    """Frequency bins after the conv1/conv2/conv3 stack (80 -> 19)."""
    f = cfg.num_features              # conv1: k3 freq-pad 1 keeps F
    f = (f - 3) // 2 + 1              # conv2: k3 stride 2 no pad
    return (f - 3) // 2 + 1           # conv3: k3 stride 2 no pad


def stack_cache_frames(scfg: StreamingConfig, ds: int) -> int:
    return max(scfg.left_frames // ds, 1)


def init_streaming_state(cfg: ZipformerConfig, scfg: StreamingConfig,
                         batch: int, device="cuda") -> dict:
    """Zero state for streaming_step: {"fbank_tail" [B, 7, 80],
    "convnext_tail" [B, C3, 6, F'], "stacks": [[layer state]]}, each layer
    state {key/na/v1/v2_cache [B, L_i, D_i], conv1/conv2_tail
    [B, kernel-1, D_i]}, all float32 on `device`, the card by default
    (raises without one, as the model constructors do)."""
    device = model_device(device)
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    stacks = []
    for i, n_layers in enumerate(cfg.num_encoder_layers):
        d, k = cfg.encoder_dim[i], cfg.cnn_module_kernel[i]
        t_cache = stack_cache_frames(scfg, cfg.downsampling_factor[i])
        stacks.append([
            dict({name: zeros(batch, t_cache, d) for name in LAYER_CACHES},
                 conv1_tail=zeros(batch, k - 1, d),
                 conv2_tail=zeros(batch, k - 1, d))
            for _ in range(n_layers)])
    return {"fbank_tail": zeros(batch, scfg.fbank_lookback, cfg.num_features),
            "convnext_tail": zeros(batch, cfg.embed_layer3_channels,
                                   CONVNEXT_TAIL, embed_freq_dim(cfg)),
            "stacks": stacks}


def map_state(fn, *states):
    """fn applied leaf by leaf over states of one structure."""
    first = states[0]
    if isinstance(first, dict):
        return {k: map_state(fn, *(s[k] for s in states)) for k in first}
    if isinstance(first, list):
        return [map_state(fn, *parts) for parts in zip(*states)]
    return fn(*states)


@functools.lru_cache(maxsize=32)
def _pos_block_on(t_cache: int, c: int, pos_dim: int, device) -> torch.Tensor:
    """compact_rel_pos_emb(t_cache + c) at offsets 0 .. t_cache + c - 1."""
    s = t_cache + c
    return torch.from_numpy(compact_rel_pos_emb(s, pos_dim)[s - 1:]).to(device)


@functools.lru_cache(maxsize=32)
def _offset_index(s_len: int, c: int, device) -> torch.Tensor:
    """[C, S] position row of (query t, key s): (s_len - c + t) - s clipped
    to [0, s_len - 1] (a future key in the chunk reads offset 0)."""
    off = (s_len - c + np.arange(c)[:, None]) - np.arange(s_len)[None, :]
    return torch.from_numpy(np.clip(off, 0, s_len - 1)).to(device)


def _streaming_embed(embed: EncoderEmbed, x, cn_tail, dt):
    """Causal Conv2dSubsampling + ConvNeXt.

    x: [B, T, 80] fbank with the 7-frame lookback prepended; cn_tail:
    [B, C3, 6, F'] cached ConvNeXt input frames. Returns (embedded
    [B, (T-7)//2, D0] float32, new tail)."""
    h = swoosh_r(_conv(embed.conv1, x[:, None], dt))
    h = swoosh_r(_conv(embed.conv2, h, dt))
    h = swoosh_r(_conv(embed.conv3, h, dt))           # [B, C3, T', F']
    full = torch.cat([cn_tail.to(dt), h], dim=2)       # [B, C3, 6+T', F']
    dw = embed.convnext_dw
    g = F.conv2d(full, dw.weight.to(dt), None, padding=(0, 3), groups=dw.groups)
    g = (g + dw.bias.to(dt)[:, None, None]).permute(0, 2, 3, 1)  # [B, T', F', C3]
    g = _lin(embed.convnext_pw2, swoosh_l(_lin(embed.convnext_pw1, g, dt)), dt)
    h = h + g.permute(0, 3, 1, 2)
    new_tail = full[:, :, -CONVNEXT_TAIL:].float()
    b, c, bt, f = h.shape
    # flatten as [B, T', C*F'] (channel-major, like the JAX package)
    h = h.permute(0, 2, 1, 3).reshape(b, bt, c * f)
    return embed.out_norm(_lin(embed.out, h, dt).float()), new_tail


def _streaming_attention(layer: ZipformerLayer, x_cache, x, pos_block, dt):
    """Rectangular attention weights [B, H, C, L+C] float32 of the chunk's
    queries against cache + chunk keys."""
    cfg, heads = layer.cfg, layer.heads
    qd, pd = cfg.query_head_dim, cfg.pos_head_dim
    full = torch.cat([x_cache, x], dim=1)
    b, s_len, _ = full.shape
    c = x.shape[1]
    proj = _lin(layer.attn_in_proj, full, dt)
    q = proj[:, -c:, : heads * qd].reshape(b, c, heads, qd)
    k = proj[..., heads * qd: 2 * heads * qd].reshape(b, s_len, heads, qd)
    pq = proj[:, -c:, 2 * heads * qd:].reshape(b, c, heads, pd)
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    pos_lin = (pos_block.to(dt) @ layer.attn_pos_proj.weight.to(dt).t()
               ).reshape(-1, heads, pd)                # [L+C, H, pd]; row = offset
    pos_full = torch.einsum("bthd,ohd->bhto", pq, pos_lin)  # [B, H, C, L+C]
    off = _offset_index(s_len, c, x.device)
    pos_scores = torch.gather(pos_full, 3, off.expand(b, heads, c, s_len))
    return torch.softmax((scores + pos_scores).float(), dim=-1)


def _attend(attn: SelfAttention, weights, value_src, c, dt):
    """A self-attention's output for the chunk's C queries over value_src
    (cache + chunk) with queries-major weights [B, H, C, S]."""
    b = value_src.shape[0]
    v = _lin(attn.in_proj, value_src, dt).reshape(b, -1, attn.heads, attn.vd)
    out = torch.einsum("bhts,bshd->bthd", weights.to(dt), v)
    return _lin(attn.out_proj, out.reshape(b, c, attn.heads * attn.vd),
                dt).float()


def _causal_conv_module(conv: ConvModule, x_with_tail, dt):
    """ConvModule with the cached kernel-1 frames as left context (valid
    padding); returns the chunk's frames."""
    v, g = _lin(conv.in_proj, x_with_tail, dt).chunk(2, dim=-1)
    h = (v * torch.sigmoid(g)).transpose(1, 2)
    f32 = dt == torch.float32  # bf16 adds the bias after the rounded conv
    h = F.conv1d(h, conv.dw_weight.to(dt), conv.dw_bias if f32 else None,
                 groups=h.shape[1]).transpose(1, 2)
    if not f32:
        h = h + conv.dw_bias.to(dt)
    return _lin(conv.out_proj, swoosh_r(h), dt).float()


def _streaming_layer(layer: ZipformerLayer, state, x, pos_block, dt):
    """One layer step. x: [B, C, D] float32. Returns (y, new layer state)."""
    c = x.shape[1]
    t_cache = state["key_cache"].shape[1]
    x_orig = x

    def with_cache(name, cur):
        return torch.cat([state[name], cur], dim=1)

    attn_w = _streaming_attention(layer, state["key_cache"], x, pos_block, dt)
    x = x + layer.ff1(x, dt)
    na_src = with_cache("na_cache", x)
    nl = layer.nonlin_attn
    s_g, v_na, y_g = _lin(nl.in_proj, na_src, dt).chunk(3, dim=-1)
    na = torch.einsum("bts,bsd->btd", attn_w[:, 0].to(dt),
                      torch.tanh(s_g) * v_na) * y_g[:, -c:]
    x = x + _lin(nl.out_proj, na, dt).float()
    v1_src = with_cache("v1_cache", x)
    x = x + _attend(layer.self_attn1, attn_w, v1_src, c, dt)
    conv1_in = with_cache("conv1_tail", x)
    x = x + _causal_conv_module(layer.conv1, conv1_in, dt)
    x = x + layer.ff2(x, dt)
    x = _bypass(layer.bypass_mid_scale, x_orig, x)
    v2_src = with_cache("v2_cache", x)
    x = x + _attend(layer.self_attn2, attn_w, v2_src, c, dt)
    conv2_in = with_cache("conv2_tail", x)
    x = x + _causal_conv_module(layer.conv2, conv2_in, dt)
    x = x + layer.ff3(x, dt)
    x = _bypass(layer.bypass_scale, x_orig, layer.norm(x))
    k = conv1_in.shape[1] - c
    new_state = {
        "key_cache": with_cache("key_cache", x_orig)[:, -t_cache:],
        "na_cache": na_src[:, -t_cache:],
        "v1_cache": v1_src[:, -t_cache:],
        "v2_cache": v2_src[:, -t_cache:],
        "conv1_tail": conv1_in[:, -k:],
        "conv2_tail": conv2_in[:, -k:],
    }
    return x, new_state


def streaming_step(encoder: ZipformerEncoder, state, fbank_chunk,
                   scfg: StreamingConfig):
    """Process one chunk.

    fbank_chunk: [B, 2 * chunk_frames, 80] float32 new fbank frames
    (100 Hz); with the cached lookback they give chunk_frames embed frames.
    Returns (enc_out [B, chunk_frames // 2, output_dim] float32, new_state).
    The encoder's compute dtype (config.compute_dtype) sets every product's,
    as in the offline encoder; on CUDA the float32 tier refuses TF32.
    """
    if fbank_chunk.device.type == "cuda":
        _check_full_fp32()
    with torch.no_grad():
        return _streaming_step_body(encoder, state, fbank_chunk, scfg)


def _streaming_step_body(encoder, state, fbank_chunk, scfg):
    cfg = encoder.cfg
    dt = getattr(torch, cfg.compute_dtype)
    with_tail = torch.cat([state["fbank_tail"], fbank_chunk], dim=1)
    new_state = {"fbank_tail": with_tail[:, -scfg.fbank_lookback:]}
    h, new_state["convnext_tail"] = _streaming_embed(
        encoder.encoder_embed, with_tail, state["convnext_tail"], dt)
    h = h[:, -scfg.chunk_frames:]
    outputs, stacks_state = [], []
    for i, stack in enumerate(encoder.stacks):
        h = _convert_channels(h, cfg.encoder_dim[i])
        h_orig = h
        hs = stack.downsample(h)
        pos_block = _pos_block_on(stack_cache_frames(scfg, stack.ds),
                                  hs.shape[1], cfg.pos_dim, h.device)
        layer_states = []
        for layer, ls in zip(stack.layers, state["stacks"][i]):
            hs, ls = _streaming_layer(layer, ls, hs, pos_block, dt)
            layer_states.append(ls)
        stacks_state.append(layer_states)
        hs = simple_upsample(hs, stack.ds)[:, : h.shape[1]]
        h = _bypass(stack.out_bypass_scale, h_orig, hs) if stack.ds != 1 else hs
        outputs.append(h)
    new_state["stacks"] = stacks_state
    # full-dim output (the offline encoder's piece-concat rule)
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
    return encoder.downsample_output(full), new_state
