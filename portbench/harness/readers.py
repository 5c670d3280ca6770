"""Arithmetic shared by the per-layer metric readers (portbench/metrics).
Each returns None when its trace holds nothing to read."""

from __future__ import annotations

from portbench.harness import counts

# Kernel 4's device kernels (csrc/encoder_layer.cu): products, score pass,
# depthwise conv and elementwise passes.
LAYER_KERNELS = ("product_kernel", "attn_bf16_kernel", "dwconv_kernel", "shadow_kernel",
                 "nonlin_gate_kernel", "biasnorm_bypass_kernel")


def vad_share(t):
    reqs = t.get("requests")
    if not reqs:
        return None
    return 100.0 * sum(r["timing"]["vad"] for r in reqs) / sum(r["wall_s"] for r in reqs)


def idle_share(t):
    w = t.get("profile")
    return None if w is None else 100.0 * (1.0 - w.busy_s / w.window_s)


def _beam_launches(t):
    """(b, t, valid frames, beam) of each beam launch of the traced slice."""
    out = []
    for shape, lens, beam in t["launches"]["beam"]:
        b, frames, _ = shape
        out.append((b, frames, int(lens.clamp(max=frames).sum()), beam))
    return out


def beam_roofline(t):
    w = t.get("profile")
    if w is None or not t["launches"]["beam"]:
        return None
    cfg = t["cfg"]
    bound = sum(counts.beam_bound_s(b, f, valid, beam, e=max(cfg["encoder_dim"]),
                                    d=cfg["decoder_dim"], k=cfg["context_size"],
                                    j=cfg["joiner_dim"], v=cfg["vocab_size"])
                for b, f, valid, beam in _beam_launches(t))
    dev = w.kernel_s("beam_kernel")
    return 100.0 * bound / dev if dev > 0 else None


def attention_roofline(t):
    w = t.get("profile")
    if w is None or not t["launches"]["attention"]:
        return None
    cfg = t["cfg"]
    bound = sum(counts.attention_bound_s(b, n, h, cfg["query_head_dim"], cfg["pos_head_dim"],
                                         cfg["pos_dim"])
                for b, n, h, _ in t["launches"]["attention"])
    dev = w.kernel_s("attn_kernel")
    return 100.0 * bound / dev if dev > 0 else None


def layer_roofline(t):
    w = t.get("profile")
    if w is None or not t["launches"]["layer"]:
        return None
    cfg = t["cfg"]
    bound = sum(counts.layer_bound_s(b, tp, d, h, ff, k, cfg["query_head_dim"],
                                     cfg["pos_head_dim"], cfg["value_head_dim"])
                for (b, tp, d), h, ff, k in t["launches"]["layer"])
    dev = sum(w.kernel_s(name) for name in LAYER_KERNELS)
    return 100.0 * bound / dev if dev > 0 else None


def decode_mfu(t):
    w = t.get("profile")
    if w is None or not t["launches"]["beam"]:
        return None
    rows = []
    for n_frames, (_, lens, _) in zip(t["launches"]["frames"], t["launches"]["beam"]):
        rows += [(int(f), int(e)) for f, e in zip(n_frames.tolist(), lens.tolist()) if f > 7]
    floor = counts.decode_floor_s(t["cfg"], rows, t["cfg"]["beam_size"])
    return 100.0 * floor / w.window_s
