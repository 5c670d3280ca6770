# Whole-layer Zipformer2 encoder kernel of the bfloat16 tier.
#
# Port of sherpa_vietnamese_asr_tpu/ops/encoder_layer.py. encoder_layer() is
# the kernel's wrapper: a CPU tensor runs the plain twin encoder_layer_plain;
# a CUDA tensor launches csrc/encoder_layer.cu (svt_encoder_layer_bf16) or
# raises. Both compute the TPU kernel's math with its rounding points:
#   * a linear is an f32 sum of products of bf16-rounded operands, rounded to
#     bf16, plus the bf16 bias added in bf16;
#   * the swoosh output is rounded to bf16 before a feed-forward's second
#     product, the attended values before out_proj, and the nonlin y-gate is
#     a bf16 product;
#   * the conv gate output is zeroed on rows >= lens and stored in bf16; the
#     K-tap depthwise sum is f32;
#   * attention weights are softmax over keys of q.k + pq.poslin[t_pad-1+s-t]
#     (masked keys score -1e9, so a chunk with lens 0 gets uniform weights
#     over all t_pad keys), stored keys-major in bf16;
#   * the residual stream, BiasNorm and both bypasses are f32.
# Products of bf16 values are exact in f32, so the twin is the TPU kernel's
# arithmetic up to summation order on any backend (on CUDA with TF32 off).

from __future__ import annotations

import ctypes

import torch

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

R = 128  # the sequence is zero-padded to a multiple of R, as in the JAX package
N_FLAT = 42

# Kernel launches of encoder_layer() on CUDA tensors.
launches = 0

_B16, _F32 = torch.bfloat16, torch.float32


def _dot16(a, w):
    """f32 product of bf16-rounded operands (exact products, f32 sums)."""
    return a.to(_B16).to(_F32) @ w.to(_B16).to(_F32)


def _linear16(a, w, b):
    """bf16(bf16(a @ w) + b): the TPU kernel's _linear16."""
    return (_dot16(a, w).to(_B16).to(_F32) + b.to(_F32)).to(_B16)


def _swoosh_l(x):
    v = x - 4.0
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())) \
        - 0.08 * x - 0.035


def _swoosh_r(x):
    v = x - 1.0
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())) \
        - 0.08 * x - 0.313261687


def rel_pos_scores(pq, poslin):
    """[B, H, S, T] f32 positional band: pq[b, t, h] . poslin[h, t_pad-1+s-t].

    pq: [B, T_pad, H, pd] bf16; poslin: [H, >= 2*T_pad-1, pd] bf16.
    """
    t_pad = pq.shape[1]
    ar = torch.arange(t_pad, device=pq.device)
    rows = poslin[:, t_pad - 1 + ar[:, None] - ar[None, :]]    # [H, S, T, pd]
    return torch.einsum("bthd,hstd->bhst", pq.to(_F32), rows.to(_F32))


def attention_weights_bf16(proj, poslin, lens, heads, qd, pd):
    """[B, H, S, T] bf16 keys-major weights from the bf16 projection
    proj [B, T_pad, H*(2qd+pd)] (q | k | pq)."""
    b, t_pad, _ = proj.shape
    q = proj[..., : heads * qd].reshape(b, t_pad, heads, qd)
    k = proj[..., heads * qd: 2 * heads * qd].reshape(b, t_pad, heads, qd)
    pq = proj[..., 2 * heads * qd:].reshape(b, t_pad, heads, pd)
    scores = torch.einsum("bshd,bthd->bhst", k.to(_F32), q.to(_F32))
    scores = scores + rel_pos_scores(pq, poslin)
    valid = torch.arange(t_pad, device=proj.device)[None, :] < lens[:, None]
    scores = torch.where(valid[:, None, :, None], scores, -1e9)
    return torch.softmax(scores, dim=2).to(_B16)


def encoder_layer_plain(flat, x, poslin, lens, heads, qd, pd, vd):
    """Plain twin of the kernel. x: [B, T_pad, D] f32; poslin [H, rows, pd]
    bf16; lens [B]. Returns [B, T_pad, D] f32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("encoder_layer_plain needs TF32 off on CUDA")
    (attn_in_w, attn_in_b, nl_in_w, nl_in_b, nl_out_w, nl_out_b,
     sa1_in_w, sa1_in_b, sa1_out_w, sa1_out_b,
     sa2_in_w, sa2_in_b, sa2_out_w, sa2_out_b,
     ff1_in_w, ff1_in_b, ff1_out_w, ff1_out_b,
     ff2_in_w, ff2_in_b, ff2_out_w, ff2_out_b,
     ff3_in_w, ff3_in_b, ff3_out_w, ff3_out_b,
     c1_in_w, c1_in_b, c1_dw, c1_dwb, c1_out_w, c1_out_b,
     c2_in_w, c2_in_b, c2_dw, c2_dwb, c2_out_w, c2_out_b,
     norm_bias, norm_logscale, byp_mid, byp_out) = flat
    b, t_pad, d = x.shape
    lens = lens.to(device=x.device, dtype=torch.long)
    x = x.to(_F32)
    x_orig = x
    w = attention_weights_bf16(_linear16(x, attn_in_w, attn_in_b), poslin,
                               lens, heads, qd, pd)

    def attend(h, v16):
        """[B, T, c] f32 = sum_s w[h][s, t] v16[s, :]."""
        return torch.einsum("bst,bsc->btc", w[:, h].to(_F32), v16.to(_F32))

    def ff(in_w, in_b, out_w, out_b, xi):
        h = _linear16(xi, in_w, in_b)
        return _linear16(_swoosh_l(h.to(_F32)), out_w, out_b).to(_F32)

    x = x + ff(ff1_in_w, ff1_in_b, ff1_out_w, ff1_out_b, x)

    hna = nl_in_w.shape[1] // 3
    pj = _linear16(x, nl_in_w, nl_in_b)
    v = (torch.tanh(pj[..., :hna].to(_F32)) * pj[..., hna:2 * hna].to(_F32)).to(_B16)
    o = (attend(0, v).to(_B16).to(_F32) * pj[..., 2 * hna:].to(_F32)).to(_B16)
    x = x + _linear16(o, nl_out_w, nl_out_b).to(_F32)

    def self_attn(in_w, in_b, out_w, out_b, xi):
        v = _linear16(xi, in_w, in_b)
        o = torch.cat([attend(h, v[..., h * vd:(h + 1) * vd]).to(_B16)
                       for h in range(heads)], dim=-1)
        return _linear16(o, out_w, out_b).to(_F32)

    x = x + self_attn(sa1_in_w, sa1_in_b, sa1_out_w, sa1_out_b, x)

    rows_valid = (torch.arange(t_pad, device=x.device)[None, :]
                  < lens[:, None])[..., None]

    def conv_mod(in_w, in_b, dw, dwb, out_w, out_b, xi):
        pj = _linear16(xi, in_w, in_b)
        hg = pj[..., :d].to(_F32) * torch.sigmoid(pj[..., d:].to(_F32))
        hg = torch.where(rows_valid, hg, 0.0).to(_B16).to(_F32)
        ksize = dw.shape[0]
        halo = (ksize - 1) // 2
        c = torch.nn.functional.pad(hg, (0, 0, halo, halo))
        acc = torch.zeros_like(hg)
        for k in range(ksize):
            acc = acc + c[:, k:k + t_pad] * dw[k].to(_F32)
        acc = _swoosh_r(acc + dwb.to(_F32))
        return _linear16(acc, out_w, out_b).to(_F32)

    x = x + conv_mod(c1_in_w, c1_in_b, c1_dw, c1_dwb, c1_out_w, c1_out_b, x)
    x = x + ff(ff2_in_w, ff2_in_b, ff2_out_w, ff2_out_b, x)
    x = x_orig + (x - x_orig) * torch.clamp(byp_mid, 0.0, 1.0)
    x = x + self_attn(sa2_in_w, sa2_in_b, sa2_out_w, sa2_out_b, x)
    x = x + conv_mod(c2_in_w, c2_in_b, c2_dw, c2_dwb, c2_out_w, c2_out_b, x)
    x = x + ff(ff3_in_w, ff3_in_b, ff3_out_w, ff3_out_b, x)

    dlt = x - norm_bias
    rms = torch.sqrt(torch.mean(dlt * dlt, dim=-1, keepdim=True) + 1e-12)
    x = x * (torch.exp(norm_logscale) / rms)
    return x_orig + (x - x_orig) * torch.clamp(byp_out, 0.0, 1.0)


def poslin_bf16(rev_pos, w_pos, heads):
    """[H, rows, pd] bf16: the reversed padded position table projected in
    f32 (outside the kernel, as in the JAX package), then rounded."""
    p = rev_pos.to(_F32) @ w_pos.to(_F32)
    return p.reshape(rev_pos.shape[0], heads, -1).permute(1, 0, 2) \
        .to(_B16).contiguous()


def _encoder_layer_cuda(flat, x, poslin, lens, h, qd, pd, vd):
    global launches
    dev = x.device
    b, t_pad, d = x.shape
    hna = flat[2].shape[1] // 3                       # nl_in_w: [D, 3*hna]
    ff1, ff2, ff3 = flat[14].shape[1], flat[18].shape[1], flat[22].shape[1]
    ksize = flat[28].shape[0]                         # c1_dw: [K, D]
    if (qd, pd) not in ((32, 4), (16, 4)):
        raise ValueError(f"encoder layer kernel is built for (qd, pd) in "
                         f"((32, 4), (16, 4)), got {(qd, pd)}")
    if x.dtype != _F32 or not x.is_contiguous():
        raise ValueError("encoder layer kernel: x must be contiguous float32")
    if lens.shape != (b,):
        raise ValueError("encoder layer kernel: lens must be [B]")
    if poslin.dtype != _B16 or poslin.shape[0] != h \
            or poslin.shape[1] < 2 * t_pad - 1 or poslin.shape[2] != pd:
        raise ValueError("encoder layer kernel: poslin must be bf16 "
                         f"[{h}, >= {2 * t_pad - 1}, {pd}]")
    if len(flat) != N_FLAT or ksize % 2 != 1:
        raise ValueError("encoder layer kernel: 42 operands, odd conv kernel")
    for i, w in enumerate(flat):
        want = _F32 if i >= 38 else _B16
        if w.device != dev or w.dtype != want or not w.is_contiguous():
            raise ValueError(f"encoder layer kernel: operand {i} must be "
                             f"contiguous {want} on {dev}")
    if b * h * t_pad * t_pad >= 2 ** 31 or b * t_pad * 4 * d >= 2 ** 31:
        raise ValueError("encoder layer kernel: shapes exceed int32 indexing")
    m = b * t_pad
    out = torch.empty_like(x)
    if m == 0:
        return out
    # Workspaces (the C code allocates nothing): the bf16 projection q|k|pq,
    # the keys-major weights [B, H, T_pad, T_pad], three bf16 activation
    # buffers and the f32 residual stream.
    ws_proj = torch.empty((m, h * (2 * qd + pd)), dtype=_B16, device=dev)
    ws_w = torch.empty((b, h, t_pad, t_pad), dtype=_B16, device=dev)
    ws_a = torch.empty((m, max(ff1, ff2, ff3, 3 * hna, 2 * d, h * vd)),
                       dtype=_B16, device=dev)
    ws_b = torch.empty((m, max(hna, h * vd, d)), dtype=_B16, device=dev)
    ws_c = torch.empty((m, max(hna, h * vd)), dtype=_B16, device=dev)
    ws_x = torch.empty((m, d), dtype=_F32, device=dev)
    lens32 = lens.to(device=dev, dtype=torch.int32).contiguous()
    ptrs = (ctypes.c_void_p * N_FLAT)(*[w.data_ptr() for w in flat])
    lib = cuda_lib.library()
    status = lib.svt_encoder_layer_bf16(
        x.data_ptr(), lens32.data_ptr(), poslin.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
        ws_proj.data_ptr(), ws_w.data_ptr(), ws_a.data_ptr(), ws_b.data_ptr(),
        ws_c.data_ptr(), ws_x.data_ptr(),
        b, t_pad, d, h, qd, pd, vd, hna, ff1, ff2, ff3, ksize, poslin.shape[1],
        cuda_lib.stream(dev))
    cuda_lib.check(status, "svt_encoder_layer_bf16")
    launches += 1
    return out


def encoder_layer(layer, x, rev_pos, lens):
    """One Zipformer2 layer through the whole-layer kernel.

    layer: models.zipformer.ZipformerLayer; x: [B, T_pad, D] float32 with
    T_pad % 128 == 0 (padded rows finite, zeros from padding); rev_pos:
    [2*T_pad-1+128, pos_dim] from zipformer._padded_rev_pos_emb; lens: [B]
    valid frames. Returns [B, T_pad, D] float32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    """
    cfg = layer.cfg
    flat, w_pos = layer.kernel_layout()
    poslin = poslin_bf16(rev_pos, w_pos, layer.heads)
    args = (flat, x, poslin, lens, layer.heads, cfg.query_head_dim,
            cfg.pos_head_dim, cfg.value_head_dim)
    with torch.no_grad():
        if x.device.type == "cpu":
            return encoder_layer_plain(*args)
        if x.device.type != "cuda":
            raise ValueError(f"encoder_layer: unsupported device {x.device}")
        return _encoder_layer_cuda(*args)
