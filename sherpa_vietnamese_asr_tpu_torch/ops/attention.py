# Zipformer attention weights: softmax(q k^T + rel_pos) over keys, written
# KEYS-MAJOR [B, H, S, T] (out[b, h, s, t] is key s's weight for query t).
#
# Port of sherpa_vietnamese_asr_tpu/ops/attention.py. attention_weights() is
# the kernel's wrapper: a CPU tensor runs the plain twin
# attention_weights_plain (the math of the JAX package's
# zipformer._attention_weights, float32 by default); a CUDA tensor launches
# csrc/attention_weights.cu, which writes bf16 weights like the TPU kernel.
# The relative-position score of query t and key s is
#   pq[t] . pos_lin[s + T - 1 - t],  pos_lin = reversed(pos_emb) @ W_pos,
# which the plain twin realigns with the Transformer-XL skew (pad, flatten,
# slice) and the kernel reads by index.

from __future__ import annotations

import torch

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

# Kernel launches of attention_weights() on CUDA tensors.
launches = 0

_KERNEL_HEAD_DIMS = ((32, 4), (16, 4))  # (query_head_dim, pos_head_dim) built


def _pos_lin(pos_proj_weight, pos_emb, heads, dtype):
    """[2T-1, H, pd]: row j holds relative offset (T-1) - j, projected."""
    pos = pos_emb.flip(0).to(dtype) @ pos_proj_weight.to(dtype)
    return pos.reshape(pos_emb.shape[0], heads, -1)


def attention_weights_plain(q, k, pq, pos_proj_weight, pos_emb, lens,
                            pos_dtype=torch.float32):
    """Plain twin: [B, H, S, T] keys-major weights (float32).

    q, k: [B, T, H, qd]; pq: [B, T, H, pd]; pos_proj_weight: [pos_dim, H*pd];
    pos_emb: [2T-1, pos_dim] (natural order); lens: [B] valid keys.
    pos_dtype rounds the position scores like the JAX package's pos_dtype.
    """
    b, t, h, _ = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    pos_lin = _pos_lin(pos_proj_weight, pos_emb, h, pos_dtype)
    pos_full = torch.einsum("bthd,rhd->bhtr", pq.to(pos_dtype), pos_lin)
    # skew: y[..., t, s] = pos_full[..., t, s + (T-1-t)]
    padded = torch.nn.functional.pad(pos_full, (0, 1))
    flat = padded.reshape(b, h, 2 * t * t)[:, :, t - 1: t - 1 + t * (2 * t - 1)]
    pos_scores = flat.reshape(b, h, t, 2 * t - 1)[..., :t]
    scores = (scores + pos_scores).to(torch.float32)
    mask = torch.arange(t, device=q.device)[None, :] >= lens[:, None]
    scores = scores.masked_fill(mask[:, None, None, :], -1e9)
    return torch.softmax(scores, dim=-1).transpose(2, 3)


def _attention_weights_cuda(q, k, pq, pos_proj_weight, pos_emb, lens):
    global launches
    b, t, h, qd = q.shape
    pd = pq.shape[-1]
    if (qd, pd) not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel is built for (qd, pd) in "
                         f"{_KERNEL_HEAD_DIMS}, got {(qd, pd)}")
    for name, x in (("q", q), ("k", k), ("pq", pq)):
        if x.dtype not in (torch.float32, torch.bfloat16) or x.device != q.device:
            raise ValueError(f"{name} must be float32 or bfloat16 on {q.device}")
    if k.shape != q.shape or pq.shape[:3] != q.shape[:3] \
            or pos_emb.shape[0] != 2 * t - 1 or lens.shape != (b,):
        raise ValueError("attention kernel: inconsistent shapes")
    # [B, T, H, d] -> [B*H, T, d]; pos -> [H, 2T-1, pd], all contiguous f32
    # (bf16 inputs of the bfloat16 tier widen exactly)
    qh = q.permute(0, 2, 1, 3).to(torch.float32).contiguous()
    kh = k.permute(0, 2, 1, 3).to(torch.float32).contiguous()
    ph = pq.permute(0, 2, 1, 3).to(torch.float32).contiguous()
    pos = _pos_lin(pos_proj_weight.to(torch.float32),
                   pos_emb.to(torch.float32), h, torch.float32)
    pos = pos.permute(1, 0, 2).contiguous()
    lens32 = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, t, t), dtype=torch.bfloat16, device=q.device)
    if t == 0 or b == 0:
        return out
    lib = cuda_lib.library()
    status = lib.svt_attention_weights(
        qh.data_ptr(), kh.data_ptr(), ph.data_ptr(), pos.data_ptr(),
        lens32.data_ptr(), out.data_ptr(), b, h, t, qd, pd,
        cuda_lib.stream(q.device))
    cuda_lib.check(status, "svt_attention_weights")
    launches += 1
    return out


def attention_weights(q, k, pq, pos_proj_weight, pos_emb, lens,
                      pos_dtype=torch.float32):
    """[B, H, S, T] keys-major attention weights.

    CPU tensors: the plain twin, float32 (pos scores rounded to pos_dtype).
    CUDA tensors (float32, or bfloat16 widened exactly): the kernel, bf16
    out (position scores always in float32, as in the TPU kernel).
    Consumers cast to their compute dtype.
    """
    if q.device.type == "cpu":
        return attention_weights_plain(q, k, pq, pos_proj_weight, pos_emb,
                                       lens, pos_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"attention_weights: unsupported device {q.device}")
    return _attention_weights_cuda(q, k, pq, pos_proj_weight, pos_emb, lens)
