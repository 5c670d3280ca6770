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
#
# attention_weights_bf16band() is the port of benchmarks/_skewbf16.py
# _attn_kernel_t_bf16band, a measurement probe: the same function with every
# position score (summed in float32) rounded to bf16 before the content score
# is added. Its twin is attention_weights_bf16band_plain, its kernel the
# BAND_BF16 instantiation of csrc/attention_weights.cu; no model path calls it
# (tools/skew_bf16.py times it against attention_weights()).

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

# Kernel launches of attention_weights() and attention_weights_bf16band()
# on CUDA tensors.
launches = 0
bf16band_launches = 0

_KERNEL_HEAD_DIMS = ((32, 4), (16, 4))  # (query_head_dim, pos_head_dim) built


def _pos_lin(pos_proj_weight, pos_emb, heads, dtype):
    """[2T-1, H, pd]: row j holds relative offset (T-1) - j, projected."""
    pos = pos_emb.flip(0).to(dtype) @ pos_proj_weight.to(dtype)
    return pos.reshape(pos_emb.shape[0], heads, -1)


def _skew(pos_full):
    """[B, H, T, 2T-1] -> [B, H, T, T]: y[..., t, s] = pos_full[..., t, s + (T-1-t)]."""
    b, h, t, _ = pos_full.shape
    padded = torch.nn.functional.pad(pos_full, (0, 1))
    flat = padded.reshape(b, h, 2 * t * t)[:, :, t - 1: t - 1 + t * (2 * t - 1)]
    return flat.reshape(b, h, t, 2 * t - 1)[..., :t]


def _masked_softmax(scores, lens):
    """[B, H, T, S] float32 scores -> [B, H, S, T] keys-major weights; keys
    s >= lens[b] masked to -1e9 (all keys masked -> uniform 1/T)."""
    t = scores.shape[-1]
    mask = torch.arange(t, device=scores.device)[None, :] >= lens[:, None]
    scores = scores.masked_fill(mask[:, None, None, :], -1e9)
    return torch.softmax(scores, dim=-1).transpose(2, 3)


def attention_weights_plain(q, k, pq, pos_proj_weight, pos_emb, lens,
                            pos_dtype=torch.float32):
    """Plain twin: [B, H, S, T] keys-major weights (float32).

    q, k: [B, T, H, qd]; pq: [B, T, H, pd]; pos_proj_weight: [pos_dim, H*pd];
    pos_emb: [2T-1, pos_dim] (natural order); lens: [B] valid keys.
    pos_dtype rounds the position scores like the JAX package's pos_dtype.
    """
    h = q.shape[2]
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    pos_lin = _pos_lin(pos_proj_weight, pos_emb, h, pos_dtype)
    pos_full = torch.einsum("bthd,rhd->bhtr", pq.to(pos_dtype), pos_lin)
    return _masked_softmax((scores + _skew(pos_full)).to(torch.float32), lens)


def attention_weights_bf16band_plain(q, k, pq, pos_proj_weight, pos_emb, lens):
    """Plain twin of the bf16-band kernel: attention_weights_plain in float32
    with every position score rounded to bf16 (nearest even) before the
    content score is added. Not pos_dtype=torch.bfloat16, which rounds the
    position table and pq and computes the band in bf16: here the inputs stay
    float32 and the band's float32 result is rounded.

    The band is summed over pos_head_dim left to right, one rounded product
    and one rounded add a term, as the kernel sums it (no fused multiply-add),
    so both round the same float32 value to bf16.
    """
    h = q.shape[2]
    f32 = torch.float32
    scores = torch.einsum("bthd,bshd->bhts", q.to(f32), k.to(f32))
    pos_lin = _pos_lin(pos_proj_weight.to(f32), pos_emb.to(f32), h, f32)
    pqh = pq.to(f32).permute(0, 2, 1, 3)[:, :, :, None, :]  # [B, H, T, 1, pd]
    rows = pos_lin.permute(1, 0, 2)[None, :, None]           # [1, H, 1, 2T-1, pd]
    band = pqh[..., 0] * rows[..., 0]
    for d in range(1, pq.shape[-1]):
        band = band + pqh[..., d] * rows[..., d]
    band = band.to(torch.bfloat16).to(f32)
    return _masked_softmax(scores + _skew(band), lens)


# The kernel's schedule (csrc/attention_weights.cu), mirrored by
# fragment_map and store_map for the CPU tests: a block of 8 warps takes
# QUERY_TILE queries of one (batch, head), four warps along the queries (16
# rows each) and two warpgroups along the keys; keys go in steps of
# STEP_KEYS.
QUERY_TILE, STEP_KEYS, ROW_WARPS, KEY_GROUPS = 64, 128, 4, 2


def fragment_map():
    """(key, query) of every accumulator element of one step, in the order
    (warp, lane, tile j, element i): where pass 2 writes it in the block's
    shared [STEP_KEYS, QUERY_TILE] tile (step-local key, block-local query).
    Warp w scores rows 16 (w % 4) .. + 15 against keys 64 (w // 4) .. + 63
    (warpgroup w // 4's wgmma m64n64); lane (g, tg) = (lane // 4, lane % 4)
    holds, in tile j, element i at row g + 8 (i // 2) and key 8j + 2tg +
    i % 2 (the accumulator layout)."""
    warp, lane, j, i = np.meshgrid(np.arange(ROW_WARPS * KEY_GROUPS), np.arange(32),
                                   np.arange(8), np.arange(4), indexing="ij")
    rw, kg = warp % ROW_WARPS, warp // ROW_WARPS
    g, tg = lane // 4, lane % 4
    key = (STEP_KEYS // KEY_GROUPS) * kg + 8 * j + 2 * tg + i % 2
    query = 16 * rw + g + 8 * (i // 2)
    return key.ravel(), query.ravel()


def store_map(t, t0, s0):
    """(key, query, width) of every global store of the block at query t0
    in the step at key s0, for sequence length t: rows of keys with
    consecutive queries, a warp a key row; `width` 2 is one bf16x2 store of
    queries (query, query + 1), only at even t, where every row of the
    output starts 4-byte aligned; 1 is one bf16 store."""
    keys, queries = min(STEP_KEYS, t - s0), min(QUERY_TILE, t - t0)
    kr = np.arange(keys)[:, None]
    if t % 2 == 0:
        tq = 2 * np.arange(32)[None, :]  # lane l stores queries 2l, 2l + 1
        width = np.where(tq + 1 < queries, 2, np.where(tq < queries, 1, 0))
    else:
        tq = np.arange(32 * ((queries + 31) // 32))[None, :]  # lanes stride 32
        width = np.where(tq < queries, 1, 0)
    kr, tq, width = np.broadcast_arrays(kr, tq, width)
    live = width > 0
    return s0 + kr[live], t0 + tq[live], width[live]


def kernel_pos_table(pos_proj_weight, pos_emb, heads):
    """[H, 2T-1, pd] float32 contiguous: the kernel's position rows, row j of
    head h = pos_lin[j, h] (relative offset (T-1) - j)."""
    f32 = torch.float32
    pos = _pos_lin(pos_proj_weight.to(f32), pos_emb.to(f32), heads, f32)
    return pos.permute(1, 0, 2).contiguous()


def kernel_args(q, k, pq, lens):
    """(q, k, pq, lens, strides): the kernel's operands. float32 q, k and
    pq are read in place (column slices of one projection: no copy); bf16
    ones (the bfloat16 tier's layer_kernel="never" path) are widened to
    float32, exactly. k is copied only if its rows are not 16-byte aligned
    (the kernel stages them with 16-byte cp.async). lens becomes int32.
    strides: the element strides of the batch, time and head dims of q, k
    and pq, nine ints. Raises on a dtype other than float32 or bfloat16,
    another device, a last dim that is not contiguous or shapes that do not
    match."""
    b, t, h, qd = q.shape
    pd = pq.shape[-1]
    if (qd, pd) not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel is built for (qd, pd) in "
                         f"{_KERNEL_HEAD_DIMS}, got {(qd, pd)}")
    if k.shape != q.shape or pq.shape[:3] != q.shape[:3] or lens.shape != (b,):
        raise ValueError("attention kernel: inconsistent shapes")
    xs = []
    for name, x in (("q", q), ("k", k), ("pq", pq)):
        if x.dtype not in (torch.float32, torch.bfloat16) or x.device != q.device:
            raise ValueError(f"{name} must be float32 or bfloat16 on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"attention kernel: {name}'s last dim must have stride 1, "
                             f"got strides {x.stride()}")
        xs.append(x if x.dtype == torch.float32 else x.to(torch.float32))
    q, k, pq = xs
    if k.data_ptr() % 16 or any(s % 4 for s in k.stride()[:3]):
        k = k.clone(memory_format=torch.contiguous_format)
    lens32 = lens.to(device=q.device, dtype=torch.int32).contiguous()
    strides = tuple(s for x in (q, k, pq) for s in x.stride()[:3])
    return q, k, pq, lens32, strides


def _attention_weights_cuda(q, k, pq, pos_proj_weight, pos_emb, lens,
                            band_bf16=False, entry=None, pos_table=None):
    """Launch svt_attention_weights (svt_attention_weights_bf16band with
    band_bf16), or `entry`, another build of the same C entry point (an A/B
    against an earlier kernel), which counts no launch. pos_table: the
    kernel_pos_table of (pos_proj_weight, pos_emb), if the caller keeps it."""
    global launches, bf16band_launches
    q, k, pq, lens32, strides = kernel_args(q, k, pq, lens)
    b, t, h, qd = q.shape
    pd = pq.shape[-1]
    if pos_emb.shape[0] != 2 * t - 1:
        raise ValueError("attention kernel: pos_emb must have 2T-1 rows")
    if pos_table is None:
        pos_table = kernel_pos_table(pos_proj_weight, pos_emb, h)
    if pos_table.shape != (h, 2 * t - 1, pd) or pos_table.dtype != torch.float32 \
            or not pos_table.is_contiguous() or pos_table.data_ptr() % 16 \
            or pos_table.device != q.device:
        raise ValueError("attention kernel: pos_table must be [H, 2T-1, pd] float32, "
                         f"contiguous and 16-byte aligned, on {q.device}")
    out = torch.empty((b, h, t, t), dtype=torch.bfloat16, device=q.device)
    if t == 0 or b == 0:
        return out
    name = "svt_attention_weights_bf16band" if band_bf16 else "svt_attention_weights"
    fn = entry or getattr(cuda_lib.library(), name)
    status = fn(q.data_ptr(), k.data_ptr(), pq.data_ptr(), pos_table.data_ptr(),
                lens32.data_ptr(), out.data_ptr(), b, h, t, qd, pd, *strides,
                cuda_lib.stream(q.device))
    cuda_lib.check(status, name)
    if entry is None:
        if band_bf16:
            bf16band_launches += 1
        else:
            launches += 1
    return out


def attention_weights(q, k, pq, pos_proj_weight, pos_emb, lens,
                      pos_dtype=torch.float32, pos_table=None):
    """[B, H, S, T] keys-major attention weights.

    CPU tensors: the plain twin, float32 (pos scores rounded to pos_dtype).
    CUDA tensors (float32, or bfloat16 widened exactly): the kernel, bf16
    out (position scores always in float32, as in the TPU kernel); q, k and
    pq are read in place. pos_table, if given, is kernel_pos_table(
    pos_proj_weight, pos_emb, H) kept by the caller (the CPU twin ignores
    it). Consumers cast to their compute dtype.
    """
    if q.device.type == "cpu":
        return attention_weights_plain(q, k, pq, pos_proj_weight, pos_emb,
                                       lens, pos_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"attention_weights: unsupported device {q.device}")
    return _attention_weights_cuda(q, k, pq, pos_proj_weight, pos_emb, lens,
                                   pos_table=pos_table)


def attention_weights_bf16band(q, k, pq, pos_proj_weight, pos_emb, lens):
    """[B, H, S, T] keys-major attention weights with the position scores
    rounded to bf16 before the add (the arguments of attention_weights).

    CPU tensors: the plain twin, float32. CUDA tensors (float32, or bfloat16
    widened exactly): the kernel, bf16 out.
    """
    if q.device.type == "cpu":
        return attention_weights_bf16band_plain(q, k, pq, pos_proj_weight,
                                                pos_emb, lens)
    if q.device.type != "cuda":
        raise ValueError(f"attention_weights_bf16band: unsupported device {q.device}")
    return _attention_weights_cuda(q, k, pq, pos_proj_weight, pos_emb, lens,
                                   band_bf16=True)
