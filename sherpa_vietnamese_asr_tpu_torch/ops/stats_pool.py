# Masked statistics pooling, batched over chunks and speaker slots.
#
# Port of sherpa_vietnamese_asr_tpu/ops/stats_pool.py: pyannote
# StatsPool._pool()'s weighted mean and std, with the same two-pass formula
# and the same eps placement. The JAX package has no Pallas kernel here (two
# einsums), so the port runs the same two library products.

from __future__ import annotations

import torch


def masked_stats_pool(frame_feat: torch.Tensor, weights: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Weighted statistics pooling.

    Args:
        frame_feat: [B, D, T] frame features.
        weights: [B, S, T] per-speaker frame weights (binary or soft).

    Returns:
        [B, S, 2D] concat(weighted mean, weighted std) per (chunk, speaker).
    """
    v1 = weights.sum(dim=-1) + eps                                   # [B, S]
    mean = torch.einsum("bdt,bst->bsd", frame_feat, weights) / v1[:, :, None]
    dx = frame_feat[:, None, :, :] - mean[:, :, :, None]             # [B, S, D, T]
    v2 = (weights * weights).sum(dim=-1)                             # [B, S]
    var = torch.einsum("bsdt,bst->bsd", dx * dx, weights) / (
        v1 - v2 / v1 + eps)[:, :, None]
    return torch.cat([mean, torch.sqrt(torch.clamp_min(var, 0.0))], dim=-1)
