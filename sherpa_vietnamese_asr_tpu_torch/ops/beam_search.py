# Batched RNN-T modified beam search in plain PyTorch: the plain twin of the
# CUDA beam-search kernel (ops/beam_search_cuda.py).
#
# Port of sherpa_vietnamese_asr_tpu/ops/beam_search.py: a loop over encoder
# frames, batched over chunks, with
#   * hypotheses as dense [N, beam, U] tensors and the decoder context
#     carried as a [N, beam, K] ring of token ids;
#   * log-softmax, then a global top-k over beam x vocab ordered by score
#     descending with the LOWEST flat index first on ties (a stable
#     descending sort; torch.topk promises no tie order);
#   * the hotword boost after top-k and the finalize subtraction;
#   * log-add merge of hypotheses with identical emitted sequences;
#   * per-token entropy metrics (tsallis, margin, entropy, top1) of the
#     parent's raw logits, margin 0 on an exact probability tie;
#   * length-normalised final selection (len(ys) = n_emitted + context).

from __future__ import annotations

import dataclasses
import math

import torch

from sherpa_vietnamese_asr_tpu_torch.models.rnnt import (
    Decoder,
    Joiner,
    RnntConfig,
    decoder_forward,
    joiner_forward,
)

NEG_INF = -1e30


@dataclasses.dataclass
class HotwordTables:
    """Dense Aho-Corasick tables (built on the host). State 0 is the root."""

    next_state: torch.Tensor  # [S, V] int
    delta: torch.Tensor       # [S, V] float32 score delta of forward_one_step
    node_score: torch.Tensor  # [S] float32 (finalize(s) = -node_score[s])

    def to(self, device) -> "HotwordTables":
        return HotwordTables(self.next_state.to(device), self.delta.to(device),
                             self.node_score.to(device))


@dataclasses.dataclass
class BeamResult:
    tokens: torch.Tensor      # [N, U] int32 emitted token ids (padded with 0)
    frames: torch.Tensor      # [N, U] int32 encoder frame of each emission
    tok_logp: torch.Tensor    # [N, U] f32 per-token log-prob
    entropy: torch.Tensor     # [N, U, 4] f32 (tsallis_norm, margin, entropy_norm, top1)
    num_tokens: torch.Tensor  # [N] int32
    total_logp: torch.Tensor  # [N] f32 score of the selected hypothesis


def metric_constants(v: int):
    """(alpha, max_entropy, tsallis_max) of the entropy metrics."""
    alpha = 1.0 / 3.0
    max_entropy = math.log(v) if v > 1 else 1.0
    tsallis_max = (1.0 / (alpha - 1.0)) * (1.0 - v ** (1.0 - alpha)) \
        if v > 1 else 1.0
    return alpha, max_entropy, tsallis_max


def _entropy_metrics(logits):
    """[..., V] raw logits -> [..., 4] metrics (margin 0 on an exact tie)."""
    alpha, max_entropy, tsallis_max = metric_constants(logits.shape[-1])
    x = logits - logits.max(dim=-1, keepdim=True).values
    p = torch.exp(x)
    p = p / p.sum(dim=-1, keepdim=True)
    entropy = -(p * torch.log(p + 1e-30)).sum(dim=-1)
    tsallis = (1.0 / (alpha - 1.0)) * (1.0 - (p ** alpha).sum(dim=-1))
    top2 = torch.topk(p, 2, dim=-1).values  # values only: ties give margin 0
    top1 = top2[..., 0]
    return torch.stack([tsallis / tsallis_max, top1 - top2[..., 1],
                        entropy / max_entropy, top1], dim=-1)


def _take(x, idx):
    """x [N, beam, ...] gathered along the beam axis by idx [N, beam']."""
    n = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[n, idx]


def beam_search_batch(enc_out, enc_lens, decoder: Decoder, joiner: Joiner,
                      cfg: RnntConfig, beam_size: int = 8,
                      hw_tables: HotwordTables | None = None) -> BeamResult:
    """Modified beam search over a batch of chunks (plain PyTorch).

    Args:
        enc_out: [N, T, E] encoder outputs (padded).
        enc_lens: [N] valid encoder frames per chunk.
        decoder/joiner: the RNN-T modules.
        beam_size: fixed beam width; 1 == greedy-style decode.
        hw_tables: optional HotwordTables.

    Returns:
        BeamResult of [N, T]-shaped arrays.
    """
    with torch.no_grad():
        return _beam_search(enc_out, enc_lens, decoder, joiner, cfg,
                            beam_size, hw_tables)


def _beam_search(enc_out, enc_lens, decoder, joiner, cfg, beam, hw):
    dev = enc_out.device
    n, t_max, _ = enc_out.shape
    u = t_max
    v = cfg.vocab_size
    i32 = torch.int32
    tokens = torch.zeros((n, beam, u), dtype=i32, device=dev)
    frames = torch.zeros((n, beam, u), dtype=i32, device=dev)
    tok_logp = torch.zeros((n, beam, u), device=dev)
    entropy = torch.zeros((n, beam, u, 4), device=dev)
    n_emit = torch.zeros((n, beam), dtype=i32, device=dev)
    logp = torch.full((n, beam), NEG_INF, device=dev)
    logp[:, 0] = 0.0
    hw_state = torch.zeros((n, beam), dtype=torch.long, device=dev)
    # Decoder context ring ([-1, 0] + emitted, >= 0 -> starts as zeros).
    ctx = torch.zeros((n, beam, cfg.context_size), dtype=torch.long,
                      device=dev)
    lens = enc_lens.to(dev)
    cols = torch.arange(u, device=dev)
    beam_ids = torch.arange(beam, device=dev)
    # lower_or_self[i, j] = i <= j
    lower_or_self = beam_ids[:, None] <= beam_ids[None, :]

    for t in range(t_max):
        dec_out = decoder_forward(decoder, ctx)                       # [N, beam, D]
        logits = joiner_forward(joiner, enc_out[:, t, None, :], dec_out)  # [N, beam, V]
        log_probs = torch.log_softmax(logits, dim=-1)
        acc = (log_probs + logp[:, :, None]).reshape(n, beam * v)
        top_scores, top_idx = torch.sort(acc, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
        hi = top_idx // v                                             # [N, beam]
        tok = top_idx % v
        is_blank = tok == cfg.blank_id

        p_n = _take(n_emit, hi)
        p_ctx = _take(ctx, hi)
        p_hw = _take(hw_state, hi)
        new_ctx = torch.where(is_blank[..., None], p_ctx,
                              torch.cat([p_ctx[..., 1:], tok[..., None]], -1))
        at_pos = (cols == p_n.clamp(0, u - 1)[..., None]) & ~is_blank[..., None]
        new_tokens = torch.where(at_pos, tok[..., None].to(i32),
                                 _take(tokens, hi))
        new_frames = torch.where(at_pos, t, _take(frames, hi))
        tok_lp = torch.gather(_take(log_probs, hi), 2, tok[..., None])[..., 0]
        new_tok_logp = torch.where(at_pos, tok_lp[..., None],
                                   _take(tok_logp, hi))
        ent = _take(_entropy_metrics(logits), hi)                     # [N, beam, 4]
        new_ent = torch.where(at_pos[..., None], ent[:, :, None, :],
                              _take(entropy, hi))
        new_n = p_n + (~is_blank).to(i32)

        new_score = top_scores
        if hw is not None:
            delta = hw.delta[p_hw, tok]
            nxt = hw.next_state[p_hw, tok].to(torch.long)
            apply = ~is_blank & (tok != cfg.unk_id)
            new_score = new_score + torch.where(apply, delta, 0.0)
            new_hw = torch.where(apply, nxt, p_hw)
        else:
            new_hw = p_hw

        # Dedup: log-add candidates with identical emitted sequences into the
        # first (highest-scoring) of them.
        same_len = new_n[:, :, None] == new_n[:, None, :]
        eq_tok = ((new_tokens[:, :, None, :] == new_tokens[:, None, :, :])
                  | (cols >= new_n[:, :, None, None])).all(dim=-1)
        equal = same_len & eq_tok                                     # [N, i, j]
        # canon[j] = min{i <= j : equal[i, j]} (the diagonal is always True)
        canon = torch.argmax((equal & lower_or_self).to(i32), dim=1)  # [N, beam]
        is_canon = canon == beam_ids
        member = equal & (canon[:, None, :] == beam_ids[None, :, None])
        contrib = torch.where(member, new_score[:, None, :], NEG_INF)
        merged = torch.logsumexp(contrib, dim=-1)
        new_score = torch.where(is_canon, merged, NEG_INF)

        valid = (t < lens)[:, None]                                   # [N, 1]
        tokens = torch.where(valid[..., None], new_tokens, tokens)
        frames = torch.where(valid[..., None], new_frames, frames)
        tok_logp = torch.where(valid[..., None], new_tok_logp, tok_logp)
        entropy = torch.where(valid[..., None, None], new_ent, entropy)
        n_emit = torch.where(valid, new_n, n_emit)
        logp = torch.where(valid, new_score, logp)
        hw_state = torch.where(valid, new_hw, hw_state)
        ctx = torch.where(valid[..., None], new_ctx, ctx)

    if hw is not None:
        # finalize: subtract the unfinished partial-match score
        logp = logp - hw.node_score[hw_state]
    norm = torch.clamp_min(n_emit + cfg.context_size, 1).to(torch.float32)
    best = torch.argmax(logp / norm, dim=1)                           # [N]
    rows = torch.arange(n, device=dev)
    return BeamResult(tokens=tokens[rows, best], frames=frames[rows, best],
                      tok_logp=tok_logp[rows, best],
                      entropy=entropy[rows, best],
                      num_tokens=n_emit[rows, best],
                      total_logp=logp[rows, best])
