"""RNN-T prediction and search, plain float32.

The stateless decoder embeds the last two tokens and applies a grouped
Conv1d (groups D / 4) over them with ReLU; the joiner projects an encoder
frame and a decoder output to the joiner width, adds them, takes tanh and
projects to the vocabulary. Modified beam search (at most one token a
frame) keeps the beam best of beam x vocab by accumulated log-probability
each frame, a stable descending order, ties to the lower flat index; equal
token sequences are merged by log-add into the first of them; the result
is the hypothesis with the best score / (tokens + 2).

Weights by name: decoder.embedding [V, D], decoder.conv_weight [D, 4, 2],
joiner.{encoder_proj,decoder_proj,output}.{weight,bias}.
"""

from __future__ import annotations

import torch

from portbench.reference.precision import Precision

NEG_INF = -1e30
BLANK = 0


def decoder(P: Precision, W, ctx):
    """[..., 2] token ids -> [..., D]."""
    emb = W["decoder.embedding"][ctx]                            # [..., 2, D]
    w = W["decoder.conv_weight"]                                 # [D, I, K]
    d, ipg, k = w.shape
    g = d // ipg
    x = emb.reshape(*emb.shape[:-1], g, ipg)                     # [..., K, G, I]
    out = P.einsum("...kgi,goik->...go", x, w.reshape(g, d // g, ipg, k))
    return torch.relu(out.reshape(*emb.shape[:-2], d))


def joiner(P: Precision, W, enc, dec):
    h = torch.tanh(P.linear(enc, W["joiner.encoder_proj.weight"], W["joiner.encoder_proj.bias"])
                   + P.linear(dec, W["joiner.decoder_proj.weight"], W["joiner.decoder_proj.bias"]))
    return P.linear(h, W["joiner.output.weight"], W["joiner.output.bias"])


def _take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def beam_search(P: Precision, W, enc, lens, beam):
    """enc [N, T, E], lens [N] -> dict of the best hypothesis of each row:
    "score" (merged log-probability), "norm" (score / (tokens + 2)),
    "n" (tokens), and [N, T] "tokens", "frames", "tok_logp" (the first n
    valid)."""
    dev = enc.device
    n, t_max, _ = enc.shape
    v = W["joiner.output.weight"].shape[0]
    seq = torch.zeros((n, beam, t_max), dtype=torch.long, device=dev)
    frm = torch.zeros((n, beam, t_max), dtype=torch.long, device=dev)
    tlp = torch.zeros((n, beam, t_max), device=dev)
    n_emit = torch.zeros((n, beam), dtype=torch.long, device=dev)
    score = torch.full((n, beam), NEG_INF, device=dev)
    score[:, 0] = 0.0
    ctx = torch.zeros((n, beam, 2), dtype=torch.long, device=dev)
    cols = torch.arange(t_max, device=dev)
    ids = torch.arange(beam, device=dev)
    with P.active():
        for t in range(t_max):
            logp = torch.log_softmax(joiner(P, W, enc[:, t, None, :], decoder(P, W, ctx)), dim=-1)
            acc = (logp + score[:, :, None]).reshape(n, beam * v)
            top, idx = torch.sort(acc, dim=-1, descending=True, stable=True)
            top, idx = top[:, :beam], idx[:, :beam]
            hi, tok = idx // v, idx % v
            blank = tok == BLANK
            p_n, p_ctx = _take(n_emit, hi), _take(ctx, hi)
            new_ctx = torch.where(blank[..., None], p_ctx, torch.stack([p_ctx[..., 1], tok], -1))
            at = (cols == p_n.clamp(max=t_max - 1)[..., None]) & ~blank[..., None]
            new_seq = torch.where(at, tok[..., None], _take(seq, hi))
            new_frm = torch.where(at, t, _take(frm, hi))
            tok_lp = torch.gather(_take(logp, hi), 2, tok[..., None])
            new_tlp = torch.where(at, tok_lp, _take(tlp, hi))
            new_n = p_n + (~blank).long()
            same = (new_n[:, :, None] == new_n[:, None, :]) & (
                (new_seq[:, :, None, :] == new_seq[:, None, :, :])
                | (cols >= new_n[:, :, None, None])).all(-1)
            first = torch.argmax((same & (ids[:, None] <= ids[None, :])).int(), dim=1)
            member = same & (first[:, None, :] == ids[None, :, None])
            merged = torch.logsumexp(torch.where(member, top[:, None, :], NEG_INF), dim=-1)
            new_score = torch.where(first == ids, merged, NEG_INF)
            live = (t < lens)[:, None]
            seq = torch.where(live[..., None], new_seq, seq)
            frm = torch.where(live[..., None], new_frm, frm)
            tlp = torch.where(live[..., None], new_tlp, tlp)
            n_emit = torch.where(live, new_n, n_emit)
            score = torch.where(live, new_score, score)
            ctx = torch.where(live[..., None], new_ctx, ctx)
    norm = score / (n_emit + 2).float()
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(n, device=dev)
    return {"score": score[rows, best], "norm": norm[rows, best], "n": n_emit[rows, best],
            "tokens": seq[rows, best], "frames": frm[rows, best], "tok_logp": tlp[rows, best]}


def token_logprobs(P: Precision, W, enc, tokens, frames):
    """Log-probability of each token of a path at its frame, with the two
    tokens before it as context: enc [T, E], tokens/frames [U] ->[U]."""
    u = tokens.shape[0]
    if u == 0:
        return enc.new_zeros(0)
    prev = torch.cat([tokens.new_zeros(2), tokens])
    ctx = torch.stack([prev[:u], prev[1: u + 1]], dim=-1)
    with P.active():
        logp = torch.log_softmax(joiner(P, W, enc[frames], decoder(P, W, ctx)), dim=-1)
    return torch.gather(logp, 1, tokens[:, None])[:, 0]


def path_logprob(P: Precision, W, enc, tokens, frames):
    """Log-probability of one alignment over every frame of enc [T, E]:
    each token at its frame (at most one a frame, frames ascending) with
    the two tokens before it as context, blank at every other frame."""
    t_len, u = enc.shape[0], tokens.shape[0]
    t = torch.arange(t_len, device=enc.device)
    before = torch.searchsorted(frames.contiguous(), t) if u else torch.zeros_like(t)
    hist = torch.cat([tokens.new_zeros(2), tokens])
    ctx = torch.stack([hist[before], hist[before + 1]], dim=-1)
    sym = torch.full((t_len,), BLANK, dtype=torch.long, device=enc.device)
    if u:
        sym[frames] = tokens
    with P.active():
        logp = torch.log_softmax(joiner(P, W, enc, decoder(P, W, ctx)), dim=-1)
    return float(torch.gather(logp, 1, sym[:, None]).sum())


def greedy_gap(P: Precision, W, enc, ctx0, served):
    """How far the served tokens of one chunk lie below the best logit.

    enc [T, E] frames of the chunk, ctx0 the two tokens before it, served
    the token ids served for it (at most one a frame, in order). Over every
    alignment of the served tokens to the frames (blank elsewhere), the
    widest gap max_v logit - logit of the aligned symbol, minimised; a
    served sequence that fits no alignment gives inf."""
    t_len, k = enc.shape[0], len(served)
    if k > t_len:
        return float("inf")
    hist = torch.tensor(list(ctx0) + list(served), dtype=torch.long, device=enc.device)
    ctx = torch.stack([hist[:k + 1], hist[1: k + 2]], dim=-1)      # context after j tokens
    with P.active():
        logits = joiner(P, W, enc[:, None, :], decoder(P, W, ctx)[None])  # [T, K+1, V]
    top = logits.max(dim=-1).values
    gap_blank = (top - logits[..., BLANK]).cpu().tolist()
    nxt = hist[2:]
    gap_tok = (top[:, :k] - torch.gather(logits[:, :k], 2, nxt[None, :, None].expand(t_len, k, 1))[..., 0]
               ).cpu().tolist() if k else []
    best = [0.0] + [float("inf")] * k                               # best[j]: j tokens placed
    for t in range(t_len):
        nb = [max(best[j], gap_blank[t][j]) for j in range(k + 1)]
        for j in range(k):
            nb[j + 1] = min(nb[j + 1], max(best[j], gap_tok[t][j]))
        best = nb
    return best[k]
