# Copied from sherpa_vietnamese_asr_tpu/utils/beam_search_ref.py (host numpy; only the package path changes).
# Reference (oracle) RNN-T modified beam search — dict-based, host numpy.
#
# This mirrors the algorithm of the reference app's _ort_beam_search
# (reference core/asr_engine.py:1023-1171) with pluggable decoder/joiner
# callables, and is used ONLY as the numeric oracle for
# ops/beam_search.py's fixed-shape TPU implementation:
#   per frame: log-softmax + accumulate -> global top-k (un-boosted) ->
#   hotword delta on non-blank/non-unk -> dedup equal token sequences via
#   log-add (descending-score insertion order) -> next beam; finalize hotword
#   partial scores; length-normalized best (len includes the 2-token init
#   context).

from __future__ import annotations

import numpy as np


def log_add(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    diff = b - a
    return a if diff < -36.0 else a + float(np.log1p(np.exp(diff)))


def ref_beam_search(enc_out, decoder_fn, joiner_fn, vocab_size,
                    beam_size=8, ctx_graph=None, blank_id=0, unk_id=2,
                    context_size=2):
    """Oracle beam search over one chunk.

    Args:
        enc_out: [T, E] numpy encoder output (valid frames only).
        decoder_fn: f([N, context_size] int32) -> [N, D] numpy.
        joiner_fn: f([N, E], [N, D]) -> [N, V] numpy logits.
        ctx_graph: optional ops.hotword.ContextGraph.

    Returns dict with tokens, frames, tok_logp, total_logp (of best hyp).
    """
    t_total = enc_out.shape[0]
    init_state = ctx_graph.root if ctx_graph is not None else None
    # hyp: (ys tuple incl. [-1, 0] prefix, logp, frames, tok_lps, hw_state)
    init_ys = tuple([-1] * (context_size - 1) + [blank_id])
    hyps = {init_ys: (init_ys, 0.0, (), (), init_state)}

    for t in range(t_total):
        prev = list(hyps.values())
        n = len(prev)
        ctx = np.array(
            [[max(0, y) for y in h[0][-context_size:]] for h in prev],
            dtype=np.int32)
        dec = decoder_fn(ctx)
        enc = np.repeat(enc_out[t][None, :], n, axis=0)
        logits = joiner_fn(enc, dec)
        mx = logits.max(axis=-1, keepdims=True)
        sh = logits - mx
        logp = sh - np.log(np.exp(sh).sum(axis=-1, keepdims=True))
        acc = logp + np.array([h[1] for h in prev])[:, None]

        flat = acc.reshape(-1)
        k = min(beam_size, flat.size)
        idx = np.argpartition(flat, -k)[-k:]
        idx = idx[np.argsort(flat[idx])[::-1]]

        new_hyps = {}
        for ix in idx:
            hi, tok = int(ix // vocab_size), int(ix % vocab_size)
            score = float(flat[ix])
            p_ys, p_lp, p_fr, p_tl, p_cs = prev[hi]
            if tok == blank_id:
                ys, fr, tl, cs = p_ys, p_fr, p_tl, p_cs
            else:
                ys = p_ys + (tok,)
                fr = p_fr + (t,)
                tl = p_tl + (float(logp[hi, tok]),)
                cs = p_cs
                if ctx_graph is not None and tok != unk_id:
                    d, cs = ctx_graph.forward_one_step(p_cs, tok)
                    score += d
            if ys in new_hyps:
                old = new_hyps[ys]
                new_hyps[ys] = (old[0], log_add(old[1], score),
                                old[2], old[3], old[4])
            else:
                new_hyps[ys] = (ys, score, fr, tl, cs)
        hyps = new_hyps

    if ctx_graph is not None:
        hyps = {k: (v[0], v[1] + ctx_graph.finalize(v[4]), v[2], v[3], v[4])
                for k, v in hyps.items()}

    best = max(hyps.values(), key=lambda h: h[1] / max(len(h[0]), 1))
    tokens = [y for y in best[0][context_size:] if y > 0]
    return {
        "tokens": np.array(tokens, dtype=np.int32),
        "frames": np.array(best[2], dtype=np.int32),
        "tok_logp": np.array(best[3], dtype=np.float32),
        "total_logp": float(best[1]),
    }
