# Port of sherpa_vietnamese_asr_tpu/pipeline/words.py (host numpy): the same
# words, built in array passes over each row instead of a loop over its tokens.
# BeamResult -> word list: BPE merge, timestamps, per-word probability and
# entropy aggregation.
#
# Host-side port of the reference's decode_chunk post-processing
# (reference core/asr_engine.py:1209-1330): frame indices scale linearly to
# seconds via chunk_duration/T; BPE pieces starting with U+2581 (or space)
# open a new word; per-word prob is the mean of piece probs; entropy metrics
# aggregate as tsallis_max / margin_min / mean entropy; word end times are
# re-estimated from the last piece start + average piece duration, clipped to
# the next word's start.
#
# Each id2token gets a table of its pieces' flags and lower-cased texts once
# (cached on the object; the counter decode_words_tables counts the builds).
# A row's word boundaries are then one lookup, max and min one reduceat each,
# and the means of a multi-piece word one np.mean of its slice, so every sum
# runs in np.mean's order on the loop's arrays: the words equal the JAX
# package's loop bit for bit.

from __future__ import annotations

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.utils import trace

_ENTROPY_FALLBACK = {"tsallis_norm": 0, "margin": 1, "entropy_norm": 0,
                     "top1_prob": 1.0}
_OPENS = (" ", "▁")  # a piece starting with either opens a word
_TABLES = {}  # id(id2token) -> (id2token, _Vocab)
_TABLES_MAX = 16


class _Vocab:
    """Per-id arrays of pieces 0 .. size - 1, and a last entry "" that rows
    fill in for ids outside them: the piece, whether it opens a word, its
    text as a word's first piece and as a later one."""

    __slots__ = ("size", "raw", "opens", "head", "cont")

    def __init__(self, pieces):
        self.size = len(pieces)
        pieces = list(pieces) + [""]
        self.raw = _objects(pieces)
        self.opens = np.fromiter((p.startswith(_OPENS) for p in pieces),
                                 dtype=bool, count=len(pieces))
        self.head = _objects([_head(p) for p in pieces])
        self.cont = _objects([p.lower() for p in pieces])


def _objects(items):
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def _head(piece):
    return piece.lstrip(" ").lstrip("▁").lower()


def _piece(id2token, t):
    """Piece of id t: "" for an id a dict lacks or one past a list's end."""
    if isinstance(id2token, dict):
        return id2token[t] if t in id2token else ""
    return id2token[t] if t < len(id2token) else ""


def _vocab(id2token):
    """The table of ids 0 .. len(id2token) - 1, built on id2token's first use;
    any other id is looked up on its own."""
    hit = _TABLES.get(id(id2token))
    if hit is not None and hit[0] is id2token:
        return hit[1]
    table = _Vocab([_piece(id2token, i) for i in range(len(id2token))])
    if len(_TABLES) >= _TABLES_MAX:
        _TABLES.clear()
    _TABLES[id(id2token)] = (id2token, table)
    trace.count("decode_words_tables", 1)
    return table


def beam_result_to_words(tokens, frames, tok_logp, entropy, num_tokens,
                         enc_len, id2token, chunk_duration_sec,
                         time_offset=0.0):
    """Convert one chunk's beam-search output to merged words.

    Args:
        tokens/frames/tok_logp: [U] arrays (first num_tokens valid).
        entropy: [U, 4] (tsallis_norm, margin, entropy_norm, top1).
        enc_len: valid encoder frames T for this chunk.
        id2token: dict or list mapping token id -> BPE piece string.
        chunk_duration_sec: audio seconds in this chunk.
        time_offset: seconds to add to absolute timestamps.

    Returns list of word dicts with text/start/end/local_start/local_end/
    prob/tsallis_max/margin_min/entropy_norm/_conf, plus _chunk_bpe_tokens &
    _chunk_bpe_timestamps_local attached to the first word.
    """
    n = int(num_tokens)
    t_total = int(enc_len)
    if n == 0 or t_total == 0:
        return []
    ts = np.asarray(frames[:n]).astype(np.float64) / t_total * chunk_duration_sec
    ids = np.asarray(tokens[:n]).astype(np.int64)
    if not ts.size or not ids.size:
        return []
    ts_list = ts.tolist()
    avg_dur = (ts_list[-1] - ts_list[0]) / (n - 1) if n >= 2 else 0.08

    table = _vocab(id2token)
    inside = (ids >= 0) & (ids < table.size)
    at = np.where(inside, ids, table.size)
    raw, opens = table.raw[at], table.opens[at]
    head, text = table.head[at], table.cont[at]
    for j in np.flatnonzero(~inside).tolist():  # negative, or past the table
        p = _piece(id2token, int(ids[j]))
        raw[j], opens[j], head[j], text[j] = p, p.startswith(_OPENS), _head(p), p.lower()

    opens[0] = True  # the first piece opens a word either way
    first = np.flatnonzero(opens)
    last = np.append(first[1:], len(ids)) - 1
    text[first] = head[first]
    texts = text[first].tolist()

    probs = np.exp(np.asarray(tok_logp[:n], dtype=np.float64))
    ents = np.ascontiguousarray(entropy[:n], dtype=np.float64)
    confs = ents[:, 1] * (1.0 - ents[:, 0])
    prob, ent_mean, conf = probs[first], ents[first, 2], confs[first]
    pieces = text.tolist()
    for w in np.flatnonzero(last > first).tolist():
        s, e = first[w], last[w] + 1
        texts[w] = "".join(pieces[s:e])
        prob[w] = np.mean(probs[s:e])
        ent_mean[w] = np.mean(ents[s:e, 2])
        conf[w] = np.mean(confs[s:e])

    # Word ends re-estimated from the last piece's start + average piece
    # duration, clipped to the next word's start (asr_engine.py:1316-1326).
    starts = ts + time_offset
    end = starts[last] + avg_dur
    nxt = starts[first[1:]]
    end[:-1] = np.where(nxt < end[:-1], nxt, end[:-1])
    words = [
        {"text": x, "start": s, "end": e, "local_start": ls, "local_end": le,
         "prob": p, "tsallis_max": round(a, 4), "margin_min": round(b, 4),
         "entropy_norm": round(c, 4), "_conf": round(d, 4)}
        for x, s, e, ls, le, p, a, b, c, d in zip(
            texts, starts[first].tolist(), end.tolist(), ts[first].tolist(),
            (end - time_offset).tolist(), prob.tolist(),
            np.maximum.reduceat(ents[:, 0], first).tolist(),
            np.minimum.reduceat(ents[:, 1], first).tolist(),
            ent_mean.tolist(), conf.tolist())]
    words[0]["_chunk_bpe_tokens"] = raw.tolist()
    words[0]["_chunk_bpe_timestamps_local"] = ts_list
    return words


def word_confidence(w):
    """margin * (1 - tsallis) confidence, prob fallback (asr_engine.py:1336)."""
    margin, tsallis = w.get("margin_min"), w.get("tsallis_max")
    if margin is not None and tsallis is not None:
        return margin * (1.0 - tsallis)
    return w.get("prob", 0.5)


def block_confidence(words):
    if not words:
        return 0.0
    return sum(word_confidence(w) for w in words) / len(words)


def mean_word_prob(words):
    if not words:
        return 0.0
    return float(np.mean([w.get("prob", 1.0) for w in words]))
