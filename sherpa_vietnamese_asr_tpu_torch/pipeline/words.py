# Copied from sherpa_vietnamese_asr_tpu/pipeline/words.py (host numpy; only the package path changes).
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

from __future__ import annotations


import numpy as np

_ENTROPY_FALLBACK = {"tsallis_norm": 0, "margin": 1, "entropy_norm": 0,
                     "top1_prob": 1.0}


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
    toks = [id2token[int(t)] if int(t) in id2token else ""
            for t in tokens[:n]] if isinstance(id2token, dict) else [
        id2token[int(t)] if int(t) < len(id2token) else "" for t in tokens[:n]]
    ts = [float(f) / t_total * chunk_duration_sec for f in frames[:n]]
    if not ts:
        return []
    avg_dur = (ts[-1] - ts[0]) / (n - 1) if n >= 2 else 0.08

    words = []
    cur = None
    ents = np.asarray(entropy[:n], dtype=np.float64)
    probs = np.exp(np.asarray(tok_logp[:n], dtype=np.float64))

    def close(cur):
        if cur is None:
            return
        e = cur.pop("_ents")
        cur["prob"] = float(np.mean(cur.pop("_probs")))
        if e:
            e = np.asarray(e)
            cur["tsallis_max"] = round(float(e[:, 0].max()), 4)
            cur["margin_min"] = round(float(e[:, 1].min()), 4)
            cur["entropy_norm"] = round(float(e[:, 2].mean()), 4)
            confs = e[:, 1] * (1.0 - e[:, 0])
            cur["_conf"] = round(float(confs.mean()), 4)
        else:
            cur["tsallis_max"] = cur["margin_min"] = None
            cur["entropy_norm"] = cur["_conf"] = None
        words.append(cur)

    for j, (t_val, tok) in enumerate(zip(ts, toks)):
        start_new = tok.startswith(" ") or tok.startswith("▁")
        end_local = ts[j + 1] if j < n - 1 else t_val + avg_dur
        piece = {
            "start": t_val + time_offset, "end": end_local + time_offset,
            "local_start": t_val, "local_end": end_local,
        }
        if start_new or cur is None:
            close(cur)
            cur = {
                "text": tok.lstrip(" ").lstrip("▁").lower(),
                **piece,
                "_last_bpe_start": piece["start"],
                "_probs": [probs[j]],
                "_ents": [ents[j]],
            }
        else:
            cur["text"] += tok.lower()
            cur["end"] = piece["end"]
            cur["local_end"] = piece["local_end"]
            cur["_last_bpe_start"] = piece["start"]
            cur["_probs"].append(probs[j])
            cur["_ents"].append(ents[j])
    close(cur)

    if words:
        words[0]["_chunk_bpe_tokens"] = list(toks)
        words[0]["_chunk_bpe_timestamps_local"] = list(ts)

    # Re-estimate word ends from last-piece start + average piece duration
    # (asr_engine.py:1316-1326).
    for wi, w in enumerate(words):
        est_end = w.pop("_last_bpe_start") + avg_dur
        if wi < len(words) - 1:
            est_end = min(est_end, words[wi + 1]["start"])
        w["end"] = est_end
        w["local_end"] = est_end - time_offset
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
