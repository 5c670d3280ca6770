# Copied from sherpa_vietnamese_asr_tpu/pipeline/rover.py (host-only; only the package path changes).
# ROVER dual-model fusion: confidence-based word selection between the 30M
# and 68M Zipformer decodes of the same audio.
#
# Behavioral port of reference core/asr_engine.py:1446-1577 (rover_merge_words
# v3) and :1352-1443 (hotword block bonus):
#   equal -> keep A; replace -> higher block confidence (with +0.5*ratio
#   hotword bonus when exactly one side matches hotwords, using 3 words of
#   context from neighboring equal blocks); insert -> add B words with
#   confidence > 0.20; delete -> keep A. B-supplements are timestamp-sorted
#   and deduplicated (+-0.15 s same normalized text). Disagreeing words carry
#   a _disagree flag that survives overlap merging.

from __future__ import annotations

from difflib import SequenceMatcher

from sherpa_vietnamese_asr_tpu_torch.pipeline.merge import normalize_word
from sherpa_vietnamese_asr_tpu_torch.pipeline.words import (
    block_confidence,
    word_confidence,
)

HOTWORD_ROVER_BONUS = 0.5
CONTEXT_WORDS = 3
SUPPLEMENT_MIN_CONF = 0.20


def count_hotword_matches(words, phrases, context_before=None,
                          context_after=None):
    """Fraction of block words covered by hotword phrases, scanning the block
    plus neighboring context (asr_engine.py:1366-1443). phrases must be
    lowercase, sorted longest-first."""
    if not words or not phrases:
        return 0.0
    ctx_b = list(context_before or [])
    ctx_a = list(context_after or [])
    all_words = ctx_b + list(words) + ctx_a
    text = " ".join(normalize_word(w["text"]) for w in all_words)
    matched_chars = set()
    for phrase in phrases:
        start = 0
        while True:
            i = text.find(phrase, start)
            if i < 0:
                break
            matched_chars.update(range(i, i + len(phrase)))
            start = i + 1
    if not matched_chars:
        return 0.0
    n_matched = 0
    pos = 0
    b0, b1 = len(ctx_b), len(ctx_b) + len(words)
    for wi, w in enumerate(all_words):
        wt = normalize_word(w["text"])
        ws = text.find(wt, pos)
        if ws >= 0:
            we = ws + len(wt)
            if b0 <= wi < b1 and any(c in matched_chars for c in range(ws, we)):
                n_matched += 1
            pos = we
    return n_matched / len(words)


def rover_merge_words(words_a, words_b, hotword_phrases=None):
    """Merge model A and B word streams. Returns (merged, disagree_indices).

    Words chosen from a disagreeing block are flagged with _disagree=True so
    indices can be rebuilt after chunk-overlap merging (asr_engine.py:2555).
    """
    if not words_a:
        return (list(words_b) if words_b else []), set()
    if not words_b:
        return list(words_a), set()

    texts_a = [normalize_word(w["text"]) for w in words_a]
    texts_b = [normalize_word(w["text"]) for w in words_b]
    opcodes = SequenceMatcher(None, texts_a, texts_b,
                              autojunk=False).get_opcodes()
    phrases = sorted([p.lower() for p in (hotword_phrases or [])],
                     key=len, reverse=True)

    result = []
    n_sup = 0
    for oi, (tag, i1, i2, j1, j2) in enumerate(opcodes):
        if tag == "equal":
            result.extend(words_a[i1:i2])
        elif tag == "replace":
            block_a, block_b = words_a[i1:i2], words_b[j1:j2]
            conf_a, conf_b = block_confidence(block_a), block_confidence(block_b)
            if phrases:
                ctx_ba = ctx_bb = ctx_aa = ctx_ab = None
                if oi > 0 and opcodes[oi - 1][0] == "equal":
                    _, p1, p2, q1, q2 = opcodes[oi - 1]
                    ctx_ba = words_a[max(p1, p2 - CONTEXT_WORDS): p2]
                    ctx_bb = words_b[max(q1, q2 - CONTEXT_WORDS): q2]
                if oi < len(opcodes) - 1 and opcodes[oi + 1][0] == "equal":
                    _, p1, p2, q1, q2 = opcodes[oi + 1]
                    ctx_aa = words_a[p1: min(p2, p1 + CONTEXT_WORDS)]
                    ctx_ab = words_b[q1: min(q2, q1 + CONTEXT_WORDS)]
                hw_a = count_hotword_matches(block_a, phrases, ctx_ba, ctx_aa)
                hw_b = count_hotword_matches(block_b, phrases, ctx_bb, ctx_ab)
                if hw_a > 0 and hw_b == 0:
                    conf_a += hw_a * HOTWORD_ROVER_BONUS
                elif hw_b > 0 and hw_a == 0:
                    conf_b += hw_b * HOTWORD_ROVER_BONUS
            chosen = block_b if conf_b > conf_a else block_a
            for w in chosen:
                w["_disagree"] = True
            result.extend(chosen)
        elif tag == "delete":
            result.extend(words_a[i1:i2])
        elif tag == "insert":
            for k in range(j1, j2):
                wb = words_b[k]
                if word_confidence(wb) > SUPPLEMENT_MIN_CONF:
                    wb["_source"] = "B_supplement"
                    wb["_disagree"] = True
                    result.append(wb)
                    n_sup += 1

    result.sort(key=lambda w: w["start"])

    if n_sup > 0:
        deduped = []
        for w in result:
            if w.get("_source") == "B_supplement":
                wn = normalize_word(w["text"])
                dup = any(
                    e.get("_source") != "B_supplement"
                    and abs(e["start"] - w["start"]) < 0.15
                    and normalize_word(e["text"]) == wn
                    for e in deduped)
                if dup:
                    continue
            deduped.append(w)
        result = deduped

    disagree = {i for i, w in enumerate(result) if w.get("_disagree")}
    for w in result:
        w.pop("_source", None)
    return result, disagree


def rebuild_disagree_indices(all_words):
    """After overlap merging, rebuild disagree indices from the surviving
    _disagree flags and strip them (asr_engine.py:2553-2563)."""
    out = set()
    for i, w in enumerate(all_words):
        if w.get("_disagree"):
            out.add(i)
            w.pop("_disagree", None)
    return out or None
