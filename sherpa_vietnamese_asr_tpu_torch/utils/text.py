# Copied from sherpa_vietnamese_asr_tpu/utils/text.py (host-only; only the package path changes).
# Vietnamese text utilities: diacritics-insensitive normalization and fuzzy
# search (used by transcript search UIs).
#
# Behavioral port of reference core/utils.py:8-74.

from __future__ import annotations

import unicodedata
from difflib import SequenceMatcher


def normalize_vietnamese(text: str) -> str:
    """Lowercase, strip diacritics ('đ' handled manually — NFD does not
    decompose it)."""
    if not text:
        return ""
    text = text.lower().replace("đ", "d")
    text = unicodedata.normalize("NFD", text)
    return "".join(c for c in text if unicodedata.category(c) != "Mn")


def fuzzy_score(query: str, text: str) -> float:
    """Similarity in [0, 1]: substring=1.0, diacritics-insensitive
    substring=0.9, else SequenceMatcher ratio."""
    if not query or not text:
        return 0.0
    if query.lower() in text.lower():
        return 1.0
    qn, tn = normalize_vietnamese(query), normalize_vietnamese(text)
    if qn in tn:
        return 0.9
    return SequenceMatcher(None, qn, tn).ratio()


def find_fuzzy_matches(query: str, text: str, threshold: float = 0.6):
    """All (start, end, matched_text, score) positions: exact (1.0) then
    diacritics-insensitive (0.9) matches, deduplicated by position."""
    matches = []
    if not query or not text:
        return matches
    ql, tl = query.lower(), text.lower()
    qlen = len(query)
    start = 0
    while True:
        i = tl.find(ql, start)
        if i == -1:
            break
        matches.append((i, i + qlen, text[i: i + qlen], 1.0))
        start = i + 1
    qn, tn = normalize_vietnamese(query), normalize_vietnamese(text)
    start = 0
    while True:
        i = tn.find(qn, start)
        if i == -1:
            break
        matches.append((i, i + qlen, text[i: i + qlen], 0.9))
        start = i + 1
    seen = set()
    unique = []
    for s, e, m, score in matches:
        if (s, e) not in seen:
            seen.add((s, e))
            unique.append((s, e, m, score))
    return unique
