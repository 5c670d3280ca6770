# Copied from sherpa_vietnamese_asr_tpu/pipeline/merge.py (host numpy; only the package path changes).
# Overlap-region text merging and segment splitting (host-side string logic).
#
# Behavioral port of the reference's overlap resolution
# (reference core/asr_engine.py:44-294: normalize/fuzzy word match, sliding
# offset alignment between the previous chunk's tail and the next chunk's
# head, confidence-based divergence resolution) and of split_long_segments
# (asr_engine.py:300-442). These algorithms define output equality, so the
# rules are preserved exactly; only the TPU-side decode that produces the
# word streams differs from the reference.

from __future__ import annotations

import re
import unicodedata
from difflib import SequenceMatcher

OVERLAP_SEC = 3.0
MAX_OVERLAP_WORDS = 100
FUZZY_MATCH_THRESHOLD = 0.8
MIN_MATCH_RATIO = 0.5


def normalize_word(word: str) -> str:
    """Lowercase, NFC, strip non-word chars (asr_engine.py:44-49)."""
    word = unicodedata.normalize("NFC", word.lower().strip())
    return re.sub(r"[^\w]", "", word, flags=re.UNICODE)


def words_match(w1: str, w2: str, threshold=FUZZY_MATCH_THRESHOLD) -> bool:
    """Exact, substring (len>2), or fuzzy-ratio match (asr_engine.py:52-67)."""
    if w1 == w2:
        return True
    if not w1 or not w2:
        return False
    if len(w1) > 2 and len(w2) > 2 and (w1 in w2 or w2 in w1):
        return True
    return SequenceMatcher(None, w1, w2).ratio() >= threshold


def _avg_prob(words):
    return sum(w.get("prob", 1.0) for w in words) / max(1, len(words))


def find_overlap_alignment(tail_words, head_words):
    """Align chunk-boundary word overlap.

    Returns (cut_index_in_head, action, tail_pop_count):
      * "cut_head": drop head[:cut_index], pop tail_pop_count merged words;
      * "drop_head": discard the whole head overlap (tail wins on confidence);
      * "drop_tail": discard the whole tail (head wins);
      * "none": nothing to do.
    Mirrors reference asr_engine.py:70-179 exactly, including the divergence
    guard and average-probability tie-break.
    """
    if not tail_words or not head_words:
        return 0, "none", 0

    original_tail_len = len(tail_words)
    tail_tr = tail_words[-MAX_OVERLAP_WORDS:]
    head_tr = head_words[:MAX_OVERLAP_WORDS]
    tail_n = [normalize_word(w["text"]) for w in tail_tr]
    head_n = [normalize_word(w["text"]) for w in head_tr]

    best_score, best_cut, best_pop = 0, 0, 0
    for offset in range(-len(tail_n) + 1, len(head_n)):
        score = 0
        matched_tail, matched_head = [], []
        for i, tw in enumerate(tail_n):
            j = i + offset
            if 0 <= j < len(head_n) and words_match(tw, head_n[j]):
                score += 1
                matched_tail.append(i)
                matched_head.append(j)
        window = min(len(head_n), len(tail_n) + offset) - max(0, offset)
        ratio = score / max(1, window)
        if score > best_score and ratio >= MIN_MATCH_RATIO:
            best_score = score
            best_cut = matched_head[-1] + 1
            best_pop = len(tail_n) - 1 - matched_tail[-1]

    min_len = min(len(tail_n), len(head_n))
    diverged = (best_score < min_len) and (best_pop > 0)

    if best_score == 0 or diverged:
        if best_score == 0:
            div_tail, div_head = tail_words, head_words
        else:
            div_tail = tail_words[-best_pop:] if best_pop > 0 else []
            div_head = head_words[best_cut:] if best_cut < len(head_words) else []
        if _avg_prob(div_tail) > _avg_prob(div_head):
            return len(head_words), "drop_head", 0
        return 0, "drop_tail", original_tail_len

    return best_cut, "cut_head", best_pop


def merge_chunks_with_overlap(chunk_results, overlap_duration_sec=OVERLAP_SEC):
    """Merge per-chunk word lists, de-duplicating the 3 s overlap regions.

    chunk_results: list of dicts with "words" (each word has text/start/end/
    local_start/local_end/prob), "audio_start_abs", "audio_end_abs",
    "overlap_sec". Returns (merged_words, merged_text).
    Mirrors reference asr_engine.py:182-237.
    """
    if not chunk_results:
        return [], ""

    merged = []
    for idx, chunk in enumerate(chunk_results):
        words = chunk["words"]
        if idx == 0:
            merged.extend(words)
            continue
        prev = chunk_results[idx - 1]
        prev_dur = prev["audio_end_abs"] - prev["audio_start_abs"]
        ov_start_local = prev_dur - overlap_duration_sec
        tail = [w for w in prev["words"]
                if w.get("local_start", 0) >= max(0, ov_start_local)]
        head = [w for w in words
                if w.get("local_start", 0) < overlap_duration_sec]
        cut, action, pop = find_overlap_alignment(tail, head)
        if pop > 0:
            del merged[-pop:]
        merged.extend(words[cut:] if cut < len(words) else [])

    return merged, " ".join(w["text"] for w in merged)


def split_long_segments(segments, max_duration=12.0, preserve_raw_words=False):
    """Split segments longer than max_duration into word-balanced parts.

    Comma boundaries are preferred; otherwise text is split into
    ceil(duration/max_duration) word-count-balanced parts with linearly
    interpolated timestamps (raw_words timestamps when available).
    Mirrors reference asr_engine.py:300-442.
    """
    if not segments:
        return segments
    result = []

    def emit(text, start, end, raw_words, src):
        part = {"text": text, "start": round(start, 3), "end": round(end, 3)}
        if preserve_raw_words and raw_words:
            part["raw_words"] = raw_words
        for k, v in src.items():
            if k not in ("text", "start", "end", "raw_words"):
                part[k] = v
        result.append(part)

    def split_span(text, start, end, raw_words, src):
        duration = end - start
        if duration <= max_duration or not text:
            emit(text, start, end, raw_words, src)
            return
        n_parts = int(duration / max_duration) + 1
        if duration % max_duration == 0:
            n_parts = int(duration / max_duration)
        n_parts = max(2, n_parts)
        words = text.split()
        total = len(words)
        if total < n_parts:
            emit(text, start, end, raw_words, src)
            return
        per, rem = divmod(total, n_parts)
        total_raw = len(raw_words)
        t_per_word = (end - start) / total if total else 0
        wi = ri = 0
        for p in range(n_parts):
            count = per + (1 if p < rem else 0)
            if count == 0:
                continue
            part_text = " ".join(words[wi: wi + count])
            if raw_words:
                raw_per, raw_rem = divmod(total_raw, n_parts)
                rcount = raw_per + (1 if p < raw_rem else 0)
                if rcount > 0 and ri < total_raw:
                    last = min(ri + rcount - 1, total_raw - 1)
                    p_start = raw_words[ri]["start"]
                    p_end = raw_words[last]["end"]
                    p_raw = raw_words[ri: last + 1]
                    ri += rcount
                else:
                    p_start = start + wi * t_per_word
                    p_end = start + (wi + count) * t_per_word
                    p_raw = []
            else:
                p_start = start + wi * t_per_word
                p_end = start + (wi + count) * t_per_word
                p_raw = []
            p_end = min(p_end, end)
            p_start = max(p_start, start)
            if p > 0 and result and p_start < result[-1]["end"]:
                p_start = result[-1]["end"]
                if p_end < p_start:
                    p_end = p_start + 0.1
            emit(part_text, p_start, p_end, p_raw, src)
            wi += count

    for seg in segments:
        duration = seg.get("end", 0) - seg.get("start", 0)
        text = seg.get("text", "").strip()
        if duration <= max_duration or not text:
            result.append(seg)
            continue
        if "," in text:
            parts = re.split(r"(?<=,)\s+", text)
            if len(parts) > 1:
                total_words = len(text.split())
                raw_words = seg.get("raw_words", [])
                t_per_word = duration / total_words if total_words else 0
                w_off = r_off = 0
                for part in parts:
                    part = part.strip()
                    if not part:
                        continue
                    count = len(part.split())
                    if raw_words:
                        p_raw = raw_words[r_off: r_off + count]
                        if p_raw:
                            p_start, p_end = p_raw[0]["start"], p_raw[-1]["end"]
                        else:
                            p_start = seg.get("start", 0) + w_off * t_per_word
                            p_end = seg.get("start", 0) + (w_off + count) * t_per_word
                        r_off += count
                    else:
                        p_start = seg.get("start", 0) + w_off * t_per_word
                        p_end = seg.get("start", 0) + (w_off + count) * t_per_word
                        p_raw = []
                    w_off += count
                    split_span(part, p_start, p_end, p_raw, seg)
                continue
        split_span(text, seg.get("start", 0), seg.get("end", 0),
                   seg.get("raw_words", []), seg)

    return result
