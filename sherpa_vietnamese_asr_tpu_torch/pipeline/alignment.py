# Copied from sherpa_vietnamese_asr_tpu/pipeline/alignment.py (host-only; only the package path changes).
# Sentence-to-word timestamp alignment after punctuation restoration.
#
# Behavioral port of the reference's alignment flows:
#   * find_word_sequence_match fuzzy forward matcher and the no-diarization
#     sentence alignment (reference core/asr_engine.py:3160-3300);
#   * diarization-first alignment with per-speaker sentence splitting
#     (asr_engine.py:2940-3057);
#   * pause-hint construction from word gaps with speaker-boundary injection
#     (asr_engine.py:2884-2908).

from __future__ import annotations

import re
from functools import lru_cache

_NON_WORD_RE = re.compile(r"[^\w\s]", re.UNICODE)


@lru_cache(maxsize=65536)
def normalize_align_word(word: str) -> str:
    # Memoized: the aligners normalize the same ASR words O(sentences) times
    # during the forward fuzzy match, and transcript vocabulary repeats.
    word = word.lower().strip()
    word = _NON_WORD_RE.sub("", word)
    return word.replace(" ", "")


def build_pause_hints(all_words, word_speaker=None):
    """pause_hints[i] = seconds of gap after word i (last word -> 1.0);
    speaker boundaries force gap >= 1.0."""
    if not all_words or len(all_words) < 2:
        return None
    hints = []
    for i in range(len(all_words)):
        if i < len(all_words) - 1:
            gap = max(0.0, all_words[i + 1].get("start", 0)
                      - all_words[i].get("end", 0))
        else:
            gap = 1.0
        if (word_speaker is not None and i < len(word_speaker) - 1
                and word_speaker[i] != word_speaker[i + 1]):
            gap = max(gap, 1.0)
        hints.append(gap)
    return hints


def split_sentences(text: str):
    return re.split(r"(?<=[.?!])\s+", text)


def find_word_sequence_match(asr_words, target_words, start_idx,
                             max_look_ahead=50):
    """Fuzzy forward match of normalized sentence words against ASR words.
    Returns (start_index, last_matched_index) or (None, None)."""
    if not target_words:
        return None, None
    first = normalize_align_word(target_words[0])
    if not first:
        return None, None

    def m(a, b):
        return a == b or (len(a) > 2 and len(b) > 2 and (a in b or b in a))

    end_search = min(start_idx + max_look_ahead, len(asr_words))
    best, best_score = None, 0.0
    for i in range(start_idx, end_search):
        if not m(normalize_align_word(asr_words[i]["text"]), first):
            continue
        matched, last, offset = 1, i, 0
        for j in range(1, len(target_words)):
            tw = normalize_align_word(target_words[j])
            if not tw:
                matched += 1
                continue
            k = i + j + offset
            if k >= len(asr_words):
                break
            if m(normalize_align_word(asr_words[k]["text"]), tw):
                matched += 1
                last = k
            else:
                if k + 1 < len(asr_words) and m(
                        normalize_align_word(asr_words[k + 1]["text"]), tw):
                    matched += 1
                    last = k + 1
                    offset += 1
                    continue
                break
        score = matched / len(target_words)
        if score > best_score:
            best_score, best = score, (i, last)
        if score >= 0.95:
            break
    if best_score >= 0.7:
        return best
    return None, None


def align_sentences(sentences, all_words, progress_callback=None):
    """No-diarization alignment (asr_engine.py:3226-3300)."""
    final_segments = []
    cur = 0
    for sent in sentences:
        sent = sent if sent else ""
        if not sent.strip():
            continue
        sent_words = [w for w in sent.split() if w.strip()]
        if not sent_words:
            continue
        clean = [w for w in (normalize_align_word(x) for x in sent_words) if w]

        ms, me = find_word_sequence_match(all_words, clean, cur)
        if ms is not None:
            seg_words = all_words[ms: me + 1]
            start_t, end_t = all_words[ms]["start"], all_words[me]["end"]
            cur = me + 1
        else:
            first = clean[0] if clean else ""
            idx = cur
            found = False
            while idx < len(all_words):
                aw = normalize_align_word(all_words[idx]["text"])
                if first and (first in aw or aw in first):
                    found = True
                    break
                idx += 1
            if found:
                end_idx = min(idx + len(clean) - 1, len(all_words) - 1)
                cur_start = idx
            else:
                cur_start = min(cur, len(all_words) - 1) if all_words else 0
                end_idx = (min(cur_start + len(clean) - 1, len(all_words) - 1)
                           if all_words else 0)
            seg_words = all_words[cur_start: end_idx + 1] if all_words else []
            start_t = all_words[cur_start]["start"] if all_words else 0.0
            end_t = all_words[end_idx]["end"] if all_words else 0.0
            cur = end_idx + 1

        final_segments.append({"text": sent, "start": start_t, "end": end_t,
                               "raw_words": seg_words})
    return final_segments


def align_sentences_with_speakers(sentences, all_words, word_speaker,
                                  word_speaker_name):
    """Diarization-first alignment: forward word match plus per-speaker
    sentence splitting (asr_engine.py:2961-3057)."""
    final_segments = []
    cur = 0
    for sent in sentences:
        if not sent.strip():
            continue
        sent_words = [w for w in sent.split() if w.strip()]
        if not sent_words:
            continue
        clean = [w for w in (normalize_align_word(x) for x in sent_words) if w]
        match_len = len(clean)
        best_start = cur
        if best_start < len(all_words):
            first = clean[0] if clean else ""
            for si in range(cur, min(cur + 50, len(all_words))):
                if normalize_align_word(all_words[si].get("text", "")) == first:
                    best_start = si
                    break
        end_idx = min(best_start + match_len, len(all_words))
        if end_idx <= best_start:
            end_idx = min(best_start + 1, len(all_words))
        seg_words = all_words[best_start:end_idx]
        if seg_words:
            groups = []
            cur_spk = (word_speaker[best_start]
                       if best_start < len(word_speaker) else 0)
            grp_start = 0
            for off in range(end_idx - best_start):
                wi = best_start + off
                spk = word_speaker[wi] if wi < len(word_speaker) else cur_spk
                if spk != cur_spk:
                    groups.append((cur_spk, grp_start, off))
                    cur_spk, grp_start = spk, off
            groups.append((cur_spk, grp_start, end_idx - best_start))

            if len(groups) == 1:
                spk_id = groups[0][0]
                name = (word_speaker_name[best_start]
                        if best_start < len(word_speaker_name)
                        else "Người nói 1")
                final_segments.append({
                    "text": sent, "start": seg_words[0].get("start", 0),
                    "end": seg_words[-1].get("end", 0), "speaker": name,
                    "speaker_id": spk_id, "raw_words": seg_words})
            else:
                total_w = len(seg_words)
                for spk_id, g0, g1 in groups:
                    grp_words = seg_words[g0:g1]
                    if not grp_words:
                        continue
                    t0 = int(g0 / total_w * len(sent_words))
                    t1 = (len(sent_words) if g1 == total_w
                          else int(g1 / total_w * len(sent_words)))
                    grp_text = " ".join(sent_words[t0:t1])
                    if not grp_text.strip():
                        continue
                    name = (word_speaker_name[best_start + g0]
                            if best_start + g0 < len(word_speaker_name)
                            else "Người nói 1")
                    final_segments.append({
                        "text": grp_text, "start": grp_words[0].get("start", 0),
                        "end": grp_words[-1].get("end", 0), "speaker": name,
                        "speaker_id": spk_id, "raw_words": grp_words})
        cur = end_idx
    return final_segments
