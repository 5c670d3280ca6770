# Copied from sherpa_vietnamese_asr_tpu/pipeline/diarization_post.py (host numpy; only the package path changes).
# Diarization post-processing and word-to-speaker mapping.
#
# Behavioral port of reference core/speaker_diarization.py's host-side
# interval algebra:
#   * merge-with-gap, fragment-zone resolution (:693-762),
#   * NaturalTurn backchannel absorption, Cychosz et al. 2025 (:556-691),
#   * time-based word->speaker assignment with orphan-prefix fix (:830-987),
#   * process_with_transcription word-level splitting plus speech-continuity
#     and trailing-word boundary corrections (:989-1226),
#   * smooth_speaker_boundary_fragments (:1474-1588),
#   * post-processing order (:518-554).
# Pure Python/numpy — no device work; the model stages live in
# pipeline/diarization_pure.py.

from __future__ import annotations

import dataclasses

import numpy as np

WORD_ASSIGN_MAX_DURATION = 0.40
WORD_TURN_PREFIX_PAUSE = 0.45
WORD_TURN_PREFIX_EDGE_GAP = 0.15
SPEECH_CONT_GAP = 0.3


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    speaker: int

    @property
    def duration(self):
        return self.end - self.start


def speaker_name(speaker_id: int) -> str:
    return f"Người nói {speaker_id + 1}"


def merge_segments_with_gap(segments, max_gap=0.3):
    """Merge same-speaker segments separated by <= max_gap."""
    if not segments:
        return []
    segs = sorted(segments, key=lambda s: (s.start, s.speaker))
    merged = [Segment(segs[0].start, segs[0].end, segs[0].speaker)]
    for seg in segs[1:]:
        prev = merged[-1]
        if seg.speaker == prev.speaker and seg.start - prev.end <= max_gap:
            prev.end = max(prev.end, seg.end)
        else:
            merged.append(Segment(seg.start, seg.end, seg.speaker))
    return merged


def resolve_fragment_zones(segments, short_thresh=0.5, min_zone_size=3):
    """Runs of >= min_zone_size short segments collapse to the duration-
    dominant speaker."""
    if len(segments) < min_zone_size:
        return segments
    result = []
    n = len(segments)
    i = 0
    while i < n:
        if segments[i].duration < short_thresh:
            j = i
            while j < n and segments[j].duration < short_thresh:
                j += 1
            if j - i >= min_zone_size:
                durs = {}
                for k in range(i, j):
                    s = segments[k]
                    durs[s.speaker] = durs.get(s.speaker, 0) + s.duration
                dominant = max(durs, key=durs.get)
                result.append(Segment(segments[i].start, segments[j - 1].end,
                                      dominant))
                i = j
                continue
        result.append(Segment(segments[i].start, segments[i].end,
                              segments[i].speaker))
        i += 1
    return result


def natural_turn_merge(segments, max_pause=1.5, asr_words=None):
    """NaturalTurn floor-holding: absorb backchannels into the primary turn.

    1. per speaker collapse segments with gap < max_pause into turns;
    2. a turn fully inside another speaker's turn is secondary;
    3. secondary turns shorter than 2.0 s with <= 3 ASR words are
       backchannels and get the primary speaker;
    4. merge adjacent same-speaker results (gap < 0.5 s).
    """
    if len(segments) < 3:
        return segments
    segs = sorted(segments, key=lambda s: s.start)

    turns = []
    for spk in {s.speaker for s in segs}:
        idxs = [i for i, s in enumerate(segs) if s.speaker == spk]
        t_start, t_end, members = segs[idxs[0]].start, segs[idxs[0]].end, [idxs[0]]
        for k in idxs[1:]:
            if segs[k].start - t_end < max_pause:
                t_end = max(t_end, segs[k].end)
                members.append(k)
            else:
                turns.append((t_start, t_end, spk, members))
                t_start, t_end, members = segs[k].start, segs[k].end, [k]
        turns.append((t_start, t_end, spk, members))
    turns.sort(key=lambda t: t[0])

    n = len(turns)
    is_secondary = [False] * n
    primary_of = [None] * n
    for i in range(n):
        if is_secondary[i]:
            continue
        t1s, t1e, t1spk, _ = turns[i]
        for j in range(i + 1, n):
            if is_secondary[j]:
                continue
            t2s, t2e, t2spk, _ = turns[j]
            if t2s >= t1e:
                break
            if t2e <= t1e and t2spk != t1spk:
                is_secondary[j] = True
                primary_of[j] = i

    max_backchannel_dur = 2.0
    backchannel_word_max = 3

    def count_words(start, end):
        if not asr_words:
            return None
        return sum(1 for w in asr_words
                   if start <= (w.get("start", 0) + w.get("end", 0)) / 2 <= end)

    reassign = {}
    for j in range(n):
        if is_secondary[j] and primary_of[j] is not None:
            t2s, t2e, _, members = turns[j]
            if t2e - t2s >= max_backchannel_dur:
                continue
            wc = count_words(t2s, t2e)
            if wc is not None and wc > backchannel_word_max:
                continue
            primary_spk = turns[primary_of[j]][2]
            for idx in members:
                reassign[idx] = primary_spk

    result = [Segment(s.start, s.end, reassign.get(i, s.speaker))
              for i, s in enumerate(segs)]
    return merge_segments_with_gap(result, max_gap=0.5)


def post_process_diarization_segments(segments, asr_words=None):
    """merge -> fragment zones -> NaturalTurn -> merge (reference :518-554)."""
    if not segments:
        return segments
    segments = merge_segments_with_gap(segments, max_gap=0.3)
    segments = resolve_fragment_zones(segments, short_thresh=0.5,
                                      min_zone_size=3)
    segments = natural_turn_merge(segments, max_pause=2.0,
                                  asr_words=asr_words)
    return merge_segments_with_gap(segments, max_gap=0.3)


# ---------------------------------------------------------------------------
# Word-level speaker assignment
# ---------------------------------------------------------------------------

def _word_interval(word):
    start = float(word.get("start", 0) or 0)
    end = float(word.get("end", start) or start)
    if end < start:
        start, end = end, start
    end = min(end, start + WORD_ASSIGN_MAX_DURATION)
    if end <= start:
        end = start + WORD_ASSIGN_MAX_DURATION
    return start, end


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def _word_overlaps_speaker(word, speaker_segments, speaker_id):
    w0, w1 = _word_interval(word)
    if w1 <= w0:
        w1 = w0 + 0.001
    return any(seg.speaker == speaker_id
               and _overlap(w0, w1, seg.start, seg.end) > 0
               for seg in speaker_segments)


def _word_overlaps_any(word, speaker_segments):
    w0, w1 = _word_interval(word)
    return any(_overlap(w0, w1, seg.start, seg.end) > 0
               for seg in speaker_segments)


def _assign_speakers_batch(words, speaker_segments, fallback_speaker=None):
    """Vectorized largest-overlap assignment for a list of words.

    Exact numpy translation of the original per-word linear scan (overlap
    argmax, ties by midpoint distance then list order; gap words to the
    nearest boundary) — the scan was O(words x segments) in Python and
    dominated post-processing on long files.
    """
    if not speaker_segments:
        fb = fallback_speaker if fallback_speaker is not None else 0
        return [fb] * len(words)
    if not words:
        return []
    iv = np.array([_word_interval(w) for w in words], np.float64)  # [N, 2]
    w0, w1 = iv[:, 0], iv[:, 1]
    w1 = np.where(w1 <= w0, w0 + 0.001, w1)
    mid = (w0 + w1) / 2.0
    s0 = np.array([s.start for s in speaker_segments], np.float64)
    s1 = np.array([s.end for s in speaker_segments], np.float64)
    spk = np.array([s.speaker for s in speaker_segments])

    ov = np.maximum(0.0, np.minimum(w1[:, None], s1[None, :])
                    - np.maximum(w0[:, None], s0[None, :]))   # [N, M]
    best_ov = ov.max(axis=1)
    # Among max-overlap segments: min midpoint distance, then first in list
    # (argmin returns the first minimum, matching the scan's tie-break).
    dist = np.abs((s0 + s1)[None, :] / 2.0 - mid[:, None])
    dist_masked = np.where(ov == best_ov[:, None], dist, np.inf)
    best_idx = np.argmin(dist_masked, axis=1)
    labels = spk[best_idx].tolist()

    gap = best_ov <= 0
    if gap.any():
        # prev: largest end <= mid (first in list among ties — argmax
        # returns the first maximum); nxt: smallest start >= mid.
        gm = mid[gap]
        pe = np.where(s1[None, :] <= gm[:, None], s1[None, :], -np.inf)
        ns = np.where(s0[None, :] >= gm[:, None], s0[None, :], np.inf)
        pi, ni = np.argmax(pe, axis=1), np.argmin(ns, axis=1)
        pbest, nbest = pe[np.arange(len(gm)), pi], ns[np.arange(len(gm)), ni]
        fb = fallback_speaker if fallback_speaker is not None \
            else speaker_segments[0].speaker
        for k, wi in enumerate(np.nonzero(gap)[0]):
            has_p, has_n = np.isfinite(pbest[k]), np.isfinite(nbest[k])
            if has_p and has_n:
                labels[wi] = spk[pi[k]] if gm[k] - pbest[k] \
                    <= nbest[k] - gm[k] else spk[ni[k]]
            elif has_p:
                labels[wi] = spk[pi[k]]
            elif has_n:
                labels[wi] = spk[ni[k]]
            else:
                labels[wi] = fb
    return labels


def speaker_for_word_by_time(word, speaker_segments, fallback_speaker=None):
    """Largest-overlap assignment; gap words go to the nearest boundary."""
    return _assign_speakers_batch([word], speaker_segments,
                                  fallback_speaker=fallback_speaker)[0]


def speaker_labels_for_words(words, speaker_segments, fallback_speaker=None):
    """Per-word labels with the orphan-prefix correction (reference
    :930-987): an unmatched word just before a clear pause and a new turn
    moves to the following turn."""
    labels = _assign_speakers_batch(words, speaker_segments,
                                    fallback_speaker=fallback_speaker)
    for i in range(len(words) - 1):
        if labels[i] == labels[i + 1]:
            continue
        word, nxt_word = words[i], words[i + 1]
        word_end = float(word.get("end", word.get("start", 0)) or 0)
        next_start = float(nxt_word.get("start", 0) or 0)
        if next_start - word_end < WORD_TURN_PREFIX_PAUSE:
            continue
        if _word_overlaps_any(word, speaker_segments):
            continue
        if not _word_overlaps_speaker(nxt_word, speaker_segments,
                                      labels[i + 1]):
            continue
        w0, w1 = _word_interval(word)
        mid = (w0 + w1) / 2.0
        prev = nxt = None
        for seg in speaker_segments:
            if seg.end <= mid:
                if prev is None or seg.end > prev.end:
                    prev = seg
            elif seg.start >= mid:
                if nxt is None or seg.start < nxt.start:
                    nxt = seg
        if (prev is not None and nxt is not None
                and prev.speaker == labels[i]
                and nxt.speaker == labels[i + 1]
                and prev.speaker != nxt.speaker
                and w0 - prev.end >= WORD_TURN_PREFIX_EDGE_GAP):
            labels[i] = labels[i + 1]
    return labels


def process_with_transcription(transcribed_segments, speaker_segments):
    """Assign speakers to transcription segments, splitting at word level.

    Mirrors reference :989-1226 including the cross-segment speech-continuity
    correction and the trailing-word boundary fix.
    """
    if not speaker_segments:
        return transcribed_segments

    results = []
    for tseg in transcribed_segments:
        t0 = tseg.get("start", 0)
        t1 = tseg.get("end", t0 + 1)
        raw_words = tseg.get("raw_words", [])

        votes = {}
        for seg in speaker_segments:
            ov = _overlap(t0, t1, seg.start, seg.end)
            if ov > 0:
                votes[seg.speaker] = votes.get(seg.speaker, 0) + ov

        if not raw_words:
            if votes:
                sid = max(votes, key=votes.get)
                name = speaker_name(sid)
            elif results:
                name = results[-1].get("speaker", speaker_name(0))
                sid = results[-1].get("speaker_id", 0)
            else:
                name, sid = speaker_name(0), 0
            out = dict(tseg)
            out.update({"speaker": name, "speaker_id": sid})
            results.append(out)
            continue

        fallback = max(votes, key=votes.get) if votes else None
        labels = speaker_labels_for_words(raw_words, speaker_segments,
                                          fallback_speaker=fallback)
        groups = []
        cur_id, cur = None, []
        for w, sid in zip(raw_words, labels):
            if sid != cur_id:
                if cur:
                    groups.append((cur_id, cur))
                cur_id, cur = sid, [w]
            else:
                cur.append(w)
        if cur:
            groups.append((cur_id, cur))

        if len(groups) == 1:
            sid = groups[0][0]
            out = dict(tseg)
            out.update({"speaker": speaker_name(sid), "speaker_id": sid})
            results.append(out)
            continue

        punct_words = tseg.get("text", "").split()
        total_raw = len(raw_words)
        pi = 0
        for gi, (sid, gwords) in enumerate(groups):
            if gi == len(groups) - 1:
                g_punct = punct_words[pi:]
            else:
                num = int(round(len(gwords) / float(total_raw)
                                * len(punct_words)))
                if num == 0 and pi < len(punct_words):
                    num = 1
                g_punct = punct_words[pi: pi + num]
                pi += num
            out = dict(tseg)
            out.update({
                "text": " ".join(g_punct),
                "start": gwords[0].get("start", t0),
                "end": gwords[-1].get("end", t1),
                "speaker": speaker_name(sid),
                "speaker_id": sid,
                "raw_words": gwords,
            })
            results.append(out)

    # Cross-segment speech continuity: continuous words at the start of B
    # that do not overlap B's diarization belong to A.
    i = 0
    while i < len(results) - 1:
        a, b = results[i], results[i + 1]
        spk_a, spk_b = a.get("speaker_id"), b.get("speaker_id")
        rw_a, rw_b = a.get("raw_words", []), b.get("raw_words", [])
        if spk_a is None or spk_b is None or spk_a == spk_b \
                or not rw_a or not rw_b:
            i += 1
            continue
        last_end = rw_a[-1].get("end", 0)
        move = 0
        for w in rw_b:
            if w.get("start", 0) - last_end < SPEECH_CONT_GAP:
                if _word_overlaps_speaker(w, speaker_segments, spk_b):
                    break
                move += 1
                last_end = w.get("end", 0)
            else:
                break
        if 0 < move < len(rw_b):
            moved, rest = rw_b[:move], rw_b[move:]
            a["raw_words"] = rw_a + moved
            a["text"] = (a.get("text", "") + " "
                         + " ".join(w.get("text", "") for w in moved)).strip()
            a["end"] = moved[-1].get("end", a["end"])
            b["raw_words"] = rest
            b["text"] = " ".join(w.get("text", "") for w in rest)
            b["start"] = rest[0].get("start", b["start"])
        elif move == len(rw_b) and move > 0:
            a["raw_words"] = rw_a + rw_b
            a["text"] = (a.get("text", "") + " " + b.get("text", "")).strip()
            a["end"] = rw_b[-1].get("end", b["end"])
            results.pop(i + 1)
        else:
            i += 1

    # Trailing word at boundary: last word of A outside A's diarization
    # moves to B.
    i = 0
    while i < len(results) - 1:
        a, b = results[i], results[i + 1]
        spk_a, spk_b = a.get("speaker_id"), b.get("speaker_id")
        rw_a, rw_b = a.get("raw_words", []), b.get("raw_words", [])
        if spk_a is None or spk_b is None or spk_a == spk_b \
                or not rw_a or not rw_b:
            i += 1
            continue
        if not _word_overlaps_speaker(rw_a[-1], speaker_segments, spk_a) \
                and len(rw_a) > 1:
            moved = rw_a.pop()
            a["end"] = rw_a[-1].get("end", a["end"])
            a["text"] = " ".join(w.get("text", "") for w in rw_a)
            rw_b.insert(0, moved)
            b["start"] = moved.get("start", b["start"])
            b["raw_words"] = rw_b
            b["text"] = " ".join(w.get("text", "") for w in rw_b)
            continue
        i += 1
    return results


def smooth_speaker_boundary_fragments(segments):
    """Reassign tiny edge/island speaker fragments (reference :1474-1588)."""
    if not segments:
        return segments
    out = [dict(s) for s in segments]

    def sid(s):
        return s.get("speaker_id")

    def name_of(s):
        spk = s.get("speaker")
        if spk:
            return spk
        v = sid(s)
        return speaker_name(v) if isinstance(v, int) else speaker_name(0)

    def set_spk(dst, src):
        dst["speaker_id"] = sid(src)
        dst["speaker"] = name_of(src)

    def wc(s):
        rw = s.get("raw_words") or []
        if rw:
            return len(rw)
        return len([w for w in str(s.get("text", "")).split() if w.strip()])

    def dur(s):
        try:
            return float(s.get("end", 0)) - float(s.get("start", 0))
        except (TypeError, ValueError):
            return 0.0

    def gap(a, b):
        try:
            return float(b.get("start", 0)) - float(a.get("end", 0))
        except (TypeError, ValueError):
            return 999.0

    def ends_sentence(s):
        return str(s.get("text", "")).strip().endswith((".", "?", "!", "…"))

    # 1) short island between same speaker
    for i in range(1, len(out) - 1):
        prev, cur, nxt = out[i - 1], out[i], out[i + 1]
        if sid(prev) is None or sid(cur) is None:
            continue
        if sid(prev) == sid(nxt) and sid(cur) != sid(prev):
            if dur(cur) <= 1.5 or wc(cur) <= 4:
                set_spk(cur, prev)

    # 2) leading singleton after long pause joins the following turn
    for i in range(len(out) - 1):
        cur, nxt = out[i], out[i + 1]
        if sid(cur) == sid(nxt):
            continue
        prev = out[i - 1] if i > 0 else None
        prev_gap = gap(prev, cur) if prev is not None else 999.0
        if (wc(cur) <= 1 and dur(cur) <= 0.8 and not ends_sentence(cur)
                and wc(nxt) >= 2 and prev_gap >= 1.2
                and gap(cur, nxt) <= 2.5):
            set_spk(cur, nxt)

    # 3) tiny trailing particle stays with the continuing previous turn
    for i in range(len(out) - 1):
        cur, nxt = out[i], out[i + 1]
        if sid(cur) == sid(nxt):
            continue
        prev = out[i - 1] if i > 0 else None
        has_prev = (prev is not None and sid(prev) == sid(cur)
                    and gap(prev, cur) <= 1.0)
        if (has_prev and wc(nxt) <= 2 and dur(nxt) <= 0.9
                and not ends_sentence(cur) and ends_sentence(nxt)
                and gap(cur, nxt) <= 0.25):
            set_spk(nxt, cur)
    return out
