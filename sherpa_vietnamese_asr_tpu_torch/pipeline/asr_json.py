# Copied from sherpa_vietnamese_asr_tpu/pipeline/asr_json.py (host-only; only the package path changes).
# .asr.json v1 serialization — the persisted result format.
#
# Behavioral port of reference core/asr_json.py: versioned JSON with speaker
# separator entries interleaved with text segments, per-segment partials,
# raw_words with suspect flags and gap annotations, and the additive
# overlap_segments field. Readers of the reference format can read files
# written here and vice versa.

from __future__ import annotations

import json
from datetime import datetime


def serialize_segments(segments, speaker_name_mapping=None,
                       speaker_colors=None, model_name="unknown",
                       model_type="file", duration_sec=0.0, timing=None,
                       overlap_segments=None):
    """Internal segments -> JSON-serializable dict (format v1)."""
    speaker_name_mapping = speaker_name_mapping or {}
    speaker_colors = speaker_colors or {}

    out_segments = []
    current_speaker = None
    for i, seg in enumerate(segments):
        speaker = seg.get("speaker", "")
        speaker_id = seg.get("speaker_id", 0)
        display = speaker
        sid = str(speaker_id)
        if sid in speaker_name_mapping:
            display = speaker_name_mapping[sid]

        if display != current_speaker and display:
            try:
                sid_val = int(speaker_id)
            except (TypeError, ValueError):
                sid_val = speaker_id
            out_segments.append({
                "type": "speaker",
                "speaker": display,
                "speaker_id": sid_val,
                "start_time": seg.get("start", seg.get("start_time", 0)),
            })
            current_speaker = display

        partials = [{"text": p.get("text", ""),
                     "timestamp": p.get("timestamp", 0)}
                    for p in seg.get("partials", [])]
        if not partials:
            partials = [{"text": seg.get("text", ""),
                         "timestamp": seg.get("end",
                                              seg.get("start", 0) + 1.0)}]

        entry = {
            "type": "text",
            "text": seg.get("text", ""),
            "start_time": seg.get("start", seg.get("start_time", 0)),
            "segment_id": i,
            "partials": partials,
        }
        raw_words = seg.get("raw_words")
        if raw_words:
            rw_out = []
            for w in raw_words:
                wd = {"text": w.get("text", "")}
                for key in ("start", "end"):
                    if key in w:
                        try:
                            wd[key] = round(float(w[key]), 3)
                        except (TypeError, ValueError):
                            pass
                if w.get("gap_after_ms"):
                    wd["gap_after_ms"] = w["gap_after_ms"]
                if w.get("gap_before_ms"):
                    wd["gap_before_ms"] = w["gap_before_ms"]
                if w.get("_suspect_level"):
                    wd["suspect"] = w["_suspect_level"]
                rw_out.append(wd)
            entry["raw_words"] = rw_out
        out_segments.append(entry)

    data = {
        "version": 1,
        "model": model_name,
        "model_type": model_type,
        "created_at": datetime.now().isoformat(),
        "duration_sec": round(duration_sec, 2),
        "timing": timing or {},
        "speaker_names": dict(speaker_name_mapping),
        "speaker_colors": dict(speaker_colors),
        "segments": out_segments,
    }

    if overlap_segments:
        ov_out = []
        for ov in overlap_segments:
            spk_id = ov.get("speaker_id", 0)
            display = ov.get("speaker", f"Người nói {spk_id + 1}")
            if str(spk_id) in speaker_name_mapping:
                display = speaker_name_mapping[str(spk_id)]
            entry = {
                "speaker": display,
                "speaker_id": int(spk_id) if isinstance(spk_id, (int, float))
                else spk_id,
                "start_time": round(float(ov.get("start", 0)), 3),
                "end_time": round(float(ov.get("end", 0)), 3),
                "text": ov.get("text", ""),
            }
            if ov.get("raw_words"):
                entry["raw_words"] = [{
                    "text": w.get("word") or w.get("text") or "",
                    "start": round(float(w.get("start", 0)), 3),
                    "end": round(float(w.get("end", 0)), 3),
                } for w in ov["raw_words"]]
            ov_out.append(entry)
        data["overlap_segments"] = ov_out
    return data


def deserialize_segments(data):
    """JSON dict -> (segments, speaker_mapping, speaker_colors, has_speakers)."""
    if "segments" not in data:
        raise ValueError("Invalid JSON: no 'segments' key")
    speaker_mapping = data.get("speaker_names", {})
    speaker_colors = data.get("speaker_colors", {})

    segments = []
    current_speaker, current_id = "", 0
    has_speakers = False
    counter = 0
    for seg in data["segments"]:
        kind = seg.get("type", "text")
        if kind == "speaker":
            current_speaker = seg.get("speaker", "")
            raw = seg.get("speaker_id", 0)
            try:
                current_id = int(raw)
            except (TypeError, ValueError):
                current_id = raw
            has_speakers = True
            continue
        if kind != "text":
            continue
        text = seg.get("text", "")
        partials = [p for p in seg.get("partials", [])
                    if p.get("text", "").strip()]
        if not partials and text:
            partials = [{"text": text}]
        item = {
            "text": text,
            "start": seg.get("start_time", 0),
            "start_time": seg.get("start_time", 0),
            "index": counter,
            "speaker": current_speaker,
            "speaker_id": current_id,
        }
        if partials:
            item["partials"] = partials
            item["end"] = partials[-1].get("timestamp", item["start"] + 1.0)
        else:
            item["end"] = item["start"] + 1.0
            item["partials"] = [{"text": text, "timestamp": item["end"]}]
        if seg.get("raw_words"):
            item["raw_words"] = list(seg["raw_words"])
        segments.append(item)
        counter += 1
    return segments, speaker_mapping, speaker_colors, has_speakers


def deserialize_overlap_segments(data):
    """overlap_segments from JSON data ([] when absent)."""
    out = []
    for o in data.get("overlap_segments") or []:
        try:
            out.append({
                "speaker": o.get("speaker", ""),
                "speaker_id": int(o.get("speaker_id", 0)),
                "start": float(o.get("start_time", 0)),
                "end": float(o.get("end_time", 0)),
                "text": o.get("text", ""),
                "raw_words": o.get("raw_words", []),
                "overlap": True,
            })
        except (TypeError, ValueError):
            continue
    return out


def load_asr_json(path):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_asr_json(path, data):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2)
