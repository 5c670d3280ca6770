"""The readers of the program's request spans and counters
(harness/program_spans.py and the metrics that use it) on synthetic
records: the window's requests alone are read, a lost or failed request
makes every reader give None, and the program's row counters give the
padded-row share of the same launches."""

import types

import pytest

from portbench.harness import cell, program_spans

NEW = ("decode_wait_share.offline", "decode_words_share.offline", "suspect_share.offline",
       "request_self_share.offline", "decode_wait_share.uploads", "vad_build_share.uploads",
       "decode_pad_share.uploads")
MEETING = ("diarization_share.meeting", "punctuation_share.meeting", "quality_share.meeting",
           "request_build_share.meeting")
S = 1_000_000_000  # ns a second
SETUP = 100.0  # setup_done, perf_counter seconds


def record(start_s, launches=((1, 8),), failed=False):
    """A request of 1 s from start_s: load_audio 0.1, vad 0.2 (vad_build
    0.05), plan 0.05, transcription 0.4 (upload 0.05, readback 0.1, words
    0.15), merge_suspect 0.15 (suspect 0.1); 0.1 s outside every child;
    counters from `launches` [(real rows, batch)]."""
    t = int(start_s * S)

    def at(a, b):
        return t + int(a * S), t + int(b * S)

    spans = [("load_audio", *at(0.0, 0.1), "request"),
             ("vad_build", *at(0.1, 0.15), "vad"), ("vad", *at(0.1, 0.3), "request"),
             ("plan", *at(0.3, 0.35), "request"),
             ("decode_upload", *at(0.35, 0.4), "transcription"),
             ("decode_readback", *at(0.4, 0.5), "transcription"),
             ("decode_words", *at(0.5, 0.65), "transcription"),
             ("transcription", *at(0.35, 0.75), "request"),
             ("suspect", *at(0.75, 0.85), "merge_suspect"),
             ("merge_suspect", *at(0.75, 0.9), "request"),
             ("request", *at(0.0, 1.0), None)]
    counters = {"decode_rows": sum(r for r, _ in launches),
                "decode_pad_rows": sum(b - r for r, b in launches)}
    return types.SimpleNamespace(spans=spans, counters=counters, failed=failed)


def trace_of(records, monkeypatch, n_requests=None, window_s=10.0):
    monkeypatch.setattr(program_spans, "finished", lambda: list(records))
    n = n_requests if n_requests is not None else sum(
        SETUP <= r.spans[-1][1] / S < SETUP + window_s for r in records)
    return {"setup_done": SETUP, "window_s": window_s,
            "requests": [{"wall_s": 1.0} for _ in range(n)]}


def read(name, t):
    return cell.reader(name)(t)


def test_only_the_windows_requests_are_read(monkeypatch):
    warm = record(SETUP - 5, launches=((8, 8),))  # before the window: no padding
    inside = [record(SETUP + 1 + 2 * i) for i in range(3)]
    after = record(SETUP + 10.5, launches=((8, 8),))  # sampled after the window ends
    t = trace_of([warm, *inside, after], monkeypatch)
    assert len(t["requests"]) == 3
    assert program_spans.records(t) == inside
    assert read("decode_wait_share.offline", t) == pytest.approx(15.0)
    assert read("decode_words_share.offline", t) == pytest.approx(15.0)
    assert read("suspect_share.offline", t) == pytest.approx(10.0)
    assert read("request_self_share.offline", t) == pytest.approx(10.0)
    assert read("vad_build_share.uploads", t) == pytest.approx(5.0)
    assert read("decode_pad_share.uploads", t) == pytest.approx(87.5)  # the warm request's 0 left out


@pytest.mark.parametrize("fault", ["lost", "failed", "no program records", "no requests"])
def test_a_lost_or_failed_request_gives_none(fault, monkeypatch):
    recs = [record(SETUP + 1 + 2 * i, failed=(fault == "failed" and i == 1)) for i in range(3)]
    if fault == "lost":  # the ring dropped one the window counted
        t = trace_of(recs[1:], monkeypatch, n_requests=3)
    else:
        t = trace_of(recs, monkeypatch, n_requests=0 if fault == "no requests" else None)
    if fault == "no program records":  # a program without utils/trace
        monkeypatch.setattr(program_spans, "finished", lambda: None)
    for name in NEW + MEETING:
        assert read(name, t) is None, name


def test_without_the_programs_module_finished_is_none(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sherpa_vietnamese_asr_tpu_torch.utils.trace", None)
    assert program_spans.finished() is None


def test_pad_share_equals_padded_row_share_for_the_same_launches(monkeypatch):
    per_request = [((1, 8),), ((3, 8),), ((8, 8), (2, 8)), ((1, 8),)]
    recs = [record(SETUP + 1 + 2 * i, launches=ls) for i, ls in enumerate(per_request)]
    t = trace_of(recs, monkeypatch)
    launches = [launch for ls in per_request for launch in ls]
    got = read("decode_pad_share.uploads", t)
    assert got == pytest.approx(100.0 * sum(b - r for r, b in launches) / sum(b for _, b in launches),
                                abs=1e-12)
    assert got == pytest.approx(100.0 * 25 / 40)


def test_self_share_counts_overlapping_children_once(monkeypatch):
    rec = record(SETUP + 1)
    start = rec.spans[-1][1]
    # a background span over the decode and merge (0.3-0.95 s): only
    # 0.9-0.95 s is new cover
    rec.spans.insert(0, ("quality_overlapped", start + int(0.3 * S), start + int(0.95 * S),
                         "request"))
    t = trace_of([rec], monkeypatch)
    assert read("request_self_share.offline", t) == pytest.approx(5.0)


def test_the_meeting_stages_shares(monkeypatch):
    """quality and diarization are the joins in the request's thread; the
    background quality_overlapped span is not read; the constructor's time
    is the wall outside the request span."""
    recs = []
    for i in range(2):
        rec = record(SETUP + 1 + 2 * i)
        start = rec.spans[-1][1]
        rec.spans[:0] = [(name, start + int(a * S), start + int(b * S), parent) for name, a, b, parent in (
            ("quality_overlapped", 0.3, 0.5, "request"), ("quality", 0.9, 0.91, "request"),
            ("diarization", 0.91, 0.95, "request"), ("punctuation", 0.95, 0.97, "request"))]
        recs.append(rec)
    t = trace_of(recs, monkeypatch)
    t["requests"] = [{"wall_s": 1.25} for _ in recs]
    assert read("quality_share.meeting", t) == pytest.approx(1.0)
    assert read("diarization_share.meeting", t) == pytest.approx(4.0)
    assert read("punctuation_share.meeting", t) == pytest.approx(2.0)
    assert read("request_build_share.meeting", t) == pytest.approx(20.0)
