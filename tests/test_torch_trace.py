# The port's request spans and row counters (utils/trace.py), on the CPU with
# the tiny model of tests/test_torch_default_path.py:
#   (a) one TranscriberPipeline.run() leaves one finished record, with one id,
#       whose spans nest as the span tree below;
#   (b) each timing key is the duration of its span(s);
#   (c) the result's keys and timing keys still equal the JAX package's;
#   (d) decode_rows + decode_pad_rows are the rows of the launched batches;
#       decode_words_tables counts one vocabulary table for the two runs;
#   (e) a request that raises is flagged, one that is cancelled is not;
#   (f) the ring keeps its bound;
#   (g) the quality thread's span joins its request; counters from threads
#       lose nothing;
#   (h) every profiler range the program opens is an svt_ span (the ranges
#       are captured at torch.profiler.record_function: a CPU profile of the
#       tiny model's plain beam search holds 800k events), none takes another
#       prefix, and under the profiler the spans sit on its timeline.
# Two runs of the port: the default path (Silero VAD on, max_batch 2: one
# batch of two rows, one of one real and one padding row) and a run with stub
# stages (quality analysis in its background thread, punctuation,
# diarization; VAD bypassed).
import collections
import os
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_default_path import (  # noqa: E402
    HEAD_BIAS_SHIFT, _audio, _jax_model, _convert,
)

torch.set_num_threads(2)
SR = 16000

# span -> its parent span, as the pipeline opens them.
TREE = {
    "request": None,
    "load_audio": "request",
    "vad": "request", "vad_build": "vad", "vad_probs": "vad", "preprocessing": "vad",
    "plan": "request",
    "transcription": "request",
    "decode_build": "transcription", "decode_upload": "transcription",
    "decode_enqueue": "transcription", "decode_readback": "transcription",
    "decode_words": "transcription",
    "merge_suspect": "request", "merge": "merge_suspect", "suspect": "merge_suspect",
    "alignment": "request", "quality": "request", "quality_overlapped": "request",
    "diarization": "request", "punctuation": "request",
}
COMMON = {"request", "load_audio", "vad", "plan", "transcription", "decode_build",
          "decode_upload", "decode_enqueue", "decode_readback", "decode_words",
          "merge_suspect", "merge", "suspect", "alignment"}
SPANS = {"default": COMMON | {"vad_build", "vad_probs", "preprocessing"},
         "stages": COMMON | {"quality", "quality_overlapped", "punctuation", "diarization"}}
# timing key -> the spans whose durations it adds
TIMED = {"default": ("load_audio", "vad", "transcription", "merge_suspect", "alignment"),
         "stages": ("load_audio", "vad", "transcription", "merge_suspect", "alignment",
                    "quality", "quality_overlapped", "punctuation", "diarization")}
STAGES_CONFIG = {"bypass_vad": True, "max_batch": 2, "restore_punctuation": True,
                 "quality_analysis": True, "speaker_diarization": True}


class StubQuality:
    device = torch.device("cpu")

    def analyze_speech(self, audio):
        time.sleep(0.01)
        return {"mos_ovr": 3.0}


class StubRestorer:
    def restore(self, text, pause_hints=None):
        return text + "."


class StubDiarizer:
    def process(self, audio, progress_callback=None):
        half = len(audio) / SR / 2
        return [{"start": 0.0, "end": half, "speaker": 0},
                {"start": half, "end": len(audio) / SR, "speaker": 1}]


def _new_records(before):
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    return [r for r in trace.finished() if r.id not in before]


@pytest.fixture(scope="module")
def models():
    jm = _jax_model(0)
    return jm, _convert(jm, beam_size=4)


class RangeNames:
    """Stands in for torch.profiler.record_function and keeps the names."""

    def __init__(self, record_function):
        self.names, self._rf = [], record_function

    def __call__(self, name, args=None):
        self.names.append(name)
        return self._rf(name, args)


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """{case: (result, [new records], [(real rows, max_batch)] of each
    launch, names of the profiler ranges opened)} and the JAX package's
    default-path result."""
    import sherpa_vietnamese_asr_tpu.models.assets as jassets
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_silero_vad
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )
    from tests.test_model_oracles import _silero_v5_file

    import sherpa_vietnamese_asr_tpu_torch.models.assets as tassets
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_import as oi
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils import trace
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    import numpy as np

    tmp = tmp_path_factory.mktemp("trace")
    jm, tm = models
    path = str(_silero_v5_file(np.random.default_rng(0), tmp))
    params, cfg = load_silero_vad(path)
    params["out"]["bias"] = params["out"]["bias"] + np.float32(HEAD_BIAS_SHIFT)
    state, tcfg = oi.load_silero_vad(path)
    state["head.bias"] = state["head.bias"] + np.float32(HEAD_BIAS_SHIFT)
    wav = {}
    for name in ("j", "default", "stages"):
        wav[name] = str(tmp / f"{name}.wav")
        write_wav(wav[name], _audio(), SR)
    launches = []
    launch = decoder.BatchedChunkDecoder._launch

    def counted_launch(self, concat_audio, group):
        launches.append((len(group), self.max_batch))
        return launch(self, concat_audio, group)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jassets, "load_silero", lambda verify=True: (params, cfg))
        mp.setattr(tassets, "load_silero", lambda verify=True: (state, tcfg))
        mp.setattr(decoder.BatchedChunkDecoder, "_launch", counted_launch)
        out["jax"] = JaxPipeline(wav["j"], jm, config={"max_batch": 2}).run()
        for case, config, stages in (
                ("default", {"max_batch": 2}, {}),
                ("stages", STAGES_CONFIG, dict(quality_analyzer=StubQuality(),
                                               punct_restorer=StubRestorer(),
                                               diarizer=StubDiarizer()))):
            before = {r.id for r in trace.finished()}
            launches.clear()
            ranges = RangeNames(torch.profiler.record_function)
            with pytest.MonkeyPatch.context() as rf:
                rf.setattr(torch.profiler, "record_function", ranges)
                res = TranscriberPipeline(wav[case], tm, config, **stages).run()
            out[case] = (res, _new_records(before), list(launches), ranges.names)
    return out


CASES = ("default", "stages")


@pytest.mark.parametrize("case", CASES)
def test_a_request_leaves_one_record_whose_spans_nest(runs, case):
    _, records, _, _ = runs[case]
    assert len(records) == 1
    rec = records[0]
    assert not rec.failed and rec.name.endswith(f"{case}.wav")
    assert {name for name, *_ in rec.spans} == SPANS[case]
    assert [name for name, _, _, parent in rec.spans if parent is None] == ["request"]
    for name, start, end, parent in rec.spans:
        assert start <= end
        assert parent == TREE[name], (name, parent)
        if parent is not None:  # inside one span of its parent's name
            assert any(p == parent and s <= start and end <= e for p, s, e, _ in rec.spans), name
    assert rec.start_ns == next(s for name, s, _, _ in rec.spans if name == "request")


def test_requests_take_distinct_ids(runs):
    ids = [r.id for case in CASES for r in runs[case][1]]
    assert len(set(ids)) == len(ids) == 2


@pytest.mark.parametrize("case", CASES)
def test_each_timing_key_is_its_spans_duration(runs, case):
    res, (rec,), _, _ = runs[case]
    for key in TIMED[case]:
        want = sum((e - s) / 1e9 for name, s, e, _ in rec.spans if name == key)
        assert res["timing"][key] == pytest.approx(want, rel=1e-12, abs=1e-15), key
        assert want > 0, key
    request = next(e - s for name, s, e, _ in rec.spans if name == "request") / 1e9
    assert 0 < res["timing"]["total"] <= request
    assert res["timing"]["transcription_detail"] == res["timing"]["transcription"]


def test_result_and_timing_keys_equal_the_jax_package(runs):
    ref = runs["jax"]
    for case in CASES:
        got = runs[case][0]
        assert set(got) == set(ref)
        assert set(got["timing"]) == set(ref["timing"])


@pytest.mark.parametrize("case", CASES)
def test_row_counters_are_the_launched_rows(runs, case):
    _, (rec,), launches, _ = runs[case]
    counters = dict(rec.counters)
    counters.pop("decode_words_tables", None)  # the next test reads it
    assert launches and counters == {
        "decode_rows": sum(r for r, _ in launches),
        "decode_pad_rows": sum(b - r for r, b in launches)}
    assert rec.counters["decode_pad_rows"] > 0  # the last batch is padded
    launched = sum(1 for name, *_ in rec.spans if name == "decode_enqueue")
    assert launched == len(launches)


def test_a_vocabulary_table_is_built_by_one_request_only(runs):
    # Both runs share one model: its first request builds the word
    # builder's table of the vocabulary, the other reuses it.
    built = [runs[case][1][0].counters.get("decode_words_tables", 0)
             for case in CASES]
    assert sorted(built) == [0, 1]


@pytest.mark.parametrize("fault", ["missing file", "decode raises", "cancelled"])
def test_a_raising_request_is_flagged(models, fault, tmp_path, monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils import trace
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / "a.wav")
    if fault != "missing file":
        write_wav(path, _audio()[: SR * 5], SR)
    if fault == "decode raises":
        def broken(feats, n_frames, model):
            raise RuntimeError("planted")
        monkeypatch.setattr(decoder, "decode_feats", broken)
    _, model = models
    before = {r.id for r in trace.finished()}
    pipeline = TranscriberPipeline(path, model, {"bypass_vad": True, "max_batch": 2},
                                   cancel_check=(lambda: True) if fault == "cancelled" else None)
    if fault == "cancelled":
        assert pipeline.run() is None
    else:
        with pytest.raises((FileNotFoundError, RuntimeError)):
            pipeline.run()
    (rec,) = _new_records(before)
    assert rec.failed is (fault != "cancelled")
    names = [name for name, *_ in rec.spans]
    assert names[-1] == "request" and "load_audio" in names
    assert ("decode_enqueue" in names) is (fault == "decode raises")


def test_the_ring_keeps_its_bound(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    ids = []
    for i in range(trace.RING + 5):
        with trace.request(f"r{i}") as rec:
            with trace.span("load_audio"):
                pass
        ids.append(rec.id)
    kept = trace.finished()
    assert trace.RING == 4096 and len(kept) == trace.RING
    assert [r.id for r in kept] == ids[5:]  # oldest first
    assert [r.name for r in kept[:2]] == ["r5", "r6"]


def test_the_quality_thread_joins_its_request(runs):
    res, (rec,), _, _ = runs["stages"]
    (q,) = [s for s in rec.spans if s[0] == "quality_overlapped"]
    assert q[3] == "request"
    assert res["timing"]["quality_overlapped"] == pytest.approx((q[2] - q[1]) / 1e9, rel=1e-12)
    transcription = [s for s in rec.spans if s[0] == "transcription"][0]
    assert q[1] < transcription[2]  # started before the decode ended


def test_counters_from_joined_threads_lose_nothing():
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    n_threads, n_adds = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.request("stress") as rec:
            def add():
                with trace.joined(rec), trace.span("worker"):
                    for _ in range(n_adds):
                        trace.count("decode_rows", 1)

            threads = [threading.Thread(target=add) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters == {"decode_rows": n_threads * n_adds}
    assert sum(1 for name, _, _, parent in rec.spans
               if name == "worker" and parent == "request") == n_threads


def test_a_span_outside_a_request_records_nothing():
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    before = len(trace.finished())
    with trace.span("decode_upload") as sp:
        trace.count("decode_rows", 3)
    assert trace.current() is None and sp.seconds >= 0
    assert len(trace.finished()) == before


@pytest.mark.parametrize("case", CASES)
def test_every_program_range_is_an_svt_span(runs, case):
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    _, (rec,), _, names = runs[case]
    spans = [name for name, *_ in rec.spans]
    assert sorted(names) == sorted(trace.PREFIX + s for s in spans)
    assert not any(s.startswith("portbench") for s in spans)


def test_only_the_trace_module_opens_profiler_ranges():
    import sherpa_vietnamese_asr_tpu_torch as pkg

    root = os.path.dirname(pkg.__file__)
    opening = []
    for folder, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(folder, f), encoding="utf-8") as fh:
                    text = fh.read()
                if "record_function(" in text or "portbench" in text:
                    opening.append(os.path.relpath(os.path.join(folder, f), root))
    assert opening == [os.path.join("utils", "trace.py")]


def test_spans_sit_on_the_profilers_timeline():
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.request("profiled") as rec:
            with trace.span("merge"):
                torch.ones(64).add_(1)
    events = {e.name: e for e in prof.events() if e.name.startswith(trace.PREFIX)}
    assert set(events) == {"svt_request", "svt_merge"}
    req, merge = events["svt_request"].time_range, events["svt_merge"].time_range
    assert req.start <= merge.start and merge.end <= req.end
    adds = [e for e in prof.events() if e.name == "aten::add_"]
    assert adds and merge.start <= adds[0].time_range.start <= merge.end
    assert [name for name, *_ in rec.spans] == ["merge", "request"]


def test_idle_gaps_are_named_by_the_innermost_range():
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import idle_gaps

    device = [(0, 100), (50, 200), (700, 800)]
    ranges = [("request", 0, 1000), ("transcription", 150, 900), ("decode_words", 300, 600),
              ("decode_readback", 600, 750)]
    gaps = idle_gaps(device, ranges, 0, 1000)
    # 200-700 (middle 450: decode_words) and 800-1000 (middle 900: the edge
    # of transcription, the shorter of the two ranges there)
    assert [(ms, name) for ms, name, _ in gaps] == [(0.5, "decode_words"),
                                                    (0.2, "transcription")]
    assert gaps[0][2] == {"decode_words": 0.3, "decode_readback": 0.1, "transcription": 0.1}
    assert gaps[1][2] == pytest.approx({"request": 0.1, "transcription": 0.1})
    assert idle_gaps(device, ranges, 0, 1000, n=1) == gaps[:1]
    assert idle_gaps([], [], 0, 1000) == [(1.0, "none", {"none": 1.0})]


def test_request_gaps_read_the_programs_ranges_from_a_profile():
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import request_gaps
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.request("profiled"):
            with trace.span("load_audio"):
                time.sleep(0.05)
            with trace.span("merge_suspect"), trace.span("suspect"):
                time.sleep(0.01)
    # no device event on the CPU: the whole request is one gap
    ((ms, name, parts),) = request_gaps(prof)
    assert name == "load_audio" and 60 <= ms < 1000
    assert set(parts) <= {"request", "load_audio", "merge_suspect", "suspect"}
    assert parts["load_audio"] >= 50 and parts["suspect"] >= 10
    assert sum(parts.values()) == pytest.approx(ms)


def test_a_profiler_range_is_kept_in_no_record():
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.request("layers") as rec:
            with trace.span("decode_enqueue"), trace.profiler_range("encoder_layer"):
                torch.ones(64).add_(1)
    names = {e.name for e in prof.events() if e.name.startswith(trace.PREFIX)}
    assert names == {"svt_request", "svt_decode_enqueue", "svt_encoder_layer"}
    assert [name for name, *_ in rec.spans] == ["decode_enqueue", "request"]


def test_request_gaps_of_a_profile_without_a_request_are_empty():
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import request_gaps
    from sherpa_vietnamese_asr_tpu_torch.utils import trace

    # as when a tool profiles a diarizer or a restorer outside run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("merge"):
            torch.ones(64).add_(1)
    assert request_gaps(prof) == []


def test_profiled_busy_gives_busy_and_wall_ms(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.tools import profile_slice

    class Event:
        def __init__(self, start, end):
            self.time_range = type("Range", (), {"start": start, "end": end})()

    events = [Event(0, 1500), Event(1000, 2000), Event(3000, 3500)]
    monkeypatch.setattr(profile_slice, "_profiled", lambda fn: (None, events, 7.5))
    # chip_smoke.py unpacks (busy ms, wall ms) from it
    busy, wall = profile_slice._profiled_busy(lambda: None)
    assert (busy, wall) == (2.5, 7.5)
