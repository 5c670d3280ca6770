# The port's bench (sherpa_vietnamese_asr_tpu_torch/bench.py) on the CPU,
# with tiny models (the ASR, diarization, ViBERT and DNSMOS weights of
# tests/test_torch_punctuate_path.py, converted from the JAX package):
#   (a) main() prints one JSON line with the port's metric names, the
#       default tier flagged and each entry's batch, on a tiny model, short
#       chunks and one batch, the full pipeline run for real;
#   (b) check_contract passes on a sound pipeline result and fails, with
#       its own message, on each planted broken stage;
#   (c) an extra that raises becomes a `skipped` entry naming the
#       exception's type, past the budget a `time_budget` one, and the
#       headline still prints;
#   (d) `cli bench` without a card and without --device cpu raises.
import copy
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_diarize_path import models  # noqa: E402,F401
from tests.test_torch_punctuate_path import _port_stages, stages  # noqa: E402,F401

from sherpa_vietnamese_asr_tpu_torch import bench  # noqa: E402

torch.set_num_threads(2)
MINUTES = 0.25  # 15 s: both speakers, six diarization windows
METRICS = ["rtfx_zipformer30m_beam8_bf16_per_chip", "rtfx_zipformer30m_beam8_fp32_per_chip",
           "rtfx_full_pipeline_0.25min_per_chip"]


@pytest.fixture
def tiny_bench(models, stages, monkeypatch, tmp_path):  # noqa: F811
    """bench at tiny size: the converted tiny ASR model in both tiers, 2 s
    chunks padded to 2.5 s, a batch of 2, the tiny stages; no checkpoint
    (a loudly flagged random Silero VAD)."""
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    monkeypatch.delenv("SVT_BENCH_BUDGET_S", raising=False)
    monkeypatch.delenv("SVT_BENCH_FULL", raising=False)
    tm = models["tm"]
    monkeypatch.setattr(bench, "measure_asr", functools.partial(
        bench.measure_asr, batch=2, model=tm, chunk_sec=2.0, pad_sec=2.5))
    monkeypatch.setattr(bench, "measure_full_pipeline", functools.partial(
        bench.measure_full_pipeline, model=tm,
        stages=_port_stages(models, stages, diarize=True)))
    return tm


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_main_prints_the_port_metric_names(tiny_bench, capsys):
    out = bench.main(["--device", "cpu", "--n-batches", "1", "--minutes", str(MINUTES)])
    assert _line(capsys) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "batch", "device", "extras"}
    assert [out["metric"]] + [e["metric"] for e in out["extras"]] == METRICS
    assert out["device"] == "cpu" and out["batch"] == 2 and out["value"] > 0
    assert abs(out["vs_baseline"] - out["value"] / bench.ASR_BASELINE_RTFX) < 1e-3
    fp32, full = out["extras"]
    assert "skipped" not in fp32 and "skipped" not in full, out
    assert fp32["default_tier"] is True and fp32["batch"] == 2 and fp32["n_batches"] == 1
    assert fp32["tokens"] > 0 and fp32["value"] > 0 and fp32["unit"] == "audio_sec/wall_sec"
    assert "default_tier" not in full and full["duration_s"] == 15 and full["value"] > 0
    assert full["batch"] == 8 and full["warm_wall_s"] > 0 and full["wall_s"] > 0
    assert abs(full["vs_baseline"] - full["value"] / bench.FULL_BASELINE_RTFX) < 1e-3


@pytest.fixture(scope="module")
def sound_result(models, stages, tmp_path_factory):  # noqa: F811
    """A pipeline result of the bench's audio and stages, and its length."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    dur = int(MINUTES * 60)
    path = str(tmp_path_factory.mktemp("bench") / "full.wav")
    write_wav(path, bench.full_pipeline_audio(dur), bench.SAMPLE_RATE)
    cfg = {"speaker_diarization": True, "restore_punctuation": True,
           "quality_analysis": True}
    old = os.environ.get("SVT_MODELS_DIR")
    os.environ["SVT_MODELS_DIR"] = os.path.dirname(path)
    try:
        res = TranscriberPipeline(path, models["tm"], config=cfg,
                                  **_port_stages(models, stages, diarize=True)).run()
    finally:
        if old is None:
            os.environ.pop("SVT_MODELS_DIR")
        else:
            os.environ["SVT_MODELS_DIR"] = old
    return res, dur


def _no_words(r):
    for s in r["segments"]:
        s["raw_words"] = []


def _empty_text(r):
    r["segments"][0]["text"] = ""


def _dnsmos(r):
    r["quality_info"]["dnsmos_bak"] = 5.5


BROKEN = {
    "no segments": (lambda r: r.update(segments=[]), "no segments produced"),
    "empty segment text": (_empty_text, "segment with empty text"),
    "no words": (_no_words, "no words decoded"),
    "no diarization": (lambda r: r.update(has_speaker_diarization=False),
                       "diarization produced nothing"),
    "no speaker segments": (lambda r: r.update(speaker_segments_raw=[]),
                            "no speaker segments"),
    "no quality": (lambda r: r.update(quality_info=None), "quality analysis missing"),
    "DNSMOS 5.5": (_dnsmos, "DNSMOS dnsmos_bak out of range: 5.5"),
    "empty text": (lambda r: r.update(text=""), "empty transcript"),
}


@pytest.mark.parametrize("fault", [None] + list(BROKEN))
def test_check_contract_fails_on_each_broken_stage(sound_result, fault):
    res, dur = sound_result
    if fault is None:
        bench.check_contract(res, dur)
        return
    broken = copy.deepcopy(res)
    plant, message = BROKEN[fault]
    plant(broken)
    with pytest.raises(AssertionError) as e:
        bench.check_contract(broken, dur)
    assert str(e.value) == message


def test_a_raising_extra_is_skipped_with_its_type(tiny_bench, monkeypatch, capsys):
    def boom(*args, **kwargs):
        raise RuntimeError("diarizer exploded")

    monkeypatch.setattr(bench, "measure_full_pipeline", boom)
    out = bench.main(["--device", "cpu", "--n-batches", "1"])
    assert _line(capsys) == out and out["metric"] == METRICS[0] and out["value"] > 0
    fp32, full = out["extras"]
    assert "skipped" not in fp32
    assert full == {"metric": "rtfx_full_pipeline_10min_per_chip",
                    "skipped": "RuntimeError: diarizer exploded"}
    monkeypatch.setenv("SVT_BENCH_BUDGET_S", "0")
    out = bench.main(["--device", "cpu", "--n-batches", "1"])
    assert out["value"] > 0 and [e.get("skipped") for e in out["extras"]] == ["time_budget"] * 2
    _line(capsys)
    monkeypatch.setenv("SVT_BENCH_FULL", "0")
    assert len(bench.main(["--device", "cpu", "--n-batches", "1"])["extras"]) == 1


def test_cli_bench_without_a_card_raises_and_the_batch(monkeypatch, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["bench"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.measure_asr("float32")
    args = cli.build_parser().parse_args(["bench", "--device", "cpu", "--minutes", "2"])
    assert (args.fn, args.device, args.minutes, args.n_batches) == (cli.cmd_bench, "cpu", 2.0, None)
    monkeypatch.chdir(tmp_path)  # no calibration_report.json here
    monkeypatch.delenv("SVT_BENCH_BATCH", raising=False)
    assert bench.bench_batch(torch.device("cpu")) == 8
    monkeypatch.setenv("SVT_BENCH_BATCH", "3")
    assert bench.bench_batch(torch.device("cpu")) == 3
    audio = bench.full_pipeline_audio(12)
    assert audio.shape == (12 * 16000,) and np.abs(audio[5 * 16000 + 100: 6 * 16000]).max() < 0.1
