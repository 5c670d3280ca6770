# The port's punctuated (and quality-analysed, diarized) transcribe path
# against the JAX package's, on the CPU, with tiny models and the same
# weights in both packages (the ASR and diarization models of
# tests/test_torch_diarize_path.py, a tiny ViBERT, the full-config DNSMOS):
#   (a) TranscriberPipeline with restore_punctuation and quality_analysis,
#       with and without speaker_diarization: the same text, sentences,
#       speakers, words and quality_info, and the result's timing keys;
#   (b) DNSMOS overlapped with the decode gives the synchronous scores;
#   (c) the CLI's `transcribe --punctuate --quality --diarize` on a model
#       directory holding the port's vibert-capu.onnx and vocab.txt writes
#       the JAX CLI's .asr.json (which holds no quality_info);
#   (d) the port's .asr.json writer gives the JAX writer's file for the same
#       punctuated, diarized result;
#   (e) a failing quality analyzer makes run() raise (the JAX pipeline logs
#       it and returns no quality_info), overlapped or not;
#   (f) config-only construction of the restorer and the analyzer, on the
#       model's device.
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_default_path import _assert_json_close  # noqa: E402
from tests.test_torch_diarization import THRESHOLD, diarization_audio  # noqa: E402
from tests.test_torch_diarize_path import models  # noqa: E402,F401
from tests.test_torch_onnx_import import tiny_registry  # noqa: E402
from tests.test_torch_punctuation import gec_vocab, jax_vibert, port_vibert  # noqa: E402
from tests.test_torch_quality import jax_dnsmos, port_dnsmos  # noqa: E402
from tests.test_torch_slice import _assert_words_equal  # noqa: E402

torch.set_num_threads(2)
SR = 16000
CONFIG = {"bypass_vad": True, "max_batch": 2, "restore_punctuation": True,
          "quality_analysis": True}
TIMING_KEYS = {"transcription", "restoration", "total", "upload_convert",
               "transcription_detail", "sentence_segmentation", "punctuation", "alignment",
               "diarization", "quality", "load_audio", "vad", "merge_suspect",
               "quality_overlapped"}


def _punct_params():
    """A tiny ViBERT whose $APPEND_. and $TRANSFORM_CASE_CAPITAL heads are
    raised, so that the random model ends sentences and capitalises."""
    from sherpa_vietnamese_asr_tpu.pipeline.gec import DEFAULT_LABELS

    p = jax.tree.map(np.array, jax_vibert(5))
    bias = p["labels_head"]["bias"]
    bias[DEFAULT_LABELS.index("$APPEND_.")] += 1.5
    bias[DEFAULT_LABELS.index("$TRANSFORM_CASE_CAPITAL")] += 1.0
    return p


@pytest.fixture(scope="module")
def stages():
    vibert, dnsmos = _punct_params(), jax.tree.map(np.array, jax_dnsmos(24))
    dnsmos["head"]["bias"] += 3.0  # raw scores near 3: mapped inside (1, 5), not clipped
    return {"vibert": vibert, "dnsmos": dnsmos, "port_vibert": port_vibert(vibert),
            "port_dnsmos": port_dnsmos(dnsmos)}


def _jax_stages(models, stages, diarize):
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT
    from sherpa_vietnamese_asr_tpu.pipeline.diarization_pure import PureDiarizer
    from sherpa_vietnamese_asr_tpu.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu.pipeline.punctuation import PunctuationRestorer
    from sherpa_vietnamese_asr_tpu.pipeline.quality import QualityAnalyzer
    from sherpa_vietnamese_asr_tpu.utils.wordpiece import WordPieceTokenizer

    seg_p, jseg_cfg, emb_p, jemb_cfg = models["jax"]
    gec = GecBert(stages["vibert"], TINY_VIBERT, WordPieceTokenizer(gec_vocab()),
                  confidence=0.3, mesh=None)
    return dict(
        punct_restorer=PunctuationRestorer(gec, confidence=0.3),
        quality_analyzer=QualityAnalyzer(params=stages["dnsmos"], mesh=None),
        diarizer=PureDiarizer(seg_params=seg_p, seg_cfg=jseg_cfg, emb_params=emb_p,
                              emb_cfg=jemb_cfg, threshold=THRESHOLD) if diarize else None)


def _port_stages(models, stages, diarize, analyzer=None):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import PunctuationRestorer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    seg, emb = models["port"]
    gec = GecBert(stages["port_vibert"], WordPieceTokenizer(gec_vocab()), confidence=0.3)
    return dict(
        punct_restorer=PunctuationRestorer(gec, confidence=0.3),
        quality_analyzer=analyzer or QualityAnalyzer(model=stages["port_dnsmos"]),
        diarizer=PureDiarizer(seg_model=seg, emb_model=emb, threshold=THRESHOLD,
                              device="cpu") if diarize else None)


def _wav(tmp_path, name, seconds=20):
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / name)
    write_wav(path, diarization_audio(seconds), SR)
    return path


def _assert_punctuated_equal(got, ref, diarize):
    assert got["text"] == ref["text"] and got["text"]
    assert any(c in got["text"] for c in ".?,")  # the model did punctuate
    assert got["quality_info"] == ref["quality_info"] and got["quality_info"]
    assert 1.0 < min(got["quality_info"].values()) < max(got["quality_info"].values()) < 5.0
    assert set(got["timing"]) == TIMING_KEYS == set(ref["timing"])
    assert got["timing"]["punctuation"] > 0 and got["timing"]["restoration"] > 0
    assert got["timing"]["quality"] > 0
    assert got["has_speaker_diarization"] == ref["has_speaker_diarization"] == diarize
    assert len(got["segments"]) == len(ref["segments"]) >= 2
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["text"] == r["text"]
        assert (g.get("speaker"), g.get("speaker_id")) == (r.get("speaker"), r.get("speaker_id"))
        for key in ("start", "end"):
            assert abs(g[key] - r[key]) <= 1e-6, (key, g, r)
        _assert_words_equal(g["raw_words"], r["raw_words"])
    if diarize:
        assert len({s["speaker_id"] for s in got["segments"]}) >= 2


@pytest.mark.parametrize("diarize", [False, True])
def test_pipeline_punctuates_and_rates_like_jax(models, stages, diarize, tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )

    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    config = dict(CONFIG, speaker_diarization=diarize)
    ref = JaxPipeline(_wav(tmp_path, "j.wav"), models["jm"], config,
                      **_jax_stages(models, stages, diarize)).run()
    phases = []
    got = TranscriberPipeline(_wav(tmp_path, "t.wav"), models["tm"], config,
                              progress_callback=phases.append,
                              **_port_stages(models, stages, diarize)).run()
    _assert_punctuated_equal(got, ref, diarize)
    assert got["timing"]["quality_overlapped"] > 0
    for phase in ("PHASE:QualityAnalysis|Done|100", "PHASE:Punctuation|Restoring punctuation|0",
                  "PHASE:Align|Done|100"):
        assert phase in phases


def test_overlapped_quality_equals_the_synchronous_pass(models, stages, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    path = _wav(tmp_path, "t.wav")
    runs, raw = [], []
    for overlap in (True, False):
        kw = _port_stages(models, stages, False)
        qa = kw["quality_analyzer"]
        qa.raw_scores = lambda w, f=qa.raw_scores: raw.append(f(w)) or raw[-1]
        runs.append(TranscriberPipeline(path, models["tm"],
                                        dict(CONFIG, quality_overlap_decode=overlap),
                                        **kw).run())
    assert runs[0]["quality_info"] == runs[1]["quality_info"] and runs[0]["quality_info"]
    assert len(raw) == 2 and raw[0].shape == (3, 3) and np.array_equal(raw[0], raw[1])
    assert runs[0]["timing"]["quality_overlapped"] > 0
    assert runs[1]["timing"]["quality_overlapped"] == 0.0
    assert runs[0]["text"] == runs[1]["text"]


def test_cli_punctuate_quality_diarize_writes_the_jax_asr_json(models, stages, tmp_path,
                                                              monkeypatch):
    import sherpa_vietnamese_asr_tpu.models.assets as jassets
    from sherpa_vietnamese_asr_tpu.cli import main as jax_main
    from sherpa_vietnamese_asr_tpu.models.onnx_export_rnnt import export_asr_dir

    import sherpa_vietnamese_asr_tpu_torch.models.assets as tassets
    from sherpa_vietnamese_asr_tpu_torch.cli import main
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import export_vibert_files
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_diar import (
        export_diarization_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import write_tokens

    jm = models["jm"]
    model_dir = tmp_path / "tiny-model"
    export_asr_dir(jm, str(model_dir), t_in=103)
    write_tokens(str(model_dir / "tokens.txt"), jm.id2token)
    export_diarization_files(*models["port"], str(model_dir))
    export_vibert_files(stages["port_vibert"], gec_vocab(), str(model_dir))
    tiny_registry(monkeypatch, jm)
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path / "no_models"))
    dn = stages["port_dnsmos"]
    monkeypatch.setattr(jassets, "load_dnsmos_asset",
                        lambda verify=True: (stages["dnsmos"], None))
    monkeypatch.setattr(tassets, "load_dnsmos_asset", lambda verify=True: (
        {k: v.numpy() for k, v in dn.state_dict().items()}, dn.cfg))
    args = ["--model", str(model_dir), "--beam", "4", "--max-batch", "2", "--no-vad",
            "--diarize", "--num-speakers", "2", "--punctuate", "--quality"]
    wav_j, wav_t = _wav(tmp_path, "j.wav"), _wav(tmp_path, "t.wav")
    assert jax_main(["transcribe", wav_j] + args) == 0
    assert main(["transcribe", wav_t, "--device", "cpu", "-v"] + args) == 0
    with open(wav_j + ".asr.json", encoding="utf-8") as f:
        ref = json.load(f)
    with open(wav_t + ".asr.json", encoding="utf-8") as f:
        got = json.load(f)
    assert got["timing"]["punctuation"] > 0 and got["timing"]["quality"] > 0
    for data in (ref, got):
        data.pop("timing")
        data.pop("created_at")
    assert "quality_info" not in got
    entries = got["segments"]
    assert entries[0]["type"] == "speaker" and any(c in got["text"] for c in ".?,")
    _assert_json_close(got, ref)


def test_asr_json_writer_matches_jax_on_a_punctuated_result(models, stages, tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline.asr_json import serialize_segments as jax_serialize

    from sherpa_vietnamese_asr_tpu_torch.pipeline.asr_json import serialize_segments
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    res = TranscriberPipeline(_wav(tmp_path, "t.wav"), models["tm"],
                              dict(CONFIG, speaker_diarization=True),
                              **_port_stages(models, stages, True)).run()
    kw = dict(model_name="tiny", duration_sec=res["duration_sec"], timing=res["timing"],
              overlap_segments=res["overlap_segments"])
    got, ref = serialize_segments(res["segments"], **kw), jax_serialize(res["segments"], **kw)
    got.pop("created_at"), ref.pop("created_at")
    assert got == ref and any(e["type"] == "speaker" for e in got["segments"])


class _FailingAnalyzer:
    device = torch.device("cpu")

    def analyze_speech(self, audio):
        raise RuntimeError("dnsmos failed on the card")


@pytest.mark.parametrize("overlap", [True, False])
def test_a_failing_analyzer_makes_run_raise(models, stages, overlap, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    with pytest.raises(RuntimeError, match="dnsmos failed"):
        TranscriberPipeline(_wav(tmp_path, "t.wav"), models["tm"],
                            dict(CONFIG, quality_overlap_decode=overlap),
                            **_port_stages(models, stages, False,
                                           analyzer=_FailingAnalyzer())).run()


def test_config_builds_the_stages_on_the_models_device(models, tmp_path, monkeypatch):
    import sherpa_vietnamese_asr_tpu_torch.models.vibert as vb
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path / "no_models"))
    monkeypatch.setattr(vb, "ViBertConfig", lambda: vb.TINY_VIBERT)
    pipe = TranscriberPipeline(_wav(tmp_path, "t.wav", 4), models["tm"],
                               dict(CONFIG, prefer_int8=True, punctuation_confidence=0.1))
    assert pipe.quality_analyzer.device == torch.device("cpu")
    gec = pipe.punct_restorer.gec_model
    assert gec.device == torch.device("cpu") and gec.model.int8 and gec.confidence == 0.1
    res = pipe.run()
    assert res["quality_info"] and res["timing"]["punctuation"] > 0
    bypass = TranscriberPipeline("unused.wav", models["tm"], dict(CONFIG, bypass_restorer=True))
    assert bypass.punct_restorer is None
