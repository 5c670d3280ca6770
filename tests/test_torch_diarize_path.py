# The port's diarized transcribe path against the JAX package's, on the CPU,
# with tiny models (the ASR model of tests/test_torch_default_path.py, the
# diarization models of tests/test_torch_diarization.py) and the same
# weights in both packages:
#   (a) TranscriberPipeline with an explicit PureDiarizer (diarizer=);
#   (b) TranscriberPipeline with only config speaker_diarization: the
#       SpeakerDiarizer facade, its backend from both packages' asset
#       registries (patched to the tiny models) and its background pass;
#   (c) the CLI's `transcribe --diarize` on a model directory holding the
#       ASR files and segmentation-community-1.onnx, embedding_encoder.onnx
#       and resnet_seg_1_{weight,bias}.npy (the port's
#       models/onnx_export_diar), which both CLIs load;
#   (d) run_diarization on transcribed segments (raw speaker segments and
#       the remapped sentences);
#   (e) a diarizer that raises makes run() raise (the JAX pipeline logs it
#       and returns no speakers), through the facade too after its one
#       synchronous retry.
# speaker_segments_raw and every segment's speaker are held equal; times to
# 1e-6 s (the .asr.json, rounded to 1 ms, to one rounding step).
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_default_path import _assert_json_close, _jax_model  # noqa: E402
from tests.test_torch_diarization import (  # noqa: E402
    THRESHOLD,
    diarization_audio,
    jax_emb_params,
    jax_seg_params,
    port_models,
    tiny_seg_cfgs,
)
from tests.test_torch_onnx_import import tiny_registry  # noqa: E402
from tests.test_torch_slice import _assert_words_equal, _convert  # noqa: E402

torch.set_num_threads(2)
SR = 16000
CONFIG = {"speaker_diarization": True, "bypass_vad": True, "max_batch": 2}


@pytest.fixture(scope="module")
def models():
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import TINY_RESNET as JAX_TINY

    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import TINY_RESNET

    jm = _jax_model(0)
    jseg_cfg, seg_cfg = tiny_seg_cfgs()
    seg_p, emb_p = jax_seg_params(jseg_cfg), jax_emb_params(JAX_TINY)
    seg, emb = port_models(seg_p, seg_cfg, emb_p, TINY_RESNET)
    return {"jm": jm, "tm": _convert(jm, beam_size=4), "jax": (seg_p, jseg_cfg, emb_p, JAX_TINY),
            "port": (seg, emb)}


def _wav(tmp_path, name):
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / name)
    write_wav(path, diarization_audio(20), SR)
    return path


def _assert_diarized_equal(got, ref):
    assert got["has_speaker_diarization"] and ref["has_speaker_diarization"]
    assert got["text"] == ref["text"] and got["text"]
    raw, raw_ref = got["speaker_segments_raw"], ref["speaker_segments_raw"]
    assert len(raw) == len(raw_ref) and len({s["speaker_id"] for s in raw}) >= 2
    for g, r in zip(raw, raw_ref):
        assert (g["speaker"], g["speaker_id"]) == (r["speaker"], r["speaker_id"])
        for key in ("start", "end", "duration"):
            assert abs(g[key] - r[key]) <= 1e-6, (key, g, r)
    assert len(got["segments"]) == len(ref["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["speaker"] and (g["speaker"], g["speaker_id"]) == (r["speaker"], r["speaker_id"])
        assert g["text"] == r["text"]
        _assert_words_equal(g["raw_words"], r["raw_words"])
    assert got["timing"]["diarization"] > 0.0


def test_pipeline_with_a_pure_diarizer_matches_jax(models, tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline.diarization_pure import PureDiarizer as JaxDiarizer
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    seg_p, jseg_cfg, emb_p, jemb_cfg = models["jax"]
    seg, emb = models["port"]
    jd = JaxDiarizer(seg_params=seg_p, seg_cfg=jseg_cfg, emb_params=emb_p, emb_cfg=jemb_cfg,
                     threshold=THRESHOLD)
    td = PureDiarizer(seg_model=seg, emb_model=emb, threshold=THRESHOLD, device="cpu")
    ref = JaxPipeline(_wav(tmp_path, "j.wav"), models["jm"], CONFIG, diarizer=jd).run()
    phases = []
    got = TranscriberPipeline(_wav(tmp_path, "t.wav"), models["tm"], CONFIG, diarizer=td,
                              progress_callback=phases.append).run()
    _assert_diarized_equal(got, ref)
    assert "PHASE:Diarization|Done|100" in phases
    assert not any("in background" in p for p in phases)  # a raw backend runs after decode


@pytest.fixture
def tiny_assets(models, monkeypatch):
    """Both packages' asset registries hand out the tiny diarization models."""
    import sherpa_vietnamese_asr_tpu.models.assets as jassets

    import sherpa_vietnamese_asr_tpu_torch.models.assets as tassets

    seg_p, jseg_cfg, emb_p, jemb_cfg = models["jax"]
    seg, emb = models["port"]
    seg_state = {k: v.numpy() for k, v in seg.state_dict().items()}
    emb_state = {k: v.numpy() for k, v in emb.state_dict().items()}
    monkeypatch.setattr(jassets, "load_segmentation", lambda verify=True: (seg_p, jseg_cfg))
    monkeypatch.setattr(jassets, "load_embedding_split", lambda verify=True: (emb_p, jemb_cfg))
    monkeypatch.setattr(tassets, "load_segmentation", lambda verify=True: (seg_state, seg.cfg))
    monkeypatch.setattr(tassets, "load_embedding_split",
                        lambda verify=True: (emb_state, emb.cfg))


def test_pipeline_config_facade_runs_in_the_background_like_jax(models, tiny_assets,
                                                                 tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    config = dict(CONFIG, diarization_threshold=THRESHOLD)
    ref = JaxPipeline(_wav(tmp_path, "j.wav"), models["jm"], config).run()
    phases = []
    pipe = TranscriberPipeline(_wav(tmp_path, "t.wav"), models["tm"], config,
                               progress_callback=phases.append)
    assert isinstance(pipe.diarizer, SpeakerDiarizer)
    got = pipe.run()
    _assert_diarized_equal(got, ref)
    assert "PHASE:Transcription|Transcribing (diarization in background)|0" in phases
    assert pipe.diarizer._backend.device == torch.device("cpu")


def test_cli_diarize_writes_the_jax_asr_json(models, tmp_path, monkeypatch):
    from sherpa_vietnamese_asr_tpu.cli import main as jax_main
    from sherpa_vietnamese_asr_tpu.models.onnx_export_rnnt import export_asr_dir

    from sherpa_vietnamese_asr_tpu_torch.cli import main
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_diar import (
        export_diarization_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import write_tokens

    jm = models["jm"]
    model_dir = tmp_path / "tiny-model"
    export_asr_dir(jm, str(model_dir), t_in=103)
    write_tokens(str(model_dir / "tokens.txt"), jm.id2token)
    export_diarization_files(*models["port"], str(model_dir))
    tiny_registry(monkeypatch, jm)
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path / "no_models"))
    args = ["--model", str(model_dir), "--beam", "4", "--max-batch", "2", "--no-vad",
            "--diarize", "--num-speakers", "2"]
    wav_j, wav_t = _wav(tmp_path, "j.wav"), _wav(tmp_path, "t.wav")
    assert jax_main(["transcribe", wav_j] + args) == 0
    assert main(["transcribe", wav_t, "--device", "cpu"] + args) == 0
    with open(wav_j + ".asr.json", encoding="utf-8") as f:
        ref = json.load(f)
    with open(wav_t + ".asr.json", encoding="utf-8") as f:
        got = json.load(f)
    for data in (ref, got):
        data.pop("timing")
        data.pop("created_at")
    # Speaker entries interleave with the text: one opens the list, so every
    # text segment falls under a speaker.
    entries = got["segments"]
    assert entries[0]["type"] == "speaker" and entries[0]["speaker"]
    assert any(e["type"] == "text" and e["text"] for e in entries)
    _assert_json_close(got, ref)


def test_run_diarization_matches_jax(models, tiny_assets):
    """The facade's high-level entry point on transcribed segments: the raw
    speaker segments and the remapped sentences."""
    from sherpa_vietnamese_asr_tpu.pipeline.diarization import run_diarization as jax_run

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import run_diarization
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import segment_words_by_pause

    audio = diarization_audio(20)
    words = [{"text": f"w{i}", "start": 0.25 + 0.5 * i, "end": 0.6 + 0.5 * i, "prob": 0.9}
             for i in range(38)]
    segments = segment_words_by_pause(words)
    kw = dict(threshold=THRESHOLD, num_speakers=0)
    raw_j, _, out_j = jax_run(audio, segments, **kw)
    raw, _, out = run_diarization(audio, segments, backend_kwargs={"device": "cpu"}, **kw)
    assert len({s["speaker_id"] for s in raw}) >= 2
    assert [(s["speaker"], s["speaker_id"]) for s in raw] == \
        [(s["speaker"], s["speaker_id"]) for s in raw_j]
    for g, r in zip(raw, raw_j):
        assert abs(g["start"] - r["start"]) <= 1e-6 and abs(g["end"] - r["end"]) <= 1e-6
    assert [(s["text"], s["speaker"], s["speaker_id"]) for s in out] == \
        [(s["text"], s["speaker"], s["speaker_id"]) for s in out_j]


class _Raising:
    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0

    def process(self, audio, progress_callback=None):
        self.calls += 1
        raise RuntimeError("diarization backend failed")


def test_a_failing_diarizer_makes_run_raise(models, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

    raw = _Raising()
    with pytest.raises(RuntimeError, match="backend failed"):
        TranscriberPipeline(_wav(tmp_path, "a.wav"), models["tm"], CONFIG, diarizer=raw).run()
    assert raw.calls == 1

    facade = SpeakerDiarizer()
    facade._backend = _Raising()
    phases = []
    with pytest.raises(RuntimeError, match="backend failed"):
        TranscriberPipeline(_wav(tmp_path, "b.wav"), models["tm"], CONFIG, diarizer=facade,
                            progress_callback=phases.append).run()
    assert facade._backend.calls == 2  # the background pass and one synchronous retry
    assert "PHASE:Transcription|Transcribing (diarization in background)|0" in phases
    assert not os.path.exists(str(tmp_path / "b.wav") + ".asr_phase")
