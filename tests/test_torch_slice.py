# The port's transcription slice end to end on the CPU:
#   (a) decode_spans and TranscriberPipeline({"bypass_vad": True}) give the
#       JAX package's words, timestamps and segments on the tiny model with
#       converted weights;
#   (b) fbank -> encoder -> beam search reproduces the frozen true-size
#       fixture tests/data/golden_e2e.json (weights from the JAX package's
#       golden model, converted);
#   (c) importing every module of the port never loads jax;
#   (d) the Senko CAM++ backend and overlap separation, alone, with a ROVER
#       pair and beside punctuation and quality, give the JAX pipeline's
#       speakers, overlap segments and words (test_unported_stages_raise).
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_e2e.json")


def _convert(jm, beam_size):
    import jax

    from sherpa_vietnamese_asr_tpu_torch.models.convert import (
        asr_model_from_numpy,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig

    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    zc = ZipformerConfig(**dataclasses.asdict(jm.zip_cfg))
    rc = RnntConfig(**dataclasses.asdict(jm.rnnt_cfg))
    return asr_model_from_numpy(enc, dec, joi, zc, rc, jm.id2token,
                                device="cpu", beam_size=beam_size)


def _assert_words_equal(got, ref):
    assert [w["text"] for w in got] == [w["text"] for w in ref]
    for g, r in zip(got, ref):
        for key in ("start", "end"):
            assert abs(g[key] - r[key]) < 1e-6, (key, g, r)
        assert abs(g["prob"] - r["prob"]) < 1e-4, (g, r)


def test_tiny_model_decode_and_pipeline_match_jax(tmp_path):
    from sherpa_vietnamese_asr_tpu.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu.pipeline.decoder import (
        BatchedChunkDecoder as JaxDecoder,
    )
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import (
        BatchedChunkDecoder,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    jm = random_asr_model(vocab_size=80, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    # Random weights leave the logits nearly uniform, where float32 rounding
    # differences between the two frameworks flip near-tied beam decisions.
    # Sharper logits (the same scaled weights in both packages) keep the
    # comparison about the pipeline, not about ties.
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    tm = _convert(jm, beam_size=4)

    sr = 16000
    t = np.arange(int(sr * 64.5)) / sr
    rng = np.random.default_rng(0)
    x = (0.3 * np.sin(2 * np.pi * 280 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    x[int(20 * sr): int(21.5 * sr)] = 0.0

    # decode_spans directly: 3 spans, batch 2 (the last batch is padded)
    spans = [(0, 30 * sr), (27 * sr, 57 * sr), (54 * sr, len(x))]
    ref = JaxDecoder(jm, max_batch=2).decode_spans(x, spans)
    got = BatchedChunkDecoder(tm, max_batch=2).decode_spans(x, spans)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_words_equal(g, r)

    path = str(tmp_path / "a.wav")
    write_wav(path, x, sr)
    cfg = {"bypass_vad": True, "max_batch": 2}
    ref = JaxPipeline(path, jm, config=cfg).run()
    phases = []
    got = TranscriberPipeline(path, tm, config=cfg,
                              progress_callback=phases.append).run()
    assert got["text"] == ref["text"] and got["text"]
    assert got["duration_sec"] == ref["duration_sec"]
    assert len(got["segments"]) == len(ref["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["text"] == r["text"]
        assert abs(g["start"] - r["start"]) < 1e-6
        assert abs(g["end"] - r["end"]) < 1e-6
        _assert_words_equal(g["raw_words"], r["raw_words"])
    assert got["asr_provider_info"] == {"backend": "torch", "device": "cpu"}
    assert phases[0].startswith("PHASE:LoadAudio") and \
        phases[-1] == "PHASE:Complete|Done|100"
    assert not os.path.exists(path + ".asr_phase")
    # The default config runs the built-in Silero VAD on the model's device
    # (random weights here, loudly flagged): no fallback to silence-based
    # chunking.
    phases = []
    res = TranscriberPipeline(path, tm, config={"max_batch": 2},
                              progress_callback=phases.append).run()
    assert res["timing"]["vad"] > 0 and "PHASE:VAD|Detecting speech|0" in phases
    assert not any("VAD failed" in p for p in phases)


def test_true_size_stack_reproduces_frozen_fixture():
    """fbank -> Zipformer-30M -> beam search (plain fp32 path) vs the 148
    frozen tokens, with the asserts of test_golden_e2e."""
    from sherpa_vietnamese_asr_tpu.models import golden
    from sherpa_vietnamese_asr_tpu_torch.models.golden import golden_audio
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import beam_search_batch
    from sherpa_vietnamese_asr_tpu_torch.ops.fbank import ASR_FBANK, compute_fbank

    with open(GOLDEN) as f:
        fx = json.load(f)
    jm = golden.golden_model()
    tm = _convert(jm, beam_size=golden.GOLDEN_BEAM)
    audio = golden_audio(fx["duration_sec"], fx["sample_rate"])
    np.testing.assert_array_equal(
        audio, golden.golden_audio(fx["duration_sec"], fx["sample_rate"]))
    feats = compute_fbank(torch.from_numpy(audio), ASR_FBANK)
    assert feats.shape[0] == fx["t_in"]
    enc, enc_lens = tm.encoder(feats[None],
                               torch.tensor([feats.shape[0]], dtype=torch.int32))
    assert [int(enc_lens[0]), enc.shape[-1]] == fx["enc_out_shape"]
    res = beam_search_batch(enc, enc_lens, tm.decoder, tm.joiner, tm.rnnt_cfg,
                            beam_size=golden.GOLDEN_BEAM)
    n = int(res.num_tokens[0])
    tokens = res.tokens[0, :n].tolist()
    assert tokens == fx["tokens"], (
        f"{sum(a == b for a, b in zip(tokens, fx['tokens']))} of "
        f"{len(fx['tokens'])} tokens match")
    np.testing.assert_array_equal(res.frames[0, :n].numpy(), fx["frames"])
    np.testing.assert_allclose(res.tok_logp[0, :n].numpy(), fx["tok_logp"],
                               atol=2e-3)
    assert abs(float(res.total_logp[0]) - fx["total_logp"]) < 0.05
    assert golden.tokens_to_words(tokens, tm.id2token) == fx["words"]


def test_port_imports_never_load_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sherpa_vietnamese_asr_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "new = {'models.gguf', 'models.llama', 'pipeline.warmup', 'web_service.auth', "
        "'web_service.database', 'web_service.queue_manager', 'web_service.server', "
        "'web_service.server_config', 'web_service.ssl_utils', 'web_service.summarizer'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'sherpa_vietnamese_asr_tpu.')) or "
        "m == 'sherpa_vietnamese_asr_tpu')\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# Overlap regions the stage-test diarizers report in both packages. The
# Senko backend splits diarization_audio(20) into turns at 3.45, 7.05 and
# 11.85 s: (10.8, 12.8) straddles the last change and leaves each speaker a
# clean turn for its centroid; (1.0, 1.6) is too short to be separated. The
# random PureDiarizer hears one speaker there, so no region of its has two
# participants.
PLANTED_REGIONS = [(1.0, 1.6), (10.8, 12.8)]


@pytest.fixture(scope="module")
def stage_models():
    """The tiny ASR pair, and the diarization, CAM++ and Conv-TasNet weights
    of tests/test_torch_diarization.py, test_torch_senko.py and
    test_torch_overlap.py, in both packages."""
    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP
    from sherpa_vietnamese_asr_tpu.models.convtasnet import TINY_CONVTASNET
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import TINY_RESNET as JAX_TINY

    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import TINY_RESNET
    from tests.test_torch_default_path import _jax_model
    from tests.test_torch_diarization import (
        diarization_audio,
        jax_emb_params,
        jax_seg_params,
        port_models,
        tiny_seg_cfgs,
    )
    from tests.test_torch_overlap import jax_convtasnet_params, port_convtasnet
    from tests.test_torch_senko import centred_campp_params, port_campp, port_cfg

    jms = [_jax_model(0), _jax_model(1)]
    jseg_cfg, seg_cfg = tiny_seg_cfgs()
    seg_p, emb_p = jax_seg_params(jseg_cfg), jax_emb_params(JAX_TINY)
    campp_p = centred_campp_params(TINY_CAMPP, diarization_audio(40))
    ct_p = jax_convtasnet_params(TINY_CONVTASNET)
    seg, emb = port_models(seg_p, seg_cfg, emb_p, TINY_RESNET)
    campp, ct = port_campp(campp_p, port_cfg(TINY_CAMPP)), port_convtasnet(ct_p, TINY_CONVTASNET)
    return {"jms": jms, "tms": [_convert(jm, beam_size=4) for jm in jms],
            "jax": {"load_segmentation": (seg_p, jseg_cfg),
                    "load_embedding_split": (emb_p, JAX_TINY),
                    "load_campp_asset": (campp_p, TINY_CAMPP),
                    "load_convtasnet_asset": (ct_p, TINY_CONVTASNET)},
            "port": {name: ({k: v.numpy() for k, v in m.state_dict().items()}, m.cfg)
                     for name, m in (("load_segmentation", seg), ("load_embedding_split", emb),
                                     ("load_campp_asset", campp),
                                     ("load_convtasnet_asset", ct))}}


@pytest.fixture
def stage_assets(stage_models, monkeypatch):
    """Both asset registries hand out the tiny models, and both packages'
    diarization backends report PLANTED_REGIONS as their overlap regions."""
    import sherpa_vietnamese_asr_tpu.models.assets as jassets
    import sherpa_vietnamese_asr_tpu.pipeline.diarization_pure as jpure
    import sherpa_vietnamese_asr_tpu.pipeline.diarization_senko as jsenko

    import sherpa_vietnamese_asr_tpu_torch.models.assets as tassets
    import sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure as tpure
    import sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko as tsenko

    for assets, key in ((jassets, "jax"), (tassets, "port")):
        for name, value in stage_models[key].items():
            monkeypatch.setattr(assets, name, lambda verify=True, value=value: value)
    planted = property(lambda self: list(PLANTED_REGIONS))
    for cls in (jpure.PureDiarizer, jsenko.SenkoCamppDiarizer, tpure.PureDiarizer,
                tsenko.SenkoCamppDiarizer):
        monkeypatch.setattr(cls, "overlap_regions", planted)


def _assert_stage_results_equal(got, ref):
    assert got["text"] == ref["text"] and got["text"]
    assert got["has_speaker_diarization"] == ref["has_speaker_diarization"]
    raw, raw_ref = got["speaker_segments_raw"], ref["speaker_segments_raw"]
    assert len(raw) == len(raw_ref)
    for g, r in zip(raw, raw_ref):
        assert (g["speaker"], g["speaker_id"]) == (r["speaker"], r["speaker_id"])
        for key in ("start", "end", "duration"):
            assert abs(g[key] - r[key]) <= 1e-6, (key, g, r)
    ov, ov_ref = got["overlap_segments"], ref["overlap_segments"]
    assert len(ov) == len(ov_ref)
    for g, r in zip(ov, ov_ref):
        assert (g["speaker"], g["speaker_id"], g["text"], g["overlap"]) == \
            (r["speaker"], r["speaker_id"], r["text"], r["overlap"])
        assert (g["start"], g["end"]) == (r["start"], r["end"])
        _assert_words_equal(g["raw_words"], r["raw_words"])
    assert len(got["segments"]) == len(ref["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["text"] == r["text"]
        assert (g.get("speaker"), g.get("speaker_id")) == (r.get("speaker"), r.get("speaker_id"))
        _assert_words_equal(g["raw_words"], r["raw_words"])
    assert got["quality_info"] == ref["quality_info"]


@pytest.mark.parametrize("config,model_pair", [
    ({"bypass_vad": True, "speaker_diarization": True,
      "speaker_model": "senko_campp"}, False),
    ({"bypass_vad": True, "speaker_diarization": True, "diarize_overlap_decode": False,
      "speaker_model": "senko_campp"}, False),
    ({"bypass_vad": True, "overlap_separation": True, "speaker_diarization": True}, False),
    ({"bypass_vad": True, "overlap_separation": True}, False),
    ({"bypass_vad": True, "speaker_diarization": True,
      "speaker_model": "senko_campp_optimized"}, True),
    ({"bypass_vad": True, "overlap_separation": True}, True),
    ({"bypass_vad": True, "speaker_diarization": True, "speaker_model": "senko_campp",
      "overlap_separation": True, "restore_punctuation": True, "quality_analysis": True},
     False),
])
def test_unported_stages_raise(config, model_pair, stage_models, stage_assets, tmp_path):
    """The stages this test once found refused (the Senko CAM++ diarization
    backend, overlapped with the decode or not, and overlap separation, with
    diarization, alone, or with a ROVER pair) run in the port and give the
    JAX TranscriberPipeline's result on the same WAV and weights: speaker
    segments, overlap segments (the Conv-TasNet streams re-decoded with the
    first model), segments and words. overlap_separation without
    speaker_diarization does nothing in either package. The last case runs
    every stage: Senko diarization, overlap separation, punctuation and
    quality."""
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )

    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav
    from tests.test_torch_diarization import THRESHOLD, diarization_audio

    config = dict(config, max_batch=2, diarization_threshold=THRESHOLD)
    jm, tm = stage_models["jms"], stage_models["tms"]
    kw_j, kw_t = {}, {}
    if config.get("restore_punctuation"):
        from tests.test_torch_punctuate_path import _jax_stages, _port_stages, _punct_params
        from tests.test_torch_punctuation import port_vibert
        from tests.test_torch_quality import jax_dnsmos, port_dnsmos

        dnsmos = jax.tree.map(np.array, jax_dnsmos(24))
        dnsmos["head"]["bias"] += 3.0
        stages = {"vibert": _punct_params(), "dnsmos": dnsmos, "port_dnsmos": port_dnsmos(dnsmos)}
        stages["port_vibert"] = port_vibert(stages["vibert"])
        none = {"jax": (None,) * 4, "port": (None,) * 2}
        kw_j = {k: v for k, v in _jax_stages(none, stages, False).items() if v is not None}
        kw_t = {k: v for k, v in _port_stages(none, stages, False).items() if v is not None}
    paths = []
    for name in ("j.wav", "t.wav"):
        paths.append(str(tmp_path / name))
        write_wav(paths[-1], diarization_audio(20), 16000)
    ref = JaxPipeline(paths[0], (jm[0], jm[1]) if model_pair else jm[0], config, **kw_j).run()
    phases = []
    got = TranscriberPipeline(paths[1], (tm[0], tm[1]) if model_pair else tm[0], config,
                              progress_callback=phases.append, **kw_t).run()
    _assert_stage_results_equal(got, ref)
    diarized = config.get("speaker_diarization", False)
    assert got["has_speaker_diarization"] == diarized
    if diarized:
        assert len({s["speaker_id"] for s in got["speaker_segments_raw"]}) >= 2
    if diarized and config.get("overlap_separation"):
        assert "PHASE:OverlapSep|Done " f"({len(got['overlap_segments'])} parallel segments)|100" \
            in phases
        if config.get("speaker_model", "").startswith("senko"):
            assert {s["speaker_id"] for s in got["overlap_segments"]} == {0, 1}
    else:
        assert got["overlap_segments"] == []
        assert not any(p.startswith("PHASE:OverlapSep") for p in phases)


@pytest.mark.parametrize("max_batch", [0, None, -1, "absent", 4, "report"])
def test_max_batch_auto_raises_and_explicit_is_kept(max_batch, tmp_path):
    """0, None or a negative max_batch is automatic, as the JAX package's
    resolve_max_batch: a calibration report's recommended.max_batch wins,
    else the memory heuristic, which has no card here and gives 8. An
    absent key gives a decoder of batch 8, a positive value that batch."""
    from sherpa_vietnamese_asr_tpu.pipeline.calibration import (
        resolve_max_batch as jax_resolve,
    )

    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )

    m = random_asr_model(vocab_size=20, zip_cfg=TINY_ZIPFORMER, beam_size=2,
                         device="cpu")
    config = {"bypass_vad": True,
              "calibration_report": str(tmp_path / "calibration_report.json")}
    want = {0: 8, None: 8, -1: 8, "absent": 8, 4: 4, "report": 24}[max_batch]
    if max_batch == "report":
        with open(config["calibration_report"], "w", encoding="utf-8") as f:
            json.dump({"recommended": {"max_batch": 24}}, f)
        config["max_batch"] = 0
    elif max_batch != "absent":
        config["max_batch"] = max_batch
    pipe = TranscriberPipeline("unused.wav", m, config=config)
    assert pipe.max_batch == pipe._decoder().max_batch == want
    assert jax_resolve(config) == want


@pytest.mark.parametrize("stage", ["decode", "embedding", "punct", "vibert", "campp",
                                   "speaker", None])
def test_auto_batch_size_tiers_match_jax(stage):
    """Every stage tier of the memory heuristic, at budgets around each
    floor, as the JAX package's auto_batch_size; no card, no budget."""
    from sherpa_vietnamese_asr_tpu.pipeline.calibration import auto_batch_size as jax_auto

    from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import (
        auto_batch_size,
        hbm_budget_mb,
    )

    assert hbm_budget_mb("cpu") is None
    for default in (4, 8, 32):
        assert auto_batch_size(stage, default, device="cpu") == default
        for budget in (None, 0, 1000, 2499, 2500, 2999, 3000, 3499, 3500, 5999, 6000,
                       6999, 7000, 9999, 10000, 80000):
            assert auto_batch_size(stage, default, budget_mb=budget) == \
                jax_auto(stage, default, budget_mb=budget), (default, budget)


def test_int16_upload_gives_the_float32_features():
    """Audio decoded from 16-bit PCM uploads as int16 losslessly."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import fbank_batch

    pcm = np.random.default_rng(3).integers(-20000, 20000, (2, 16000),
                                            dtype=np.int16)
    as_float = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    torch.testing.assert_close(fbank_batch(torch.from_numpy(pcm)),
                               fbank_batch(as_float), rtol=0, atol=0)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, and (on a machine without CUDA) in the
    checkout, chip_smoke.py exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(script, "rb").read())
    paths = [str(alone)] + ([] if torch.cuda.is_available() else [script])
    for path in paths:
        proc = subprocess.run([sys.executable, path], cwd=os.path.dirname(path),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_profile_busy_time_is_the_union_of_device_intervals():
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import _busy_ms

    assert _busy_ms([]) == 0.0
    assert _busy_ms([(3000, 4000), (0, 1000), (500, 1500), (600, 700)]) == 2.5
