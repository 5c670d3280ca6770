# The port's default transcribe path against the JAX package's, on the CPU,
# on tiny models with the same weights (converted), the same Silero VAD (one
# synthesized Silero-v5 file, given to both packages' assets.load_silero)
# and the same audio:
#   (a) TranscriberPipeline with the default config (Silero VAD on);
#   (b) ROVER over a model pair, with a hotword phrase;
#   (c) preprocess_wpe;
#   (d) enable_resume: a run stopped after the decode leaves a checkpoint
#       equal to JAX's; the next run resumes from it and clears it;
#   (e) the CLI `transcribe --device cpu` on a directory written by the JAX
#       exporter writes the .asr.json of the JAX CLI.
# Words, times and segments are held to tests/test_torch_slice.py's
# tolerances (times 1e-6 s, word probabilities 1e-4); the .asr.json, whose
# times are rounded to 1 ms, to one rounding step.
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_model_oracles import _silero_v5_file  # noqa: E402
from tests.test_torch_onnx_import import tiny_registry  # noqa: E402
from tests.test_torch_slice import _assert_words_equal, _convert  # noqa: E402

torch.set_num_threads(2)
SR = 16000
# Shifts the synthesized VAD's head so that the silences of the test audio
# fall under the 0.2 threshold and parts of the tone do not: the VAD then
# cuts the file into several segments.
HEAD_BIAS_SHIFT = -1.6


def _jax_model(seed):
    from sherpa_vietnamese_asr_tpu.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    jm = random_asr_model(vocab_size=80, beam_size=4, seed=seed,
                          zip_cfg=dataclasses.replace(TINY_ZIPFORMER,
                                                      pos_dtype="float32"))
    # Sharper logits than random weights give (tests/test_torch_slice.py).
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    return jm


@pytest.fixture(scope="module")
def models():
    jms = [_jax_model(0), _jax_model(1)]
    return jms, [_convert(jm, beam_size=4) for jm in jms]


def _audio():
    t = np.arange(int(SR * 64.5)) / SR
    rng = np.random.default_rng(0)
    x = (0.3 * np.sin(2 * np.pi * 280 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    x[int(20 * SR): int(24 * SR)] = 0.0
    x[int(40 * SR): int(41.5 * SR)] = 0.0
    return x


@pytest.fixture
def same_silero(tmp_path, monkeypatch):
    """Both packages' default VAD loads one synthesized Silero-v5 file."""
    import sherpa_vietnamese_asr_tpu.models.assets as jassets
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_silero_vad

    import sherpa_vietnamese_asr_tpu_torch.models.assets as tassets
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_import as oi

    path = str(_silero_v5_file(np.random.default_rng(0), tmp_path))
    params, cfg = load_silero_vad(path)
    params["out"]["bias"] = params["out"]["bias"] + np.float32(HEAD_BIAS_SHIFT)
    state, tcfg = oi.load_silero_vad(path)
    state["head.bias"] = state["head.bias"] + np.float32(HEAD_BIAS_SHIFT)
    monkeypatch.setattr(jassets, "load_silero", lambda verify=True: (params, cfg))
    monkeypatch.setattr(tassets, "load_silero", lambda verify=True: (state, tcfg))


def _wav(tmp_path, name):
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / name)
    write_wav(path, _audio(), SR)
    return path


def _assert_results_equal(got, ref):
    assert got["text"] == ref["text"] and got["text"]
    assert got["duration_sec"] == ref["duration_sec"]
    assert len(got["segments"]) == len(ref["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["text"] == r["text"]
        assert abs(g["start"] - r["start"]) < 1e-6
        assert abs(g["end"] - r["end"]) < 1e-6
        _assert_words_equal(g["raw_words"], r["raw_words"])
    assert got["asr_confidence"] == pytest.approx(ref["asr_confidence"], abs=1e-4)


def _run_both(tmp_path, jmodel, tmodel, config, **kw):
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )

    jphases, tphases = [], []
    ref = JaxPipeline(_wav(tmp_path, "j.wav"), jmodel, config=config,
                      progress_callback=jphases.append, **kw).run()
    got = TranscriberPipeline(_wav(tmp_path, "t.wav"), tmodel, config=config,
                              progress_callback=tphases.append, **kw).run()
    return ref, got, jphases, tphases


def test_default_config_runs_silero_like_jax(models, same_silero, tmp_path):
    (jm, _), (tm, _) = models
    ref, got, jphases, tphases = _run_both(tmp_path, jm, tm, {"max_batch": 2})
    _assert_results_equal(got, ref)
    found = [p for p in tphases if p.startswith("PHASE:VAD|Found")]
    assert found == [p for p in jphases if p.startswith("PHASE:VAD|Found")]
    assert found and found[0] != "PHASE:VAD|Found 1 speech segments|100"
    assert not any("VAD failed" in p for p in tphases)


def test_rover_pair_matches_jax(models, same_silero, tmp_path):
    (jm_a, jm_b), (tm_a, tm_b) = models
    config = {"max_batch": 2, "hotword_phrases": ["ba"]}
    ref, got, _, tphases = _run_both(tmp_path, (jm_a, jm_b), (tm_a, tm_b), config)
    _assert_results_equal(got, ref)
    assert "PHASE:Transcription|Transcribing (ROVER)|0" in tphases
    flags = [bool(w.get("_disagree")) for s in got["segments"] for w in s["raw_words"]]
    ref_flags = [bool(w.get("_disagree")) for s in ref["segments"] for w in s["raw_words"]]
    assert flags == ref_flags


def test_wpe_matches_jax(models, tmp_path):
    (jm, _), (tm, _) = models
    ref, got, _, _ = _run_both(tmp_path, jm, tm,
                               {"bypass_vad": True, "preprocess_wpe": True,
                                "max_batch": 2})
    _assert_results_equal(got, ref)
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )
    plain = TranscriberPipeline(_wav(tmp_path, "p.wav"), tm,
                                {"bypass_vad": True, "max_batch": 2}).run()
    assert plain["text"] != got["text"]  # the transform ran


def test_resume_checkpoint_matches_jax(models, same_silero, tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline.transcriber import (
        TranscriberPipeline as JaxPipeline,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )

    (jm, _), (tm, _) = models
    config = {"max_batch": 2, "enable_resume": True}
    paths = {"j": _wav(tmp_path, "j.wav"), "t": _wav(tmp_path, "t.wav")}
    ckpts = {k: p + ".asr_ckpt.json" for k, p in paths.items()}
    # Run 1 stops after the decode (cancel_check turns true once the
    # checkpoint is written): the checkpoint stays.
    assert JaxPipeline(paths["j"], jm, config, cancel_check=lambda: os.path.exists(
        ckpts["j"])).run() is None
    assert TranscriberPipeline(paths["t"], tm, config, cancel_check=lambda: os.path.exists(
        ckpts["t"])).run() is None
    with open(ckpts["j"], encoding="utf-8") as f:
        ck_j = json.load(f)
    with open(ckpts["t"], encoding="utf-8") as f:
        ck_t = json.load(f)
    assert set(ck_t) == set(ck_j)
    for key in ("version", "stage", "full_text", "concat_len"):
        assert ck_t[key] == ck_j[key], key
    assert ck_t["version"] == 1 and ck_t["stage"] == "decoded"
    assert [set(w) for w in ck_t["all_words"]] == [set(w) for w in ck_j["all_words"]]
    _assert_words_equal(ck_t["all_words"], ck_j["all_words"])
    assert len(ck_t["vad_probs"]) == len(ck_j["vad_probs"]) == len(_audio()) // 512
    np.testing.assert_allclose(ck_t["vad_probs"], ck_j["vad_probs"], atol=1e-4)
    # Run 2 resumes (no VAD, no decode) and clears the checkpoint.
    phases = []
    ref = JaxPipeline(paths["j"], jm, config).run()
    got = TranscriberPipeline(paths["t"], tm, config, progress_callback=phases.append).run()
    assert "PHASE:Transcription|Resuming from checkpoint|100" in phases
    assert not any(p.startswith("PHASE:VAD") for p in phases)
    _assert_results_equal(got, ref)
    assert not os.path.exists(ckpts["t"]) and not os.path.exists(ckpts["j"])


def _assert_json_close(got, ref, path="$"):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
        for k in ref:
            _assert_json_close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_json_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert abs(got - ref) <= 1.001e-3, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def test_cli_writes_the_jax_asr_json(models, same_silero, tmp_path, monkeypatch):
    from sherpa_vietnamese_asr_tpu.cli import main as jax_main
    from sherpa_vietnamese_asr_tpu.models.onnx_export_rnnt import export_asr_dir

    from sherpa_vietnamese_asr_tpu_torch.cli import main
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import write_tokens

    (jm, _), _ = models
    model_dir = tmp_path / "tiny-model"
    export_asr_dir(jm, str(model_dir), t_in=103)
    write_tokens(str(model_dir / "tokens.txt"), jm.id2token)
    tiny_registry(monkeypatch, jm)
    args = ["--model", str(model_dir), "--beam", "4", "--max-batch", "2"]
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
    assert got["text"] and got["model"] == "tiny-model"
    _assert_json_close(got, ref)


def test_cli_refuses_unported_stages_and_needs_a_card(tmp_path):
    """Every stage the CLI offers is ported (--punctuate and --quality since
    they came to the port: tests/test_torch_punctuate_path.py runs them on
    the CPU); each one, like the default path, needs a card unless
    --device cpu is given."""
    from sherpa_vietnamese_asr_tpu_torch.cli import build_parser, main

    wav = _wav(tmp_path, "t.wav")
    args = build_parser().parse_args(["transcribe", wav, "--punctuate", "--quality"])
    assert args.punctuate and args.quality and args.device == "cuda"
    if not torch.cuda.is_available():
        for extra in ([], ["--diarize"], ["--punctuate"], ["--quality"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["transcribe", wav, "--allow-random"] + extra)
    assert jax.default_backend() == "cpu"
