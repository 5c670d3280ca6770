# The port's transcription slice end to end on the CPU:
#   (a) decode_spans and TranscriberPipeline({"bypass_vad": True}) give the
#       JAX package's words, timestamps and segments on the tiny model with
#       converted weights;
#   (b) fbank -> encoder -> beam search reproduces the frozen true-size
#       fixture tests/data/golden_e2e.json (weights from the JAX package's
#       golden model, converted);
#   (c) importing every module of the port never loads jax.
import dataclasses
import json
import os
import subprocess
import sys

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
    # the built-in VAD is not ported: asking for it raises, never falls back
    with pytest.raises(NotImplementedError):
        TranscriberPipeline(path, tm).run()


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
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'sherpa_vietnamese_asr_tpu.')) or "
        "m == 'sherpa_vietnamese_asr_tpu')\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("config,model_pair", [
    ({"bypass_vad": True, "speaker_diarization": True}, False),
    ({"bypass_vad": True, "restore_punctuation": True}, False),
    ({"bypass_vad": True, "quality_analysis": True}, False),
    ({"bypass_vad": True, "enable_resume": True}, False),
    ({"bypass_vad": True}, True),
])
def test_unported_stages_raise(config, model_pair):
    """Stages the port does not have yet raise instead of being skipped."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )

    m = random_asr_model(vocab_size=20, zip_cfg=TINY_ZIPFORMER, beam_size=2,
                         device="cpu")
    with pytest.raises(NotImplementedError):
        TranscriberPipeline("unused.wav", (m, m) if model_pair else m,
                            config=config)


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
