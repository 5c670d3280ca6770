"""The frozen reference against the program's CPU path (its plain twins) on
the tiny preset, from the same weights made by the benchmark."""

import numpy as np
import pytest
import torch

from conftest import TINY
from portbench.harness import audio, cell, weights
from portbench.reference import fbank as ref_fbank
from portbench.reference import host, rnnt, streaming, vad as ref_vad, zipformer as ref_zip
from portbench.reference.precision import Precision

CPU = torch.device("cpu")
P = Precision("fp32")


def tiny_config(**extra):
    _, _, cfg, _, _ = cell.spec("zipformer30m-fp32.longform")
    return dict(cfg, **TINY, pos_dtype="float32", **extra)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    model, w = weights.asr_model(cfg, 11, CPU)
    return cfg, model, w


def test_vad_equals_the_programs_streamed_vad():
    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad

    cfg = tiny_config()
    vad, w = weights.silero(cfg, 5, CPU)
    x = audio.two_speakers(9.3, np.random.default_rng(0))
    got = silero_vad.silero_vad_probs_streamed(vad, x, block_windows=100).numpy()
    ref = ref_vad.speech_probs(P, w, x, CPU).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-5


def test_fbank_equals_the_programs_fbank():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import fbank_batch

    x = audio.speechlike(2.37, np.random.default_rng(1))
    got = fbank_batch(torch.from_numpy(x)[None])[0]
    ref = ref_fbank.fbank(P, torch.from_numpy(x))
    assert got.shape == ref.shape
    # the program's plain twin is a DFT by products, the reference an FFT
    assert float((got - ref).abs().max()) < 2e-3


def test_encoder_at_exact_length_equals_the_programs_padded_batch(tiny):
    cfg, model, w = tiny
    rng = np.random.default_rng(2)
    lens = [311, 190]
    feats = torch.from_numpy(rng.standard_normal((2, 320, 80)).astype(np.float32))
    enc, enc_lens = model.encoder(feats, torch.tensor(lens))
    for r, n in enumerate(lens):
        ref = ref_zip.encoder(P, w, cfg, feats[r, :n])
        assert int(enc_lens[r]) == ref.shape[0] == ref_zip.output_frames(n)
        err = torch.linalg.vector_norm(enc[r, : ref.shape[0]] - ref) / torch.linalg.vector_norm(ref)
        assert float(err) < 1e-5


def test_streaming_step_equals_the_programs(tiny):
    from sherpa_vietnamese_asr_tpu_torch.models import zipformer_streaming as zs

    cfg, model, w = tiny
    scfg = zs.StreamingConfig()
    state = zs.init_streaming_state(model.zip_cfg, scfg, 2, CPU)
    ref_state = streaming.zero_state(cfg, 2, CPU)
    rng = np.random.default_rng(3)
    for _ in range(3):
        chunk = torch.from_numpy(rng.standard_normal((2, 64, 80)).astype(np.float32))
        got, state = zs.streaming_step(model.encoder, state, chunk, scfg)
        ref, ref_state = streaming.step(P, w, cfg, ref_state, chunk)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_beam_search_equals_the_programs(tiny):
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import beam_search_batch

    cfg, model, w = tiny
    enc = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 40, 96)).astype(np.float32))
    lens = torch.tensor([40, 23, 1])
    got = beam_search_batch(enc, lens, model.decoder, model.joiner, model.rnnt_cfg, beam_size=4)
    ref = rnnt.beam_search(P, w, enc, lens, 4)
    assert torch.equal(got.num_tokens.long(), ref["n"])
    for r in range(3):
        n = int(ref["n"][r])
        assert torch.equal(got.tokens[r, :n].long(), ref["tokens"][r, :n])
        assert torch.equal(got.frames[r, :n].long(), ref["frames"][r, :n])
        lp = rnnt.token_logprobs(P, w, enc[r], ref["tokens"][r, :n], ref["frames"][r, :n])
        assert n == 0 or float((lp - got.tok_logp[r, :n]).abs().max()) < 1e-5
    assert float((got.total_logp - ref["score"]).abs().max()) < 1e-4


def test_greedy_gap_is_nought_on_the_programs_tokens_and_not_on_an_altered_one(tiny):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import greedy_chunk_decode

    cfg, model, w = tiny
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, 96)).astype(np.float32))
    toks, counts, _ = greedy_chunk_decode(enc, torch.zeros((1, 2), dtype=torch.long),
                                          model.decoder, model.joiner, model.rnnt_cfg)
    served = toks[0, : int(counts[0])].tolist()
    assert served
    assert rnnt.greedy_gap(P, w, enc[0], [0, 0], served) < 1e-5
    altered = list(served)
    altered[0] = (altered[0] + 1) % cfg["vocab_size"] or 1
    assert rnnt.greedy_gap(P, w, enc[0], [0, 0], altered) > 1e-3


def test_host_rules_equal_the_programs():
    from sherpa_vietnamese_asr_tpu_torch.pipeline import chunking, preprocessing, vad

    rng = np.random.default_rng(6)
    x = audio.two_speakers(95.0, rng)
    probs = np.clip(rng.random(len(x) // 512) * 0.4 + (np.arange(len(x) // 512) % 300 < 200) * 0.5, 0, 1)
    segs = vad.get_vad_segments(x, lambda a: probs)
    speech, _ = vad.concat_speech(preprocessing.preprocess_audio(x, segs, enable_rms_normalize=False),
                                  chunking.merge_vad_gaps(segs))
    plan = chunking.plan_chunks(len(speech), chunking.find_silent_regions(speech))
    ref_speech, ref_spans = host.request_plan(x, probs)
    assert np.array_equal(speech, ref_speech)
    assert [(s, e) for s, e, _ in plan] == ref_spans


def test_stream_windows_follow_the_slot_rule():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import MultiStreamRecognizer

    rec = MultiStreamRecognizer.__new__(MultiStreamRecognizer)  # its host side alone
    x = audio.speechlike(5.0, np.random.default_rng(7))
    rec.n, rec.active, rec.buffers, rec.cursors = 1, [True], [x.copy()], [0]
    rec.scfg = type("S", (), {"chunk_frames": 32})()
    rec._chunk_samples = host.StreamWindows.WINDOW
    seen = []
    rec.device, rec.enc_state, rec.ctx = CPU, None, None
    rec.tokens = [[]]
    rec._step = _capture(seen)
    wins = host.StreamWindows()
    while rec.ready_slots():
        assert wins.ready_at() <= len(x)
        rec.step()
        win, f0 = wins.take(x)
        assert np.array_equal(seen[-1][0], win) and seen[-1][1] == f0
    assert len(seen) == 7


def _capture(seen):
    def step(state, ctx, wav, f0s, mask):
        seen.append((wav[0].numpy().copy(), int(f0s[0])))
        n = wav.shape[0]
        return state, ctx, torch.full((n, 1), -1), torch.zeros(n, dtype=torch.long), None
    return step
