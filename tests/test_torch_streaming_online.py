# The port's online streaming recognizers (pipeline/streaming_online.py)
# against the JAX package's on TINY_ZIPFORMER, vocab 60, with the weights
# converted from the JAX model: the same token ids from
# CachedStreamingRecognizer (pipelined, and with its pump thread),
# MultiStreamRecognizer (slots joining mid-flight, one idle, one reused
# after close; equal to single-stream), the greedy chunk decode's compaction,
# and the same callbacks from OnlineStreamingSession (partials, finals, the
# three endpoint rules). Random weights leave the joiner's logits nearly
# uniform, where float32 rounding differences between the two frameworks
# flip near-tied decisions; as in tests/test_torch_slice.py both packages
# run the joiner's output weights x 8.
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model
from sherpa_vietnamese_asr_tpu.pipeline import streaming_online as jso
from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming_online as tso

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_slice import _convert  # noqa: E402

torch.set_num_threads(2)

SR = 16000
PIECE = 1600  # 0.1 s pieces, as a client sends them


@pytest.fixture(scope="module")
def models():
    jm = random_asr_model(vocab_size=60, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    return jm, _convert(jm, beam_size=4)


def _speech(seconds, seed, f0=300.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.03 * rng.standard_normal(len(t)))
    return np.clip(x, -1, 1).astype(np.float32)


def _feed(rec, audio):
    """Feed 0.1 s pieces, decoding while ready; returns each decode()'s ids."""
    emitted = []
    for i in range(0, len(audio), PIECE):
        rec.accept_waveform(audio[i: i + PIECE])
        while rec.is_ready():
            emitted.append([int(t) for t in rec.decode()])
    return emitted


@pytest.mark.parametrize("background", [False, True])
def test_cached_recognizer_matches_jax(models, background):
    """The pipelined recognizer returns JAX's ids call by call (one chunk
    late); with the pump thread the whole sequence and the text equal
    JAX's; a reset and a second utterance stay in lockstep."""
    jm, tm = models
    ref = jso.CachedStreamingRecognizer(jm, chunk_frames=32, left_frames=64)
    rec = tso.CachedStreamingRecognizer(tm, chunk_frames=32, left_frames=64,
                                        background=background)
    try:
        for seed in (0, 1):
            audio = _speech(3.0, seed, f0=280 + 40 * seed)
            want, got = _feed(ref, audio), _feed(rec, audio)
            if not background:
                assert got == want
            assert sum(map(len, want)) > 0
            assert rec.tokens == list(ref.tokens)
            assert rec.get_result() == ref.get_result() != ""
            assert tuple(rec.ctx.shape) == (1, 2)
            assert rec.ctx.cpu().tolist() == np.asarray(ref.ctx).tolist()
            rec.reset()
            ref.reset()
            assert rec.get_result() == "" and rec.tokens == []
    finally:
        rec.close()


def test_background_pump_surfaces_its_exception(models):
    """A failing step on the pump thread is raised on the caller's next
    decode() or get_result(), and close() still stops the thread."""
    _, tm = models
    rec = tso.CachedStreamingRecognizer(tm, chunk_frames=32, left_frames=64,
                                        background=True)

    def broken(*args):
        raise RuntimeError("step failed")

    rec._step = broken
    try:
        with pytest.raises(RuntimeError, match="step failed"):
            _feed(rec, _speech(1.5, 2))  # raised by a later decode()
            rec.get_result()
    finally:
        rec.close()
    assert rec._bg is None


def _single_tokens(mod, model, audio):
    rec = mod.CachedStreamingRecognizer(model, chunk_frames=32, left_frames=64)
    _feed(rec, audio)
    return list(rec.tokens)


def _drive_multistream(mod, model, audios):
    """Two slots from the start, a third joining at tick 5 (one slot of four
    never opened); then slot 0 closed and reused for a fourth stream.
    Returns (tokens of the four streams, the idle slot's tokens, texts)."""
    ms = mod.MultiStreamRecognizer(model, n_streams=4, chunk_frames=32, left_frames=64)
    s0, s1 = ms.open_stream(), ms.open_stream()
    offsets, slot_audio = {s0: 0, s1: 0}, {s0: audios[0], s1: audios[1]}
    s2, tick = None, 0

    def pump():
        while True:
            moved = False
            for s, a in list(slot_audio.items()):
                if offsets[s] < len(a):
                    ms.accept_waveform(s, a[offsets[s]: offsets[s] + PIECE])
                    offsets[s] += PIECE
                    moved = True
            while ms.ready_slots():
                ms.step()
            yield
            if not moved and not ms.ready_slots():
                return

    for _ in pump():
        tick += 1
        if tick == 5 and s2 is None:
            s2 = ms.open_stream()
            offsets[s2], slot_audio[s2] = 0, audios[2]
    toks = [list(ms.tokens[s]) for s in (s0, s1, s2)]
    texts = [ms.close_stream(s0)]
    assert ms.open_stream() == s0  # a closed slot is reused
    offsets[s0], slot_audio[s0] = 0, audios[3]
    del slot_audio[s1], slot_audio[s2]
    for _ in pump():
        pass
    toks.append(list(ms.tokens[s0]))
    texts.append(ms.get_result(s0))
    idle = ({0, 1, 2, 3} - {s0, s1, s2}).pop()
    return toks, list(ms.tokens[idle]), texts


def test_multistream_matches_jax_and_single_stream(models):
    jm, tm = models
    audios = [_speech(2.0 + 0.3 * i, 10 + i, f0=250 + 60 * i) for i in range(4)]
    got, idle, texts = _drive_multistream(tso, tm, audios)
    want, want_idle, want_texts = _drive_multistream(jso, jm, audios)
    assert got == want and texts == want_texts
    assert idle == want_idle == []
    assert all(got) and all(texts)
    assert got == [_single_tokens(tso, tm, a) for a in audios]


def test_greedy_chunk_decode_matches_jax_compaction(models):
    """Frames alternating blank and emission: ids, counts and contexts equal
    JAX's per slot, emitted ids at the front in frame order."""
    jm, tm = models
    rng = np.random.default_rng(3)
    enc = (2.0 * rng.standard_normal((3, 16, tm.rnnt_cfg.encoder_out_dim))).astype(np.float32)
    ctx = np.asarray([[0, 0], [5, 9], [12, 40]], np.int64)
    # Blank's output bias raised until about half the frames emit (4–15 a slot).
    jm_joi = dict(jm.joi_params, output=dict(jm.joi_params["output"]))
    bias = np.zeros(jm.rnnt_cfg.vocab_size, np.float32)
    bias[jm.rnnt_cfg.blank_id] = 15.0
    jm_joi["output"]["bias"] = jnp.asarray(bias)
    with torch.no_grad():
        joiner = type(tm.joiner)(tm.rnnt_cfg)
        joiner.load_state_dict(tm.joiner.state_dict())
        joiner.output.bias.copy_(torch.from_numpy(bias))
    toks, counts, new_ctx = tso.greedy_chunk_decode(
        torch.from_numpy(enc), torch.from_numpy(ctx), tm.decoder, joiner, tm.rnnt_cfg)
    counts = counts.tolist()
    assert any(0 < n < 16 for n in counts), counts
    for i in range(3):
        rt, rn, rc = jso._greedy_chunk_decode(
            jnp.asarray(enc[i]), jnp.asarray(ctx[i], jnp.int32), jm.dec_params, jm_joi,
            jm.rnnt_cfg)
        assert toks[i].tolist() == np.asarray(rt).tolist()
        assert counts[i] == int(rn)
        assert new_ctx[i].tolist() == np.asarray(rc).tolist()
        assert (toks[i, counts[i]:] == -1).all() and (toks[i, :counts[i]] >= 0).all()


def _session_events(mod, model, audio, piece, speaker_at=None, **kw):
    events = []
    sess = mod.OnlineStreamingSession(model, lambda t, f, ts: events.append((t, f, ts)),
                                      **kw)
    for k, i in enumerate(range(0, len(audio), piece)):
        if k == speaker_at:
            sess.insert_speaker("Bob")
        sess.push_chunk(audio[i: i + piece])
    sess.finalize()
    return events


ONLINE_KW = dict(chunk_sec=0.32, max_window_sec=4.0, decode_throttle_sec=0.32,
                 rule1_min_trailing_silence=1.5, rule2_min_trailing_silence=0.8,
                 rule3_min_utterance_length=3.0)


def test_online_session_decodes_like_jax(models):
    """Real decodes (BatchedChunkDecoder at batch 1, 4 s windows): the same
    partials, finals and timestamps as the JAX session, with a speaker
    separator, PCM16 bytes in, and rule 3 ending 3 s utterances."""
    jm, tm = models
    audio = np.concatenate([_speech(4.0, 20), np.zeros(SR, np.float32),
                            _speech(3.5, 21, f0=360)])
    pcm = np.clip(np.rint(audio * 32768), -32768, 32767).astype(np.int16).tobytes()
    got = _session_events(tso, tm, pcm, 2 * 800, speaker_at=30, **ONLINE_KW)
    want = _session_events(jso, jm, pcm, 2 * 800, speaker_at=30, **ONLINE_KW)
    assert got == want
    assert any(not f for _, f, _ in got) and sum(f for _, f, _ in got) >= 3
    assert sum("__SPK_SEP__Bob__SPK_SEP__" in t for t, _, _ in got) == 1


def _energy_decode(self):
    """The JAX package's test stub: a word per loud 50 ms window."""
    self._pending = 0
    buf, win, words = self.buffer, 800, []
    for i in range(len(buf) // win):
        if np.sqrt((buf[i * win: (i + 1) * win] ** 2).mean()) > 0.02:
            t = i * win / 16000.0
            words.append({"text": f"w{i}", "start": t, "end": t + 0.05})
    self._last_words = words
    self._last_text = " ".join(w["text"] for w in words)


def _rules_fired(mod, model, audio, monkeypatch):
    fired = []
    is_endpoint = mod.OnlineRecognizer.is_endpoint

    def recording(self):
        hit = is_endpoint(self)
        if hit:
            fired.append("rule3" if self.utterance_length_sec() >= self.rule3 else
                         "rule2" if self._last_text else "rule1")
        return hit

    monkeypatch.setattr(mod.OnlineRecognizer, "decode", _energy_decode)
    monkeypatch.setattr(mod.OnlineRecognizer, "is_endpoint", recording)
    return _session_events(mod, model, audio, 800, speaker_at=3, **ONLINE_KW), fired


def test_online_endpoint_rules_match_jax(models, monkeypatch):
    """With the JAX test's energy stub as the decode in both packages, each
    of the three rules ends an utterance and the callbacks are JAX's."""
    jm, tm = models
    tone = (0.3 * np.sin(2 * np.pi * 300 * np.arange(4 * SR) / SR)).astype(np.float32)
    audio = np.concatenate([tone[:SR], np.zeros(2 * SR, np.float32),  # rule 2
                            np.zeros(2 * SR, np.float32),              # rule 1
                            tone])                                     # rule 3
    got, got_rules = _rules_fired(tso, tm, audio, monkeypatch)
    want, want_rules = _rules_fired(jso, jm, audio, monkeypatch)
    assert got == want and got_rules == want_rules
    assert {"rule1", "rule2", "rule3"} <= set(got_rules), got_rules
