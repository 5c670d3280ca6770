# The port's live-mic session (pipeline/streaming.py) against the JAX
# package's: VADTrigger's probabilities with the same Silero weights
# (converted by models/convert.py) and the StreamingSession's
# (text, is_final, timestamp) callbacks under an injected clock, on
# TINY_ZIPFORMER, vocab 60, with weights converted from the JAX model (the
# joiner's output weights x 8 in both, as in tests/test_torch_slice.py).
# The Silero weights are the JAX package's random init with the head
# sharpened (weight x 100, bias -2): random weights give 0.5 on every
# window, these give about 0.12 on silence and 0.9 on a tone, so the
# sessions start and end utterances.
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv
from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model
from sherpa_vietnamese_asr_tpu.pipeline import streaming as jst
from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import SileroVadConfig
from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming as tst

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_slice import _convert  # noqa: E402

torch.set_num_threads(2)

SR = 16000
PROB_TOL = 1e-5  # |port - JAX| of each VAD probability, both float32 on the CPU


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_vad_step():
    """The JAX trigger calls silero_vad.vad_step eagerly, op by op (about
    30 ms a window on the CPU); the same function under jax.jit takes 2."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsv, "vad_step", jax.jit(jsv.vad_step))
        yield


@pytest.fixture(scope="module")
def vads():
    params = jax.tree.map(np.asarray, jsv.init_silero_params(jax.random.PRNGKey(0)))
    params["out"] = {"weight": params["out"]["weight"] * 100.0,
                     "bias": params["out"]["bias"] - 2.0}
    port = convert.silero_from_numpy(convert.silero_state_dict(params), SileroVadConfig(),
                                     device="cpu")
    return params, port


@pytest.fixture(scope="module")
def models():
    jm = random_asr_model(vocab_size=60, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    return jm, _convert(jm, beam_size=4)


def _tone(seconds, f0=300.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.2 * t))
         + 0.01 * rng.standard_normal(len(t)))
    return x.astype(np.float32)


def _silence(seconds):
    return np.zeros(int(seconds * SR), np.float32)


def test_vad_trigger_matches_jax(vads):
    """One 512-sample window a call (300 windows), then ragged 800-sample
    calls: each call's decision equal and its max probability within
    PROB_TOL; the context ring equal; both resets keep the two in step."""
    params, port = vads
    ref, trig = jst.VADTrigger(params), tst.VADTrigger(port)
    audio = np.concatenate([_silence(1.0), _tone(2.0), _silence(1.5), _tone(2.0, 420, 1),
                            _silence(0.6), _tone(1.0, 250, 2)])
    windows = [audio[i: i + 512] for i in range(0, 300 * 512, 512)]
    ragged = [audio[i: i + 800] for i in range(0, len(audio), 800)]
    probs = []
    for k, chunk in enumerate(windows + ragged):
        if k == 150:
            ref.soft_reset()
            trig.soft_reset()
        if k == 300:
            ref.reset()
            trig.reset()
        want, got = ref.process(chunk), trig.process(chunk)
        assert got[0] == want[0]
        if want[1] is None:
            assert got[1] is None
        else:
            assert abs(got[1] - want[1]) <= PROB_TOL, (k, got, want)
            probs.append(got[1])
        np.testing.assert_array_equal(trig.get_context(), ref.get_context())
    assert len(probs) >= 400 and min(probs) < 0.3 < max(probs)
    # PCM16 bytes are taken as the JAX trigger takes them
    pcm = np.clip(np.rint(audio[:4000] * 32768), -32768, 32767).astype(np.int16).tobytes()
    want, got = ref.process(pcm), trig.process(pcm)
    assert got[0] == want[0] and abs(got[1] - want[1]) <= PROB_TOL


def test_vad_trigger_default_weights_go_to_the_card():
    """Without a VAD the trigger builds random_silero_vad(seed=0) on the
    device it is given, the card by default; the CPU only when asked."""
    trig = tst.VADTrigger(device="cpu")
    assert trig.vad.device.type == "cpu"
    assert trig.process(np.zeros(600, np.float32))[0] in (True, False)
    if torch.cuda.is_available():
        assert tst.VADTrigger().vad.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tst.VADTrigger()


def _run_session(mod, model, vad, script, max_speech=None):
    """Feed `script`: (audio, chunk samples, queue depth, speaker or None)
    parts, 50 ms of the injected clock a chunk; PCM16 bytes where the chunk
    size is negative. Returns the callbacks."""
    events, clock = [], FakeClock()
    kw = {"vad_params": vad} if mod is jst else {"vad": vad}
    sess = mod.StreamingSession(model, lambda t, f, ts: events.append((t, f, ts)),
                                clock=clock, **kw)
    if max_speech is not None:
        sess.MAX_SPEECH_DURATION = max_speech
    for audio, size, depth, speaker in script:
        if speaker:
            sess.insert_speaker(speaker)
        as_bytes = size < 0
        size = abs(size)
        for i in range(0, len(audio), size):
            chunk = audio[i: i + size]
            if as_bytes:
                chunk = np.clip(np.rint(chunk * 32768), -32768, 32767).astype(
                    np.int16).tobytes()
            clock.t += 0.05
            sess.push_chunk(chunk, queue_depth=depth)
    sess.finalize()
    return events, sess.state


def test_session_lifecycle_matches_jax(models, vads):
    """Speech ended by 0.6 s of silence (partials at 1 Hz), a speaker change
    requested while idle and one mid-utterance, PCM16 bytes, and an
    utterance flushed by finalize(): the JAX session's callbacks."""
    (jm, tm), (params, port) = models, vads
    script = [(_silence(0.5), 800, 0, None), (_tone(2.6), 800, 0, None),
              (_silence(1.0), 800, 0, None), (_tone(1.6, 380, 1), -800, 0, "Alice"),
              (_tone(0.8, 380, 2), -800, 0, "Bob"), (_silence(1.0), 800, 0, None),
              (_tone(1.5, 260, 3), 800, 0, None)]
    got, got_state = _run_session(tst, tm, port, script)
    want, want_state = _run_session(jst, jm, params, script)
    assert got == want and got_state == want_state == "IDLE"
    finals = [e for e in got if e[1] and "__SPK_SEP__" not in e[0]]
    assert len(finals) >= 3 and any(not e[1] for e in got)
    assert [e[0] for e in got if "__SPK_SEP__" in e[0]] == [
        " __SPK_SEP__Alice__SPK_SEP__", " __SPK_SEP__Bob__SPK_SEP__"]


def test_session_max_duration_and_backpressure_match_jax(models, vads):
    """Continuous speech past a 2 s maximum ends utterances; chunks with
    more than 10 queued skip the partials: the JAX session's callbacks."""
    (jm, tm), (params, port) = models, vads
    script = [(_tone(2.0, 300, 4), 800, 20, None), (_tone(3.0, 340, 5), 800, 0, None)]
    got, _ = _run_session(tst, tm, port, script, max_speech=2.0)
    want, _ = _run_session(jst, jm, params, script, max_speech=2.0)
    assert got == want
    assert sum(1 for e in got if e[1]) >= 2
