# The port's Silero VAD against the JAX package's, on the CPU:
#   (a) loaders: a Silero-v5-named file through both packages' load_silero_vad
#       gives the same weights (the port's in torch layout), and the JAX
#       tree converts to the same state (models/convert.silero_state_dict);
#   (b) silero_vad_probs_streamed(quantize=True) equals the JAX function on
#       the same weights and audio within rtol 1e-4 / atol 1e-5 (the gate of
#       tests/test_model_oracles.py), at block_windows 7: a file of several
#       blocks, a ragged last block, audio shorter than one window, at the
#       small synthesized size and at full size (129 / 256 /
#       (128, 64, 64, 128) / 128);
#   (c) window_features, lstm_scan, vad_step and silero_vad_probs equal
#       theirs; the streamed int16 path is not the unquantised one;
#   (d) models default to the card.
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models import onnx_import as oi
from sherpa_vietnamese_asr_tpu_torch.models import silero_vad as tsv

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_model_oracles import _silero_v5_file  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
FULL = dict(n_freq=129, filt=256, channels=(128, 64, 64, 128), hid=128)


def _pair(source, tmp_path):
    """(JAX params, JAX cfg, port SileroVad on the CPU) with one weight set."""
    from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_silero_vad

    rng = np.random.default_rng(7)
    if source == "jax_random":
        cfg = jsv.SileroVadConfig()
        params = jsv.init_silero_params(jax.random.PRNGKey(0), cfg)
        state = convert.silero_state_dict(jax.tree.map(np.asarray, params))
        tcfg = tsv.SileroVadConfig()
    else:
        path = _silero_v5_file(rng, tmp_path, **(FULL if source == "v5_full" else {}))
        params, cfg = load_silero_vad(str(path))
        state, tcfg = oi.load_silero_vad(str(path))
    assert tcfg == tsv.SileroVadConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return params, cfg, convert.silero_from_numpy(state, tcfg, device="cpu")


def _speech_like(n, seed):
    """Tones with an envelope and noise, with stretches of silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 230 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))
    x = x + 0.03 * rng.standard_normal(n)
    x[n // 3: n // 3 + 9000] = 0.0
    return x.astype(np.float32)


def test_loaders_agree(tmp_path):
    """The port's loader gives the JAX loader's weights in torch layout."""
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_silero_vad

    path = _silero_v5_file(np.random.default_rng(1), tmp_path)
    params, _ = load_silero_vad(str(path))
    state, cfg = oi.load_silero_vad(str(path))
    assert cfg.n_freq == 33 and cfg.encoder_channels == (16, 24) and cfg.lstm_dim == 20
    want = convert.silero_state_dict(jax.tree.map(np.asarray, params))
    assert set(state) == set(want) == set(tsv.SileroVad(cfg).state_dict())
    for k in want:
        assert state[k].dtype == np.float32
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)


# lengths in samples: several blocks of 7 windows with a ragged last block
# and a partial window, exactly three blocks, one window, under one window.
LENGTHS = (512 * 23 + 300, 512 * 21, 512, 511, 100)


@pytest.mark.parametrize("source", ["v5_small", "v5_full", "jax_random"])
def test_streamed_matches_jax(source, tmp_path):
    from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv

    params, cfg, vad = _pair(source, tmp_path)
    for i, n in enumerate(LENGTHS + LENGTHS[:1]):
        # the last case is quiet, where the int16 round shows (see below)
        audio = _speech_like(n, seed=i) * (0.01 if i == len(LENGTHS) else 1.0)
        want = jsv.silero_vad_probs_streamed(params, audio, block_windows=7,
                                             quantize=True, cfg=cfg)
        got = tsv.silero_vad_probs_streamed(vad, audio, block_windows=7)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        assert got.shape == (n // 512,) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The default block (1875 windows) on a ragged file of two blocks.
    audio = _speech_like(512 * 1900 + 17, seed=9)
    want = jsv.silero_vad_probs_streamed(params, audio, cfg=cfg)
    got = tsv.silero_vad_probs_streamed(vad, audio).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.ptp(got) > 1e-3  # the probabilities move with the audio


def test_functions_match_jax(tmp_path):
    from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv

    params, cfg, vad = _pair("v5_full", tmp_path)
    audio = _speech_like(512 * 40, seed=3)
    wins = np.random.default_rng(2).standard_normal((6, 576)).astype(np.float32) * 0.1
    feats_j = np.array(jsv.window_features(params, jnp.asarray(wins), cfg))
    with torch.no_grad():
        feats_t = tsv.window_features(vad, torch.from_numpy(wins))
    np.testing.assert_allclose(feats_t.numpy(), feats_j, rtol=RTOL, atol=ATOL)
    probs_j, (h_j, c_j) = jsv.lstm_scan(params, jnp.asarray(feats_j))
    with torch.no_grad():
        probs_t, (h_t, c_t) = tsv.lstm_scan(vad, torch.from_numpy(feats_j))
    for got, want in ((probs_t, probs_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    want = np.asarray(jsv.silero_vad_probs(params, jnp.asarray(audio), cfg))
    got = tsv.silero_vad_probs(vad, torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the streamed function without quantisation is the same function
    got_s = tsv.silero_vad_probs_streamed(vad, audio, block_windows=7,
                                          quantize=False).numpy()
    np.testing.assert_allclose(got_s, want, rtol=RTOL, atol=ATOL)

    # one streaming step with carried state, twice
    ctx_j, st_j = jnp.zeros(64), None
    ctx_t, st_t = torch.zeros(64), None
    for w in range(2):
        chunk = audio[w * 512: (w + 1) * 512]
        p_j, ctx_j, st_j = jsv.vad_step(params, jnp.asarray(chunk), ctx_j, st_j, cfg)
        p_t, ctx_t, st_t = tsv.vad_step(vad, torch.from_numpy(chunk), ctx_t, st_t)
        np.testing.assert_allclose(float(p_t), float(p_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ctx_t.numpy(), np.asarray(ctx_j))


def test_quantisation_and_blocks_matter(tmp_path):
    """The int16 round before the VAD and the carried state across blocks
    are part of the result: on quiet audio at full size, dropping either
    moves probabilities beyond the gate (6.7x and 1600x of it)."""
    from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv

    params, cfg, vad = _pair("v5_full", tmp_path)
    audio = _speech_like(512 * 23 + 300, seed=0) * 0.01  # quiet: int16 steps show
    want = jsv.silero_vad_probs_streamed(params, audio, block_windows=7,
                                         quantize=True, cfg=cfg)
    unquantised = tsv.silero_vad_probs_streamed(vad, audio, block_windows=7,
                                                quantize=False).numpy()
    restarted = np.concatenate([
        tsv.silero_vad_probs_streamed(
            vad, np.rint(audio[s: s + 7 * 512] * 32768) / 32768, block_windows=7).numpy()
        for s in range(0, len(audio), 7 * 512)])
    for wrong in (unquantised, restarted):
        assert not np.allclose(wrong, want, rtol=RTOL, atol=ATOL)


def test_random_init_and_device_default():
    vad = tsv.random_silero_vad(seed=0, device="cpu")
    again = tsv.random_silero_vad(seed=0, device="cpu")
    for k, v in vad.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    assert int(torch.count_nonzero(vad.lstm.bias_hh_l0)) == 0
    assert vad.encoder[0].weight.shape == (128, 129, 3)
    probs = tsv.silero_vad_probs_streamed(vad, _speech_like(16000, 1))
    assert probs.shape == (31,) and bool(torch.isfinite(probs).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsv.random_silero_vad()
