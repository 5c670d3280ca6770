# The port's remaining CLI subcommands and its native WAV path, on the CPU:
#   * `verify-assets --device cpu` exits 0 on an empty models dir (every
#     asset absent), 1 on a hash mismatch, prints JSON with --json, and the
#     default device raises without a card;
#   * `install-service` writes a systemd unit that runs this package's
#     `serve`, the JAX unit's other lines unchanged;
#   * `monitor --samples 2 --interval 0` prints two samples and writes them
#     as CSV;
#   * every subcommand parses;
#   * utils/native (native/audiokit.cpp built into build/native/) against the
#     JAX package's loaders on the cases of tests/test_native.py, and
#     utils/audio_io.load_audio against the JAX load_audio (both native).
import json

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch import cli
from sherpa_vietnamese_asr_tpu_torch.models import assets
from sherpa_vietnamese_asr_tpu_torch.utils import native


def test_verify_assets_empty_dir_exits_0(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    assert cli.main(["verify-assets", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("overall: OK")
    assert out.count(": ABSENT") == len(assets.MANIFEST)
    assert cli.main(["verify-assets", "--device", "cpu", "--json",
                     "--asset", "dnsmos", "--asset", "plda"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is True and list(report["assets"]) == ["dnsmos", "plda"]


def test_verify_assets_hash_mismatch_exits_1(tmp_path, monkeypatch, capsys):
    d = tmp_path / assets.MANIFEST["dnsmos"]["local_dir"]
    d.mkdir()
    (d / "sig_bak_ovr.onnx").write_bytes(b"corrupt")
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    assert cli.main(["verify-assets", "--device", "cpu", "--asset", "dnsmos"]) == 1
    out = capsys.readouterr().out
    assert "dnsmos: FAILED" in out and "[FAIL] hash.sig_bak_ovr.onnx: got " in out
    assert out.rstrip().endswith("overall: FAILED")


def test_verify_assets_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["verify-assets"])


def test_install_service_names_the_port(tmp_path, capsys):
    from sherpa_vietnamese_asr_tpu import cli as jcli

    out = tmp_path / "svt.service"
    assert cli.main(["install-service", "--port", "8123", "--data-dir", "/srv/d",
                     "--output", str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    unit = out.read_text()
    assert "-m sherpa_vietnamese_asr_tpu_torch.cli serve --host 0.0.0.0 --port 8123 " \
           "--data-dir /srv/d" in unit
    jout = tmp_path / "jax.service"
    assert jcli.main(["install-service", "--port", "8123", "--data-dir", "/srv/d",
                      "--output", str(jout)]) == 0
    want = jout.read_text().replace("sherpa_vietnamese_asr_tpu.cli", "sherpa_vietnamese_asr_tpu_torch.cli")
    differ = [(a, b) for a, b in zip(unit.splitlines(), want.splitlines()) if a != b]
    assert [a.split("=")[0] for a, _ in differ] == ["Description"]


def test_monitor_samples(tmp_path, capsys):
    out = tmp_path / "m.csv"
    assert cli.main(["monitor", "--samples", "2", "--interval", "0", "--output", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(line.startswith("t=") and "rss=" in line for line in lines)
    rows = out.read_text().splitlines()
    assert rows[0] == "t,rss_mb,cpu_user_s,cpu_sys_s" and len(rows) == 3
    assert cli.main(["monitor", "--samples", "2", "--interval", "0"]) == 0


@pytest.mark.parametrize("argv", [
    ["transcribe", "x.wav", "--model", "d", "--device", "cpu", "--diarize"],
    ["serve", "--port", "9000", "--http"],
    ["warmup", "--stages", "decode", "--jobs", "2"],
    ["calibrate", "--autotune", "--candidates", "8,16"],
    ["verify-assets", "--asset", "dnsmos", "--asset", "plda", "--json", "--device", "cpu"],
    ["install-service", "--port", "8001", "--data-dir", "/d", "--output", "u.service"],
    ["monitor", "--interval", "0.5", "--samples", "3", "--output", "m.csv"],
])
def test_every_subcommand_parses(argv):
    args = cli.build_parser().parse_args(argv)
    assert args.cmd == argv[0] and callable(args.fn)
    if argv[0] == "verify-assets":
        assert args.asset == ["dnsmos", "plda"] and args.json and args.device == "cpu"
    if argv[0] == "monitor":
        assert (args.interval, args.samples, args.output) == (0.5, 3, "m.csv")


# ---------------------------------------------------------------------------
# native/audiokit.cpp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    lib = native.get_audiokit()
    assert lib is not None, "g++ builds audiokit on this host"
    return lib


def test_audiokit_is_built_under_build(lib):
    path = native.library_path("audiokit")
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert native.get_audiokit() is lib


def test_native_wav_decode_equals_jax(lib, tmp_path):
    from sherpa_vietnamese_asr_tpu.utils import native as jnative

    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import read_wav, write_wav

    rng = np.random.default_rng(0)
    x = np.clip(0.3 * rng.standard_normal((8000, 2)), -0.99, 0.99).astype(np.float32)
    p = tmp_path / "n.wav"
    write_wav(str(p), x, 22050)
    audio, rate = native.wav_decode_native(str(p))
    assert rate == 22050
    ref, _ = read_wav(str(p))
    np.testing.assert_allclose(audio, ref.mean(axis=1), atol=1e-6)
    j_audio, j_rate = jnative.wav_decode_native(str(p))
    assert j_rate == rate
    np.testing.assert_array_equal(audio, j_audio)
    (tmp_path / "bad.wav").write_bytes(b"RIFF....WAVEjunk")
    assert native.wav_decode_native(str(tmp_path / "bad.wav")) is None


def test_native_resample_equals_jax(lib):
    from sherpa_vietnamese_asr_tpu.utils import native as jnative

    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import resample_poly

    sr_in, sr_out = 44100, 16000
    x = np.sin(2 * np.pi * 440 * np.arange(sr_in) / sr_in).astype(np.float32)
    got = native.resample_native(x, sr_in, sr_out)
    np.testing.assert_array_equal(got, jnative.resample_native(x, sr_in, sr_out))
    assert abs(len(got) - sr_out) <= 2
    ref = resample_poly(x, sr_in, sr_out)
    n = min(len(got), len(ref))
    assert np.abs(got[200: n - 200] - ref[200: n - 200]).max() < 5e-3


@pytest.mark.parametrize("rate,channels", [(16000, 1), (32000, 1), (44100, 2)])
def test_load_audio_equals_jax(lib, tmp_path, rate, channels):
    from sherpa_vietnamese_asr_tpu.utils.audio_io import load_audio as jax_load

    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import load_audio, write_wav

    t = np.arange(rate) / rate
    x = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    p = tmp_path / "r.wav"
    write_wav(str(p), np.stack([x] * channels, axis=1) if channels > 1 else x, rate)
    calls = []
    audio = load_audio(str(p), 16000, progress_callback=calls.append)
    assert abs(len(audio) - 16000) <= 2
    np.testing.assert_array_equal(audio, jax_load(str(p), 16000))
    assert calls == ([] if rate == 16000 else ["PHASE:LoadAudio|Resampling|10"])


def test_load_audio_without_the_library(tmp_path, monkeypatch):
    """Without audiokit the pure-numpy reader and resampler serve."""
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import (
        load_audio,
        read_wav,
        resample_poly,
        write_wav,
    )

    monkeypatch.setattr(native, "get_audiokit", lambda: None)
    x = (0.3 * np.sin(2 * np.pi * 300 * np.arange(32000) / 32000)).astype(np.float32)
    p = tmp_path / "r.wav"
    write_wav(str(p), x, 32000)
    ref, _ = read_wav(str(p))
    want = resample_poly(ref[:, 0], 32000, 16000)
    np.testing.assert_array_equal(load_audio(str(p), 16000), want / np.abs(want).max() * 0.95)
