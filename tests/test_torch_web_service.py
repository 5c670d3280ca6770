# The port's serving surface (web_service/, pipeline/warmup.py, the CLI's
# serve/warmup/calibrate) on the CPU:
#   (a) the JAX server and the port's server, each with the same tiny ASR
#       weights (through convert), run upload -> process -> result through
#       the real queue and TranscriberPipeline; the stored result JSONs have
#       equal words, segments and timing keys;
#   (b) /ws/stream gives the JAX server's text over the same weights;
#   (c) the reference's auth/admin, queue pause/resume/cancel, queue-position
#       and other endpoint flows (tests/test_web_service*.py, run as they are
#       against the port's server over their own stub pipelines);
#   (d) /api/version and /api/calibration/status name the port's backend;
#   (e) warmup_programs returns the JAX stage keys, stage-isolated;
#   (f) the CLI's serve, warmup and calibrate.
# Word times are compared within 1e-6 s and probabilities within 1e-4, as in
# tests/test_torch_slice.py (the joiner sharpened x 8 in both packages).
import base64
import dataclasses
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import tests.test_web_service as jws
import tests.test_web_service_extended as jwsx
from tests.test_torch_slice import _convert

torch.set_num_threads(2)
SR = 16000


def _jax_model():
    from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model

    jm = random_asr_model(vocab_size=80, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    return jm


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _convert(jm, beam_size=4)


def _serve(make_server, data_dir, **kw):
    server, state = make_server(data_dir=data_dir, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}", state


@pytest.fixture(scope="module")
def both(models, tmp_path_factory):
    """{"jax": (base, state), "port": (base, state)}: each package's server
    with its real queue and pipeline over the same tiny weights."""
    from sherpa_vietnamese_asr_tpu.web_service.server import make_server as jax_make
    from sherpa_vietnamese_asr_tpu_torch.web_service.server import make_server

    jm, tm = models
    sj, bj, stj = _serve(jax_make, str(tmp_path_factory.mktemp("web_jax")),
                         model_provider=lambda name: jm)
    sp, bp, stp = _serve(make_server, str(tmp_path_factory.mktemp("web_port")),
                         model_provider=lambda name: tm, device="cpu")
    yield {"jax": (bj, stj), "port": (bp, stp)}
    for server, state in ((sj, stj), (sp, stp)):
        server.shutdown()
        state.shutdown()


_req = jws._req


def _speechlike(seconds):
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(0)
    x = (0.3 * np.sin(2 * np.pi * 280 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    x[int(6 * SR): int(7.5 * SR)] = 0.0
    return x


def _wav_bytes(x, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / "upload.wav")
    write_wav(path, x, SR)
    with open(path, "rb") as f:
        return f.read()


def _transcribe(base, state, wav, config):
    _, s = _req(base, "/api/session", "POST")
    h = {"X-Session-Id": s["session_id"]}
    status, up = _req(base, "/api/upload", "POST", headers={**h, "X-Filename": "a.wav"},
                      raw=wav)
    assert status == 200, up
    fid = up["file_id"]
    status, _ = _req(base, f"/api/process/{fid}", "POST", body=config, headers=h)
    assert status == 200
    for _ in range(1200):
        _, st = _req(base, f"/api/files/{fid}/status", headers=h)
        if st["status"] in ("completed", "error"):
            break
        time.sleep(0.05)
    assert st["status"] == "completed", st
    status, res = _req(base, f"/api/files/{fid}/result", headers=h)
    assert status == 200
    return json.loads(state.db.get_file(fid)["asr_result_json"]), res["result"]


# The request's config: no diarization, the punctuation slider at 1 (the
# restorer bypassed), no VAD (the tiny model's VAD is tested elsewhere).
PROCESS_CONFIG = {"speaker_diarization": False, "punctuation_confidence": 1,
                  "bypass_vad": True, "max_batch": 2}


def _words(data):
    return [w for s in data["segments"] if s["type"] == "text" for w in s.get("raw_words", [])]


def test_upload_process_result_equals_jax(both, tmp_path):
    wav = _wav_bytes(_speechlike(40.0), tmp_path)
    ref, ref_api = _transcribe(*both["jax"], wav, PROCESS_CONFIG)
    got, got_api = _transcribe(*both["port"], wav, PROCESS_CONFIG)
    assert got["text"] == ref["text"] and got["text"]
    assert set(got) == set(ref)
    assert set(got["timing"]) == set(ref["timing"])
    assert got["duration_sec"] == ref["duration_sec"]
    assert len(got["segments"]) == len(ref["segments"]) > 1
    for g, r in zip(got["segments"], ref["segments"]):
        assert set(g) == set(r)
        assert g["type"] == r["type"] and g["text"] == r["text"]
        assert abs(g["start_time"] - r["start_time"]) < 1e-6, (g, r)
    gw, rw = _words(got), _words(ref)
    assert [w["text"] for w in gw] == [w["text"] for w in rw] and gw
    for g, r in zip(gw, rw):  # times rounded to 1 ms by serialize_segments
        assert set(g) == set(r)
        assert abs(g["start"] - r["start"]) <= 1.001e-3 and abs(g["end"] - r["end"]) <= 1.001e-3
    assert got["asr_confidence"] == pytest.approx(ref["asr_confidence"], abs=1e-4)
    assert got_api["text"] == ref_api["text"]


def _ws_stream(base, pcm, piece):
    """A /ws/stream client: PCM16 in `piece`-sample binary frames, then a
    close. Returns (partials, final)."""
    host, port = base.replace("http://", "").split(":")
    sock = socket.create_connection((host, int(port)), timeout=120)
    key = base64.b64encode(b"0123456789abcdef").decode()
    sock.sendall((f"GET /ws/stream HTTP/1.1\r\nHost: {host}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(1)
    assert b"101" in buf.split(b"\r\n", 1)[0]

    def frame(payload, opcode):
        mask = b"\x01\x02\x03\x04"
        n = len(payload)
        head = bytes([0x80 | opcode])
        head += bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n)
        return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))

    def read():
        head = b""
        while len(head) < 2:
            head += sock.recv(2 - len(head))
        ln = head[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", sock.recv(2))[0]
        data = b""
        while len(data) < ln:
            data += sock.recv(ln - len(data))
        return json.loads(data)

    assert read()["type"] == "ready"
    partials = []
    for off in range(0, len(pcm), piece):
        sock.sendall(frame(pcm[off: off + piece].tobytes(), 0x2))
    sock.sendall(frame(b"", 0x8))
    while True:
        m = read()
        if m["type"] == "partial":
            partials.append(m["text"])
        if m["type"] == "final":
            sock.close()
            return partials, m["text"]


def test_ws_stream_text_equals_jax(both, models):
    from sherpa_vietnamese_asr_tpu.pipeline.streaming_online import (
        MultiStreamRecognizer as JaxMulti,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import MultiStreamRecognizer

    jm, tm = models
    both["jax"][1]._streamer = JaxMulti(jm, n_streams=2, chunk_frames=32, left_frames=64)
    both["port"][1]._streamer = MultiStreamRecognizer(tm, n_streams=2, chunk_frames=32,
                                                      left_frames=64)
    x = _speechlike(4.0)
    pcm = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    ref = _ws_stream(both["jax"][0], pcm, 1600)
    got = _ws_stream(both["port"][0], pcm, 1600)
    assert got[1] == ref[1] and got[1]
    assert got[0] == ref[0] and got[0]  # a partial after each decoded chunk


def test_version_and_calibration_status_name_the_port(both):
    base, state = both["port"]
    _, v = _req(base, "/api/version")
    assert v["backend"] == "torch-cpu"
    import sherpa_vietnamese_asr_tpu_torch as pkg

    assert v["version"] == pkg.__version__
    _, st = _req(base, "/api/calibration/status")
    assert st["backend"] == "torch-cpu" and st["devices"] == ["cpu"]
    _, ref = _req(both["jax"][0], "/api/calibration/status")
    assert set(st) == set(ref)
    _, sm = _req(base, "/api/summarizer/status")
    assert sm["backend"] in ("extractive", "ollama", "local")


def test_server_defaults_to_the_card(tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.web_service.server import make_server

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(data_dir=str(tmp_path))


# -- the reference's endpoint flows, run against the port's server ---------

def _stub_service(module, tmp_path_factory):
    from sherpa_vietnamese_asr_tpu_torch.web_service.server import make_server

    server, base, state = _serve(make_server, str(tmp_path_factory.mktemp("web_stub")),
                                 model_provider=lambda name: None,
                                 pipeline_factory=module.StubPipeline, device="cpu")
    return server, (base, state)


@pytest.fixture(scope="module")
def port_service(tmp_path_factory):
    server, service = _stub_service(jws, tmp_path_factory)
    yield service
    server.shutdown()
    service[1].shutdown()


@pytest.fixture(scope="module")
def port_service_ext(tmp_path_factory):
    server, service = _stub_service(jwsx, tmp_path_factory)
    yield service
    server.shutdown()
    service[1].shutdown()


@pytest.mark.parametrize("flow", [
    "test_full_upload_process_flow", "test_auth_and_admin_flow",
    "test_queue_pause_resume_and_cancel", "test_queue_position_pushed_to_second_client"])
def test_reference_flows_on_the_port(port_service, flow):
    getattr(jws, flow)(port_service)


@pytest.mark.parametrize("flow", [
    "test_index_and_login_pages", "test_session_status",
    "test_upload_json_sanitizes_and_downloads", "test_file_audio_serving",
    "test_queue_position_endpoint", "test_save_result_requires_auth_and_syncs_meeting",
    "test_upload_validation", "test_admin_config_endpoints", "test_admin_user_management",
    "test_localhost_gui_admin_api", "test_admin_session_endpoints",
    "test_calibration_endpoints", "test_defaults_are_config_driven",
    "test_session_reuse_and_max_sessions_eviction", "test_ws_session_validation_and_messages"])
def test_reference_extended_flows_on_the_port(port_service_ext, flow):
    getattr(jwsx, flow)(port_service_ext)


def test_queue_cancels_a_waiting_job(port_service):
    base, state = port_service
    _, s = _req(base, "/api/session", "POST")
    h = {"X-Session-Id": s["session_id"]}
    state.queue.pause()
    try:
        fid = jwsx._upload_wav(base, h)
        status, pr = _req(base, f"/api/process/{fid}", "POST", body={}, headers=h)
        assert status == 200 and pr["queue_position"] == 1
        assert state.queue.cancel(fid)
        assert state.db.get_file(fid)["status"] == "cancelled"
    finally:
        state.queue.resume()


# -- warmup, calibration, CLI ------------------------------------------------

def test_warmup_stage_keys_equal_jax(models):
    from sherpa_vietnamese_asr_tpu.pipeline import warmup as jwarm
    from sherpa_vietnamese_asr_tpu_torch.pipeline import warmup

    _, tm = models
    assert warmup.STAGES == jwarm.STAGES
    for jobs, stages in ((1, ("decode", "vad", "streaming", "quality")),
                         (2, ("streaming", "quality"))):
        logs = []
        timings = warmup.warmup_programs(tm, stages=stages, log=logs.append, jobs=jobs)
        assert set(timings) == set(stages), logs
        assert all(v is not None and v > 0 for v in timings.values()), logs
    # A failing stage is isolated to None and the others run.
    bad = dataclasses.replace(tm, beam_size=0)
    timings = warmup.warmup_programs(bad, stages=("decode", "streaming"), log=lambda m: None)
    assert timings["decode"] is None and timings["streaming"] is not None


@pytest.mark.slow
def test_warmup_every_stage_on_the_cpu(models, tmp_path):
    from sherpa_vietnamese_asr_tpu.pipeline import warmup as jwarm
    from sherpa_vietnamese_asr_tpu_torch.pipeline import warmup

    logs = []
    timings = warmup.warmup_programs(models[1], log=logs.append)
    assert list(timings) == list(jwarm.STAGES)
    assert all(v is not None for v in timings.values()), logs


def test_device_calibration_layout_equals_jax(monkeypatch):
    """On a CPU-only host both reports hold the "cpu" backend alone; with a
    second backend (here the CPU again under the name "cuda") the port's
    stages carry the JAX report's diff, speedup and accepted keys."""
    from sherpa_vietnamese_asr_tpu.pipeline import calibration as jcal
    from sherpa_vietnamese_asr_tpu_torch.pipeline import calibration as cal

    rng = np.random.default_rng(0)
    names = [n for n, _ in jcal._stage_specs(rng)]
    assert [n for n, _ in cal._stage_specs(rng)] == names
    assert cal.STAGE_TOLERANCES == jcal.STAGE_TOLERANCES
    assert cal.SPEEDUP_MIN == jcal.SPEEDUP_MIN
    # The JAX report of its fbank stage only (its encoder stage compiles the
    # 30M model on the CPU for minutes).
    fbank_only = [s for s in jcal._stage_specs(rng) if s[0] == "fbank"]
    monkeypatch.setattr(jcal, "_stage_specs", lambda r: fbank_only)
    ref = jcal.run_device_calibration()
    got = cal.run_device_calibration()
    assert set(got) == set(ref) == {"devices", "speedup_min", "stages"}
    assert list(got["devices"]) == list(ref["devices"]) == ["cpu"]
    assert list(got["stages"]) == names
    for name, entry in got["stages"].items():
        assert set(entry) == {"cpu"} and set(entry["cpu"]) == {"time_sec"}, entry
    assert set(ref["stages"]["fbank"]) == {"cpu"}

    monkeypatch.setattr(cal, "calibration_devices",
                        lambda: {"cpu": torch.device("cpu"), "cuda": torch.device("cpu")})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    two = cal.run_device_calibration()
    for name, entry in two["stages"].items():
        assert set(entry) == {"cpu", "cuda", "diff", "speedup", "accepted"}, entry
        assert entry["diff"]["max_abs"] == 0.0  # the same device twice
    assert isinstance(two["accelerated_stages"], list)


def test_autotune_and_compare_equal_jax(models):
    from sherpa_vietnamese_asr_tpu.pipeline import calibration as jcal
    from sherpa_vietnamese_asr_tpu_torch.pipeline import calibration as cal

    _, tm = models
    out = cal.autotune_max_batch(model=tm, candidates=(-1, 1, 2), chunk_sec=1.0)
    by = {a["batch"]: a for a in out["attempts"]}
    assert by[-1]["ok"] is False and "error" in by[-1]
    ok = [a for a in out["attempts"] if a["ok"]]
    assert [a["batch"] for a in ok] == [1, 2]
    assert out["best_batch"] == min(ok, key=lambda a: a["sec_per_item"])["batch"]
    assert out["hbm_free_mb"] is None  # the CPU
    cpu = {"elapsed_sec": 10.0, "duration_sec": 60.0, "text_chars": 1000,
           "speaker_count": 2, "speaker_turns": 9, "asr_confidence": 0.51,
           "timing": {"transcription": 8.0, "diarization": 2.0}}
    for acc in ({**cpu, "elapsed_sec": 2.0, "text_chars": 1005},
                {**cpu, "elapsed_sec": 2.0, "text_chars": 1100},
                {**cpu, "asr_confidence": 0.512, "speaker_count": 3}):
        for tol in (1e-4, 5e-3):
            assert cal.compare_pipeline_runs(cpu, acc, tol) == \
                jcal.compare_pipeline_runs(cpu, acc, tol)


def test_full_pipeline_calibration_on_the_cpu(tmp_path, monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import calibration as cal

    wav = cal.make_calibration_wav(str(tmp_path / "cal.wav"), minutes=0.2)
    rep = cal.run_full_pipeline_calibration(
        wav_path=wav, model_spec={"tiny": True, "vocab_size": 80, "seed": 0},
        config={"speaker_diarization": False, "restore_punctuation": False,
                "quality_analysis": False, "bypass_vad": True, "max_batch": 1},
        device="cpu")
    assert set(rep) == {"cpu_run", "accel_run", "compare"}
    for run in (rep["cpu_run"], rep["accel_run"]):
        assert run["duration_sec"] == 12.0 and run["text_chars"] > 0
        assert run["backend"] == "cpu"
    assert rep["compare"]["text_chars_delta"] == 0
    assert rep["compare"]["parity_ok"] is True


@pytest.fixture
def tiny_dir(models, tmp_path, monkeypatch):
    """The tiny model written by the port's exporter, loadable as the 30M
    configuration (tests/test_torch_onnx_import.tiny_registry)."""
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from tests.test_torch_onnx_import import tiny_registry

    jm, tm = models
    d = tmp_path / "tiny-model"
    export_asr_dir(tm, str(d))
    tiny_registry(monkeypatch, jm)
    return str(d)


def test_cli_serve_warmup_calibrate(tiny_dir, tmp_path, capsys):
    from sherpa_vietnamese_asr_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--help"])
    assert e.value.code == 0
    assert "--warmup" in capsys.readouterr().out
    assert cli.main(["warmup", "--model", tiny_dir, "--device", "cpu",
                     "--stages", "decode,streaming"]) == 0
    assert "2/2 stages ran (decode, streaming)" in capsys.readouterr().out
    out = str(tmp_path / "report.json")
    assert cli.main(["calibrate", "--device", "cpu", "--output", out, "--autotune",
                     "--candidates", "1"]) == 0
    with open(out) as f:
        report = json.load(f)
    assert list(report["stages"]) == ["fbank", "encoder", "dnsmos"]
    assert report["recommended"]["max_batch"] == report["batch_autotune"]["best_batch"] == 1


@pytest.mark.parametrize("argv", [["warmup", "--allow-random"], ["calibrate"],
                                  ["serve", "--http", "--port", "0"]])
def test_cli_defaults_to_the_card(argv, tmp_path, monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "calibration_report.json")
