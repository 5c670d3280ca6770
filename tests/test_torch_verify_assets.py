# The port's asset rehearsal (models/verify_assets.py) against the JAX
# package's, on the CPU. One tiny stand-in of every asset is written under
# its MANIFEST directory and names (tools/rehearsal_assets.write_assets: the
# ASR asset as an executable export of a JAX model converted with
# models/convert.py, the others from the port's writers) and both packages'
# MANIFESTs are re-pinned to the files' own SHA-256, as
# tests/test_verify_assets.py does for the JAX package. Then:
#   * verify_asset(key, device="cpu") gives the check names, order, ok
#     values and statuses of the JAX verify_asset(key), asset by asset;
#   * where the JAX verifier crashes (segmentation feeds PyanNet a [1, 1, L]
#     waveform, DNSMOS a 1-D one) the port's rows begin with the JAX rows
#     before the crash and the asset passes;
#   * JAX tests/test_verify_assets.py's cases on the port: the gates, the
#     exec cross-check, the weight-only skip, an absent asset, a hash
#     mismatch, the report's layout;
#   * a crashing verifier is a failed row and a failed run; without a card
#     the default device raises.
import dataclasses

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.models import assets as jassets
from sherpa_vietnamese_asr_tpu.models import verify_assets as jva

from sherpa_vietnamese_asr_tpu_torch.models import assets
from sherpa_vietnamese_asr_tpu_torch.models import verify_assets as va
from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import GraphBuilder

torch.set_num_threads(2)

ASR_KEYS = ("zipformer-30m", "zipformer-30m-streaming")
SAME = ASR_KEYS + ("vibert-capu", "embedding-split", "plda", "campp", "silero-vad",
                   "convtasnet")
JAX_CRASHES = ("segmentation", "dnsmos")


def _stand_ins():
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import TINY_CAMPP, random_campp
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import (
        TINY_CONVTASNET,
        random_convtasnet,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import random_dnsmos
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig, random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
        TINY_RESNET,
        random_resnet_speaker,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import random_silero_vad
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import TINY_VIBERT, random_vibert
    from sherpa_vietnamese_asr_tpu_torch.tools.rehearsal_assets import random_plda

    seg_cfg = PyanNetConfig(sinc_filters=16, conv_channels=12, lstm_hidden=8,
                            lstm_layers=2, linear_dim=8)
    return {
        "vibert-capu": (random_vibert(TINY_VIBERT, device="cpu"),
                        [f"w{i}" for i in range(TINY_VIBERT.vocab_size)]),
        "segmentation": random_pyannet(seg_cfg, device="cpu"),
        "embedding-split": random_resnet_speaker(TINY_RESNET, device="cpu"),
        "plda": random_plda(TINY_RESNET.embed_dim, 16),
        "campp": random_campp(TINY_CAMPP, device="cpu"),
        "silero-vad": random_silero_vad(device="cpu"),
        "convtasnet": random_convtasnet(TINY_CONVTASNET, device="cpu"),
        "dnsmos": random_dnsmos(device="cpu"),
    }


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """Every asset's tiny stand-in under one models dir; both packages see
    it through SVT_MODELS_DIR and their re-pinned MANIFESTs, and both
    registries load the tiny ASR directories as their 30M configuration."""
    from tests.test_torch_onnx_import import _jax_tiny, tiny_registry
    from tests.test_torch_slice import _convert

    from sherpa_vietnamese_asr_tpu_torch.tools.rehearsal_assets import write_assets

    jm = _jax_tiny(seed=5, vocab=40)
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    tm = _convert(jm, beam_size=4)
    root = tmp_path_factory.mktemp("models")
    manifest = write_assets(str(root), {key: tm for key in ASR_KEYS} | _stand_ins())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_MODELS_DIR", str(root))
        for mod in (assets, jassets):
            mp.setattr(mod, "MANIFEST", manifest)
            mp.setattr(mod, "_cache", {})
        tiny_registry(mp, jm)
        yield root


def _rows(report):
    return [(c["check"], c["ok"]) for c in report["checks"]]


@pytest.mark.parametrize("key", SAME)
def test_verify_asset_equals_jax(rehearsal, key):
    got = va.verify_asset(key, device="cpu")
    want = jva.verify_asset(key)
    assert _rows(got) == _rows(want), (va.format_report({"assets": {key: got}, "ok": False}),
                                       jva.format_report({"assets": {key: want}, "ok": False}))
    assert got["status"] == want["status"] != "failed"
    skips = [c["detail"] for c in got["checks"] if c["ok"] is None]
    assert skips == [c["detail"] for c in want["checks"] if c["ok"] is None]


def test_asr_rehearsal_runs_every_check(rehearsal):
    """The executable ASR export: every exec cross-check and the token
    identity ran and passed (status verified, as in the JAX test)."""
    rep = va.verify_asset("zipformer-30m", device="cpu")
    assert rep["status"] == "verified"
    by = {c["check"]: c for c in rep["checks"]}
    for name in ("import", "forward.encoder", "forward.decoder", "forward.joiner",
                 "encoder.exec[0]", "decoder.exec[0]", "joiner.exec[0]", "tokens.decode"):
        assert by[name]["ok"] is True, by[name]


@pytest.mark.parametrize("key", JAX_CRASHES)
def test_port_passes_where_the_jax_verifier_crashes(rehearsal, key):
    got = va.verify_asset(key, device="cpu")
    want = jva.verify_asset(key)
    assert want["status"] == "failed" and want["checks"][-1]["check"] == "verifier"
    before_crash = _rows(want)[:-1]
    assert _rows(got)[: len(before_crash)] == before_crash
    assert got["status"] == ("verified" if key == "dnsmos" else "partial")
    assert all(c["ok"] is not False for c in got["checks"])


def test_verify_assets_report_and_overall(rehearsal):
    rep = va.verify_assets(["zipformer-30m", "dnsmos", "zipformer-68m"], device="cpu")
    assert rep["ok"] is True
    assert [r["status"] for r in rep["assets"].values()] == ["verified", "verified", "absent"]
    text = va.format_report(rep)
    assert "zipformer-30m: VERIFIED" in text and "zipformer-68m: ABSENT" in text
    assert text.endswith("overall: OK")


def test_crashing_verifier_fails_the_asset_and_the_run(rehearsal, monkeypatch):
    def broken(key, dev):
        raise RuntimeError("svt_attention_weights: CUDA error 209 (no kernel image)")

    monkeypatch.setitem(va._VERIFIERS, "plda", broken)
    rep = va.verify_assets(["plda"], device="cpu")
    assert rep["ok"] is False
    row = rep["assets"]["plda"]["checks"][-1]
    assert rep["assets"]["plda"]["status"] == "failed"
    assert row["check"] == "verifier" and row["ok"] is False and "CUDA error" in row["detail"]


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        va.verify_assets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        va.verify_asset("dnsmos")


# ---------------------------------------------------------------------------
# tests/test_verify_assets.py's cases on the port
# ---------------------------------------------------------------------------

def test_cmp_gates():
    a = np.ones((3, 4), np.float32)
    assert va._cmp("x", a, a + 1e-5)["ok"] is True
    assert va._cmp("x", a, a + 1.0)["ok"] is False
    shp = va._cmp("x", a, np.ones((4, 3)))
    assert shp["ok"] is False and "shape" in shp["detail"]
    # each gate alone fails a comparison
    ref = np.ones(10_000)
    assert va._cmp("x", ref + 2 * va.REL_L2, ref)["ok"] is False       # rel_l2
    spike = ref.copy()
    spike[0] += 2 * va.MAX_ABS
    assert va._cmp("x", spike, ref)["ok"] is False                    # max_abs


def test_exec_checks_executable_graph(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = GraphBuilder()
    x = b.input("x")
    b.output(b.node("Relu", [b.node("MatMul", [x, b.init("w", w)])]))
    p = tmp_path / "m.onnx"
    p.write_bytes(b.build())
    xs = rng.standard_normal((2, 6)).astype(np.float32)
    ref = np.maximum(xs @ w, 0.0)
    rows, outs = va._exec_checks("m", str(p), [xs], [ref])
    assert rows[0]["ok"] is True and outs is not None
    rows_bad, _ = va._exec_checks("m", str(p), [xs], [ref + 0.5])
    assert rows_bad[0]["ok"] is False
    rows_err, _ = va._exec_checks("m", str(p), [xs[:, :5]], [ref])
    assert rows_err[0]["ok"] is False and "EXEC-ERROR" in rows_err[0]["detail"]


def test_exec_checks_weight_only_graph_skips(tmp_path):
    b = GraphBuilder()
    b.init("w", np.zeros((2, 2), np.float32))
    p = tmp_path / "w.onnx"
    p.write_bytes(b.build())
    rows, outs = va._exec_checks("m", str(p), [], [])
    assert rows[0]["ok"] is None and "weight-only" in rows[0]["detail"]
    assert outs is None


def test_absent_asset_status(monkeypatch, tmp_path):
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    rep = va.verify_asset("dnsmos", device="cpu")
    assert rep["status"] == "absent"
    assert any(c["detail"] == "missing" for c in rep["checks"])


def test_hash_mismatch_fails(monkeypatch, tmp_path):
    spec = assets.MANIFEST["dnsmos"]
    d = tmp_path / spec["local_dir"]
    d.mkdir()
    (d / "sig_bak_ovr.onnx").write_bytes(b"corrupt")
    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    rows, present = va._hash_checks("dnsmos")
    assert present is True
    assert rows[0]["ok"] is False and "got " in rows[0]["detail"]
    rep = va.verify_assets(["dnsmos"], device="cpu")
    assert rep["ok"] is False and rep["assets"]["dnsmos"]["status"] == "failed"


def test_with_pos_dtype_keeps_the_weights():
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        TINY_ZIPFORMER,
        random_asr_model,
        with_pos_dtype,
    )

    m = random_asr_model(vocab_size=30, zip_cfg=TINY_ZIPFORMER, device="cpu")
    assert m.zip_cfg.pos_dtype == "bfloat16"
    s = with_pos_dtype(m, "float32")
    assert s.zip_cfg == dataclasses.replace(m.zip_cfg, pos_dtype="float32")
    assert all(layer.cfg.pos_dtype == "float32"
               for stack in s.encoder.stacks for layer in stack.layers)
    for k, v in m.encoder.state_dict().items():
        assert torch.equal(s.encoder.state_dict()[k], v)
    assert s.decoder is m.decoder and s.joiner is m.joiner
