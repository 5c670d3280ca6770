# The port's DNSMOS quality stage against the JAX package's, on the CPU:
#   (a) Dnsmos at the full config on the same weights
#       (models/convert.dnsmos_state_dict): raw scores within 1e-4, and a
#       periodic Hann window (the planted fault of chip_smoke.py) beyond it;
#   (b) QualityAnalyzer.analyze_speech and compute_dnsmos_average equal to
#       the JAX analyzer's;
#   (c) load_dnsmos on a graph of onnx_export_aux.build_dnsmos_graph, on a
#       TF-named structural export and on the port's writer, every tensor
#       equal, and the JAX loader on the port's file;
#   (d) the JAX package's tests/test_quality.py cases, and mesh "auto" is
#       None here.
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def jax_dnsmos(seed, cfg=None):
    from sherpa_vietnamese_asr_tpu.models.dnsmos import DnsmosConfig, init_dnsmos_params

    return init_dnsmos_params(jax.random.PRNGKey(seed), cfg or DnsmosConfig())


def port_dnsmos(params, cfg=None):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import (
        dnsmos_from_numpy,
        dnsmos_state_dict,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import DnsmosConfig

    cfg = DnsmosConfig() if cfg is None else DnsmosConfig(**dataclasses.asdict(cfg))
    return dnsmos_from_numpy(dnsmos_state_dict(jax.tree.map(np.asarray, params)), cfg,
                             device="cpu")


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.2 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    from sherpa_vietnamese_asr_tpu.pipeline.quality import QualityAnalyzer as JaxAnalyzer

    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    params = jax_dnsmos(24)
    return (JaxAnalyzer(params=params, mesh=None),
            QualityAnalyzer(model=port_dnsmos(params)))


def test_full_config_raw_scores_match_jax_and_a_periodic_window_does_not(pair):
    from sherpa_vietnamese_asr_tpu.models.dnsmos import DnsmosConfig, dnsmos_forward

    jqa, qa = pair
    x = np.stack([_audio(9.01, s)[:144160] for s in range(3)])
    ref = np.asarray(dnsmos_forward(jqa.params, x, DnsmosConfig()))
    got = qa.raw_scores(list(x))
    assert got.shape == (3, 3) and np.abs(got - ref).max() <= 1e-4
    qa.model.window = torch.hann_window(320, periodic=True)
    try:
        assert np.abs(qa.raw_scores(list(x)) - ref).max() > 1e-4
    finally:
        qa.model.window = torch.hann_window(320, periodic=False, dtype=torch.float64).float()


@pytest.mark.parametrize("seconds", [0.3, 5.0, 40.0])
def test_analyze_speech_and_average_match_jax(pair, seconds):
    jqa, qa = pair
    x = _audio(seconds, 1)
    assert qa.analyze_speech(x) == jqa.analyze_speech(x)
    got, ref = qa.compute_dnsmos_average(x), jqa.compute_dnsmos_average(x)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got, ref)


def _assert_state_equal(state, want):
    assert set(state) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(state[key], value, err_msg=key)


def test_load_dnsmos_reads_the_jax_graph_and_the_port_writer(tmp_path):
    from sherpa_vietnamese_asr_tpu.models import onnx_export_aux as ax
    from sherpa_vietnamese_asr_tpu.models.dnsmos import DnsmosConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_dnsmos as jax_load

    from sherpa_vietnamese_asr_tpu_torch.models.convert import dnsmos_state_dict
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import DnsmosConfig
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import export_dnsmos_file
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_dnsmos

    params = jax.tree.map(np.asarray, jax_dnsmos(5))
    want = dnsmos_state_dict(params)
    graph = tmp_path / "graph.onnx"
    graph.write_bytes(ax.build_dnsmos_graph(params, JaxCfg(), 1))
    path = export_dnsmos_file(port_dnsmos(params), str(tmp_path / "port"))
    for p in (str(graph), path):
        state, cfg = load_dnsmos(p)
        assert cfg == DnsmosConfig()
        _assert_state_equal(state, want)
    jparams, jcfg = jax_load(path)
    assert jcfg == JaxCfg()
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_structural_import_of_a_tf_named_export(tmp_path):
    """The JAX package's test_dnsmos_structural_import file: HWIO kernels
    and [in, out] denses under TF names load into the same tensors."""
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_dnsmos as jax_load
    from sherpa_vietnamese_asr_tpu.models.onnx_synth import GraphBuilder

    from sherpa_vietnamese_asr_tpu_torch.models.convert import dnsmos_state_dict
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_dnsmos

    rng = np.random.default_rng(0)
    b = GraphBuilder()
    cur = b.input("input_1")
    chans, c_in = (8, 8, 16), 1
    for i, c in enumerate(chans):
        w = b.init(f"conv{i}/kernel", rng.standard_normal((3, 3, c_in, c)).astype(np.float32))
        bb = b.init(f"conv{i}/bias", rng.standard_normal((c,)).astype(np.float32))
        cur = b.node("Conv", [cur, w, bb], pads=(1, 1, 1, 1))
        c_in = c
    for name, shape in (("dense", (16, 12)), ("head", (12, 3))):
        w = b.init(f"{name}/kernel", rng.standard_normal(shape).astype(np.float32))
        bb = b.init(f"{name}/bias", rng.standard_normal(shape[1:]).astype(np.float32))
        cur = b.node("Add", [b.node("MatMul", [cur, w]), bb])
    b.output(cur)
    path = tmp_path / "sig_bak_ovr.onnx"
    path.write_bytes(b.build())
    state, cfg = load_dnsmos(str(path))
    assert cfg.channels == chans and cfg.dense == 12
    jparams, _ = jax_load(str(path))
    _assert_state_equal(state, dnsmos_state_dict(jax.tree.map(np.asarray, jparams)))


# ---- the JAX package's tests/test_quality.py, on the port ----

def test_dnsmos_scores_in_range(pair):
    _, qa = pair
    scores = qa.compute_dnsmos((0.1 * np.random.default_rng(0).standard_normal(48000))
                               .astype(np.float32))
    assert scores is not None and all(1.0 <= scores[k] <= 5.0 for k in ("SIG", "BAK", "OVRL"))


def test_analyze_speech_stratified(pair):
    _, qa = pair
    info = qa.analyze_speech((0.1 * np.random.default_rng(0).standard_normal(16000 * 40))
                             .astype(np.float32))
    assert info is not None and set(info) == {"dnsmos_sig", "dnsmos_bak", "dnsmos_ovrl"}
    assert qa.analyze_speech(np.zeros(4000, np.float32)) is None


def test_polynomial_mapping_matches_reference():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    out = QualityAnalyzer._map_scores(np.array([3.0, 2.5, 3.2]))
    p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
    assert abs(out["SIG"] - np.clip(p_sig(3.0), 1, 5)) < 1e-9


def test_random_fallback_is_flagged_and_one_device_only(tmp_path, monkeypatch, capsys):
    from sherpa_vietnamese_asr_tpu_torch.models import assets
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(assets, "_warned", set())
    qa = QualityAnalyzer(device="cpu")
    assert "DNSMOS quality model is running with RANDOM weights" in capsys.readouterr().err
    assert qa.device == torch.device("cpu")
    # mesh "auto" (the default) is default_mesh(): None on a host without
    # several cards.
    assert qa.mesh is None and QualityAnalyzer(model=qa.model, mesh="auto").mesh is None
