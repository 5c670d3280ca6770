# The port against the frozen true-size fixture tests/data/golden_aux.json,
# on the CPU (slow tier, like the JAX package's tests/test_golden_aux.py):
# each test draws the weights from the JAX init with the fixture's seed,
# checks their sum against the frozen one, converts them with
# models/convert.py, runs the port's module and meets the JAX tests' own
# tolerances:
#   pyannet (seed 21): the argmax and |out| summed within 1e-3 relative;
#   resnet (seed 22): frame features summed within 1e-3 relative, the
#     embedding within 1e-3;
#   vibert (seed 23): both argmaxes and |labels| summed within 1e-3 relative;
#   dnsmos (seed 24): the raw scores within 1e-3;
#   diarization_composition: the port's PureDiarizer, from the JAX
#     diarizer's host-side random weights, gives the frozen segments within
#     0.05 s.
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_golden_aux import _diarization_audio, _tree_abs_sum

torch.set_num_threads(4)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "golden_aux.json")


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(init, seed, cfg, want):
    p = init(jax.random.PRNGKey(seed), cfg)
    assert abs(_tree_abs_sum(p) - want) < 1e-4 * abs(want), \
        "PRNG-derived weights changed"
    return _np(p)


@pytest.mark.slow
def test_frozen_pyannet(fx):
    from sherpa_vietnamese_asr_tpu.models.pyannet import PyanNetConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.pyannet import init_pyannet_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import CHUNK_SAMPLES, PyanNetConfig

    d = fx["pyannet"]
    p = _weights(init_pyannet_params, d["seed"], JaxCfg(), d["weights_abs_sum"])
    model = convert.pyannet_from_numpy(convert.pyannet_state_dict(p), PyanNetConfig(),
                                       device="cpu")
    audio = _diarization_audio(10)[None, :CHUNK_SAMPLES]
    with torch.no_grad():
        out = model(torch.from_numpy(audio)).numpy()
    assert np.argmax(out[0], axis=-1).tolist() == d["argmax"]
    assert abs(float(np.abs(out).sum()) - d["abs_sum"]) < 1e-3 * abs(d["abs_sum"])


@pytest.mark.slow
def test_frozen_resnet_embedding(fx):
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import (
        ResNetSpeakerConfig as JaxCfg,
    )
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import init_resnet_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeakerConfig
    from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool

    d = fx["resnet"]
    p = _weights(init_resnet_params, d["seed"], JaxCfg(), d["weights_abs_sum"])
    model = convert.resnet_from_numpy(convert.resnet_state_dict(p), ResNetSpeakerConfig(),
                                      device="cpu")
    feats = np.random.default_rng(d["seed"]).standard_normal((1, 200, 80)).astype(np.float32)
    with torch.no_grad():
        frame_feat = model.resnet_frame_features(torch.from_numpy(feats))
        assert abs(float(frame_feat.abs().sum()) - d["frame_abs_sum"]) \
            < 1e-3 * abs(d["frame_abs_sum"])
        weights = torch.ones(1, 1, frame_feat.shape[-1])
        emb = model.project_embedding(masked_stats_pool(frame_feat, weights)).numpy()[0, 0]
    np.testing.assert_allclose(emb, np.asarray(d["embedding"]), atol=1e-3)


@pytest.mark.slow
def test_frozen_vibert(fx):
    from sherpa_vietnamese_asr_tpu.models.vibert import ViBertConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.vibert import init_vibert_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBertConfig

    d = fx["vibert"]
    p = _weights(init_vibert_params, d["seed"], JaxCfg(), d["weights_abs_sum"])
    cfg = ViBertConfig()
    model = convert.vibert_from_numpy(convert.vibert_state_dict(p), cfg, device="cpu")
    vrng = np.random.default_rng(d["seed"])
    b, t, w = 2, 64, 16
    ids = vrng.integers(0, cfg.vocab_size, (b, t)).astype(np.int64)
    mask = np.ones((b, t), np.int64)
    mask[1, 48:] = 0
    offs = np.sort(vrng.integers(0, 48, (b, w)), axis=1).astype(np.int64)
    with torch.no_grad():
        r1, r2 = model(*(torch.from_numpy(a) for a in (ids, mask, np.zeros_like(ids), offs)))
    assert r1.argmax(-1).tolist() == d["labels_argmax"]
    assert r2.argmax(-1).tolist() == d["d_tags_argmax"]
    got = float(r1.abs().sum())
    assert abs(got - d["labels_abs_sum"]) < 1e-3 * abs(d["labels_abs_sum"])


@pytest.mark.slow
def test_frozen_dnsmos(fx):
    from sherpa_vietnamese_asr_tpu.models.dnsmos import DnsmosConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.dnsmos import init_dnsmos_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import INPUT_SAMPLES, DnsmosConfig

    d = fx["dnsmos"]
    p = _weights(init_dnsmos_params, d["seed"], JaxCfg(), d["weights_abs_sum"])
    model = convert.dnsmos_from_numpy(convert.dnsmos_state_dict(p), DnsmosConfig(),
                                      device="cpu")
    audio = _diarization_audio(10)[None, :INPUT_SAMPLES]
    with torch.no_grad():
        out = model(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(out[0], np.asarray(d["scores"]), atol=1e-3)


@pytest.mark.slow
def test_frozen_diarization_composition(fx):
    """The port's PureDiarizer (fused superblocks + clustering) on the JAX
    diarizer's default random weights (utils/host_init.host_random_like,
    seeds 0 and 1) gives the frozen segments."""
    from sherpa_vietnamese_asr_tpu.models.pyannet import PyanNetConfig as JaxSegCfg
    from sherpa_vietnamese_asr_tpu.models.pyannet import init_pyannet_params
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import (
        ResNetSpeakerConfig as JaxEmbCfg,
    )
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import init_resnet_params
    from sherpa_vietnamese_asr_tpu.utils.host_init import host_random_like

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeakerConfig
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    d = fx["diarization_composition"]
    audio = _diarization_audio(d["audio_seconds"])
    assert abs(float(np.abs(audio).sum()) - d["audio_abs_sum"]) < 1e-3 * abs(d["audio_abs_sum"])
    seg = convert.pyannet_from_numpy(
        convert.pyannet_state_dict(_np(host_random_like(init_pyannet_params, 0, JaxSegCfg()))),
        PyanNetConfig(), device="cpu")
    emb = convert.resnet_from_numpy(
        convert.resnet_state_dict(_np(host_random_like(init_resnet_params, 1, JaxEmbCfg()))),
        ResNetSpeakerConfig(), device="cpu")
    segs = PureDiarizer(seg_model=seg, emb_model=emb, device="cpu").process(audio)
    frozen = d["segments"]
    assert len(segs) == len(frozen)
    for got, want in zip(segs, frozen):
        assert got["speaker"] == want["speaker"]
        assert abs(float(got["start"]) - want["start"]) < 0.05
        assert abs(float(got["end"]) - want["end"]) < 0.05

