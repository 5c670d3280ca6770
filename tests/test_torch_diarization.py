# The port's diarization models and superblock against the JAX package's, on
# the CPU, at tiny sizes (PyanNetConfig(sinc_filters=16, conv_channels=12,
# lstm_hidden=16, lstm_layers=2) and TINY_RESNET), with one full-width case
# per model on a short input. Weights come from the JAX init (norms, biases
# and BatchNorm statistics perturbed so that every mapping is exercised)
# through models/convert; inputs come from numpy with a seed. The tiny
# PyanNet's classifier bias favours the single-speaker classes, so that
# chunks have the clean frames clustering trains on, and the diarizers run
# with an AHC threshold of 0.03, under which the random embeddings split
# into several speakers. Tolerances:
#   masked_stats_pool                     max relative error <= 1e-5 (each
#                                         (chunk, speaker) row's max |error|
#                                         over its max |reference|)
#   PyanNet log-probs                     max abs <= 1e-4, argmax identical
#   ResNet34 frame features + projection  max abs <= 1e-4 * max |ref|
#   fused superblock (float32 and int16)  argmax and valid mask identical,
#                                         embeddings as the ResNet's
#   PureDiarizer.process (fused, classic) identical segments (speakers equal,
#                                         times within 1e-6 s)
# A flipped argmax reports the reference's margin between its two best
# classes at the flipped frames.
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

torch.set_num_threads(2)
SR = 16000
RESNET_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def tiny_seg_cfgs():
    from sherpa_vietnamese_asr_tpu.models.pyannet import PyanNetConfig as JaxCfg

    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig

    kw = dict(sinc_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=2)
    return JaxCfg(**kw), PyanNetConfig(**kw)


# Added to the classifier bias: silence, the three single speakers, pairs.
SPEAKER_BIAS = np.array([0, 2, 2, -2, -2, -2, -2], np.float32)
THRESHOLD = 0.03


def jax_seg_params(cfg, seed=3, speaker_bias=SPEAKER_BIAS):
    """The JAX init, with the norms' affines, conv, LSTM and linear biases
    drawn from numpy so that none of them is an identity or a zero, and
    `speaker_bias` added to the classifier's."""
    from sherpa_vietnamese_asr_tpu.models.pyannet import init_pyannet_params

    p = _np_tree(init_pyannet_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for norm in [p["wav_norm"]] + p["norms"]:
        norm["scale"] = (1.0 + 0.1 * rng.standard_normal(norm["scale"].shape)).astype(np.float32)
        norm["bias"] = (0.1 * rng.standard_normal(norm["bias"].shape)).astype(np.float32)
    leaves = [c for c in p["convs"]] + [p["linear1"], p["linear2"], p["classifier"]]
    leaves += [layer[d] for layer in p["lstm"] for d in ("fwd", "bwd")]
    for leaf in leaves:
        key = "bias" if "bias" in leaf else "b"
        leaf[key] = (0.1 * rng.standard_normal(leaf[key].shape)).astype(np.float32)
    p["classifier"]["bias"] = p["classifier"]["bias"] + speaker_bias
    return p


def jax_emb_params(cfg, seed=1):
    """The JAX init with BatchNorm scale, bias and running statistics and the
    projection's bias drawn from numpy."""
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import init_resnet_params

    p = _np_tree(init_resnet_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def bn(q):
        c = q["scale"].shape
        q["scale"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        q["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        q["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        q["var"] = (0.5 + rng.random(c)).astype(np.float32)

    bn(p["bn1"])
    for blocks in p["stages"]:
        for blk in blocks:
            for k in ("bn1", "bn2", "down_bn"):
                if k in blk:
                    bn(blk[k])
    p["proj"]["bias"] = (0.1 * rng.standard_normal(p["proj"]["bias"].shape)).astype(np.float32)
    return p


def port_models(seg_params, seg_cfg, emb_params, emb_cfg):
    from sherpa_vietnamese_asr_tpu_torch.models import convert

    return (convert.pyannet_from_numpy(convert.pyannet_state_dict(seg_params), seg_cfg,
                                       device="cpu"),
            convert.resnet_from_numpy(convert.resnet_state_dict(emb_params), emb_cfg,
                                      device="cpu"))


@pytest.fixture(scope="module")
def tiny():
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import TINY_RESNET as JAX_TINY

    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import TINY_RESNET

    jseg_cfg, seg_cfg = tiny_seg_cfgs()
    seg_p, emb_p = jax_seg_params(jseg_cfg), jax_emb_params(JAX_TINY)
    seg, emb = port_models(seg_p, seg_cfg, emb_p, TINY_RESNET)
    return {"jseg_cfg": jseg_cfg, "jemb_cfg": JAX_TINY, "seg_p": seg_p, "emb_p": emb_p,
            "seg": seg, "emb": emb}


def diarization_audio(seconds=20, seed=0):
    """Two alternating 'speakers' (3 s tones at 200 and 340 Hz with
    different AM rates, 1 s gaps) and noise at 0.01, rounded to int16 steps
    so that the int16 transfer of the fused path is lossless."""
    t = np.arange(SR * seconds) / SR
    x = np.zeros(SR * seconds, np.float32)
    for k in range(seconds // 4):
        f0, am = (200.0, 2.0) if k % 2 == 0 else (340.0, 3.1)
        s, e = k * 4 * SR, (k * 4 + 3) * SR
        tt = t[s:e]
        x[s:e] = 0.3 * np.sin(2 * np.pi * f0 * tt) * (0.5 + 0.5 * np.sin(2 * np.pi * am * tt))
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(x)).astype(np.float32)
    return (np.rint(x * 32768.0) / 32768.0).astype(np.float32)


def assert_argmax_equal(got, ref_logits, what):
    want = np.argmax(ref_logits, axis=-1)
    flips = np.argwhere(got != want)
    if len(flips):
        top2 = np.sort(ref_logits, axis=-1)[..., -2:]
        margins = [float(top2[tuple(i)][1] - top2[tuple(i)][0]) for i in flips[:10]]
        pytest.fail(f"{what}: {len(flips)} argmax flips of {want.size}, reference margins "
                    f"{margins}")


def assert_resnet_close(got, ref, what):
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= RESNET_TOL * scale, f"{what}: max abs {err:.3e} > {RESNET_TOL} * {scale:.3e}"


def test_masked_stats_pool_matches_jax():
    from sherpa_vietnamese_asr_tpu.ops.stats_pool import masked_stats_pool as jax_pool

    from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool

    rng = np.random.default_rng(0)
    feat = rng.standard_normal((3, 40, 125)).astype(np.float32)
    w = (rng.random((3, 3, 125)) > 0.4).astype(np.float32)
    w[1, 2] = 0.0  # an empty slot: v1 is eps
    w[2, 0] *= rng.random(125).astype(np.float32)  # soft weights
    ref = np.asarray(jax_pool(jnp.asarray(feat), jnp.asarray(w)))
    got = masked_stats_pool(torch.from_numpy(feat), torch.from_numpy(w)).numpy()
    rel = np.abs(got - ref).max(axis=-1) / np.maximum(np.abs(ref).max(axis=-1), 1e-30)
    assert not got[1, 2].any() and not ref[1, 2].any()
    assert got.shape == ref.shape == (3, 3, 80)
    assert float(rel.max()) <= 1e-5, float(rel.max())


def test_pyannet_matches_jax(tiny):
    from sherpa_vietnamese_asr_tpu.models.pyannet import pyannet_forward

    audio = (np.random.default_rng(1).standard_normal((2, 160000)) * 0.1).astype(np.float32)
    ref = np.asarray(pyannet_forward(tiny["seg_p"], jnp.asarray(audio), tiny["jseg_cfg"]))
    with torch.no_grad():
        got = tiny["seg"](torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, 589, 7)
    assert float(np.abs(got - ref).max()) <= 1e-4, float(np.abs(got - ref).max())
    assert_argmax_equal(got.argmax(-1), ref, "pyannet")


def test_resnet_matches_jax(tiny):
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import (
        project_embedding,
        resnet_frame_features,
    )

    fb = np.random.default_rng(2).standard_normal((2, 998, 80)).astype(np.float32)
    ref = np.asarray(resnet_frame_features(tiny["emb_p"], jnp.asarray(fb), tiny["jemb_cfg"]))
    stats = np.random.default_rng(3).standard_normal((2, 3, 2 * ref.shape[1])).astype(np.float32)
    ref_emb = np.asarray(project_embedding(tiny["emb_p"], jnp.asarray(stats)))
    with torch.no_grad():
        got = tiny["emb"].resnet_frame_features(torch.from_numpy(fb)).numpy()
        got_emb = tiny["emb"].project_embedding(torch.from_numpy(stats)).numpy()
    assert got.shape == ref.shape == (2, tiny["jemb_cfg"].frame_feature_dim, 125)
    assert_resnet_close(got, ref, "frame features")
    assert_resnet_close(got_emb, ref_emb, "projection")


@pytest.mark.parametrize("quantized", [False, True])
def test_superblock_matches_jax(tiny, quantized):
    from sherpa_vietnamese_asr_tpu.models.pyannet import pyannet_forward
    from sherpa_vietnamese_asr_tpu.pipeline import diarization_pure as jdp

    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as tdp

    n_windows = 4
    sb_len = tdp.superblock_samples(n_windows)
    assert sb_len == jdp.superblock_samples(n_windows)
    x = diarization_audio(20)[:sb_len]
    block = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16) if quantized else x
    msf = math.ceil(589 * 1680 / 160000)
    am_j, emb_j, valid_j = (np.asarray(a) for a in jdp._superblock_jit(
        tiny["seg_p"], tiny["emb_p"], jnp.asarray(block), seg_cfg=tiny["jseg_cfg"],
        emb_cfg=tiny["jemb_cfg"], n_windows=n_windows, min_seg_frames=msf,
        quantized=quantized))
    am, emb, valid = (t.numpy() for t in tdp._superblock_body(
        tiny["seg"], tiny["emb"], torch.from_numpy(block), n_windows, msf, quantized))
    assert am.dtype == np.int8 and am.shape == (n_windows, 589)
    if not np.array_equal(am, am_j):
        xs = block.astype(np.float32) / (32768.0 if quantized else 1.0)
        windows = np.stack([xs[i * 16000: i * 16000 + 160000] for i in range(n_windows)])
        logits = np.asarray(pyannet_forward(tiny["seg_p"], jnp.asarray(windows),
                                            tiny["jseg_cfg"]))
        assert_argmax_equal(am, logits, "superblock argmax")
    np.testing.assert_array_equal(valid, valid_j)
    assert valid.any() and not valid.all()
    assert_resnet_close(emb[valid], emb_j[valid], "superblock embeddings")


def _diarizers(tiny, fused):
    from sherpa_vietnamese_asr_tpu.pipeline.diarization_pure import PureDiarizer as JaxDiarizer

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    kw = dict(fused=fused, segmentation_batch_size=8, embedding_batch_size=8,
              threshold=THRESHOLD)
    jd = JaxDiarizer(seg_params=tiny["seg_p"], seg_cfg=tiny["jseg_cfg"],
                     emb_params=tiny["emb_p"], emb_cfg=tiny["jemb_cfg"], **kw)
    td = PureDiarizer(seg_model=tiny["seg"], emb_model=tiny["emb"], device="cpu", **kw)
    return jd, td


def assert_segments_equal(got, ref):
    assert len(got) == len(ref), (len(got), len(ref))
    for g, r in zip(got, ref):
        assert g["speaker"] == r["speaker"], (g, r)
        assert abs(g["start"] - r["start"]) <= 1e-6 and abs(g["end"] - r["end"]) <= 1e-6, (g, r)


@pytest.mark.parametrize("fused", [True, False])
def test_pure_diarizer_matches_jax(tiny, fused):
    audio = diarization_audio(20)
    jd, td = _diarizers(tiny, fused)
    ref = jd.process(audio)
    got = td.process(audio)
    assert got and len({s["speaker"] for s in got}) >= 2
    assert_segments_equal(got, ref)
    assert td.overlap_regions == jd.overlap_regions
    np.testing.assert_allclose(td.speaker_centroids, jd.speaker_centroids, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jd.speaker_centroids).max()))
    if not fused:
        _, fused_td = _diarizers(tiny, True)
        assert_segments_equal(fused_td.process(audio), got)
        one = td.compute_single_embedding(audio[: 2 * SR])
        assert_resnet_close(one, jd.compute_single_embedding(audio[: 2 * SR]),
                            "single embedding")
        assert td.compute_single_embedding(audio[:1000]) is None


def test_full_width_pyannet_one_window():
    from sherpa_vietnamese_asr_tpu.models.pyannet import PyanNetConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.pyannet import pyannet_forward

    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig

    from sherpa_vietnamese_asr_tpu_torch.models import convert

    p = jax_seg_params(JaxCfg(), seed=0, speaker_bias=0.0)
    seg = convert.pyannet_from_numpy(convert.pyannet_state_dict(p), PyanNetConfig(),
                                     device="cpu")
    audio = diarization_audio(10)[None, :160000]
    ref = np.asarray(pyannet_forward(p, jnp.asarray(audio), JaxCfg()))
    with torch.no_grad():
        got = seg(torch.from_numpy(audio)).numpy()
    assert got.shape == (1, 589, 7)
    assert float(np.abs(got - ref).max()) <= 1e-4, float(np.abs(got - ref).max())
    assert_argmax_equal(got.argmax(-1), ref, "full-width pyannet")


def test_full_width_resnet34_200_frames():
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import ResNetSpeakerConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import (
        project_embedding,
        resnet_frame_features,
    )
    from sherpa_vietnamese_asr_tpu.ops.stats_pool import masked_stats_pool as jax_pool

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeakerConfig
    from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool

    p = jax_emb_params(JaxCfg(), seed=0)
    emb = convert.resnet_from_numpy(convert.resnet_state_dict(p), ResNetSpeakerConfig(),
                                    device="cpu")
    fb = np.random.default_rng(0).standard_normal((1, 200, 80)).astype(np.float32)
    feat = resnet_frame_features(p, jnp.asarray(fb), JaxCfg())
    ones = jnp.ones((1, 1, feat.shape[-1]))
    ref = np.asarray(project_embedding(p, jax_pool(feat, ones)))
    with torch.no_grad():
        got_feat = emb.resnet_frame_features(torch.from_numpy(fb))
        got = emb.project_embedding(masked_stats_pool(
            got_feat, torch.ones((1, 1, got_feat.shape[-1])))).numpy()
    assert_resnet_close(got_feat.numpy(), np.asarray(feat), "full-width frame features")
    assert got.shape == (1, 1, 256)
    assert_resnet_close(got, ref, "full-width embedding")
