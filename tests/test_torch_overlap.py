# The port's overlap separation against the JAX package's, on the CPU:
#   (a) models/convtasnet.ConvTasNet against convtasnet_separate at
#       TINY_CONVTASNET, on lengths on the frame grid, off it (zeros appended
#       for a full grid) and shorter than one frame;
#   (b) OverlapSeparator: compute_embedding (the 1,000-frame budget and a
#       clip over it), and process() on planted 2-speaker segments and
#       overlap regions (one too short, one with three participants, two
#       separated): the same regions, participants and stream-to-speaker
#       assignment, stitched audio within 1e-4 of its max |value|, the same
#       real start and end of each stream;
#   (c) onnx_import.load_convtasnet on a file written by
#       tests/torch_refs.state_dict_to_onnx from TorchConvTasNet: the
#       oracle's outputs and its derived config.
# Weights: the JAX init with gLN affines, biases and PReLU slopes drawn from
# numpy, through models/convert; CAM++ as tests/test_torch_senko.py.
# Tolerances: separated sources within 1e-4 of max |output| (the
# overlap-add sums in another order, conv_transpose1d against a
# scatter-add); embeddings as tests/test_torch_senko.py.
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_diarization import _np_tree  # noqa: E402
from tests.test_torch_senko import (  # noqa: E402
    assert_embeddings_close,
    jax_campp_params,
    port_campp,
    port_cfg,
)

torch.set_num_threads(2)
SR = 16000
SEP_TOL = 1e-4


def jax_convtasnet_params(cfg, seed=0):
    from sherpa_vietnamese_asr_tpu.models.convtasnet import init_convtasnet_params

    p = _np_tree(init_convtasnet_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def draw(shape, scale=0.1, base=0.0):
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    for ln in [p["ln_in"]] + [b[k] for b in p["blocks"] for k in ("ln1", "ln2")]:
        ln["scale"], ln["bias"] = draw(ln["scale"].shape, base=1.0), draw(ln["bias"].shape)
    for conv in [p["bottleneck_in"], p["mask_out"]] + [
            b[k] for b in p["blocks"] for k in ("in_conv", "dw_conv", "res_conv", "skip_conv")]:
        conv["bias"] = draw(conv["bias"].shape)
    for b in p["blocks"]:
        b["prelu1"], b["prelu2"] = draw((1,), base=0.25), draw((1,), base=0.25)
    p["mask_prelu"] = draw((1,), base=0.25)
    return p


def port_convtasnet(params, jcfg):
    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import ConvTasNetConfig

    cfg = ConvTasNetConfig(**{k: getattr(jcfg, k) for k in ConvTasNetConfig.__dataclass_fields__})
    return convert.convtasnet_from_numpy(convert.convtasnet_state_dict(params), cfg,
                                         device="cpu")


def assert_sources_close(got, ref):
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= SEP_TOL * scale, (np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("t", [16000 + 16 * 5 + 16, 16007, 24, 32])
def test_convtasnet_matches_jax(t):
    from sherpa_vietnamese_asr_tpu.models.convtasnet import (
        TINY_CONVTASNET,
        convtasnet_separate,
    )

    p = jax_convtasnet_params(TINY_CONVTASNET)
    model = port_convtasnet(p, TINY_CONVTASNET)
    mix = (0.1 * np.random.default_rng(t).standard_normal((2, t))).astype(np.float32)
    ref = np.asarray(convtasnet_separate(p, mix, TINY_CONVTASNET))
    assert_sources_close(model(torch.from_numpy(mix)).numpy(), ref)


@pytest.fixture(scope="module")
def separators():
    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP
    from sherpa_vietnamese_asr_tpu.models.convtasnet import TINY_CONVTASNET
    from sherpa_vietnamese_asr_tpu.pipeline.overlap import OverlapSeparator as JaxSeparator

    from sherpa_vietnamese_asr_tpu_torch.pipeline.overlap import OverlapSeparator

    ct_p, campp_p = jax_convtasnet_params(TINY_CONVTASNET), jax_campp_params(TINY_CAMPP)
    jsep = JaxSeparator(convtasnet_params=ct_p, convtasnet_cfg=TINY_CONVTASNET,
                        campp_params=campp_p, campp_cfg=TINY_CAMPP, embed_pad_sec=4.0)
    tsep = OverlapSeparator(convtasnet=port_convtasnet(ct_p, TINY_CONVTASNET),
                            campp=port_campp(campp_p, port_cfg(TINY_CAMPP)),
                            embed_pad_sec=4.0, device="cpu")
    return jsep, tsep


def overlap_audio(seconds=24):
    """Speaker 0: an AM tone at 220 Hz; speaker 1: 800 Hz with 1 kHz; both in
    the overlaps; noise at 0.01."""
    t = np.arange(SR * seconds) / SR
    s0 = 0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t))
    s1 = 0.2 * np.sin(2 * np.pi * 800 * t) + 0.1 * np.sin(2 * np.pi * 1000 * t)
    on0, on1 = np.zeros_like(t), np.zeros_like(t)
    for a, b in ((0, 6), (8, 14), (17, 20)):
        on0[int(a * SR): int(b * SR)] = 1
    for a, b in ((5, 8), (12.5, 16), (19, 24)):
        on1[int(a * SR): int(b * SR)] = 1
    x = s0 * on0 + s1 * on1 + 0.01 * np.random.default_rng(0).standard_normal(len(t))
    return x.astype(np.float32)


SEGMENTS = [  # clean stretches, the overlaps' participants, one short third speaker
    {"start": 0.0, "end": 5.0, "speaker": 0}, {"start": 4.5, "end": 6.0, "speaker": 0},
    {"start": 5.0, "end": 8.0, "speaker": 1}, {"start": 6.2, "end": 8.0, "speaker": 1},
    {"start": 8.0, "end": 12.5, "speaker": 0}, {"start": 12.0, "end": 14.0, "speaker": 0},
    {"start": 12.5, "end": 16.0, "speaker": 1}, {"start": 15.0, "end": 15.6, "speaker": 2},
    {"start": 15.5, "end": 16.5, "speaker": 0}, {"start": 17.0, "end": 19.0, "speaker": 0},
    {"start": 18.5, "end": 20.0, "speaker": 0}, {"start": 19.0, "end": 24.0, "speaker": 1},
    {"start": 20.5, "end": 24.0, "speaker": 1}]
# (5, 6), (12.5, 14) and (19, 20) are separated; (15.2, 15.5) is too short
# and (15.0, 16.0) has three participants.
REGIONS = [(5.0, 6.0), (12.5, 14.0), (15.2, 15.5), (15.0, 16.0), (19.0, 20.0)]


def test_embedding_matches_jax(separators):
    jsep, tsep = separators
    audio = overlap_audio()
    for a, b in ((0.0, 0.2), (0.0, 0.31), (1.0, 4.0), (0.0, 6.0)):
        clip = audio[int(a * SR): int(b * SR)]
        ref, got = jsep.compute_embedding(clip), tsep.compute_embedding(clip)
        if ref is None:
            assert got is None
            continue
        assert_embeddings_close(got[None], ref[None])
    ref_c = jsep.compute_centroids(audio, SEGMENTS, REGIONS)
    got_c = tsep.compute_centroids(audio, SEGMENTS, REGIONS)
    assert sorted(got_c) == sorted(ref_c) == [0, 1]
    for spk in ref_c:
        assert_embeddings_close(got_c[spk][None], ref_c[spk][None])


def test_process_matches_jax(separators):
    jsep, tsep = separators
    audio = overlap_audio()
    ref = jsep.process(audio, SEGMENTS, REGIONS)
    progress = []
    got = tsep.process(audio, SEGMENTS, REGIONS, progress_callback=progress.append)
    assert len(got) == len(ref) == 3 and progress[-1] == 100
    for g, r in zip(got, ref):
        assert (g["start"], g["end"], g["participants"]) == (r["start"], r["end"],
                                                             r["participants"])
        assert list(g["audio_per_speaker"]) == list(r["audio_per_speaker"])
        for spk in r["audio_per_speaker"]:
            assert g["real_start_per_speaker"][spk] == r["real_start_per_speaker"][spk]
            assert g["real_end_per_speaker"][spk] == r["real_end_per_speaker"][spk]
            assert_sources_close(g["audio_per_speaker"][spk], r["audio_per_speaker"][spk])
    assert tsep.process(audio, SEGMENTS, []) == [] == jsep.process(audio, SEGMENTS, [])
    assert tsep.process(audio, SEGMENTS, [(1.0, 1.5)]) == []


def test_load_convtasnet_reproduces_the_torch_oracle(tmp_path):
    from tests.torch_refs import TorchConvTasNet, state_dict_to_onnx

    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_convtasnet as jax_load

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import TINY_CONVTASNET
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_convtasnet

    torch.manual_seed(1)
    ref = TorchConvTasNet(TINY_CONVTASNET).eval()
    path = tmp_path / "convtasnet_16k.onnx"
    state_dict_to_onnx(ref, path)
    state, cfg = load_convtasnet(str(path))
    assert cfg == TINY_CONVTASNET
    model = convert.convtasnet_from_numpy(state, cfg, device="cpu")
    mix = np.random.default_rng(1).standard_normal((2, 512)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(mix)).numpy()[:, :, :512]
    assert_sources_close(model(torch.from_numpy(mix)).numpy(), want)
    jp, _ = jax_load(str(path))
    np.testing.assert_array_equal(convert.convtasnet_state_dict(jp)["masker.TCN.1.res_conv.weight"],
                                  state["masker.TCN.1.res_conv.weight"])
