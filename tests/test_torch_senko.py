# The port's Senko CAM++ backend against the JAX package's, on the CPU:
#   (a) models/campplus.Campp against campp_embed at TINY_CAMPP, masked
#       (ragged windows zero-padded after their end) and unmasked at T 250
#       (a ceil-mode partial CAM segment), and one 150-frame window batch at
#       the full CamppConfig() width;
#   (b) campp_window_block (the in-block window gather) against the JAX
#       package's _campp_window_block on the same packed block;
#   (c) SenkoCamppDiarizer.process on 20 s and 40 s of two alternating tones
#       with block_frames 700 / block_windows 6, so that blocks flush on
#       both limits: identical segments and overlap regions;
#   (d) onnx_import.load_campp on a file written by
#       tests/torch_refs.state_dict_to_onnx from TorchCampp: the oracle's
#       outputs, the derived config, folded BatchNorm groups;
#   (e) the models default to the card and raise without one.
# Weights: the JAX init with every BatchNorm's statistics and affine and
# every bias drawn from numpy, through models/convert. For the diarizer the
# embedding BatchNorm is centred on the test audio's raw window embeddings,
# so that the random CAM++ separates the two tones into speakers. The tiny
# PyanNet is tests/test_torch_diarization.py's. Tolerances: embeddings
# within 1e-4 of max |embedding| and cosine >= 0.99999; diarizer segments
# equal, times within 1e-6 s.
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_diarization import (  # noqa: E402
    _np_tree,
    diarization_audio,
    jax_seg_params,
    tiny_seg_cfgs,
)

torch.set_num_threads(2)
EMB_TOL = 1e-4
COS_GATE = 0.99999
BLOCK_FRAMES, BLOCK_WINDOWS = 700, 6


def jax_campp_params(cfg, seed=3):
    """The JAX CAM++ init with BatchNorm statistics and affines and the CAM
    linears' biases drawn from numpy."""
    from sherpa_vietnamese_asr_tpu.models.campplus import init_campp_params

    p = _np_tree(init_campp_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        if "var" in node:
            c = node["var"].shape
            node["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            node["var"] = (0.5 + rng.random(c)).astype(np.float32)
            if "scale" in node:
                node["scale"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                node["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            return
        if "weight" in node and "bias" in node:
            node["bias"] = (0.1 * rng.standard_normal(node["bias"].shape)).astype(np.float32)
        for v in node.values():
            if isinstance(v, (dict, list)):
                walk(v)

    walk(p)
    return p


def port_campp(params, cfg):
    from sherpa_vietnamese_asr_tpu_torch.models import convert

    return convert.campp_from_numpy(convert.campp_state_dict(params), cfg, device="cpu")


def centred_campp_params(cfg, audio, seed=3):
    """jax_campp_params with the embedding BatchNorm's statistics set to the
    mean and variance of the raw embeddings of `audio`'s 1.5 s windows."""
    from sherpa_vietnamese_asr_tpu_torch.ops.fbank import CAMPP_FBANK, compute_fbank

    p = jax_campp_params(cfg, seed)
    bn = p["dense"]["bn"]
    bn["mean"] = np.zeros_like(bn["mean"])
    bn["var"] = np.full_like(bn["var"], 1.0 - 1e-5)
    fb = compute_fbank(torch.from_numpy(audio), CAMPP_FBANK)
    wins = torch.stack([fb[s: s + 150] for s in range(0, fb.shape[0] - 150, 60)])
    raw = port_campp(p, port_cfg(cfg))(wins).numpy()
    bn["mean"] = raw.mean(0).astype(np.float32)
    bn["var"] = (raw.var(0) + 1e-3).astype(np.float32)
    return p


def port_cfg(jcfg):
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import CamppConfig

    return CamppConfig(**{k: getattr(jcfg, k) for k in CamppConfig.__dataclass_fields__})


def assert_embeddings_close(got, ref):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= EMB_TOL * scale, (np.abs(got - ref).max(), scale)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= COS_GATE, cos.min()


def _ragged(rng, b, t, lens):
    x = rng.standard_normal((b, t, 80)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return x * mask[:, :, None], mask


@pytest.mark.parametrize("width,t,lens", [
    ("tiny", 250, [250, 213, 90, 1]),
    ("tiny", 150, [150, 149, 12, 150]),
    ("full", 150, [150, 150, 77]),
])
def test_campp_matches_jax(width, t, lens):
    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP, CamppConfig, campp_embed

    jcfg = TINY_CAMPP if width == "tiny" else CamppConfig()
    p = jax_campp_params(jcfg)
    model = port_campp(p, port_cfg(jcfg))
    x, mask = _ragged(np.random.default_rng(len(lens) + t), len(lens), t, lens)
    ref = np.asarray(campp_embed(p, x, jcfg, mask=mask))
    got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (len(lens), jcfg.embed_dim)
    assert_embeddings_close(got, ref)
    ref = np.asarray(campp_embed(p, x, jcfg))
    assert_embeddings_close(model(torch.from_numpy(x)).numpy(), ref)


def test_window_block_gather_matches_jax():
    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP
    from sherpa_vietnamese_asr_tpu.pipeline.diarization_senko import _campp_window_block

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import campp_window_block

    p = jax_campp_params(TINY_CAMPP)
    model = port_campp(p, port_cfg(TINY_CAMPP))
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((400, 80)).astype(np.float32)
    starts = np.array([0, 60, 120, 250, 330, 0], np.int32)
    lens = np.array([150, 150, 150, 80, 70, 1], np.int32)  # the last two run past the block
    ref = np.asarray(_campp_window_block(p, feat, starts, lens, TINY_CAMPP, 150))
    got = campp_window_block(model, torch.from_numpy(feat), torch.from_numpy(starts).long(),
                             torch.from_numpy(lens).long(), 150).numpy()
    assert_embeddings_close(got, ref)


@pytest.fixture(scope="module")
def senko_models():
    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP

    from sherpa_vietnamese_asr_tpu_torch.models import convert

    jseg_cfg, seg_cfg = tiny_seg_cfgs()
    seg_p = jax_seg_params(jseg_cfg)
    campp_p = centred_campp_params(TINY_CAMPP, diarization_audio(40))
    seg = convert.pyannet_from_numpy(convert.pyannet_state_dict(seg_p), seg_cfg, device="cpu")
    return {"jax": (seg_p, jseg_cfg, campp_p, TINY_CAMPP),
            "port": (seg, port_campp(campp_p, port_cfg(TINY_CAMPP)))}


def senko_pair(senko_models, **kw):
    from sherpa_vietnamese_asr_tpu.pipeline.diarization_senko import (
        SenkoCamppDiarizer as JaxSenko,
    )

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import SenkoCamppDiarizer

    seg_p, jseg_cfg, campp_p, jcampp_cfg = senko_models["jax"]
    seg, campp = senko_models["port"]
    jd = JaxSenko(seg_params=seg_p, seg_cfg=jseg_cfg, campp_params=campp_p,
                  campp_cfg=jcampp_cfg, **kw)
    td = SenkoCamppDiarizer(seg_model=seg, campp_model=campp, device="cpu", **kw)
    return jd, td


def assert_segments_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["speaker"] == r["speaker"], (g, r)
        assert abs(g["start"] - r["start"]) <= 1e-6 and abs(g["end"] - r["end"]) <= 1e-6, (g, r)


@pytest.mark.parametrize("seconds,num_speakers", [(20, -1), (40, -1), (40, 2)])
def test_senko_process_matches_jax(senko_models, seconds, num_speakers):
    jd, td = senko_pair(senko_models, num_speakers=num_speakers)
    for d in (jd, td):
        d.block_frames, d.block_windows = BLOCK_FRAMES, BLOCK_WINDOWS
    audio = diarization_audio(seconds)
    ref = jd.process(audio)
    progress = []
    got = td.process(audio, progress_callback=progress.append)
    assert_segments_equal(got, ref)
    assert len({s["speaker"] for s in got}) >= 2
    assert td.overlap_regions == jd.overlap_regions
    assert progress[-1] == 100 and len(progress) >= 3  # blocks flushed


def test_senko_short_and_silent_audio_match_jax(senko_models):
    jd, td = senko_pair(senko_models)
    for audio in (np.zeros(4000, np.float32), diarization_audio(4),
                  np.zeros(16000 * 3, np.float32)):
        assert_segments_equal(td.process(audio), jd.process(audio))


def test_load_campp_reproduces_the_torch_oracle(tmp_path):
    from tests.torch_refs import TorchCampp, randomize_bn_stats, state_dict_to_onnx

    from sherpa_vietnamese_asr_tpu.models.campplus import TINY_CAMPP as JAX_TINY
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_campp as jax_load

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import TINY_CAMPP, Campp
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_campp

    torch.manual_seed(3)
    ref = TorchCampp(TINY_CAMPP).eval()
    randomize_bn_stats(ref, seed=3)
    path = tmp_path / "campplus_cn_en_common_200k.onnx"
    state_dict_to_onnx(ref, path)
    state, cfg = load_campp(str(path))
    assert cfg == TINY_CAMPP
    model = convert.campp_from_numpy(state, cfg, device="cpu")
    feats = np.random.default_rng(3).standard_normal((2, 250, 80)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(feats)).numpy()
    assert_embeddings_close(model(torch.from_numpy(feats)).numpy(), want)
    jp, jcfg = jax_load(str(path))
    assert jcfg == JAX_TINY
    assert {k: v.shape for k, v in convert.campp_state_dict(jp).items()} == \
        {k: tuple(v.shape) for k, v in Campp(cfg).state_dict().items()}

    # An export with every BatchNorm folded away loads identity statistics.
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import GraphBuilder

    b = GraphBuilder()
    for k, v in ref.state_dict().items():
        if not any(n in k for n in (".bn", "batchnorm", "shortcut.1")):
            b.init(k, v.numpy())
    folded = tmp_path / "folded.onnx"
    folded.write_bytes(b.build())
    state, _ = load_campp(str(folded), cfg=TINY_CAMPP)
    assert np.all(state["head.bn1.running_var"] == np.float32(1.0 - 1e-5))
    assert np.all(state["xvector.dense.nonlinear.batchnorm.running_mean"] == 0.0)


def test_models_default_to_the_card():
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import TINY_CAMPP, random_campp
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import SenkoCamppDiarizer

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_campp(TINY_CAMPP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SenkoCamppDiarizer()
    assert random_campp(TINY_CAMPP, device="cpu").device == torch.device("cpu")
