# The port's data parallelism (parallel/sharding.py) on the CPU, against
# the JAX package's 8-device CPU mesh (tests/conftest.py):
#   (a) shard_batch pads to a mesh multiple and splits like the JAX
#       shard_batch; default_mesh() is None here; shard_model copies a
#       model to another device and leaves the original alone;
#   (b) BatchedChunkDecoder over meshes of 1, 3 and 8 CPU "devices" (one
#       replica shared by every repeat of a device) equals mesh=None, with
#       max_batch 6 rounded up (words equal, starts within 1e-6, probs
#       within 1e-4, the gates of the JAX tests/test_pipeline.py), and the
#       8-way split equals the JAX decoder on its 8-device mesh;
#   (c) QualityAnalyzer, GecBert and PureDiarizer split == unsplit at the
#       gates of the JAX tests/test_sharded_stages.py (DNSMOS 1e-4; ViBERT
#       rtol 2e-4 / atol 2e-5, equal labels and text; superblocks equal
#       argmaxes and embeddings at cosine > 0.9999);
#   (d) decode_batch_sharded and vad_probs_sharded against their JAX
#       counterparts (equal tokens; probabilities within 1e-5).
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_diarization import (  # noqa: E402
    diarization_audio,
    jax_emb_params,
    jax_seg_params,
    port_models,
    tiny_seg_cfgs,
)
from tests.test_torch_punctuation import gec_vocab, jax_vibert, port_vibert  # noqa: E402
from tests.test_torch_quality import jax_dnsmos, port_dnsmos  # noqa: E402
from tests.test_torch_slice import _assert_words_equal, _convert  # noqa: E402

from sherpa_vietnamese_asr_tpu_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(2)
MESH_SIZES = (1, 3, 8)


def cpu_mesh(k):
    return sharding.make_mesh(["cpu"] * k)


def jax_mesh():
    from sherpa_vietnamese_asr_tpu.parallel.sharding import make_mesh

    assert len(jax.devices()) == 8
    return make_mesh()


@pytest.fixture(scope="module")
def asr_pair():
    from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model

    jm = random_asr_model(vocab_size=80, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    # Sharper logits, as tests/test_torch_slice.py: no near-tied beam steps.
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    return jm, _convert(jm, beam_size=4)


def _audio(seconds=8, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000
    return np.clip(0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(len(t)),
                   -1, 1).astype(np.float32)


SPANS = [(i * 8000, i * 8000 + 24000) for i in range(7)]


def test_shard_batch_pads_splits_and_gathers_like_jax():
    from sherpa_vietnamese_asr_tpu.parallel.sharding import shard_batch as jax_shard

    x = np.arange(5 * 3, dtype=np.float32).reshape(5, 3) + 1
    pieces, n = sharding.shard_batch(x, cpu_mesh(3))
    assert n == 5 and [tuple(p.shape) for p in pieces] == [(2, 3)] * 3
    assert float(pieces[2][1].abs().sum()) == 0.0  # the zero pad row
    np.testing.assert_array_equal(sharding.gather(pieces, n), x)
    y = np.arange(11 * 2, dtype=np.int16).reshape(11, 2)
    pieces, n = sharding.shard_batch(y, cpu_mesh(8))
    jarr, jn = jax_shard(y, jax_mesh())
    assert n == jn == 11 and all(p.shape == (2, 2) and p.dtype == torch.int16 for p in pieces)
    np.testing.assert_array_equal(sharding.gather(pieces), np.asarray(jarr))


def test_default_mesh_is_none_here_and_the_mesh_helpers():
    assert sharding.default_mesh() is None
    assert sharding.resolve("auto") is None
    mesh = cpu_mesh(3)
    assert sharding.resolve(mesh) is mesh and mesh.size == 3 and mesh.axis_name == "data"
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert [sharding.round_up(n, mesh) for n in (1, 3, 6, 7)] == [3, 3, 6, 9]
    assert sharding.round_up(7, None) == 7
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()


def test_shard_model_copies_to_another_device_and_reuses_repeats(asr_pair):
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import HotwordTables

    _, tm = asr_pair
    reps = sharding.shard_model(tm, cpu_mesh(3))
    assert all(r is tm for r in reps)
    hw = HotwordTables(torch.zeros((2, 80), dtype=torch.int32), torch.zeros((2, 80)),
                       torch.zeros((2,)))
    model = dataclasses.replace(tm, hotword_tables=hw)
    meta = sharding.make_mesh(["cpu", "meta", "meta"])
    first, copy_a, copy_b = sharding.shard_model(model, meta)
    assert first is model and copy_a is copy_b and copy_a is not model
    assert copy_a.device.type == "meta" and copy_a.hotword_tables.delta.device.type == "meta"
    assert model.device.type == "cpu" and model.hotword_tables is hw
    assert copy_a.encoder is not model.encoder and copy_a.id2token is model.id2token
    lin = torch.nn.Linear(2, 2)
    r = sharding.replicate(lin, meta)
    assert r[0] is lin and r[1] is r[2] and r[1].weight.device.type == "meta"
    assert lin.weight.device.type == "cpu"


@pytest.mark.parametrize("k", MESH_SIZES)
def test_decoder_split_equals_unsplit(asr_pair, k):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

    _, tm = asr_pair
    audio = _audio()
    plain = BatchedChunkDecoder(tm, max_batch=6, chunk_pad_sec=3.0)
    assert plain.mesh is None and plain.max_batch == 6
    split = BatchedChunkDecoder(tm, max_batch=6, chunk_pad_sec=3.0, mesh=cpu_mesh(k),
                                model_b=tm if k == 3 else None)
    assert split.max_batch == {1: 6, 3: 6, 8: 8}[k]
    assert split.model is tm and split.devices == [torch.device("cpu")] * k
    ref = plain.decode_spans(audio, SPANS)
    got = split.decode_spans(audio, SPANS)
    if k == 3:  # the ROVER partner split too
        got_a, got_b = got
        for a, b in zip(got_b, got_a):
            _assert_words_equal(a, b)
        got = got_a
    assert len(got) == len(ref) == len(SPANS) and sum(map(len, ref)) > 0
    for g, r in zip(got, ref):
        _assert_words_equal(g, r)


def test_decoder_8_way_split_equals_the_jax_mesh(asr_pair):
    from sherpa_vietnamese_asr_tpu.pipeline.decoder import BatchedChunkDecoder as JaxDecoder

    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

    jm, tm = asr_pair
    audio = _audio()
    ref = JaxDecoder(jm, max_batch=6, chunk_pad_sec=3.0, mesh=jax_mesh()).decode_spans(
        audio, SPANS)
    got = BatchedChunkDecoder(tm, max_batch=6, chunk_pad_sec=3.0,
                              mesh=cpu_mesh(8)).decode_spans(audio, SPANS)
    assert [[w["text"] for w in ws] for ws in got] == [[w["text"] for w in ws] for ws in ref]
    assert sum(map(len, ref)) > 0


def test_quality_split_equals_unsplit():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    rng = np.random.default_rng(0)
    windows = [(0.1 * rng.standard_normal(16000 * 3)).astype(np.float32) for _ in range(3)]
    model = port_dnsmos(jax_dnsmos(24))
    plain = QualityAnalyzer(model=model)
    assert plain.mesh is None
    ref = plain.compute_dnsmos_batch(windows)
    for k in (3, 8):  # 3 pads up to the mesh multiple 8
        got = QualityAnalyzer(model=model, mesh=cpu_mesh(k)).compute_dnsmos_batch(windows)
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            for key in ("SIG", "BAK", "OVRL"):
                assert abs(a[key] - b[key]) < 1e-4


def test_gec_split_equals_unsplit():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    model = port_vibert(jax_vibert(0))
    plain = GecBert(model, WordPieceTokenizer(gec_vocab()), mini_batch_size=8)
    split = GecBert(model, WordPieceTokenizer(gec_vocab()), mini_batch_size=8,
                    mesh=cpu_mesh(3))
    assert plain.mesh is None and plain.mini_batch_size == 8 and split.mini_batch_size == 9
    sents = [["xin", "chao", "viet", "nam"], ["hom", "nay", "troi", "dep", "rat", "vui"],
             ["mot", "hai", "ba"]] * 4
    inp_p, inp_s = plain.preprocess(sents), split.preprocess(sents)
    lg_p, dt_p = plain._run_model(inp_p)
    lg_s, dt_s = split._run_model(inp_s)
    np.testing.assert_allclose(lg_s, lg_p, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dt_s, dt_p, rtol=2e-4, atol=2e-5)
    p_p, i_p, e_p = plain._run_decode(inp_p)
    p_s, i_s, e_s = split._run_decode(inp_s)
    assert i_s == i_p
    np.testing.assert_allclose(p_s, p_p, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(e_s, e_p, rtol=2e-4, atol=2e-5)
    text = "xin chao viet nam hom nay troi dep"
    assert split(text) == plain(text)


def test_diarizer_superblocks_split_equal_unsplit():
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import TINY_RESNET as JAX_TINY

    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import TINY_RESNET
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    jseg_cfg, seg_cfg = tiny_seg_cfgs()
    seg, emb = port_models(jax_seg_params(jseg_cfg), seg_cfg, jax_emb_params(JAX_TINY),
                           TINY_RESNET)
    kw = dict(seg_model=seg, emb_model=emb, fused=True, superblock_windows=4,
              transfer_dtype="float32", device="cpu")
    audio = diarization_audio(28)
    plain = PureDiarizer(**kw)
    assert plain.mesh is None
    bin_p, starts_p, emb_p = plain._segment_and_embed_fused(audio)
    assert len(starts_p) > 4 * kw["superblock_windows"]  # a group of 3, a tail of 2
    bin_s, starts_s, emb_s = PureDiarizer(mesh=cpu_mesh(3), **kw)._segment_and_embed_fused(audio)
    assert starts_s == starts_p
    np.testing.assert_array_equal(bin_s, bin_p)
    np.testing.assert_array_equal(np.isnan(emb_s[..., 0]), np.isnan(emb_p[..., 0]))
    both = ~np.isnan(emb_p[..., 0])
    cf, cc = emb_s[both], emb_p[both]
    cos = (cf * cc).sum(-1) / (np.linalg.norm(cf, axis=-1) * np.linalg.norm(cc, axis=-1) + 1e-9)
    assert both.any() and cos.min() > 0.9999


def test_decode_batch_sharded_matches_jax(asr_pair):
    from sherpa_vietnamese_asr_tpu.parallel.sharding import decode_batch_sharded as jax_decode

    jm, tm = asr_pair
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((8, 16000)) * 0.1).astype(np.float32)
    lens = np.array([16000, 12000, 16000, 9000, 16000, 16000, 14000, 16000], np.int32)
    jres, jlens = jax_decode(jm, audio, lens, jax_mesh())
    res, enc_lens = sharding.decode_batch_sharded(tm, audio, lens, cpu_mesh(8))
    np.testing.assert_array_equal(enc_lens, np.asarray(jlens))
    np.testing.assert_array_equal(res.num_tokens, np.asarray(jres.num_tokens))
    assert res.num_tokens.sum() > 0
    for i, n in enumerate(res.num_tokens):
        np.testing.assert_array_equal(res.tokens[i, :n], np.asarray(jres.tokens)[i, :n])
    # 7 rows: the split pads one zero row and drops it.
    part, part_lens = sharding.decode_batch_sharded(tm, audio[:7], lens[:7], cpu_mesh(8))
    assert part.tokens.shape[0] == 7 and part_lens.shape == (7,)
    np.testing.assert_array_equal(part.num_tokens, res.num_tokens[:7])


def test_vad_probs_sharded_matches_jax():
    from sherpa_vietnamese_asr_tpu.models import silero_vad as jsv
    from sherpa_vietnamese_asr_tpu.parallel.sharding import vad_probs_sharded as jax_vad

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad as tsv

    params = jsv.init_silero_params(jax.random.PRNGKey(0), jsv.SileroVadConfig())
    vad = convert.silero_from_numpy(convert.silero_state_dict(jax.tree.map(np.asarray, params)),
                                    tsv.SileroVadConfig(), device="cpu")
    wins = (np.random.default_rng(0).standard_normal((32, 576)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_vad(params, wins, jax_mesh()))
    got = sharding.vad_probs_sharded(vad, wins, cpu_mesh(8)).numpy()
    assert got.shape == (32,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    odd = sharding.vad_probs_sharded(vad, wins[:29], cpu_mesh(3)).numpy()
    np.testing.assert_allclose(odd, got[:29], rtol=1e-4, atol=1e-5)
