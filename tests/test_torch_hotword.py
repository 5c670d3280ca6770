# The port's hotword host side (ops/hotword, utils/bpe, utils/protowire,
# utils/config) against the JAX package's, and the beam search twin with the
# port's tables against the JAX scan with the JAX package's tables: on the
# frozen beam fixture, and after the JAX bf16 encoder of the tiny model.
# Then the bf16 + hotwords slice through TranscriberPipeline on the CPU.
import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.ops import hotword as thw
from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import beam_search_batch
from sherpa_vietnamese_asr_tpu_torch.utils import bpe as tbpe
from sherpa_vietnamese_asr_tpu_torch.utils import config as tconfig
from sherpa_vietnamese_asr_tpu_torch.utils import protowire as tpw

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "beam_fixture.json")

PIECES = [
    ("<blk>", 0.0, 3), ("<sos/eos>", 0.0, 3), ("<unk>", 0.0, 2),
    ("▁", -2.0, 1), ("a", -3.0, 1), ("b", -3.5, 1), ("c", -4.0, 1),
    ("▁a", -1.0, 1), ("▁ab", -0.5, 1), ("ab", -1.5, 1), ("bc", -2.5, 1),
    ("▁abc", -0.2, 1), ("N", -3.0, 1), ("G", -3.1, 1), ("▁NG", -0.8, 1),
    ("Ư", -3.2, 1), ("Ơ", -3.3, 1), ("▁NGƯ", -0.4, 1), ("ƠI", -0.9, 1),
    ("I", -3.4, 1), ("▁A", -1.1, 1), ("B", -3.6, 1), ("C", -3.7, 1),
    ("▁AB", -0.6, 1), ("BC", -1.2, 1), ("▁ABC", -0.3, 1),
]


def _sp_model_bytes(pieces):
    """A minimal sentencepiece ModelProto (pieces only), written with the
    port's protowire writer."""
    out = b""
    for piece, score, ptype in pieces:
        body = tpw.write_field(1, 2, piece.encode())
        body += tpw.write_varint((2 << 3) | 5) + struct.pack("<f", score)
        body += tpw.write_field(3, 0, ptype)
        out += tpw.write_field(1, 2, body)
    return out


def _random_phrases(seed, n, vocab):
    """Token phrases where many share a prefix with an earlier one, plus a
    duplicate, a prefix and a suffix of earlier phrases."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        if seqs and rng.random() < 0.5:
            base = seqs[int(rng.integers(len(seqs)))]
            cut = int(rng.integers(1, len(base) + 1))
            tail = rng.integers(3, vocab, int(rng.integers(1, 4))).tolist()
            seqs.append(base[:cut] + tail)
        else:
            seqs.append(rng.integers(3, vocab, int(rng.integers(1, 7))).tolist())
    seqs += [list(seqs[0]), seqs[1][:1], seqs[2][-2:]]
    return seqs, rng.uniform(0.5, 3.0, len(seqs)).round(2).tolist()


def _assert_tables_equal(got, ref):
    assert got.next_state.dtype == torch.int32
    assert got.delta.dtype == got.node_score.dtype == torch.float32
    for name in ("next_state", "delta", "node_score"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _fixture_phrases():
    with open(FIXTURE) as f:
        fx = json.load(f)
    return fx["hotword_phrases"], fx["hotword_scores"], fx["rnnt_cfg"]["vocab_size"]


@pytest.mark.parametrize("case", ["beam_fixture", "random_shared_prefixes"])
def test_tables_equal_jax(case):
    from sherpa_vietnamese_asr_tpu.ops import hotword as jhw

    if case == "beam_fixture":
        seqs, scores, vocab = _fixture_phrases()
    else:
        vocab = 120
        seqs, scores = _random_phrases(0, 40, vocab)
    got, graph = thw.build_hotword_tables(seqs, scores, vocab)
    ref, _ = jhw.build_hotword_tables(seqs, scores, vocab)
    _assert_tables_equal(got, ref)
    dense = thw.build_dense_tables(graph, vocab)
    ref_dense = jhw.build_dense_tables(jhw.ContextGraph(seqs, scores), vocab)
    for a, b in zip(dense, ref_dense):
        np.testing.assert_array_equal(a, b)
    if case == "random_shared_prefixes":
        assert got.next_state.shape[0] > len(seqs)  # shared prefixes -> a trie


def test_bpe_and_tables_from_files_equal_jax(tmp_path):
    from sherpa_vietnamese_asr_tpu.ops.hotword import parse_hotwords_file
    from sherpa_vietnamese_asr_tpu.utils import config as jconfig
    from sherpa_vietnamese_asr_tpu.utils.bpe import BpeModel

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "bpe.model").write_bytes(_sp_model_bytes(PIECES))
    port = tbpe.BpeModel.from_file(str(model_dir / "bpe.model"))
    ref = BpeModel.from_file(str(model_dir / "bpe.model"))
    assert port.pieces == ref.pieces and port.unk_id == ref.unk_id == 2
    for text in ("abc", "ab c", "NGƯƠI", "ngươi", "ABC xyz", "Ａbc", "  a  "):
        assert port.encode(text) == ref.encode(text), text
    hw = tmp_path / "hotword.txt"
    hw.write_text("# comment\nABC :2.0\nAB\nngươi:3\n\nxyz :bad\n", encoding="utf-8")
    assert thw.parse_hotwords_file(str(hw)) == parse_hotwords_file(str(hw))
    got, got_phrases = tconfig.build_hotword_tables_for_model(
        str(model_dir), vocab_size=len(PIECES), hotwords_file=str(hw))
    exp, exp_phrases = jconfig.build_hotword_tables_for_model(
        str(model_dir), vocab_size=len(PIECES), hotwords_file=str(hw))
    assert got_phrases == exp_phrases and len(got_phrases) == 4
    _assert_tables_equal(got, exp)
    assert tconfig.get_hotwords_config(str(model_dir), base_dir=str(tmp_path)) == \
        jconfig.get_hotwords_config(str(model_dir), base_dir=str(tmp_path))
    none = tconfig.build_hotword_tables_for_model(
        str(model_dir), vocab_size=len(PIECES),
        hotwords_file=str(tmp_path / "missing.txt"), base_dir=str(tmp_path / "nowhere"))
    assert none == (None, [])


def _port_rnnt(jcfg, dec, joi):
    import jax

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner, RnntConfig

    cfg = RnntConfig(**dataclasses.asdict(jcfg))
    dec, joi = jax.tree.map(np.asarray, (dec, joi))
    d, j = Decoder(cfg), Joiner(cfg)
    convert._load(d, convert.decoder_state_dict(dec))
    convert._load(j, convert.joiner_state_dict(joi))
    return cfg, d.eval(), j.eval()


def test_beam_twin_with_port_tables_matches_fixture_and_jax_scan():
    """Every hotword case of beam_fixture.json: the port's tables in the
    port's beam twin decode the frozen tokens and the JAX scan's (JAX
    tables) tokens, frames and scores."""
    import jax
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.models import rnnt as jr
    from sherpa_vietnamese_asr_tpu.ops import hotword as jhw
    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs

    with open(FIXTURE) as f:
        fx = json.load(f)
    jcfg = jr.RnntConfig(**fx["rnnt_cfg"])
    k1, k2 = jax.random.split(jax.random.PRNGKey(fx["prng_seed"]))
    jdec, jjoi = jr.init_decoder_params(k1, jcfg), jr.init_joiner_params(k2, jcfg)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = (np.random.default_rng(fx["enc_seed"]).standard_normal(fx["enc_shape"])
           * fx["enc_scale"]).astype(np.float32)
    lens = np.asarray(fx["lens"], np.int32)
    tables, _ = thw.build_hotword_tables(fx["hotword_phrases"], fx["hotword_scores"],
                                         cfg.vocab_size)
    jtables, _ = jhw.build_hotword_tables(fx["hotword_phrases"], fx["hotword_scores"],
                                          cfg.vocab_size)
    cases = [c for c in fx["cases"] if c["hotwords"]]
    assert cases
    for case in cases:
        got = beam_search_batch(torch.from_numpy(enc), torch.from_numpy(lens), dec, joi,
                                cfg, beam_size=case["beam"], hw_tables=tables)
        ref = jbs(jnp.asarray(enc), jnp.asarray(lens), jdec, jjoi, jcfg,
                  beam_size=case["beam"], hw_tables=jtables, with_hotwords=True)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.frames.numpy(), np.asarray(ref.frames))
        np.testing.assert_allclose(got.total_logp.numpy(), np.asarray(ref.total_logp),
                                   atol=1e-4, rtol=0)
        for i, exp in enumerate(case["expected"]):
            nt = int(got.num_tokens[i])
            assert got.tokens[i, :nt].tolist() == exp["tokens"]
            assert abs(float(got.total_logp[i]) - exp["total_logp"]) < 1e-3


@pytest.fixture(scope="module")
def tiny_bf16():
    """The JAX package's tiny model in bf16 (joiner sharpened as in
    test_torch_slice) and the port's copy of it."""
    import jax

    from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.models.convert import asr_model_from_numpy
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig

    jm = random_asr_model(vocab_size=80, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"), compute_dtype="bfloat16")
    jm.joi_params["output"]["weight"] = jm.joi_params["output"]["weight"] * 8.0
    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    tm = asr_model_from_numpy(enc, dec, joi,
                              ZipformerConfig(**dataclasses.asdict(jm.zip_cfg)),
                              RnntConfig(**dataclasses.asdict(jm.rnnt_cfg)),
                              jm.id2token, device="cpu", beam_size=4)
    assert tm.zip_cfg.compute_dtype == "bfloat16"
    return jm, tm


def _decoded_bigrams(tokens, num_tokens, n):
    out = []
    for row, k in zip(tokens, num_tokens):
        for i in range(0, max(int(k) - 1, 0), 3):
            out.append([int(row[i]), int(row[i + 1])])
    return out[:n]


def test_port_tables_after_the_jax_bf16_encoder_match_jax(tiny_bf16):
    """The JAX bf16 encoder's output of the tiny model through the port's
    beam twin with the port's tables gives the JAX scan's tokens (JAX tables).
    The phrases are bigrams of the plain decode, so the automaton fires."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.models.zipformer import zipformer_encoder
    from sherpa_vietnamese_asr_tpu.ops import hotword as jhw
    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs

    jm, tm = tiny_bf16
    lens = np.asarray([400, 331, 120], np.int32)
    feats = np.random.default_rng(5).standard_normal((3, 400, 80)).astype(np.float32)
    enc, enc_lens = zipformer_encoder(jm.enc_params, jnp.asarray(feats),
                                      jnp.asarray(lens), jm.zip_cfg)
    plain = jbs(enc, enc_lens, jm.dec_params, jm.joi_params, jm.rnnt_cfg, beam_size=4)
    phrases = _decoded_bigrams(np.asarray(plain.tokens), np.asarray(plain.num_tokens), 12)
    assert len(phrases) >= 6
    scores = [2.0] * len(phrases)
    v = jm.rnnt_cfg.vocab_size
    tables, _ = thw.build_hotword_tables(phrases, scores, v)
    jtables, _ = jhw.build_hotword_tables(phrases, scores, v)
    ref = jbs(enc, enc_lens, jm.dec_params, jm.joi_params, jm.rnnt_cfg, beam_size=4,
              hw_tables=jtables, with_hotwords=True)
    got = beam_search_batch(torch.from_numpy(np.array(enc)),
                            torch.from_numpy(np.array(enc_lens)), tm.decoder,
                            tm.joiner, tm.rnnt_cfg, beam_size=4, hw_tables=tables)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(ref.num_tokens))
    np.testing.assert_allclose(got.total_logp.numpy(), np.asarray(ref.total_logp),
                               atol=1e-3, rtol=0)
    # the automaton fired: boosted scores differ from the plain decode's
    assert not np.allclose(np.asarray(ref.total_logp), np.asarray(plain.total_logp))


def test_bf16_hotword_pipeline_on_cpu(tiny_bf16, tmp_path):
    """TranscriberPipeline with the bf16 tier and hotword tables on the CPU:
    the result contract holds and the tables stay on the model's device."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    _, tm = tiny_bf16
    seqs, scores = _random_phrases(1, 20, tm.rnnt_cfg.vocab_size)
    tm = dataclasses.replace(tm, hotword_tables=thw.build_hotword_tables(
        seqs, scores, tm.rnnt_cfg.vocab_size)[0]).to("cpu")
    assert tm.hotword_tables.next_state.device.type == "cpu"
    sr = 16000
    t = np.arange(int(sr * 40.0)) / sr
    x = (0.3 * np.sin(2 * np.pi * 280 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2.2 * t))
         + 0.02 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, x, sr)
    res = TranscriberPipeline(path, tm, config={"bypass_vad": True, "max_batch": 2}).run()
    assert res["text"] and res["segments"]
    assert abs(res["duration_sec"] - 40.0) < 1e-6
    assert res["asr_provider_info"] == {"backend": "torch", "device": "cpu"}
    words = [w for s in res["segments"] for w in s["raw_words"]]
    assert words and all(np.isfinite(w["prob"]) for w in words)
    assert all(s["start"] <= s["end"] for s in res["segments"])
    assert not os.path.exists(path + ".asr_phase")
