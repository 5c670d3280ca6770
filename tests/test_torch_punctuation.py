# The port's punctuation stage against the JAX package's, on the CPU:
#   (a) ViBERT at TINY_VIBERT, float32 and the int8 tier (the same int8
#       values as JAX's quantize_vibert_int8), and once at full width, on
#       the same weights (models/convert.vibert_state_dict): logits within
#       1e-5 (tiny) and 1e-4 (full width) of their largest magnitude;
#   (b) GecBert on the same weights and vocab as the JAX GecBert
#       (mesh=None): the same restored text with and without pause hints,
#       and the device decode equal to _run_model + the host _convert;
#   (c) load_vibert on a file of Hugging Face names written on the JAX side,
#       on the port's writer (models/onnx_export_aux) and, like JAX's
#       loader, refusing a graph of onnx_export_aux.build_vibert_graph;
#   (d) the JAX package's tests/test_punctuation.py cases on the port's
#       copies (WordPiece, edits, nudges, chunking, post-processing, pause
#       hints, alignment, buckets, the vocabulary loader, the int8 tier,
#       build_punctuation_restorer) and the port's own rules (mesh "auto"
#       is None here; a failing model makes restore() raise).
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(2)

WORDS = ["xin", "chao", "viet", "nam", "hom", "nay", "troi", "dep", "rat", "vui",
         ",", ".", "?", ":"]


def jax_vibert(seed, cfg=None):
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT, init_vibert_params

    return init_vibert_params(jax.random.PRNGKey(seed), cfg or TINY_VIBERT)


def port_vibert(params, cfg=None):
    """The port's ViBert on the CPU from a JAX tree (float32 or int8)."""
    from sherpa_vietnamese_asr_tpu_torch.models.convert import (
        vibert_from_numpy,
        vibert_state_dict,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import TINY_VIBERT, ViBertConfig

    cfg = TINY_VIBERT if cfg is None else ViBertConfig(**dataclasses.asdict(cfg))
    return vibert_from_numpy(vibert_state_dict(jax.tree.map(np.asarray, params)), cfg,
                             device="cpu")


def gec_vocab():
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab += [c, "##" + c]
    return vocab + WORDS


def gec_pair(seed=0, **kw):
    """(JAX GecBert, port GecBert) on the same tiny weights and vocab."""
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT
    from sherpa_vietnamese_asr_tpu.pipeline.gec import GecBert as JaxGec
    from sherpa_vietnamese_asr_tpu.utils.wordpiece import WordPieceTokenizer as JaxTok

    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    params = jax_vibert(seed)
    return (JaxGec(params, TINY_VIBERT, JaxTok(gec_vocab()), mesh=None, **kw),
            GecBert(port_vibert(params), WordPieceTokenizer(gec_vocab()), **kw))


def _inputs(rng, cfg, b=3, t=24, w=8):
    ids = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    att = np.ones((b, t), np.int32)
    att[1, 10:] = 0
    att[-1] = 0  # a padding row: uniform attention, no NaN
    offs = np.sort(rng.integers(0, 10, (b, w)), axis=1).astype(np.int32)
    return ids, att, np.zeros_like(ids), offs


def _forward_pair(params, cfg, inputs):
    from sherpa_vietnamese_asr_tpu.models.vibert import vibert_forward

    ref = vibert_forward(params, *inputs, cfg)
    model = port_vibert(params, cfg)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_tiny_vibert_matches_jax(tier):
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT, quantize_vibert_int8

    from sherpa_vietnamese_asr_tpu_torch.models.vibert import quantize_vibert_int8 as quantize

    params = jax_vibert(0)
    if tier == "int8":
        qparams = quantize_vibert_int8(params)
        # the port quantizes a float32 model to the same int8 values and scales
        want = port_vibert(qparams).state_dict()
        for key, value in quantize(port_vibert(params)).state_dict().items():
            assert value.dtype == want[key].dtype and torch.equal(value, want[key]), key
        params = qparams
    ref, got = _forward_pair(params, TINY_VIBERT, _inputs(np.random.default_rng(0), TINY_VIBERT))
    for r, g in zip(ref, got):
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


def test_full_width_vibert_matches_jax():
    from sherpa_vietnamese_asr_tpu.models.vibert import ViBertConfig

    cfg = ViBertConfig()
    rng = np.random.default_rng(23)
    ids = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    att = np.ones((2, 64), np.int32)
    att[1, 48:] = 0
    offs = np.sort(rng.integers(0, 48, (2, 16)), axis=1).astype(np.int32)
    ref, got = _forward_pair(jax_vibert(23, cfg), cfg, (ids, att, np.zeros_like(ids), offs))
    for r, g in zip(ref, got):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


TEXT = "xin chao viet nam hom nay troi dep rat vui " * 6


@pytest.mark.parametrize("hints", [False, True])
def test_gec_restores_the_jax_text(hints):
    jgec, gec = gec_pair(chunk_size=16, overlap_size=6, min_words_cut=2,
                         mini_batch_size=4, confidence=0.05, case_confidence=0.02)
    words = TEXT.split()
    pause = ([[0.05, 0.3, 1.5, 0.0][i % 4] for i in range(len(words))]
             if hints else None)
    assert gec(TEXT.strip(), pause_hints=pause) == jgec(TEXT.strip(), pause_hints=pause)
    batch = [TEXT.strip(), "hom nay troi dep", "rat vui"]
    assert gec(batch) == jgec(batch)


def test_run_decode_matches_host_convert():
    """vibert_decode (packed upload, bias and nudges on the device, reduced
    downloads) == _convert(_run_model(...)), with the JAX numbers too."""
    jgec, gec = gec_pair(mini_batch_size=4, confidence=0.05, case_confidence=0.02)
    sents = [["xin", "chao", "viet", "nam"], ["hom", "nay", "troi", "dep", "rat", "vui"],
             ["mot", "hai", "ba"], ["rat", "vui"], ["nam", "nay", "dep"]]
    hints = [[0.0, 1.5, 0.0, 0.0], None, [0.05, 0.3, 0.0], [2.0, 0.0], None]
    inputs = gec.preprocess(sents)
    logits, detect = gec._run_model(inputs)
    for h in (hints, None):
        p_ref, i_ref, e_ref = gec._convert(logits.copy(), detect, pause_hints_batch=h)
        p_dev, i_dev, e_dev = gec._run_decode(inputs, hints_rows=h)
        assert i_dev == i_ref
        np.testing.assert_allclose(p_dev, p_ref, atol=2e-6)
        np.testing.assert_allclose(e_dev, e_ref, atol=2e-6)
        p_j, i_j, e_j = jgec._run_decode(jgec.preprocess(sents), hints_rows=h)
        assert i_dev == i_j
        np.testing.assert_allclose(p_dev, p_j, atol=2e-6)
        np.testing.assert_allclose(e_dev, e_j, atol=2e-6)


def _hf_file(params, path):
    """A vibert-capu.onnx of Hugging Face names written on the JAX side."""
    from tests.test_onnx_import import _vibert_tensors, make_onnx

    tensors = {k: np.asarray(v) for k, v in _vibert_tensors(params).items()}
    with open(path, "wb") as f:
        f.write(make_onnx(tensors))
    return tensors


def test_load_vibert_reads_hf_names_and_the_port_writer(tmp_path):
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_vibert as jax_load
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT

    from sherpa_vietnamese_asr_tpu_torch.models.convert import vibert_state_dict
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import export_vibert_files
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_vibert
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBertConfig

    params = jax.tree.map(np.asarray, jax_vibert(7))
    want = vibert_state_dict(params)
    inferred = ViBertConfig(**dict(dataclasses.asdict(TINY_VIBERT), heads=0))
    inferred = dataclasses.replace(inferred, heads=max(1, TINY_VIBERT.hidden // 64))
    _hf_file(params, tmp_path / "hf.onnx")
    paths = export_vibert_files(port_vibert(params), gec_vocab(), str(tmp_path / "port"))
    for path in (str(tmp_path / "hf.onnx"), paths["vibert-capu.onnx"]):
        state, cfg = load_vibert(path)
        assert cfg == inferred
        assert set(state) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(state[key], value, err_msg=key)
    # the JAX loader reads the port's file into the same tree
    jparams, jcfg = jax_load(paths["vibert-capu.onnx"])
    assert jcfg.layers == TINY_VIBERT.layers and jcfg.vocab_size == TINY_VIBERT.vocab_size
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(paths["vocab.txt"], encoding="utf-8") as f:
        assert f.read().split("\n")[:-1] == gec_vocab()


def test_load_vibert_refuses_a_build_vibert_graph_file_like_jax(tmp_path):
    """onnx_export_aux.build_vibert_graph names its initializers after the
    graph (embeddings.word, layer0.q.weight, positions cut to T as a
    constant): neither package's loader maps it."""
    from sherpa_vietnamese_asr_tpu.models import onnx_export_aux as ax
    from sherpa_vietnamese_asr_tpu.models.onnx_import import ImportReport as JaxReport
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_vibert as jax_load
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT

    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import ImportReport, load_vibert
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import TINY_VIBERT as PORT_TINY

    path = tmp_path / "graph.onnx"
    path.write_bytes(ax.build_vibert_graph(jax_vibert(1), TINY_VIBERT, 2, 16, 8))
    for loader, report, cfg in ((jax_load, JaxReport, TINY_VIBERT),
                                (load_vibert, ImportReport, PORT_TINY)):
        with pytest.raises(report, match="word_embeddings"):
            loader(str(path))
        with pytest.raises(report, match="position_embeddings"):
            loader(str(path), cfg=cfg)


# ---- the JAX package's tests/test_punctuation.py, on the port ----

def _tiny_gec(**kw):
    return gec_pair(**kw)[1]


def test_wordpiece_tokenizer():
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    tok = WordPieceTokenizer(["[PAD]", "[UNK]", "ab", "##cd", "##c", "x"])
    assert tok.tokenize_word("ab") == [2]
    assert tok.tokenize_word("abcd") == [2, 3]
    assert tok.tokenize_word("abc") == [2, 4]
    assert tok.tokenize_word("zzz") == [1]
    ids, wids = tok.encode_words(["ab", "x"])
    assert ids == [2, 5] and wids == [0, 1]


def test_get_target_sent_by_edits():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import get_target_sent_by_edits

    tokens = ["xin", "chao", "viet", "nam"]
    assert get_target_sent_by_edits(tokens, [(4, 4, "$APPEND_.", 0.9)]) == tokens + ["."]
    assert get_target_sent_by_edits(tokens, [(0, 1, "$TRANSFORM_CASE_CAPITAL", 0.9)]) == \
        ["Xin", "chao", "viet", "nam"]
    assert get_target_sent_by_edits(["a", ".", "b"], [(1, 1, "$APPEND_.", 0.9)]) == \
        ["a", ".", "b"]


def test_convert_pause_nudges():
    gec = _tiny_gec()
    n_labels = len(gec.labels)
    logits = np.zeros((1, 4, n_labels), np.float32)
    logits[:, :, gec.noop_index] = 5.0
    detect = np.zeros((1, 4, len(gec.d_tags)), np.float32)
    logits[0, 2, gec.noop_index] = 1.0
    logits[0, 2, gec.append_period_index] = 0.9
    _, idxs, _ = gec._convert(logits.copy(), detect, pause_hints_batch=[[0.0, 1.5, 0.0]])
    assert idxs[0][2] == gec.append_period_index
    _, idxs2, _ = gec._convert(logits.copy(), detect)
    assert idxs2[0][2] == gec.noop_index
    logits3 = np.zeros((1, 4, n_labels), np.float32)
    logits3[0, 1, gec.append_comma_index] = 1.0
    logits3[0, 1, gec.noop_index] = 0.9
    _, idxs3, _ = gec._convert(logits3.copy(), detect, pause_hints_batch=[[0.05, 0.0, 0.0]])
    assert idxs3[0][1] == gec.noop_index


def test_device_nudges_use_the_biased_argmax():
    """vibert_decode decides the nudges on the probabilities after the
    confidence bias and before any nudge (word wi's gap at token wi+1)."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline import gec as gec_mod

    gec = _tiny_gec(confidence=0.05)
    n = len(gec.labels)

    class Fixed(torch.nn.Module):  # logits chosen per token, whatever the ids
        cfg = gec.cfg

        def forward(self, ids, att, types, offs):
            lg = torch.zeros(ids.shape[0], offs.shape[1], n)
            lg[:, :, gec.noop_index] = 1.0
            lg[:, 2, gec.append_period_index] = 1.1  # $KEEP wins only with the bias
            lg[:, 3, gec.append_comma_index] = 1.5  # the comma wins even with the bias
            return lg, torch.zeros(ids.shape[0], offs.shape[1], len(gec.d_tags))

    t, w = 4, 4
    packed = torch.zeros(2, 2 * t + w, dtype=torch.int32)
    hints = torch.tensor([[np.nan, 0.0, 1.5, 0.05], [np.nan] * 4])
    mp, ix, _ = gec_mod.vibert_decode(Fixed(), packed, hints, *gec._decode_vecs, t=t, w=w,
                                      noop_index=gec.noop_index,
                                      incorr_index=gec.incorr_index)
    assert ix[0, 2] == gec.append_period_index  # gap 1.5 after the biased $KEEP won
    assert ix[0, 3] == gec.noop_index           # gap 0.05 holds the comma back
    assert ix[1, 2] == gec.noop_index and ix[1, 3] == gec.append_comma_index  # NaN: untouched
    assert torch.isfinite(mp).all()


def test_split_and_merge_chunks_identity():
    gec = _tiny_gec(chunk_size=16, overlap_size=6, min_words_cut=2)
    words = [f"w{i}" for i in range(50)]
    chunks, indices, _ = gec.split_chunks([words])
    assert indices == [(0, len(chunks))]
    assert all(len(c) <= 16 for c in chunks)
    assert gec.merge_chunks(chunks) == " ".join(words)


def test_gec_handle_batch_runs_with_random_weights():
    gec = _tiny_gec(chunk_size=16, overlap_size=6, min_words_cut=2, mini_batch_size=4)
    out = gec(TEXT.strip())
    assert isinstance(out, list) and len(out) == 1 and out[0]


def test_post_process_rules():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import PunctuationRestorer

    pp = PunctuationRestorer.post_process
    assert pp("xin chao ,, viet nam") == "Xin chao, viet nam"
    assert pp("a : b") == "A b"
    assert pp("a ,. b") == "A. B"
    assert pp("xin chao. tam biet") == "Xin chao. Tam biet"
    assert pp("mot, hai, ba, bon nam.").count(",") == 1


def test_build_pause_hints_and_alignment():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.alignment import (
        align_sentences,
        build_pause_hints,
        split_sentences,
    )

    words, t = [], 0.0
    for i, w in enumerate("xin chao viet nam hom nay troi dep".split()):
        words.append({"text": w, "start": t, "end": t + 0.2})
        t += 0.3 if i != 3 else 1.5
    hints = build_pause_hints(words)
    assert hints[3] > 1.0 and hints[-1] == 1.0 and abs(hints[0] - 0.1) < 1e-6
    assert build_pause_hints(words, word_speaker=[0, 0, 1, 1, 1, 1, 1, 1])[1] >= 1.0
    segs = align_sentences(split_sentences("Xin chao viet nam. Hom nay troi dep."), words)
    assert len(segs) == 2 and segs[0]["text"] == "Xin chao viet nam."
    assert abs(segs[0]["start"]) < 1e-6 and segs[1]["raw_words"][0]["text"] == "hom"


def test_align_sentences_with_speakers_split():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.alignment import (
        align_sentences_with_speakers,
        split_sentences,
    )

    words = [{"text": w, "start": 0.3 * i, "end": 0.3 * i + 0.2}
             for i, w in enumerate("mot hai ba bon".split())]
    names = ["Người nói 1"] * 2 + ["Người nói 2"] * 2
    segs = align_sentences_with_speakers(split_sentences("Mot hai ba bon."), words,
                                         [0, 0, 1, 1], names)
    assert len(segs) == 2 and segs[0]["speaker_id"] == 0 and segs[1]["speaker_id"] == 1
    assert segs[0]["text"].lower().startswith("mot") and "ba" in segs[1]["text"]


def test_gec_shape_buckets_bounded():
    gec = _tiny_gec(chunk_size=16, overlap_size=6, min_words_cut=2, mini_batch_size=2)
    seen = set()
    for words in (["xin"] * 3, ["chao"] * 16, ["q" * 40] * 16, ["z" * 300] * 16):
        inputs = gec.preprocess([words])
        t, w = inputs["input_ids"].shape[1], inputs["input_offsets"].shape[1]
        seen.add((t, w))
        assert t in (64, 128, 256, 512) and w in (64, 128, 256, 512)
        assert t <= gec.cfg.max_position
    assert len(seen) > 1


def test_load_gec_vocabulary_matches_reference_format(tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import (
        DEFAULT_D_TAGS,
        DEFAULT_LABELS,
        load_gec_vocabulary,
    )

    vocdir = tmp_path / "vocabulary"
    vocdir.mkdir()
    (vocdir / "non_padded_namespaces.txt").write_text("*tags\n*labels\n")
    (vocdir / "labels.txt").write_text("\n".join(DEFAULT_LABELS) + "\n")
    (vocdir / "d_tags.txt").write_text("\n".join(DEFAULT_D_TAGS) + "\n")
    (vocdir / "tokens.txt").write_text("a\n@@NEWLINE@@\nb\n")
    ns = load_gec_vocabulary(str(vocdir))
    assert ns["labels"] == DEFAULT_LABELS and ns["d_tags"] == DEFAULT_D_TAGS
    assert ns["tokens"] == ["@@PADDING@@", "a", "\n", "b"]


def test_int8_tier_close_to_f32_and_runs():
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import TINY_VIBERT, quantize_vibert_int8
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    model = port_vibert(jax_vibert(0))
    qmodel = quantize_vibert_int8(model)
    assert qmodel.bert.encoder.layer[0].attention.self.query.weight_q.dtype == torch.int8
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, TINY_VIBERT.vocab_size, (2, 24)))
    att, tt = torch.ones(2, 24, dtype=torch.int32), torch.zeros(2, 24, dtype=torch.int32)
    offs = torch.arange(12)[None].repeat(2, 1)
    with torch.no_grad():
        lg, dt = model(ids, att, tt, offs)
        lgq, dtq = qmodel(ids, att, tt, offs)
    assert float((lgq - lg).abs().max()) < 0.2 and float((dtq - dt).abs().max()) < 0.2
    out = GecBert(qmodel, WordPieceTokenizer(gec_vocab()), mini_batch_size=4)(
        "xin chao viet nam hom nay troi dep")
    assert isinstance(out, list) and len(out) == 1 and out[0]


def test_build_restorer_prefer_int8_reads_a_model_dir(tmp_path, monkeypatch):
    import sherpa_vietnamese_asr_tpu_torch.models.vibert as vb
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import export_vibert_files
    from sherpa_vietnamese_asr_tpu_torch.pipeline import punctuation as pc

    monkeypatch.setenv("SVT_MODELS_DIR", str(tmp_path / "no_models"))
    with monkeypatch.context() as m:  # the random fallback at tiny size
        m.setattr(vb, "ViBertConfig", lambda: vb.TINY_VIBERT)
        r = pc.build_punctuation_restorer(prefer_int8=True, mini_batch_size=4, device="cpu")
    assert r.gec_model.model.int8 and r.gec_model.device == torch.device("cpu")
    assert r.restore("xin chao viet nam") is not None
    model = port_vibert(jax_vibert(3))
    export_vibert_files(model, gec_vocab(), str(tmp_path / "dir"))
    r = pc.build_punctuation_restorer(model_dir=str(tmp_path / "dir"), device="cpu")
    assert r.gec_model.tokenizer.vocab["rat"] == gec_vocab().index("rat")
    for key, value in model.state_dict().items():
        assert torch.equal(r.gec_model.model.state_dict()[key], value), key


def test_one_device_only_and_failures_propagate():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import PunctuationRestorer
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    # mesh "auto" is default_mesh(): None on a host without several cards.
    gec = GecBert(port_vibert(jax_vibert(0)), WordPieceTokenizer(gec_vocab()), mesh="auto")
    assert gec.mesh is None and gec.mini_batch_size == 32

    def failing(text, pause_hints=None, progress_callback=None):
        raise RuntimeError("vibert failed on the card")

    with pytest.raises(RuntimeError, match="vibert failed"):
        PunctuationRestorer(failing).restore("xin chao")
