# The port's golden oracle stack against tests/data/golden_e2e.json and the
# JAX package, on the CPU:
#   * the fixture's true-size Zipformer-30M (the JAX seed-0 weights,
#     converted with models/convert.py; their |sum| checked against the
#     frozen one) exported executable at the fixture's 600 frames: both
#     run_exec_stack (numpy fbank -> graph executor -> oracle beam) and
#     run_torch_stack (ops/fbank -> ZipformerEncoder -> beam_search_batch_cuda,
#     here every kernel's plain twin) give the 148 frozen tokens and words,
#     as the JAX stacks do; the torch stack also its frames, per-token
#     log-probs (2e-3) and total (0.05), the JAX test's tolerances;
#   * utils/beam_search_ref and utils/text equal the JAX copies on seeded
#     inputs (with and without a hotword graph).
import json
import os
import unicodedata

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.models import golden

torch.set_num_threads(4)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "golden_e2e.json")


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fixture_model(fx, tmp_path_factory):
    """The fixture's weights on the port, and their executable export."""
    from sherpa_vietnamese_asr_tpu.models import golden as jgolden

    from tests.test_torch_slice import _convert

    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from sherpa_vietnamese_asr_tpu_torch.models.registry import with_pos_dtype

    model = with_pos_dtype(_convert(jgolden.golden_model(), beam_size=golden.GOLDEN_BEAM),
                           "float32")
    assert abs(golden.weights_abs_sum(model) - fx["weights_abs_sum"]) < 2.0
    d = tmp_path_factory.mktemp("golden_export")
    export_asr_dir(model, str(d), t_in=fx["t_in"])
    return model, str(d)


def _audio(fx):
    return golden.golden_audio(fx["duration_sec"], fx["sample_rate"])


def test_exec_stack_reproduces_frozen_fixture(fx, fixture_model):
    model, d = fixture_model
    tokens, res, enc, feats = golden.run_exec_stack(model, _audio(fx), d)
    assert feats.shape[0] == fx["t_in"]
    assert list(enc.shape) == fx["enc_out_shape"]
    assert tokens == fx["tokens"], (
        f"{sum(a == b for a, b in zip(tokens, fx['tokens']))} of "
        f"{len(fx['tokens'])} tokens match")
    np.testing.assert_array_equal(res["frames"], fx["frames"])
    assert golden.tokens_to_words(tokens, model.id2token) == fx["words"]


def test_torch_stack_reproduces_frozen_fixture(fx, fixture_model):
    model, d = fixture_model
    tokens, res, enc, feats = golden.run_torch_stack(model, _audio(fx))
    assert feats.shape[0] == fx["t_in"]
    assert list(enc.shape) == fx["enc_out_shape"]
    assert tokens == fx["tokens"], (
        f"{sum(a == b for a, b in zip(tokens, fx['tokens']))} of "
        f"{len(fx['tokens'])} tokens match")
    n = len(tokens)
    np.testing.assert_array_equal(res.frames[0, :n].numpy(), fx["frames"])
    np.testing.assert_allclose(res.tok_logp[0, :n].numpy(), fx["tok_logp"], atol=2e-3)
    assert abs(float(res.total_logp[0]) - fx["total_logp"]) < 0.05
    assert golden.tokens_to_words(tokens, model.id2token) == fx["words"]
    # the encoder against the graph executor's, as the fixture's generator held them
    _, _, enc_exec, _ = golden.run_exec_stack(model, _audio(fx), d)
    assert float(np.abs(enc - enc_exec).max()) < 1e-4


def test_golden_model_on_the_cpu_and_default_device(monkeypatch):
    m = golden.golden_model(device="cpu")
    assert m.zip_cfg.pos_dtype == "float32" and m.zip_cfg.compute_dtype == "float32"
    assert m.rnnt_cfg.vocab_size == golden.GOLDEN_VOCAB and m.beam_size == golden.GOLDEN_BEAM
    assert np.isfinite(golden.weights_abs_sum(m))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.golden_model()


def test_tokens_to_words_equals_jax():
    from sherpa_vietnamese_asr_tpu.models import golden as jgolden

    vocab = ["<blk>", "<sos/eos>", "<unk>", "▁Xin", "chào", "▁BẠN", " ơi", "ạ"]
    rng = np.random.default_rng(0)
    for _ in range(20):
        toks = rng.integers(0, len(vocab) + 2, rng.integers(0, 12)).tolist()
        assert golden.tokens_to_words(toks, vocab) == jgolden.tokens_to_words(toks, vocab)


# ---------------------------------------------------------------------------
# beam_search_ref and text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hotwords", [False, True])
def test_ref_beam_search_equals_jax(hotwords):
    from sherpa_vietnamese_asr_tpu.ops.hotword import ContextGraph as JaxGraph
    from sherpa_vietnamese_asr_tpu.utils import beam_search_ref as jref

    from sherpa_vietnamese_asr_tpu_torch.ops.hotword import ContextGraph
    from sherpa_vietnamese_asr_tpu_torch.utils import beam_search_ref as tref

    rng = np.random.default_rng(7)
    v, e, d, t = 40, 12, 6, 25
    emb = rng.standard_normal((v, d)).astype(np.float32)
    w_enc = rng.standard_normal((e, v)).astype(np.float32)
    w_dec = rng.standard_normal((d, v)).astype(np.float32)
    enc = rng.standard_normal((t, e)).astype(np.float32)

    def dec_fn(ctx):
        return np.tanh(emb[ctx].sum(axis=1))

    def joi_fn(enc_rows, dec_rows):
        return enc_rows @ w_enc + dec_rows @ w_dec

    phrases, scores = [[5, 9, 12], [5, 9], [30, 31, 32], [12, 7]], [1.5, 2.0, 1.0, 3.0]
    graphs = (ContextGraph(phrases, scores), JaxGraph(phrases, scores)) if hotwords \
        else (None, None)
    for beam in (1, 4, 8):
        got = tref.ref_beam_search(enc, dec_fn, joi_fn, v, beam_size=beam, ctx_graph=graphs[0])
        want = jref.ref_beam_search(enc, dec_fn, joi_fn, v, beam_size=beam, ctx_graph=graphs[1])
        assert set(got) == set(want)
        for k in ("tokens", "frames", "tok_logp"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["total_logp"] == want["total_logp"]
    for a, b in rng.standard_normal((50, 2)) * 20:
        assert tref.log_add(a, b) == jref.log_add(a, b)


def test_text_equals_jax():
    from sherpa_vietnamese_asr_tpu.utils import text as jtext

    from sherpa_vietnamese_asr_tpu_torch.utils import text as ttext

    syll = ["Xin", "chào", "các", "bạn", "Đường", "đi", "học", "Việt", "Nam", "người",
            "tiếng", "nói", "ĐẸP", "quá", "ạ"]
    rng = np.random.default_rng(3)
    for _ in range(40):
        text = " ".join(rng.choice(syll, rng.integers(1, 12)))
        text = unicodedata.normalize("NFC", text)
        query = " ".join(rng.choice(syll, rng.integers(1, 3)))
        if rng.random() < 0.5:
            query = ttext.normalize_vietnamese(query)
        assert ttext.normalize_vietnamese(text) == jtext.normalize_vietnamese(text)
        assert ttext.fuzzy_score(query, text) == jtext.fuzzy_score(query, text)
        assert ttext.find_fuzzy_matches(query, text) == jtext.find_fuzzy_matches(query, text)
    assert ttext.find_fuzzy_matches("", "x") == [] and ttext.fuzzy_score("x", "") == 0.0
