# The summarizer LLM of the port (models/gguf.py, models/llama.py,
# models/convert.llama_from_numpy, web_service/summarizer.py) against the JAX
# package's on one tiny GGUF: TINY_LLAMA, weights from init_llama_params
# (PRNGKey 0), written once by the JAX writer, with F32, Q8_0, Q4_K, Q5_K and
# Q6_K tensors. Tolerances: logits within 1e-5 (both float32, one
# arithmetic); token ids, metadata, dequantised tensors and texts equal.
import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.models import gguf as jgguf
from sherpa_vietnamese_asr_tpu.models import llama as jllama
from sherpa_vietnamese_asr_tpu.web_service import summarizer as jsum
from sherpa_vietnamese_asr_tpu_torch.models import gguf as tgguf
from sherpa_vietnamese_asr_tpu_torch.models import llama as tllama
from sherpa_vietnamese_asr_tpu_torch.models.convert import llama_from_numpy
from sherpa_vietnamese_asr_tpu_torch.web_service import summarizer as tsum

LOGIT_TOL = 1e-5
TRANSCRIPT = ("xin chao viet nam. hom nay hop ve du an moi. "
              "can hoan thanh bao cao truoc thu sau.")


def _quantize_q5_k(arr):
    """f32 array (size % 256 == 0) -> Q5_K raw bytes in llama.cpp's layout
    (d f16 | dmin f16 | scales 12B | qh 32B | qs 128B): a per-32-group affine
    encoder, as the JAX package's quantize_q4_k with 31 levels."""
    flat = np.asarray(arr, np.float32).reshape(-1, 8, 32)
    blocks = flat.shape[0]
    m_g = -np.minimum(flat.min(axis=2), 0.0)
    t_g = (np.maximum(flat.max(axis=2), 0.0) + m_g) / 31.0
    d = np.maximum(t_g.max(axis=1, keepdims=True) / 63.0, 1e-12)
    dmin = np.maximum(m_g.max(axis=1, keepdims=True) / 63.0, 1e-12)
    d = d.astype(np.float16).astype(np.float32)
    dmin = dmin.astype(np.float16).astype(np.float32)
    sc6 = np.clip(np.round(t_g / d), 0, 63)
    mn6 = np.clip(np.round(m_g / dmin), 0, 63)
    scale = np.where(sc6 == 0, 1e-12, d * sc6)[:, :, None]
    q = np.clip(np.round((flat + (dmin * mn6)[:, :, None]) / scale), 0, 31).astype(np.uint8)
    rec = np.zeros(blocks, dtype=jgguf._Q5K_DTYPE)
    rec["d"] = d[:, 0].astype(np.float16)
    rec["dmin"] = dmin[:, 0].astype(np.float16)
    rec["scales"] = jgguf._pack_scale_min_k4(sc6, mn6)
    rec["qs"] = ((q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)).reshape(blocks, 128)
    qh = np.zeros((blocks, 32), np.uint8)
    for g in range(8):
        qh |= ((q[:, g] >> 4) & 1) << g
    rec["qh"] = qh
    return rec.tobytes()


def _tensors(params):
    t = {"token_embd.weight": np.asarray(params["tok_emb"]),
         "output_norm.weight": np.asarray(params["out_norm"])}
    if params.get("output") is not None:
        t["output.weight"] = np.asarray(params["output"])
    for i, lp in enumerate(params["layers"]):
        b = f"blk.{i}"
        t[f"{b}.attn_norm.weight"] = np.asarray(lp["attn_norm"])
        t[f"{b}.ffn_norm.weight"] = np.asarray(lp["ffn_norm"])
        for src, dst in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                         ("wo", "attn_output"), ("w_gate", "ffn_gate"),
                         ("w_up", "ffn_up"), ("w_down", "ffn_down")):
            t[f"{b}.{dst}.weight"] = np.asarray(lp[src]).T  # ggml [out, in]
    return t


def _meta(cfg, context=None):
    """tests/test_llama_gguf.py's sentencepiece-style vocabulary."""
    n_bytes = 64
    vocab = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(n_bytes)]
    vocab += ["▁xin", "▁chao", "▁viet", "▁nam", "▁hom", "▁nay",
              "x", "i", "n", "ch", "ao"]
    vocab = vocab[: cfg.vocab_size]
    while len(vocab) < cfg.vocab_size:
        vocab.append(f"<extra_{len(vocab)}>")
    return {
        "general.architecture": "llama",
        "general.alignment": 32,
        "llama.embedding_length": cfg.dim,
        "llama.block_count": cfg.n_layers,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.feed_forward_length": cfg.ffn_dim,
        "llama.context_length": context or cfg.max_seq,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "tokenizer.ggml.tokens": vocab,
        "tokenizer.ggml.scores": [float(-i) for i in range(len(vocab))],
        "tokenizer.ggml.token_type": ([2] + [3] * 2 + [6] * n_bytes
                                      + [1] * (len(vocab) - 3 - n_bytes)),
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }


QUANT = {"blk.0.ffn_up.weight": jgguf.GGML_Q8_0, "blk.0.ffn_gate.weight": jgguf.GGML_Q4_K,
         "blk.1.ffn_gate.weight": 13, "blk.1.attn_output.weight": jgguf.GGML_Q6_K}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(paths, JAX params): "f32q8" (one Q8_0 tensor), "kquant" (Q8_0, Q4_K,
    Q5_K, Q6_K), "context1024" (F32, context length 1024)."""
    cfg = jllama.TINY_LLAMA
    params = jllama.init_llama_params(jax.random.PRNGKey(0), cfg)
    tensors = _tensors(params)
    d = tmp_path_factory.mktemp("gguf")
    paths = {"f32q8": str(d / "tiny-f32q8.gguf"), "kquant": str(d / "tiny-kquant.gguf"),
             "context1024": str(d / "tiny-1024.gguf")}
    jgguf.write_gguf(paths["f32q8"], _meta(cfg), tensors, q8_names=("blk.0.ffn_up.weight",))
    with pytest.MonkeyPatch.context() as mp:  # the JAX writer has no Q5_K encoder
        mp.setitem(jgguf._QUANTIZERS, 13, _quantize_q5_k)
        jgguf.write_gguf(paths["kquant"], _meta(cfg), tensors, quant_types=QUANT)
    jgguf.write_gguf(paths["context1024"], _meta(cfg, 1024), tensors)
    return paths, params


@pytest.mark.parametrize("name", ["f32q8", "kquant"])
def test_read_gguf_equals_jax(tiny, name):
    paths, _ = tiny
    ref = jgguf.read_gguf(paths[name])
    got = tgguf.read_gguf(paths[name])
    assert got["metadata"] == ref["metadata"]
    assert set(got["tensors"]) == set(ref["tensors"])
    for k, v in ref["tensors"].items():
        assert got["tensors"][k].dtype == v.dtype
        np.testing.assert_array_equal(got["tensors"][k], v, err_msg=k)
    assert got["infos"] == ref["infos"]
    kinds = {t for _, t in got["infos"].values()}
    assert kinds == ({0, 8, 12, 13, 14} if name == "kquant" else {0, 8})


def _jax_forward(params, cfg, ids):
    return np.asarray(jllama.llama_forward(params, jnp.asarray(ids, jnp.int32), cfg))


@pytest.mark.parametrize("name", ["f32q8", "kquant"])
def test_load_gguf_llama_forward_matches_jax(tiny, name):
    paths, _ = tiny
    jp, jcfg, jtok, jmeta = jllama.load_gguf_llama(paths[name])
    model, cfg, tok, meta = tllama.load_gguf_llama(paths[name], device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert model.device.type == "cpu" and model.output is None
    ids = np.arange(1, 40) % cfg.vocab_size
    ref = _jax_forward(jp, jcfg, ids)
    got = model(ids).numpy()
    assert np.abs(got - ref).max() <= LOGIT_TOL * max(1.0, np.abs(ref).max())
    assert tok.vocab_size() == jtok.vocab_size()


def test_load_gguf_llama_defaults_to_the_card(tiny):
    paths, _ = tiny
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.load_gguf_llama(paths["f32q8"])


@pytest.fixture(scope="module")
def loaded(tiny):
    paths, _ = tiny
    return jllama.load_gguf_llama(paths["f32q8"]), tllama.load_gguf_llama(paths["f32q8"],
                                                                          device="cpu")


def _eos_at(jp, jcfg, prompt, k):
    """The token JAX's greedy emits k-th, used as eos_id: generation must
    stop before it."""
    return jllama.generate(jp, jcfg, prompt, max_new_tokens=k + 1)[k]


@pytest.mark.parametrize("case", ["plain", "eos", "truncated", "no_room"])
def test_generate_equals_jax(loaded, case):
    (jp, jcfg, _, _), (model, _, _, _) = loaded
    prompt, n, eos = [1, 5, 9, 12], 12, None
    if case == "eos":
        eos = _eos_at(jp, jcfg, prompt, 5)
        n = 20
    elif case == "truncated":  # 90 + 30 > max_seq 96: the prompt keeps its last 66
        prompt, n = list(np.arange(90) % 90 + 3), 30
    elif case == "no_room":  # max_new_tokens >= max_seq: JAX drops the whole prompt
        prompt, n = [1, 5, 9], 200
    ref = jllama.generate(jp, jcfg, prompt, max_new_tokens=n, eos_id=eos)
    got = tllama.generate(model, prompt, max_new_tokens=n, eos_id=eos)
    assert got == ref
    if case == "eos":
        assert eos not in got and len(got) < n
    if case == "no_room":
        assert len(got) == jcfg.max_seq  # positions 0..max_seq-1, then the cache is full


def test_kv_cache_matches_full_forward(loaded):
    _, (model, _, _, _) = loaded
    prompt = [1, 5, 9, 12]
    out = tllama.generate(model, prompt, max_new_tokens=8)
    ids, ref = list(prompt), []
    for _ in range(8):
        tok = int(torch.argmax(model(ids)[-1]))
        ref.append(tok)
        ids.append(tok)
    assert out == ref
    logits, cache = model.prefill(prompt)
    full = model(prompt)
    assert torch.equal(torch.argmax(logits), torch.argmax(full[-1]))
    assert torch.allclose(logits, full[-1], atol=LOGIT_TOL)
    assert cache[0].shape == (model.cfg.n_layers, model.cfg.max_seq, model.cfg.n_kv_heads,
                              model.cfg.head_dim)


def test_detokenize_equals_jax(loaded):
    (_, _, jtok, _), (_, _, tok, _) = loaded
    ids = [tok.piece_to_id["▁xin"], tok.piece_to_id["▁chao"], tok.piece_to_id["<0x21>"],
           tok.piece_to_id["ch"], tok.piece_to_id["ao"], tok.piece_to_id["<0x0A>"]]
    assert tllama.detokenize(tok, ids) == jllama.detokenize(jtok, ids) == "xin chao!chao\n"
    assert tok.encode(TRANSCRIPT) == jtok.encode(TRANSCRIPT)


@pytest.mark.parametrize("tied", [True, False])
def test_llama_from_numpy_matches_jax(tied):
    cfg = jllama.TINY_LLAMA
    params = jllama.init_llama_params(jax.random.PRNGKey(3), cfg)
    if not tied:
        params["output"] = jax.random.normal(jax.random.PRNGKey(4),
                                             (cfg.vocab_size, cfg.dim)) * 0.05
    model = llama_from_numpy(jax.tree.map(np.asarray, params), tllama.TINY_LLAMA,
                             device="cpu")
    assert (model.output is None) == tied
    ids = np.arange(2, 50) % cfg.vocab_size
    ref = _jax_forward(params, cfg, ids)
    got = model(ids).numpy()
    assert np.abs(got - ref).max() <= LOGIT_TOL * max(1.0, np.abs(ref).max())
    assert tllama.generate(model, [1, 2, 3], max_new_tokens=10) == \
        jllama.generate(params, cfg, [1, 2, 3], max_new_tokens=10)


def test_random_llama_uses_the_generator():
    cfg = tllama.TINY_LLAMA
    a = tllama.random_llama(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    b = tllama.random_llama(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    c = tllama.random_llama(cfg, seed=8, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if x.dim() == 2:
            assert not torch.equal(x, z), name
    assert abs(float(a.tok_emb.std()) - 0.02) < 0.005


@pytest.fixture
def clean_llm_cache(monkeypatch):
    monkeypatch.setattr(jsum, "_LOCAL_LLM", {})
    monkeypatch.setattr(tsum, "_LOCAL_LLM", {})


@pytest.mark.parametrize("name,max_new", [("f32q8", 512), ("f32q8", 40), ("context1024", 64)])
def test_local_generate_equals_jax(tiny, clean_llm_cache, name, max_new):
    """The summarizer's prompt through both packages' local backend; 512 new
    tokens leave the 96-position model no prompt (the reference's own
    truncation), 40 keep its last 56 tokens, the 1024-context file keeps it
    whole."""
    paths, _ = tiny
    prompt = ("Summarize this Vietnamese meeting transcript chunk as JSON "
              'with keys "title", "summary", "key_points" (list), '
              '"action_items" (list):\n\n' + TRANSCRIPT)
    ref = jsum._local_generate(prompt, paths[name], max_new_tokens=max_new)
    got = tsum._local_generate(prompt, paths[name], max_new_tokens=max_new, device="cpu")
    assert got == ref
    assert (paths[name], "cpu") in tsum._LOCAL_LLM  # loaded once a path and device


def test_summarize_equals_jax(tiny, clean_llm_cache, monkeypatch):
    paths, _ = tiny
    monkeypatch.setenv("SVT_SUMMARIZER_GGUF", paths["f32q8"])
    ref = jsum.Summarizer(backend="auto")
    got = tsum.Summarizer(backend="auto", device="cpu")
    assert got.backend == ref.backend == "local"
    assert got.status()["local_gguf"] == paths["f32q8"]
    out = got.summarize(TRANSCRIPT)
    assert out == ref.summarize(TRANSCRIPT)
    assert tsum.validate_summary(out)


def test_local_failure_propagates_where_jax_falls_back(tiny, clean_llm_cache, monkeypatch):
    """The port falls back to the extractive summary only for output that is
    no summary JSON and for an unreachable Ollama; a failure of the local
    model (here generate raising, and a GGUF path that does not exist)
    propagates, where the JAX Summarizer returns the extractive summary."""
    paths, _ = tiny

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(jllama, "generate", boom)
    monkeypatch.setattr(tllama, "generate", boom)
    ref = jsum.Summarizer(gguf_path=paths["f32q8"]).summarize(TRANSCRIPT)
    assert ref == jsum.extractive_summary(TRANSCRIPT)
    port = tsum.Summarizer(gguf_path=paths["f32q8"], device="cpu")
    assert port.backend == "local"
    with pytest.raises(RuntimeError, match="device fault"):
        port.summarize(TRANSCRIPT)
    missing = paths["f32q8"] + ".missing"
    assert jsum.Summarizer(backend="local", gguf_path=missing).summarize(TRANSCRIPT) == ref
    with pytest.raises(OSError):
        tsum.Summarizer(backend="local", gguf_path=missing, device="cpu").summarize(TRANSCRIPT)


def test_unreachable_ollama_falls_back():
    url = "http://127.0.0.1:9"  # discard port on this host: refused
    s = tsum.Summarizer(backend="ollama", ollama_url=url, device="cpu")
    assert s.summarize(TRANSCRIPT) == tsum.extractive_summary(TRANSCRIPT) == \
        jsum.Summarizer(backend="ollama", ollama_url=url).summarize(TRANSCRIPT)


def test_no_valid_summary_is_the_fallback_reason(monkeypatch):
    monkeypatch.setattr(tsum, "_local_generate", lambda *a, **k: "not json")
    s = tsum.Summarizer(backend="local", gguf_path="unused.gguf", device="cpu")
    with pytest.raises(tsum.NoValidSummary):
        s._summarize_llm(TRANSCRIPT)
    assert s.summarize(TRANSCRIPT) == tsum.extractive_summary(TRANSCRIPT)
    good = '{"title": "t", "summary": "s", "key_points": [], "action_items": []}'
    monkeypatch.setattr(tsum, "_local_generate", lambda *a, **k: good)
    assert s.summarize(TRANSCRIPT)["title"] == "t"


def test_gguf_writer_header_is_the_jax_writers(tiny, tmp_path):
    """The port's copy writes byte-identical files."""
    paths, params = tiny
    t = _tensors(params)
    a, b = tmp_path / "a.gguf", tmp_path / "b.gguf"
    jgguf.write_gguf(str(a), _meta(jllama.TINY_LLAMA), t, q8_names=("blk.0.ffn_up.weight",))
    tgguf.write_gguf(str(b), _meta(jllama.TINY_LLAMA), t, q8_names=("blk.0.ffn_up.weight",))
    assert a.read_bytes() == b.read_bytes()
    assert struct.unpack("<I", b.read_bytes()[4:8])[0] == 3


def test_rope_rotates_halves_as_jax():
    """The rotary convention is the JAX package's (the two halves of a head,
    not llama.cpp's adjacent pairs): the port's _rope against JAX's."""
    x = np.random.default_rng(0).standard_normal((7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)
    ref = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
