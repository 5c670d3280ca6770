# The port's beam search (plain twin sherpa_vietnamese_asr_tpu_torch/ops/
# beam_search.py, reached through the kernel wrapper on CPU tensors) against
# the JAX package's XLA scan and its Pallas kernel in interpret mode, with
# the same decoder/joiner weights and encoder frames.
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner, RnntConfig
from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda, cuda_lib
from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import (
    HotwordTables, beam_search_batch,
)

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "beam_fixture.json")


def _jax_rnnt(vocab_size, seed=0, enc_dim=256, dim=512, jcfg=None):
    import jax

    from sherpa_vietnamese_asr_tpu.models import rnnt as jr

    cfg = jcfg or jr.RnntConfig(vocab_size=vocab_size, encoder_out_dim=enc_dim,
                                decoder_dim=dim, joiner_dim=dim)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return cfg, jr.init_decoder_params(k1, cfg), jr.init_joiner_params(k2, cfg)


def _port_rnnt(jcfg, dec, joi):
    import jax

    cfg = RnntConfig(**dataclasses.asdict(jcfg))
    dec, joi = jax.tree.map(np.asarray, (dec, joi))
    d, j = Decoder(cfg), Joiner(cfg)
    convert._load(d, convert.decoder_state_dict(dec))
    convert._load(j, convert.joiner_state_dict(joi))
    return cfg, d.eval(), j.eval()


def _port_tables(tables):
    return HotwordTables(
        next_state=torch.from_numpy(np.array(tables.next_state)),
        delta=torch.from_numpy(np.array(tables.delta)),
        node_score=torch.from_numpy(np.array(tables.node_score)))


def _run_port(enc, lens, cfg, dec, joi, beam, tables=None):
    return beam_search_cuda.beam_search_batch_cuda(
        torch.from_numpy(enc), torch.from_numpy(np.asarray(lens, np.int32)),
        dec, joi, cfg, beam_size=beam,
        hw_tables=None if tables is None else _port_tables(tables))


def _assert_same(got, ref, atol=1e-4):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(ref.frames))
    np.testing.assert_array_equal(got.num_tokens.numpy(),
                                  np.asarray(ref.num_tokens))
    np.testing.assert_allclose(got.tok_logp.numpy(), np.asarray(ref.tok_logp),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(got.total_logp.numpy(),
                               np.asarray(ref.total_logp), atol=atol, rtol=0)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(ref.entropy),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("beam", [1, 4, 8])
def test_parity_with_jax_scan_and_pallas(beam):
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs
    from sherpa_vietnamese_asr_tpu.ops.beam_search_pallas import (
        beam_search_batch_pallas,
    )

    jcfg, jdec, jjoi = _jax_rnnt(48)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = np.random.default_rng(beam).standard_normal((3, 20, 256)).astype(
        np.float32)
    lens = [20, 13, 1]
    got = _run_port(enc, lens, cfg, dec, joi, beam)
    ref = jbs(jnp.asarray(enc), jnp.asarray(lens, jnp.int32), jdec, jjoi, jcfg,
              beam_size=beam)
    _assert_same(got, ref)
    if beam >= 4:
        pal = beam_search_batch_pallas(jnp.asarray(enc),
                                       jnp.asarray(lens, jnp.int32), jdec, jjoi,
                                       jcfg, beam_size=beam, interpret=True)
        _assert_same(got, pal)


def test_dedup_merges_like_jax():
    """Vocabulary 2 forces identical emitted sequences across beams."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs

    jcfg, jdec, jjoi = _jax_rnnt(2, seed=3)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = np.random.default_rng(5).standard_normal((2, 12, 256)).astype(
        np.float32)
    got = _run_port(enc, [12, 12], cfg, dec, joi, 4)
    ref = jbs(jnp.asarray(enc), jnp.asarray([12, 12], jnp.int32), jdec, jjoi,
              jcfg, beam_size=4)
    _assert_same(got, ref)


def _forced_joiner(jcfg, jdec, jjoi, blank_bias):
    import jax
    import jax.numpy as jnp

    joi = jax.tree_util.tree_map(jnp.zeros_like, jjoi)
    joi["output"]["bias"] = joi["output"]["bias"].at[0].set(blank_bias)
    return joi


def test_all_blank():
    """A joiner biased hard toward blank: no emissions, empty records."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs

    jcfg, jdec, jjoi = _jax_rnnt(16)
    jjoi = _forced_joiner(jcfg, jdec, jjoi, 20.0)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = np.random.default_rng(6).standard_normal((2, 8, 256)).astype(
        np.float32)
    got = _run_port(enc, [8, 3], cfg, dec, joi, 4)
    ref = jbs(jnp.asarray(enc), jnp.asarray([8, 3], jnp.int32), jdec, jjoi,
              jcfg, beam_size=4)
    assert got.num_tokens.tolist() == [0, 0]
    _assert_same(got, ref, atol=1e-6)


def test_margin_zero_on_exact_tie():
    """Constant logits (blank pushed down): every frame emits from a 15-way
    exact tie, so the margin is exactly 0 and the lowest token id wins."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs

    jcfg, jdec, jjoi = _jax_rnnt(16)
    jjoi = _forced_joiner(jcfg, jdec, jjoi, -8.0)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = np.random.default_rng(7).standard_normal((2, 6, 256)).astype(
        np.float32)
    got = _run_port(enc, [6, 6], cfg, dec, joi, 4)
    ref = jbs(jnp.asarray(enc), jnp.asarray([6, 6], jnp.int32), jdec, jjoi,
              jcfg, beam_size=4)
    n = int(got.num_tokens[0])
    assert n > 0
    np.testing.assert_array_equal(got.entropy.numpy()[0, :n, 1], 0.0)
    _assert_same(got, ref, atol=1e-6)


def test_hotwords_match_jax_scan():
    """The plain twin carries the hotword automaton (the CUDA kernel's
    hotword branch is held against this twin on the card by chip_smoke.py)."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.ops.beam_search import beam_search_batch as jbs
    from sherpa_vietnamese_asr_tpu.ops.hotword import build_hotword_tables

    jcfg, jdec, jjoi = _jax_rnnt(48)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    tables, _ = build_hotword_tables([[5, 9, 12], [5, 9], [30, 31, 32, 33],
                                      [12, 7]], [1.5, 2.0, 1.0, 3.0], 48)
    enc = np.random.default_rng(8).standard_normal((3, 18, 256)).astype(
        np.float32)
    lens = [18, 11, 1]
    got = _run_port(enc, lens, cfg, dec, joi, 8, tables)
    ref = jbs(jnp.asarray(enc), jnp.asarray(lens, jnp.int32), jdec, jjoi, jcfg,
              beam_size=8, hw_tables=tables, with_hotwords=True)
    _assert_same(got, ref)


def test_matches_frozen_beam_fixture():
    """tests/data/beam_fixture.json (frozen from the dict-based reference
    algorithm): every case, with and without hotwords."""
    from sherpa_vietnamese_asr_tpu.models import rnnt as jr
    from sherpa_vietnamese_asr_tpu.ops.hotword import build_hotword_tables

    with open(FIXTURE) as f:
        fx = json.load(f)
    jcfg = jr.RnntConfig(**fx["rnnt_cfg"])
    _, jdec, jjoi = _jax_rnnt(None, seed=fx["prng_seed"], jcfg=jcfg)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    rng = np.random.default_rng(fx["enc_seed"])
    enc = (rng.standard_normal(fx["enc_shape"]) * fx["enc_scale"]).astype(
        np.float32)
    tables, _ = build_hotword_tables(fx["hotword_phrases"],
                                     fx["hotword_scores"], cfg.vocab_size)
    for case in fx["cases"]:
        got = _run_port(enc, fx["lens"], cfg, dec, joi, case["beam"],
                        tables if case["hotwords"] else None)
        for i, exp in enumerate(case["expected"]):
            label = f"beam={case['beam']} hw={case['hotwords']} chunk={i}"
            nt = int(got.num_tokens[i])
            assert nt == len(exp["tokens"]), label
            assert got.tokens[i, :nt].tolist() == exp["tokens"], label
            assert abs(float(got.total_logp[i]) - exp["total_logp"]) < 1e-3, label


def test_cpu_tensor_runs_plain_twin_without_launch(monkeypatch):
    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    beam_search_cuda.launches = 0
    jcfg, jdec, jjoi = _jax_rnnt(32)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 10, 256)).astype(np.float32))
    lens = torch.tensor([10, 4], dtype=torch.int32)
    got = beam_search_cuda.beam_search_batch_cuda(enc, lens, dec, joi, cfg, 4)
    ref = beam_search_batch(enc, lens, dec, joi, cfg, 4)
    assert beam_search_cuda.launches == 0
    assert torch.equal(got.tokens, ref.tokens)
    assert got.tokens.dtype == torch.int32 and got.tokens.shape == (2, 10)
    assert got.entropy.shape == (2, 10, 4)
