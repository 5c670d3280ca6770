# The port's word builder (pipeline/words.py beam_result_to_words: a table of
# the vocabulary's pieces and array passes over each row) against the JAX
# package's loop over tokens, on the CPU: every word, key, key order, value and
# value type exactly equal, _chunk_bpe_tokens and _chunk_bpe_timestamps_local
# included. Cases: the benchmark's one-piece vocabulary, BPE words of 1-12
# pieces (8 and more take np.mean's pairwise sums), dict and list vocabularies,
# space-prefixed and upper-case pieces, a row whose first piece continues a
# word, ids past the vocabulary, rows of 0, 1 and 2 tokens, enc_len 0, a
# non-zero time offset, and confidences on and next to 4-digit rounding ties. Then the table counter: one build per vocabulary
# object, however many rows use it.
import os
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sherpa_vietnamese_asr_tpu.pipeline.words import (  # noqa: E402
    beam_result_to_words as jax_words,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.words import (  # noqa: E402
    beam_result_to_words as port_words,
)
from sherpa_vietnamese_asr_tpu_torch.utils import trace  # noqa: E402

SR = 16000


def _bench_vocab():
    # portbench/harness/weights.py vocab(2000): every id past 2 is one word.
    return ["<blk>", "<sos/eos>", "<unk>"] + ["▁ta"] * 1997


def _bpe_vocab():
    # Ids 3-402 open a word, 403-802 continue one; a few upper-case.
    opens = [f"▁W{i}" if i % 7 == 0 else f"▁w{i}" for i in range(400)]
    conts = [f"C{i}" if i % 5 == 0 else f"c{i}" for i in range(400)]
    return ["<blk>", "<sos/eos>", "<unk>"] + opens + conts


def _bpe_tokens(rng, n_words, lengths=range(1, 13)):
    ids = []
    for _ in range(n_words):
        k = int(rng.choice(list(lengths)))
        ids.append(int(rng.integers(3, 403)))
        ids.extend(int(t) for t in rng.integers(403, 803, k - 1))
    return ids


def _row(rng, ids, enc_len=823, pad=7):
    """Beam outputs for one row: the ids, then `pad` padding slots."""
    n = len(ids)
    u = n + pad
    tokens = np.zeros(u, np.int32)
    tokens[:n] = ids
    frames = np.zeros(u, np.int32)
    frames[:n] = np.sort(rng.integers(0, max(enc_len, 1), n))
    tok_logp = rng.uniform(-4.0, 0.0, u).astype(np.float32)
    entropy = rng.uniform(0.0, 1.0, (u, 4)).astype(np.float32)
    return tokens, frames, tok_logp, entropy, n, enc_len


def _case(name):
    """[(row, id2token, chunk_duration_sec, time_offset)] of one case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    bpe = _bpe_vocab()
    rows = []
    if name == "bench_one_piece":
        vocab = _bench_vocab()
        for i in range(4):
            ids = rng.integers(3, 2000, 823).tolist()
            rows.append((_row(rng, ids), vocab, 33.0, 30.0 * i))
    elif name == "bpe_1_to_12_pieces":
        for i in range(6):
            ids = _bpe_tokens(rng, 60)
            rows.append((_row(rng, ids, enc_len=2 * len(ids)), bpe, 32.96, 29.5 * i))
    elif name == "bpe_long_words":
        for i in range(4):
            ids = _bpe_tokens(rng, 25, lengths=range(8, 13))
            rows.append((_row(rng, ids, enc_len=len(ids) + 3), bpe, 31.0, 0.0))
    elif name == "dict_vocab":
        vocab = {i: p for i, p in enumerate(bpe) if i % 11}  # ids % 11 == 0 missing
        for i in range(4):
            ids = _bpe_tokens(rng, 50, lengths=range(1, 5))
            rows.append((_row(rng, ids), vocab, 33.0, 12.25 * i))
    elif name == "list_vocab":
        for i in range(4):
            ids = _bpe_tokens(rng, 50, lengths=range(1, 5))
            rows.append((_row(rng, ids), list(bpe), 33.0, 12.25 * i))
    elif name == "space_and_upper_case":
        vocab = ["<blk>", " Ab", "▁XY", "ĐÊM", "Ü", " ▁Lạ", "▁ ", " ", "▁",
                 "NGƯỜI", "▁Việt", "İ", "ß", ""]
        for i in range(4):
            ids = rng.integers(0, len(vocab), 90).tolist()
            rows.append((_row(rng, ids), vocab, 20.0, 7.5 * i))
        dvocab = dict(enumerate(vocab))
        rows.append((_row(rng, rng.integers(0, len(vocab), 90).tolist()),
                     dvocab, 20.0, 3.0))
    elif name == "first_piece_continues":
        for i in range(4):
            ids = [int(rng.integers(403, 803))] + _bpe_tokens(rng, 30)
            rows.append((_row(rng, ids), bpe, 33.0, 4.0 * i))
        rows.append((_row(rng, [500, 501, 502]), bpe, 1.0, 0.0))
    elif name == "ids_past_vocab":
        small = bpe[:403] + bpe[403:603]  # ids 603+ past the list
        for i in range(3):
            ids = _bpe_tokens(rng, 40)
            ids[1::9] = [len(small) + 5] * len(ids[1::9])
            ids[3::13] = [-1] * len(ids[3::13])  # a list reads from its end
            rows.append((_row(rng, ids), small, 33.0, 1.5 * i))
        dvocab = {i: p for i, p in enumerate(bpe)}
        dvocab[5000] = "▁far"  # a sparse id past len(dvocab)
        dvocab[-3] = "neg"
        for i in range(3):
            ids = _bpe_tokens(rng, 40)
            ids[2::7] = [5000] * len(ids[2::7])
            ids[4::11] = [[900, -3, 4999][i]] * len(ids[4::11])
            ids[5::17] = [-2] * len(ids[5::17])
            rows.append((_row(rng, ids), dvocab, 33.0, 2.5 * i))
    elif name == "short_rows":
        for k in (1, 2, 3):
            for vocab in (bpe, _bench_vocab()):
                ids = rng.integers(3, 803, k).tolist()
                rows.append((_row(rng, ids), vocab, 0.64, 10.0))
        rows.append((_row(rng, [500, 4]), bpe, 0.64, 0.0))
        rows.append((_row(rng, [4, 500]), bpe, 0.64, 0.0))
    elif name == "empty_rows":
        rows.append((_row(rng, []), bpe, 33.0, 0.0))
        rows.append((_row(rng, _bpe_tokens(rng, 5), enc_len=0), bpe, 33.0, 0.0))
        rows.append((_row(rng, []), _bench_vocab(), 33.0, 5.0))
    elif name == "decoder_offsets":
        # The decoder's arguments: (e - s) / SR and s / SR of sample spans.
        for s, e in ((0, 528000), (480000, 1008000), (123457, 651457), (9999991, 10003791)):
            ids = _bpe_tokens(rng, 80, lengths=range(1, 4))
            rows.append((_row(rng, ids, enc_len=(e - s) // 640 + 1), bpe,
                         (e - s) / SR, s / SR))
    elif name == "rounding_near_ties":
        # Exact half-digit ties (k / 32), 4-digit halves and their float32 and
        # float64 neighbours, in every entropy column (float64 here, so that
        # v * 1e4 can round onto a half): max, min and means round them.
        halves = np.round(rng.uniform(0.0, 1.0, 200), 4) + 0.00005
        f32 = halves.astype(np.float32)
        pool = np.concatenate([np.arange(33) / 32.0, halves, [0.00015, 0.00005],
                               np.nextafter(halves, 0), np.nextafter(halves, 2),
                               np.nextafter(f32, 0), np.nextafter(f32, 2)])
        for vocab, ids in ((_bench_vocab(), rng.integers(3, 2000, 400).tolist()),
                           (bpe, _bpe_tokens(rng, 60, lengths=range(1, 4)))):
            row = list(_row(rng, ids))
            row[3] = rng.choice(pool, row[3].shape)
            rows.append((tuple(row), vocab, 33.0, 0.0))
    else:
        raise KeyError(name)
    return rows


CASES = ["bench_one_piece", "bpe_1_to_12_pieces", "bpe_long_words",
         "dict_vocab", "list_vocab", "space_and_upper_case",
         "first_piece_continues", "ids_past_vocab", "short_rows",
         "empty_rows", "decoder_offsets", "rounding_near_ties"]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert type(g[k]) is type(w[k]), k
            if isinstance(w[k], list):
                assert [type(x) for x in g[k]] == [type(x) for x in w[k]], k
            assert g[k] == w[k], k


@pytest.mark.parametrize("name", CASES)
def test_words_equal_the_jax_packages(name):
    rows = _case(name)
    n_words = 0
    for (tokens, frames, tok_logp, entropy, n, enc_len), vocab, dur, off in rows:
        args = (tokens, frames, tok_logp, entropy, n, enc_len, vocab, dur)
        want = jax_words(*args, time_offset=off)
        got = port_words(*args, time_offset=off)
        _assert_same(got, want)
        n_words += len(want)
    if name == "empty_rows":
        assert n_words == 0
    else:
        assert n_words > 0


def test_a_vocabulary_table_is_built_once_per_object():
    rng = np.random.default_rng(7)
    vocab_a, vocab_b = _bpe_vocab(), _bpe_vocab()
    rows = [_row(rng, _bpe_tokens(rng, 20)) for _ in range(6)]
    with trace.request("words") as rec:
        for _ in range(3):
            for tokens, frames, tok_logp, entropy, n, enc_len in rows:
                port_words(tokens, frames, tok_logp, entropy, n, enc_len,
                           vocab_a, 33.0)
        assert rec.counters.get("decode_words_tables") == 1
        for tokens, frames, tok_logp, entropy, n, enc_len in rows:
            port_words(tokens, frames, tok_logp, entropy, n, enc_len,
                       vocab_b, 33.0)
        assert rec.counters.get("decode_words_tables") == 2
    with trace.request("again") as rec:
        tokens, frames, tok_logp, entropy, n, enc_len = rows[0]
        port_words(tokens, frames, tok_logp, entropy, n, enc_len, vocab_a, 33.0)
        port_words(tokens, frames, tok_logp, entropy, n, enc_len, vocab_b, 33.0)
    assert "decode_words_tables" not in rec.counters

