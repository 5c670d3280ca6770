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
    NEG_INF, HotwordTables, _entropy_metrics, beam_search_batch, metric_constants,
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


@pytest.mark.parametrize("beam", [1, 4, 8, 12, 16, 32, 33, 64])
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
    """The plain twin carries the hotword automaton, at beam 8 and at a beam
    past the live candidates of the first frames (the CUDA kernel's hotword
    branch is held against this twin on the card by chip_smoke.py)."""
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
    for beam in (8, 64):
        got = _run_port(enc, lens, cfg, dec, joi, beam, tables)
        ref = jbs(jnp.asarray(enc), jnp.asarray(lens, jnp.int32), jdec, jjoi, jcfg,
                  beam_size=beam, hw_tables=tables, with_hotwords=True)
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


@pytest.mark.parametrize("case", ["random", "halves", "dead_rows", "all_equal"])
@pytest.mark.parametrize("beam,v", [(1, 7), (4, 2), (8, 7), (64, 7), (33, 48), (64, 48),
                                    (128, 2000)])
def test_tiled_selection_equals_the_full_stable_sort(beam, v, case):
    """The row-tiled kernel's selection over 8 vocab slices (the numpy
    mirror _tiled_top_beam, below) is the first `beam` of the twin's one
    stable descending sort over beam x vocab: ties within and across rows
    and slices, the -1e30 rows of the first frames, slices narrower than a
    beam or empty, and a beam that outnumbers beam x vocab's live entries."""
    acc = np.random.default_rng(beam * v).standard_normal((3, beam, v)).astype(np.float32)
    if case == "halves":  # many exact ties, within rows and across them
        acc = np.round(acc * 2) / 2
    elif case == "dead_rows":
        acc[:, 1:] = NEG_INF
    elif case == "all_equal":
        acc[:] = 0.0
    want = torch.sort(torch.from_numpy(acc).reshape(3, -1), dim=-1, descending=True,
                      stable=True).indices[:, :beam].numpy()
    for n in range(3):
        np.testing.assert_array_equal(
            _tiled_top_beam(acc[n], np.zeros(beam, np.float32), 8, seed=n), want[n])


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


# ---- a float32 model of the beam kernel's cluster schedule -----------------
# csrc/beam_search.cu splits each frame over a cluster of C blocks: block r
# owns vocab columns [r*W, min(V, (r+1)*W)), W = ceil(V / C). Every block
# takes its slice's max and sum of exp per beam row, combines the C partials
# into the row's lse, takes its slice's entropy, Tsallis and top-2 terms and
# its local exact top-beam (first per warp of 32 threads, then over the
# warps' lists); the leader merges the C local lists and the metric
# partials. A beam runs in the kernel's smallest beam cap that holds it (8
# or 16), which sets the threads a row of the warp scan; a beam past 16
# runs the row-tiled kernel, whose block takes its slice's top-beam by a
# radix select of score keys (then of flat indices among the tied keys) and
# whose leader ranks the union of the lists by counting. The model follows
# those steps in float32 and is held against the plain twin's stable sort
# and metrics.

_INT_MAX = 2 ** 31 - 1
_WARPS = 16  # 512 threads a block


def _top_passes(scores, idx, k):
    """Exact top-k of (score, flat index) pairs, ordered by score descending
    then index ascending, as the kernel takes it: k passes, each the best
    pair strictly after the previous winner; (-inf, INT_MAX) once none is
    left."""
    out_s, out_i = [], []
    prev_s, prev_i = np.float32(np.inf), -1
    for _ in range(k):
        after = (scores < prev_s) | ((scores == prev_s) & (idx > prev_i))
        if not after.any():
            prev_s, prev_i = np.float32(-np.inf), _INT_MAX
        else:
            s, i = scores[after], idx[after]
            prev_s = s.max()
            prev_i = int(i[s == prev_s].min())
        out_s.append(prev_s)
        out_i.append(prev_i)
    return np.asarray(out_s, np.float32), np.asarray(out_i, np.int64)


def _slices(v, c):
    w = -(-v // c)
    return [(r * w, min(v, (r + 1) * w)) for r in range(c)]


def _split_top_beam(lp, logp, c):
    """Flat indices of the top-beam of lp [beam, V] + logp [beam]: each
    slice's local top-beam (per warp, then over the warps' lists), then the
    leader's merge of the C lists."""
    beam, v = lp.shape
    row_threads = 512 // beam_search_cuda.beam_cap(beam)
    score_all = (lp + logp[:, None]).astype(np.float32)
    lists_s, lists_i = [], []
    for lo, hi in _slices(v, c):
        width = hi - lo
        bb, col = np.divmod(np.arange(beam * width), max(width, 1))
        flat = bb * v + lo + col
        score = score_all[bb, lo + col]
        # row_threads a row: at cap 8 warp w scans row w // 2, columns (w %
        # 2) * 32 + lane + 64k; at cap 16 a warp scans one row.
        warp = (bb * row_threads + col % row_threads) // 32
        ws, wi = zip(*[_top_passes(score[warp == k], flat[warp == k], beam)
                       for k in range(_WARPS)])
        s, i = _top_passes(np.concatenate(ws), np.concatenate(wi), beam)
        lists_s.append(s)
        lists_i.append(i)
    return _top_passes(np.concatenate(lists_s), np.concatenate(lists_i), beam)[1]


def _score_keys(s):
    """The kernel's score_key: uint32 keys in the order of the float32
    scores, -0 taken as +0."""
    u = (s.astype(np.float32) + np.float32(0)).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _kth_largest(keys, k):
    """The k-th largest of uint32 keys as the kernel's kth_largest finds it,
    four passes of an 8-bit digit from the top, each a histogram of the
    keys that match the digits found so far: (key, how many exceed it, how
    many equal it)."""
    prefix, mask, kk = 0, 0, k
    for shift in (24, 16, 8, 0):
        live = keys[(keys & np.uint32(mask)) == np.uint32(prefix)]
        hist = np.bincount((live >> np.uint32(shift)) & np.uint32(255), minlength=256)
        top = np.cumsum(hist[::-1])[::-1] - hist  # keys in the bins above each digit
        d = int(np.nonzero((top < kk) & (kk <= top + hist))[0][0])
        kk -= int(top[d])
        prefix |= d << shift
        mask |= 255 << shift
        equal = int(hist[d])
    return prefix, k - kk, equal


def _tiled_top_beam(lp, logp, c, seed=0):
    """Flat indices of the top-beam of lp [beam, V] + logp [beam] as the
    row-tiled kernel takes it: each slice's exact top-beam by kth_largest
    over the score keys and, when more keys tie at the threshold than are
    needed, over ~flat index among the tied ones, appended in an arbitrary
    order (shuffled here) and padded to beam with (-inf, INT_MAX); then the
    leader ranks every entry of the C lists by how many entries beat it on
    (score key, ~flat index), and the entry of rank p < beam is new beam p."""
    beam, v = lp.shape
    rng = np.random.default_rng(seed)
    score_all = (lp + logp[:, None]).astype(np.float32)
    ent_s, ent_i = [], []
    for lo, hi in _slices(v, c):
        width = hi - lo
        bb, col = np.divmod(np.arange(beam * width), max(width, 1))
        flat = (bb * v + lo + col).astype(np.int64)
        sc = score_all[bb, lo + col]
        take = np.ones(sc.size, bool)
        if sc.size > beam:
            keys = _score_keys(sc)
            t_hi, above, equal = _kth_largest(keys, beam)
            need = beam - above
            take = keys > t_hi
            ties = keys == np.uint32(t_hi)
            if need < equal:
                lo_keys = (~flat.astype(np.uint32)).astype(np.uint32)
                t_lo = _kth_largest(lo_keys[ties], need)[0]
                take |= ties & (lo_keys >= np.uint32(t_lo))
            else:
                take |= ties
        order = rng.permutation(int(take.sum()))
        pad = beam - len(order)
        ent_s.append(np.concatenate([sc[take][order], np.full(pad, -np.inf, np.float32)]))
        ent_i.append(np.concatenate([flat[take][order], np.full(pad, _INT_MAX)]))
    s, i = np.concatenate(ent_s), np.concatenate(ent_i)
    key = (_score_keys(s).astype(np.uint64) << np.uint64(32)) | \
        (~i.astype(np.uint32)).astype(np.uint64)
    rank = (key[None, :] > key[:, None]).sum(1)
    out = np.full(beam, -1, np.int64)
    real = i != _INT_MAX
    assert (rank[real] < beam).sum() == beam
    out[rank[real & (rank < beam)]] = i[real & (rank < beam)]
    return out


def _split_metrics(logits, c):
    """([beam, 4] metrics, [beam, V] log-probs) of logits [beam, V] from the
    slices' partial max / sum of exp and partial entropy, Tsallis and top-2
    terms, combined in rank order."""
    beam, v = logits.shape
    f32 = np.float32
    alpha, max_entropy, tsallis_max = metric_constants(v)
    slices = _slices(v, c)
    m = np.full(beam, -np.inf, f32)
    part = []
    for lo, hi in slices:
        x = logits[:, lo:hi]
        pm = x.max(1) if hi > lo else np.full(beam, -np.inf, f32)
        ps = np.exp(x - pm[:, None]).sum(1, dtype=f32) if hi > lo else np.zeros(beam, f32)
        part.append((pm, ps))
        m = np.maximum(m, pm)
    se = np.zeros(beam, f32)
    for pm, ps in part:
        se = se + ps * np.exp(pm - m)
    z = logits - m[:, None]
    p = np.exp(z) / se[:, None]
    ent, ts = np.zeros(beam, f32), np.zeros(beam, f32)
    p1, p2 = np.full(beam, -1, f32), np.full(beam, -1, f32)
    for lo, hi in slices:
        q = p[:, lo:hi]
        ent = ent + (q * np.log(q + f32(1e-30))).sum(1, dtype=f32)
        ts = ts + (q ** f32(alpha)).sum(1, dtype=f32)
        top = -np.sort(-np.concatenate([q, np.full((beam, 2), -1, f32)], 1), 1)[:, :2]
        p1, p2 = (np.maximum(p1, top[:, 0]),  # merge the top-2 values, ties kept
                  np.maximum(np.minimum(p1, top[:, 0]), np.maximum(p2, top[:, 1])))
    met = np.stack([(f32(-1.5) * (1 - ts)) / f32(tsallis_max), p1 - p2,
                    -ent / f32(max_entropy), p1], axis=1)
    return met, z - np.log(se)[:, None]


def _frame_case(case, v, beam=8):
    """Logits [beam, V] and parent scores [beam] of one frame."""
    rng = np.random.default_rng(v)
    logits = rng.standard_normal((beam, v)).astype(np.float32)
    logp = np.sort(rng.uniform(-6, 0, beam)).astype(np.float32)[::-1].copy()
    if case == "ties_at_slice_boundaries":
        # The two columns beside every boundary of an 8-way split tie, above
        # the rest (past every row's maximum at the wide beams); beams 0 and
        # 1 tie too, so ties cross rows as well.
        w = -(-v // 8)
        top = max(4.0, float(logits.max()) + 1.0)
        for b in range(w, v, w):
            logits[:, b - 1] = logits[:, b] = top + b / v
        logp[1] = logp[0]
    elif case == "exact_ties_whole_vocab":
        logits[:] = 0.0
        logits[:, 0] = -8.0
        logp[:] = 0.0
    elif case == "first_frame":
        logp[:] = NEG_INF
        logp[0] = 0.0
    return logits, logp


@pytest.mark.parametrize("case", ["random", "ties_at_slice_boundaries",
                                  "exact_ties_whole_vocab", "first_frame"])
@pytest.mark.parametrize("v", [2000, 1999, 7])
@pytest.mark.parametrize("c,beam", [(1, 8), (8, 8), (8, 12), (8, 16), (8, 32),
                                    (8, 33), (8, 64), (8, 128)],
                         ids=["1", "8", "8-beam12", "8-beam16", "8-beam32",
                              "8-tiled33", "8-tiled64", "8-tiled128"])
def test_cluster_split_schedule_matches_the_twin(c, beam, v, case):
    """The split top-beam is the twin's stable-sort order exactly (ties to the
    lowest flat index across slices and rows; -1e30 parents at frame 0), and
    the combined metrics and log-probs are the twin's within 1e-6, at beam 8
    and past it (cap 16, a beam of 12 in cap 16, and the row-tiled kernel's
    selection at beams 32, 33, 64 and 128)."""
    logits, logp = _frame_case(case, v, beam)
    log_probs = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    acc = (log_probs + torch.from_numpy(logp)[:, None]).reshape(-1)
    want = torch.sort(acc, descending=True, stable=True).indices[:beam]
    # Selection on the twin's own scores: the order alone is under test.
    lp_twin = log_probs.numpy()
    tiled = beam_search_cuda.beam_cap(beam) == beam_search_cuda.TILED
    top = _tiled_top_beam if tiled else _split_top_beam
    np.testing.assert_array_equal(top(lp_twin, logp, c), want.numpy())
    met, lp = _split_metrics(logits, c)
    np.testing.assert_allclose(met, _entropy_metrics(torch.from_numpy(logits)).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(lp, lp_twin, atol=1e-6, rtol=0)
    if case in ("ties_at_slice_boundaries", "exact_ties_whole_vocab"):
        assert (met[:, 1] == 0).all(), "margin must be 0 on an exact tie"


def test_beam_caps_fit_shared_memory_and_raise_past_the_largest():
    """Each beam up to 16 runs in the smallest cap that holds it and keeps
    its layout (cap 8's byte count and limit); a beam past 16 runs the
    row-tiled kernel, whose block holds one 32-row tile whatever the beam
    and T; every route's block state fits shared memory at a 33 s chunk (T
    823, V 2000) at Zipformer-30M's joiner input (E 256) and 68M's (E 512),
    J = D = 512. A beam below 1 raises in the wrapper, naming the beam,
    before any launch."""
    bsc = beam_search_cuda
    assert bsc.CAPS == (8, 16) and bsc.MAX_CAP == 16 and bsc.TILE == 32
    for beam in range(1, 17):
        cap = bsc.beam_cap(beam)
        assert beam <= cap and all(c < beam for c in bsc.CAPS if c < cap)
    for beam in (17, 32, 33, 64, 128, 1000):
        assert bsc.beam_cap(beam) == bsc.TILED
    for cap in (*bsc.CAPS, bsc.TILED):
        for e in (256, 512):
            smem = bsc._kernel_smem_bytes(823, e, 512, 512, 2000, cap)
            assert 0 < smem <= bsc._smem_limit(cap), (cap, e, smem)
    # cap 8: as before the caps (87,584 B at E 512 against 228,352 B)
    assert bsc._kernel_smem_bytes(823, 512, 512, 512, 2000) == 87584
    assert bsc._smem_limit(8) == 227 * 1024 - 4 * 1024
    # the tiled kernel's histories are in its workspace: no T term, and the
    # same 32-row tile whatever the beam
    assert bsc._kernel_smem_bytes(64, 512, 512, 512, 2000, bsc.TILED) == \
        bsc._kernel_smem_bytes(4000, 512, 512, 512, 2000, bsc.TILED) == 200704
    assert bsc._smem_limit(bsc.TILED) >= 200704 + 5664  # ptxas: 5,664 B static
    for bad in (0, -1):
        with pytest.raises(ValueError, match=f"got {bad}"):
            bsc.beam_cap(bad)
    jcfg, jdec, jjoi = _jax_rnnt(32)
    cfg, dec, joi = _port_rnnt(jcfg, jdec, jjoi)
    enc = torch.zeros((1, 4, 256), device="meta")
    for bad in (0, -1):
        with pytest.raises(ValueError, match=f"got {bad}"):
            bsc._beam_search_cuda(enc, torch.ones(1, dtype=torch.int32), dec, joi, cfg, bad,
                                  None)
