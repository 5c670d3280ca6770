# The schedule of the attention-weights kernel (sherpa_vietnamese_asr_tpu_torch/
# csrc/attention_weights.cu and attn_tile.cuh) as a float32 numpy model, held
# to chip_smoke.py's bf16 gate against the plain twins on the CPU: TF32
# rounding on float32 bit patterns (cvt.rna: nearest, ties away from zero),
# the 3xTF32 split, the walk over query tiles, key steps and key groups, the
# online max and sum in base 2 and the bf16-band order of kernel 5. The same
# model with one TF32 pass must fail the gate at chip_smoke.py's inputs. Also
# the Python mirrors of the kernel's fragment and store maps, and the
# wrapper's kernel_args, which reads q, k and pq in place.
import numpy as np
import pytest
import torch

import chip_smoke
from sherpa_vietnamese_asr_tpu_torch.ops import attention as tatt
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.tools import skew_bf16

torch.set_num_threads(2)

LOG2E = np.float32(1.4426950408889634)
F32 = np.float32


def tf32_rna(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, nearest, ties away from 0."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def bf16_rne(x):
    """__float2bfloat16_rn, widened back to float32."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    bias = ((bits >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(F32)


def _content(a, b, split):
    """q.k of a [BH, 64, qd] row tile and a [BH, 64, qd] key slab as the
    tile's wgmma sequence: per 8-dim step, small*big, big*small and
    big*big (or big*big alone), each 8-term dot exact and rounded once into
    the float32 accumulator."""
    acc = np.zeros((a.shape[0], a.shape[1], b.shape[1]), F32)
    for ks in range(0, a.shape[-1], 8):
        ab, bb = tf32_rna(a[..., ks: ks + 8]), tf32_rna(b[..., ks: ks + 8])
        terms = [(ab, bb)]
        if split:
            a_s = tf32_rna(a[..., ks: ks + 8] - ab)
            b_s = tf32_rna(b[..., ks: ks + 8] - bb)
            terms = [(a_s, bb), (ab, b_s), (ab, bb)]
        for x, y in terms:
            dot = np.einsum("btd,bsd->bts", x.astype(np.float64), y.astype(np.float64))
            acc = (acc.astype(np.float64) + dot).astype(F32)
    return acc


def _band(p, rows, band_bf16):
    """[BH, 64, 64] band of p [BH, 64, 4] and rows [BH, 64, 64, 4]: kernel
    2's fmaf chain (each step exact, then rounded), or kernel 5's rounded
    products and adds left to right, rounded to bf16."""
    p = p[:, :, None, :]
    if band_bf16:
        b = (p[..., 0] * rows[..., 0]).astype(F32)
        for d in range(1, 4):
            b = (b + (p[..., d] * rows[..., d]).astype(F32)).astype(F32)
        return bf16_rne(b)
    b = np.zeros(rows.shape[:-1], F32)
    for d in range(4):
        b = (p[..., d].astype(np.float64) * rows[..., d] + b).astype(F32)
    return b


def kernel_model(q, k, pq, table, lens, band_bf16=False, split=True):
    """The kernel's weights [B, H, S, T] (bf16 values as float32) for numpy
    q, k [B, T, H, qd], pq [B, T, H, 4], table [H, 2T-1, 4] (the wrapper's
    kernel_pos_table) and lens [B]."""
    b, t, h, qd = q.shape
    qt, sk = tatt.QUERY_TILE, tatt.STEP_KEYS
    gk = sk // tatt.KEY_GROUPS
    bh_len = np.repeat(np.asarray(lens), h)[:, None, None]
    n_t = -(-t // qt) * qt + sk  # zero rows beyond T for the padded tiles
    n_s = -(-t // sk) * sk

    def heads(x, n):
        x = x.transpose(0, 2, 1, 3).reshape(b * h, t, -1).astype(F32)
        return np.concatenate([x, np.zeros((b * h, n - t, x.shape[-1]), F32)], 1)

    qh, kh, ph = heads(q, n_t), heads(k, n_s), heads(pq, n_t)
    tab = np.tile(table.astype(F32), (b, 1, 1))  # [BH, 2T-1, 4], bh = b * H + h
    out = np.zeros((b * h, t, t), F32)
    for t0 in range(0, t, qt):
        tq = np.arange(t0, t0 + qt)
        m = np.full((tatt.KEY_GROUPS, b * h, qt), -np.inf, F32)
        l = np.zeros((tatt.KEY_GROUPS, b * h, qt), F32)
        scores = {}
        for s0 in range(0, t, sk):  # pass 1
            for kg in range(tatt.KEY_GROUPS):
                ks = np.arange(s0 + kg * gk, s0 + (kg + 1) * gk)
                x = _content(qh[:, tq], kh[:, ks], split)
                j = ks[None, :] + t - 1 - tq[:, None]
                ok = (j >= 0) & (j < 2 * t - 1)
                rows = np.where(ok[None, ..., None], tab[:, np.clip(j, 0, 2 * t - 2)], 0)
                x = (x + _band(ph[:, tq], rows.astype(F32), band_bf16)).astype(F32)
                x = np.where(ks[None, None, :] >= bh_len, F32(-1e9), x)
                x = np.where(ks[None, None, :] >= t, F32(-np.inf), x)
                scores[s0, kg] = x
                mt = np.maximum(m[kg], x.max(-1))
                ms = np.where(mt == -np.inf, F32(0), mt)
                with np.errstate(invalid="ignore"):
                    p = np.exp2(((x - ms[..., None]) * LOG2E).astype(F32)).astype(F32)
                    scale = np.exp2(((m[kg] - ms) * LOG2E).astype(F32)).astype(F32)
                l[kg] = (l[kg] * scale + p.sum(-1, dtype=F32)).astype(F32)
                m[kg] = mt
        mm = np.maximum(m[0], m[1])
        lsum = np.zeros_like(l[0])
        for kg in range(tatt.KEY_GROUPS):
            e = np.exp2(((m[kg] - mm) * LOG2E).astype(F32)).astype(F32)
            lsum = (lsum + l[kg] * e).astype(F32)
        inv = (F32(1) / lsum).astype(F32)
        for (s0, kg), x in scores.items():  # pass 2: the same scores
            w = (np.exp2(((x - mm[..., None]) * LOG2E).astype(F32)) * inv[..., None])
            s_lo = s0 + kg * gk
            rows_t, cols_s = min(qt, t - t0), min(gk, t - s_lo)
            if cols_s > 0:
                out[:, t0: t0 + rows_t, s_lo: s_lo + cols_s] = \
                    bf16_rne(w.astype(F32))[:, :rows_t, :cols_s]
    return out.reshape(b, h, t, t).transpose(0, 1, 3, 2)


def _probe_args(t, qd, lens, heads=2, seed=0):
    """Standard normal q, k, pq and position table (tools/skew_bf16's probe
    inputs) as the wrappers' torch arguments, with the given lens."""
    rng = np.random.default_rng(seed + 7 * t + qd)
    inputs = skew_bf16.probe_inputs(rng, len(lens), t, heads, qd, 4)
    return skew_bf16.port_args(inputs[:4] + (np.asarray(lens, np.int32),), heads, "cpu")


def _model_of(args, **kw):
    q, k, pq, wpos, pos_emb, lens = args
    table = tatt.kernel_pos_table(wpos, pos_emb, q.shape[2]).numpy()
    got = kernel_model(q.numpy(), k.numpy(), pq.numpy(), table, lens.numpy(), **kw)
    return torch.from_numpy(np.ascontiguousarray(got))


TWINS = {False: tatt.attention_weights_plain, True: tatt.attention_weights_bf16band_plain}


@pytest.mark.parametrize("band_bf16", [False, True])
@pytest.mark.parametrize("qd", [32, 16])
@pytest.mark.parametrize("t", [1, 7, 64, 65, 130, 206])
def test_model_within_gate(t, qd, band_bf16):
    """The 3xTF32 model of the kernel (kernel 2, or kernel 5's band) within
    chip_smoke.attention_gate of its twin: every weight within the twin's
    bf16 rounding, key sums 1, uniform rows for lens 0."""
    lens_list = [t, 1, 0, (t + 1) // 2]
    args = _probe_args(t, qd, lens_list)
    got = _model_of(args, band_bf16=band_bf16)
    with torch.no_grad():
        ref = TWINS[band_bf16](*args)
    assert got.shape == ref.shape == (4, 2, t, t)
    err, sum_err, rel = chip_smoke.attention_gate(got, ref, lens_list)
    assert err < 2e-2 and sum_err < 2e-2
    assert rel <= 1.0, rel


@pytest.fixture(scope="module")
def smoke_stack3():
    """chip_smoke.py's attention inputs at stack 3 (B 8, T 206, H 8): layer
    0's projections of N(0, 1) rows, the random Zipformer-30M of seed 0, on
    the CPU."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model

    model = random_asr_model(vocab_size=500, device="cpu")
    for stack, t, h, lens_list, args in chip_smoke.attention_inputs(torch.device("cpu"),
                                                                     model):
        if stack == 3:
            return lens_list, args
    raise AssertionError("stack 3 not in chip_smoke.ATTN_SHAPES")


@pytest.mark.parametrize("band_bf16", [False, True])
def test_one_tf32_pass_fails_gate_at_smoke_inputs(smoke_stack3, band_bf16):
    """At chip_smoke's stack-3 inputs the 3xTF32 model passes the gate and
    the same model with one TF32 pass does not: the split is what float32
    accuracy needs, and the gate sees its absence."""
    lens_list, args = smoke_stack3
    with torch.no_grad():
        ref = TWINS[band_bf16](*args)
    _, _, rel3 = chip_smoke.attention_gate(_model_of(args, band_bf16=band_bf16), ref,
                                           lens_list)
    _, _, rel1 = chip_smoke.attention_gate(
        _model_of(args, band_bf16=band_bf16, split=False), ref, lens_list)
    assert rel3 <= 1.0 < rel1, (rel3, rel1)


def test_smoke_fault_tf32_inputs_fails_gate(smoke_stack3):
    """chip_smoke's planted fault, the twin fed TF32-rounded q and k, fails
    the gate against the twin (here at stack 3)."""
    lens_list, args = smoke_stack3
    with torch.no_grad():
        ref = tatt.attention_weights_plain(*args)
        fault = chip_smoke.tf32_twin(args)
    _, _, rel = chip_smoke.attention_gate(fault, ref, lens_list)
    assert rel > 1.0
    np.testing.assert_array_equal(chip_smoke.tf32_round(args[0]).numpy(),
                                  tf32_rna(args[0].numpy()))


def test_fragment_map_is_a_bijection():
    """Pass 2's accumulator elements fill the shared [128 keys, 64 queries]
    tile, each cell once."""
    key, query = tatt.fragment_map()
    assert key.size == tatt.STEP_KEYS * tatt.QUERY_TILE
    cells = key * tatt.QUERY_TILE + query
    assert np.array_equal(np.sort(cells), np.arange(key.size))


@pytest.mark.parametrize("t", [1646, 823, 412, 206, 1, 7])
def test_store_map_writes_every_weight_once(t):
    """The blocks' stores over all steps write each (key, query) of [T, T]
    exactly once and nothing at or beyond T; a bf16x2 store lands 4-byte
    aligned in every (batch, head) plane."""
    count = np.zeros((t, t), np.int64)
    for t0 in range(0, t, tatt.QUERY_TILE):
        for s0 in range(0, t, tatt.STEP_KEYS):
            key, query, width = tatt.store_map(t, t0, s0)
            assert (key < t).all() and (query + width - 1 < t).all()
            assert (key - s0 < tatt.STEP_KEYS).all() and (query - t0 < tatt.QUERY_TILE).all()
            for w in (1, 2):
                sel = width == w
                for d in range(w):
                    np.add.at(count, (key[sel], query[sel] + d), 1)
            pairs = width == 2
            assert t % 2 == 0 or not pairs.any()
            for bh in (0, 1, 5):
                offset = (bh * t * t + key[pairs] * t + query[pairs]) * 2
                assert (offset % 4 == 0).all()
    assert (count == 1).all()


P_Q, P_PQ = 32, 4


def _projection(b=2, t=9, h=4, extra=0, dtype=torch.float32):
    """q, k, pq as the model takes them: column slices of one projection
    [B, T, H (2 qd + pd) + extra]."""
    proj = torch.randn(b, t, h * (2 * P_Q + P_PQ) + extra, dtype=dtype)
    q = proj[..., : h * P_Q].reshape(b, t, h, P_Q)
    k = proj[..., h * P_Q: 2 * h * P_Q].reshape(b, t, h, P_Q)
    pq = proj[..., 2 * h * P_Q: 2 * h * P_Q + h * P_PQ].reshape(b, t, h, P_PQ)
    return proj, q, k, pq


def test_kernel_args_read_projection_in_place():
    proj, q, k, pq = _projection()
    lens = torch.tensor([9, 4])
    q2, k2, pq2, lens32, strides = tatt.kernel_args(q, k, pq, lens)
    p = proj.shape[-1]
    t = proj.shape[1]
    assert strides == (t * p, p, P_Q, t * p, p, P_Q, t * p, p, P_PQ)
    es = proj.element_size()
    assert q2.data_ptr() == proj.data_ptr()
    assert k2.data_ptr() == proj.data_ptr() + 4 * P_Q * es
    assert pq2.data_ptr() == proj.data_ptr() + 8 * P_Q * es
    assert lens32.dtype == torch.int32 and lens32.tolist() == [9, 4]


def test_kernel_args_copy_misaligned_keys_and_widen_bf16():
    """k rows off a 16-byte boundary are copied (the kernel's cp.async
    needs 16 bytes); bf16 inputs are widened to float32, exactly."""
    _, q, k, pq = _projection(extra=1)
    q2, k2, _, _, strides = tatt.kernel_args(q, k, pq, torch.tensor([9, 9]))
    assert q2.data_ptr() == q.data_ptr() and k2.is_contiguous()
    assert torch.equal(k2, k) and strides[3:6] == tuple(k2.stride()[:3])
    _, q, k, pq = _projection(dtype=torch.bfloat16)
    q2, k2, pq2, _, _ = tatt.kernel_args(q, k, pq, torch.tensor([9, 9]))
    assert q2.dtype == k2.dtype == pq2.dtype == torch.float32
    assert torch.equal(q2, q.float()) and torch.equal(pq2, pq.float())


@pytest.mark.parametrize("fault", ["last_stride", "dtype", "shape"])
def test_kernel_args_raise(fault):
    _, q, k, pq = _projection()
    lens = torch.tensor([9, 9])
    if fault == "last_stride":
        k = torch.randn(2, 9, 4, 2 * P_Q)[..., ::2]
    elif fault == "dtype":
        pq = pq.half()
    else:
        k = k[:, :8]
    with pytest.raises(ValueError):
        tatt.kernel_args(q, k, pq, lens)


def test_cpu_layer_takes_twin_without_launch(monkeypatch):
    """A CPU layer's attention weights come from the twin (no library, no
    launch, no position table); the table, when asked for, is kept until
    the projection's weight changes."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import TINY_ZIPFORMER
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
        ZipformerLayer,
        _pos_emb_on,
    )

    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    cfg = TINY_ZIPFORMER
    torch.manual_seed(0)
    layer = ZipformerLayer(cfg.encoder_dim[0], cfg.ffn_dim[0], cfg.num_heads[0],
                           cfg.cnn_module_kernel[0], cfg, device="cpu")
    x = torch.randn(2, 11, cfg.encoder_dim[0])
    pos_emb = _pos_emb_on(11, cfg.pos_dim, torch.device("cpu"))
    assert pos_emb is _pos_emb_on(11, cfg.pos_dim, torch.device("cpu"))
    lens = torch.tensor([11, 5], dtype=torch.int32)
    tatt.launches = 0
    with torch.no_grad():
        w = layer.attention_weights(x, pos_emb, lens)
    assert tatt.launches == 0 and layer._pos_table is None
    assert w.shape == (2, cfg.num_heads[0], 11, 11)
    table = layer.kernel_pos_table(pos_emb)
    assert table.shape == (cfg.num_heads[0], 21, cfg.pos_head_dim)
    assert layer.kernel_pos_table(pos_emb) is table
    with torch.no_grad():
        layer.attn_pos_proj.weight.mul_(2.0)
    table2 = layer.kernel_pos_table(pos_emb)
    assert table2 is not table and torch.allclose(table2, 2 * table)
