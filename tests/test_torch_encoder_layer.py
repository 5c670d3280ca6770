# The port's whole-layer kernel twin (ops/encoder_layer.encoder_layer_plain,
# reached through the kernel wrapper on CPU tensors), its plain bf16 layer and
# its layer-kernel gate, against the JAX package, with the same weights
# converted by models/convert.py and the same numpy inputs.
#
# The JAX whole-layer kernel runs in Pallas interpret mode in a subprocess
# with XLA's excess precision off (--xla_allow_excess_precision=false).
# With it on (the default), XLA:CPU drops some of the kernel's own
# astype(bfloat16) roundings and keeps those values in f32, which moves a
# layer's output by about 2e-3 of its mean magnitude; with it off, the JAX
# kernel rounds where its source says, and the twin differs from it only in
# summation order (measured: mean error at most 8e-4, max 7e-3 of the scale).
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models import zipformer as tz
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(num_encoder_layers=(1,), downsampling_factor=(1,), encoder_dim=(64,),
            ffn_dim=(96,), num_heads=(2,), cnn_module_kernel=(15,),
            query_head_dim=16, pos_head_dim=4, value_head_dim=8, pos_dim=16,
            compute_dtype="bfloat16", pos_dtype="float32")
TWO_STACKS = dict(TINY, num_encoder_layers=(2, 2), downsampling_factor=(1, 2),
                  encoder_dim=(64, 64), ffn_dim=(96, 96), num_heads=(2, 2),
                  cnn_module_kernel=(15, 15))
# One layer at Zipformer-68M's widest stacks (head dims of both models,
# conv kernel 15, a narrow ffn): a nonlin attend of 288 columns (D 384, H 4)
# and of 384 columns (D 512, H 8), the two column tiles of the kernel.
WIDE = {name: dict(TINY, encoder_dim=(d,), num_heads=(h,), ffn_dim=(96,),
                   query_head_dim=32, pos_head_dim=4, value_head_dim=12, pos_dim=48)
        for name, d, h in (("d384", 384, 4), ("d512", 512, 8))}
LAYER_T, LAYER_TP = 100, 128
LAYER_LENS = [100, 61, 17, 0]
ENC_LENS = [220, 173, 64]
# Gate (a): per chunk, mean and max |port - JAX| over its valid rows (all
# rows for lens 0) as a fraction of mean |JAX|. On these inputs summation
# order alone gives at most 4.3e-5 and 3.8e-3 (7.7e-4 and 7.2e-3 on other
# seeds); a rel-pos term 1% off gives at least 2.6e-3 and 2.2e-2.
GATE_MEAN, GATE_MAX = 1.5e-3, 1.2e-2
# The same gate at the WIDE layers, with the max of chip_smoke.py's
# full-width kernel-vs-twin gate. From D 128 on, one bf16 rounding that
# summation order flips early in a chunk reaches every row through the
# attends and flips later roundings, so a chunk either matches almost
# exactly or differs in most elements by under one bf16 ulp. Measured on
# these inputs: mean at most 1.2e-3 and max at most 2.1e-2 of the scale
# (over 1.2e-2 in both layers); the twin with a rel-pos term 1% off, a mean
# of 2.8e-3 to 3.2e-3 on the chunks with valid rows (on another seed, sound
# 1.3e-3 and 1.8e-2, faulted 2.8e-3 to 4.7e-3).
WIDE_GATE_MAX = 3e-2

_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from jax.experimental.pallas import tpu as pltpu
import sherpa_vietnamese_asr_tpu.models.zipformer as Z
from sherpa_vietnamese_asr_tpu.ops.encoder_layer import encoder_layer_pallas

spec = json.loads(sys.argv[1])
for key in ("tiny", "two"):
    spec[key] = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in spec[key].items()}
spec["wide"] = {name: {k: tuple(v) if isinstance(v, list) else v for k, v in w.items()}
                for name, w in spec["wide"].items()}
out = {}


def perturbed(cfg, seed):
    """Init params with nonzero biases, norms and bypasses (every rounding
    point and term of the layer is then exercised)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, Z.init_zipformer_params(jax.random.PRNGKey(seed), cfg)))
    new = []
    for path, leaf in leaves:
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in ("bias", "dw_bias", "log_scale", "bypass_scale",
                    "bypass_mid_scale", "out_bypass_scale"):
            leaf = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        new.append(leaf)
    return jax.tree_util.tree_unflatten(tree, new)


cfg = Z.ZipformerConfig(**spec["tiny"])
params = perturbed(cfg, 0)
layer = jax.tree.map(jnp.asarray, params["stacks"][0]["layers"][0])
t, tp = spec["t"], spec["tp"]
lens = np.asarray(spec["lens"], np.int32)
rng = np.random.default_rng(1)
x = np.zeros((len(lens), tp, cfg.encoder_dim[0]), np.float32)
x[:, :t] = rng.standard_normal((len(lens), t, cfg.encoder_dim[0]))
rev = Z._padded_rev_pos_emb(t, tp, cfg.pos_dim)
with pltpu.force_tpu_interpret_mode():
    out["layer_out"] = np.asarray(encoder_layer_pallas(
        layer, jnp.asarray(x), jnp.asarray(rev), jnp.asarray(lens), 2, cfg))
out["layer_x"] = x
out["layer_rev"] = rev
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p/" + jax.tree_util.keystr(path)] = np.asarray(leaf)

cfg2 = dataclasses.replace(Z.ZipformerConfig(**spec["two"]), layer_kernel="always")
params2 = perturbed(cfg2, 2)
enc_lens = np.asarray(spec["enc_lens"])
feats = rng.standard_normal((len(enc_lens), enc_lens.max() * 2 + 7, 80)).astype(np.float32)
with pltpu.force_tpu_interpret_mode():
    enc, enc_out_lens = Z.zipformer_encoder(params2, jnp.asarray(feats),
                                            jnp.asarray(enc_lens * 2 + 7, jnp.int32), cfg2)
out["enc_out"], out["enc_out_lens"] = np.asarray(enc), np.asarray(enc_out_lens)
out["enc_feats"] = feats
for path, leaf in jax.tree_util.tree_flatten_with_path(params2)[0]:
    out["q/" + jax.tree_util.keystr(path)] = np.asarray(leaf)

for seed, (name, wide) in enumerate(spec["wide"].items(), start=10):
    wcfg = Z.ZipformerConfig(**wide)
    wparams = perturbed(wcfg, seed)
    d = wcfg.encoder_dim[0]
    wx = np.zeros((len(lens), tp, d), np.float32)
    wx[:, :t] = rng.standard_normal((len(lens), t, d))
    wrev = Z._padded_rev_pos_emb(t, tp, wcfg.pos_dim)
    with pltpu.force_tpu_interpret_mode():
        out[name + "_out"] = np.asarray(encoder_layer_pallas(
            jax.tree.map(jnp.asarray, wparams["stacks"][0]["layers"][0]), jnp.asarray(wx),
            jnp.asarray(wrev), jnp.asarray(lens), wcfg.num_heads[0], wcfg))
    out[name + "_x"], out[name + "_rev"] = wx, wrev
    for path, leaf in jax.tree_util.tree_flatten_with_path(wparams)[0]:
        out[name + "/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(spec["out"], **out)
'''


def _tree(ref, prefix, like):
    """Rebuild a parameter tree shaped like `like` from the saved leaves."""
    import jax

    leaves = [ref[prefix + jax.tree_util.keystr(path)]
              for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's kernel outputs (interpret mode, excess precision
    off) and the weights they used, from one subprocess."""
    path = str(tmp_path_factory.mktemp("layer_ref") / "ref.npz")
    spec = {"tiny": TINY, "two": TWO_STACKS, "wide": WIDE, "t": LAYER_T, "tp": LAYER_TP,
            "lens": LAYER_LENS, "enc_lens": ENC_LENS, "out": path}
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               SVT_DISABLE_COMPILE_CACHE="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(spec)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _jax_cfg(spec, **kw):
    import sherpa_vietnamese_asr_tpu.models.zipformer as jz

    return jz.ZipformerConfig(**dict(spec, **kw))


def _jax_params_like(spec, seed):
    import jax

    import sherpa_vietnamese_asr_tpu.models.zipformer as jz

    return jax.eval_shape(lambda k: jz.init_zipformer_params(k, _jax_cfg(spec)),
                          jax.random.PRNGKey(seed))


def _port_layer(params, spec):
    """The port's ZipformerLayer for stack 0, layer 0 of a JAX tree."""
    cfg = tz.ZipformerConfig(**spec)
    layer = tz.ZipformerLayer(cfg.encoder_dim[0], cfg.ffn_dim[0], cfg.num_heads[0],
                              cfg.cnn_module_kernel[0], cfg)
    prefix = "stacks.0.layers.0."
    state = {k[len(prefix):]: torch.tensor(np.asarray(v), dtype=torch.float32)
             for k, v in convert.encoder_state_dict(params).items()
             if k.startswith(prefix)}
    layer.load_state_dict(state, strict=True)
    return layer


def _layer_case(reference, name="layer", spec=TINY, prefix="p/", seed=0):
    params = _tree(reference, prefix, _jax_params_like(spec, seed))
    layer = _port_layer(params, spec)
    got = el.encoder_layer(layer, torch.from_numpy(reference[name + "_x"]),
                           torch.from_numpy(reference[name + "_rev"]),
                           torch.tensor(LAYER_LENS, dtype=torch.int32))
    return got.numpy(), reference[name + "_out"]


def _gate(got, ref):
    """[(mean, max)] per chunk as fractions of mean |ref|."""
    scale = float(np.abs(ref).mean())
    out = []
    for i, ln in enumerate(LAYER_LENS):
        rows = slice(None) if ln == 0 else slice(0, ln)
        d = np.abs(got[i, rows] - ref[i, rows])
        out.append((float(d.mean()) / scale, float(d.max()) / scale))
    return out


def _passes(errs, gate_max=GATE_MAX):
    return all(m <= GATE_MEAN and x <= gate_max for m, x in errs)


def test_layer_twin_matches_jax_kernel(reference):
    """(a) D 64, H 2, T 100 -> T_pad 128, lens [100, 61, 17, 0]."""
    got, ref = _layer_case(reference)
    assert got.shape == ref.shape and np.isfinite(got).all()
    errs = _gate(got, ref)
    assert _passes(errs), errs


def _wide_case(reference, name):
    return _layer_case(reference, name, WIDE[name], name + "/", 10 + list(WIDE).index(name))


@pytest.mark.parametrize("name", WIDE)
def test_layer_twin_matches_jax_kernel_at_68m_widths(reference, name):
    """(a) at Zipformer-68M's stack 2-4 widths: D 384, H 4 (a nonlin attend
    of 288 columns) and D 512, H 8 (384 columns), the widths the kernel
    takes in two column tiles; T 100 -> T_pad 128, lens [100, 61, 17, 0];
    GATE_MEAN and WIDE_GATE_MAX."""
    assert 3 * WIDE[name]["encoder_dim"][0] // 4 > el.NONLIN_TILE_N
    got, ref = _wide_case(reference, name)
    assert got.shape == ref.shape and np.isfinite(got).all()
    errs = _gate(got, ref)
    assert _passes(errs, WIDE_GATE_MAX), errs


@pytest.mark.parametrize("name", WIDE)
def test_wide_gate_catches_a_rel_pos_fault(reference, monkeypatch, name):
    """(d) at the WIDE layers: the gate of the test above fails for the
    twin with a rel-pos term 1% off."""
    rel = el.rel_pos_scores
    monkeypatch.setattr(el, "rel_pos_scores", lambda pq, poslin: rel(pq, poslin) * 1.01)
    got, ref = _wide_case(reference, name)
    assert not _passes(_gate(got, ref), WIDE_GATE_MAX)


def _skew_off_by_one(pq, poslin):
    t_pad = pq.shape[1]
    ar = torch.arange(t_pad)
    idx = (t_pad + ar[:, None] - ar[None, :]).clamp(max=poslin.shape[1] - 1)
    return torch.einsum("bthd,hstd->bhst", pq.float(), poslin[:, idx].float())


_REL_POS = el.rel_pos_scores


@pytest.mark.parametrize("fault", [
    _skew_off_by_one,
    lambda pq, poslin: _REL_POS(pq, poslin) * 1.01,
], ids=["skew_off_by_one", "rel_pos_1pct_off"])
def test_gate_catches_deliberate_faults(reference, monkeypatch, fault):
    """(d) The gate of (a) fails for a skew off by one and a rel-pos term 1%
    off."""
    monkeypatch.setattr(el, "rel_pos_scores", fault)
    got, ref = _layer_case(reference)
    assert not _passes(_gate(got, ref))


def test_plain_bf16_layer_matches_jax_layer():
    """(b) The plain bf16 layer ("never") against the JAX encoder_layer in
    bf16 (XLA), at the JAX kernel test's own gates: max <= 0.12 x scale,
    mean <= 0.015 x scale over valid rows."""
    import jax
    import jax.numpy as jnp

    import sherpa_vietnamese_asr_tpu.models.zipformer as jz

    cfg = _jax_cfg(TINY)
    params = jax.tree.map(np.asarray,
                          jz.init_zipformer_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    layer_p = params["stacks"][0]["layers"][0]
    for sub in ("ff1", "ff2", "ff3"):
        for io in ("in", "out"):
            p = layer_p[sub][io]
            p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
    t, lens = 100, np.array([100, 61, 17])
    x = rng.standard_normal((3, t, 64)).astype(np.float32)
    mask = np.arange(t)[None, :] >= lens[:, None]
    pos_emb = jz.compact_rel_pos_emb(t, cfg.pos_dim)
    ref = np.asarray(jz.encoder_layer(jax.tree.map(jnp.asarray, layer_p),
                                      jnp.asarray(x), jnp.asarray(pos_emb),
                                      jnp.asarray(mask), 2, cfg))
    layer = _port_layer(params, dict(TINY, layer_kernel="never"))
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(pos_emb),
                    torch.from_numpy(lens), torch.from_numpy(mask)).numpy()
    scale = np.abs(ref).mean()
    for i, ln in enumerate(lens):
        d = np.abs(got[i, :ln] - ref[i, :ln])
        assert d.max() < 0.12 * scale and d.mean() < 0.015 * scale, (i, d.max(), d.mean())


def test_two_stack_encoder_with_layer_kernel_matches_jax(reference):
    """(c) A two-stack tiny bf16 encoder, layer_kernel="always" in both
    packages (the port's twin on the CPU, the JAX kernel in interpret mode):
    same output lengths, and per chunk a mean error <= 0.02 x scale (the JAX
    end-to-end test's gate; the embed runs as banded matmuls in JAX and as
    convolutions here, both in bf16)."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import build_modules
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig

    params = _tree(reference, "q/", _jax_params_like(TWO_STACKS, 2))
    cfg = tz.ZipformerConfig(**dict(TWO_STACKS, layer_kernel="always"))
    model = build_modules("t", cfg, RnntConfig(encoder_out_dim=64), [], 1)
    convert._load(model.encoder, convert.encoder_state_dict(params))
    x_lens = np.asarray(ENC_LENS) * 2 + 7
    got, got_lens = model.encoder(torch.from_numpy(reference["enc_feats"]),
                                  torch.from_numpy(x_lens.astype(np.int32)))
    ref = reference["enc_out"]
    assert got_lens.tolist() == reference["enc_out_lens"].tolist()
    got = got.numpy()
    scale = np.abs(ref).mean()
    for i, ln in enumerate(reference["enc_out_lens"]):
        d = np.abs(got[i, :ln] - ref[i, :ln])
        assert d.mean() < 0.02 * scale and d.max() < 0.15 * scale, (i, d.mean(), d.max())


@pytest.mark.parametrize("stack", range(6))
def test_gate_routes_like_the_jax_flag(stack):
    """(e) "auto": every CUDA bf16 stack of Zipformer-30M takes the kernel
    (t_ds of a 33 s chunk), no CPU stack and no float32 stack; "never" and
    "always" force."""
    bf16 = dataclasses.replace(tz.ZIPFORMER_30M, compute_dtype="bfloat16")
    t_ds = (1646, 823, 412, 206, 412, 823)[stack]
    assert tz.use_layer_kernel(bf16, stack, t_ds, "cuda")
    assert not tz.use_layer_kernel(bf16, stack, t_ds, "cpu")
    assert not tz.use_layer_kernel(tz.ZIPFORMER_30M, stack, t_ds, "cuda")
    for dev in ("cpu", "cuda"):
        assert not tz.use_layer_kernel(
            dataclasses.replace(bf16, layer_kernel="never"), stack, t_ds, dev)
        assert tz.use_layer_kernel(
            dataclasses.replace(bf16, layer_kernel="always"), stack, t_ds, dev)


def test_cpu_tensor_runs_plain_twin_without_launch(monkeypatch):
    """(f) On CPU tensors the wrapper runs the twin, loads no library and
    counts no launch; the cached layout is rebuilt after a weight changes."""
    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    el.launches = 0
    cfg = tz.ZipformerConfig(**TINY)
    torch.manual_seed(0)
    layer = tz.ZipformerLayer(64, 96, 2, 15, cfg)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.zeros(2, 128, 64)
    x[:, :90] = torch.randn(2, 90, 64)
    rev = torch.from_numpy(tz._padded_rev_pos_emb(90, 128, cfg.pos_dim))
    lens = torch.tensor([90, 40])
    got = el.encoder_layer(layer, x, rev, lens)
    flat, w_pos = layer.kernel_layout()
    ref = el.encoder_layer_plain(flat, x, el.poslin_bf16(rev, w_pos, 2), lens,
                                 2, 16, 4, 8)
    assert el.launches == 0
    assert got.dtype == torch.float32 and got.shape == (2, 128, 64)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert len(flat) == el.N_FLAT and layer.kernel_layout()[0] is flat
    assert [t.dtype for t in flat[:38]] == [torch.bfloat16] * 38
    with torch.no_grad():
        layer.ff1.in_proj.weight.add_(1.0)
    assert layer.kernel_layout()[0] is not flat


# ---------------------------------------------------------------------------
# The product kernel's host-side contract (csrc/encoder_layer.cu
# product_kernel): tile plans and the epilogue's register map, at the six
# Zipformer-30M stack shapes (B 8, 33 s chunks), Zipformer-68M's stacks 2-4
# and the TINY shape above.

def _stack_shape(stack, cfg=tz.ZIPFORMER_30M):
    d, ff = cfg.encoder_dim[stack], cfg.ffn_dim[stack]
    t_pad = -(-(1646, 823, 412, 206, 412, 823)[stack] // el.R) * el.R
    return (8, t_pad, d, cfg.num_heads[stack], cfg.query_head_dim, cfg.pos_head_dim,
            cfg.value_head_dim, 3 * d // 4, ff * 3 // 4, ff, ff * 5 // 4)


LAYER_SHAPES = {f"stack{s}": _stack_shape(s) for s in range(6)}
LAYER_SHAPES["tiny"] = (len(LAYER_LENS), LAYER_TP, 64, 2, 16, 4, 8, 48, 72, 96, 120)
# Zipformer-68M's stacks 2-4: nonlin attends of 288 / 384 / 288 columns.
LAYER_SHAPES.update({f"68m_stack{s}": _stack_shape(s, tz.ZIPFORMER_68M) for s in (2, 3, 4)})


def _planned(shape):
    products = el.layer_products(*shape)
    return [(p, el.tile_plan(p, sms=132)) for p in products]


@pytest.mark.parametrize("shape", LAYER_SHAPES.values(), ids=LAYER_SHAPES.keys())
def test_tile_plan_meets_the_kernels_constraints(shape):
    """Every product's plan fits wgmma (64-row warpgroup tiles, width 64 for
    a linear and 16 for an attend, at most 256 columns and 128 accumulators
    a thread), TMA (16-byte
    global strides and box starts, 128- or 32-byte swizzled inner boxes) and
    shared memory (a ring of at least 3 stages in 227 KB, tiles on 1024-byte
    swizzle atoms); its column tiles cover the product's columns (one for a
    self-attention head, at most two for the nonlin attend)."""
    b, t_pad, d, h, qd, pd, vd, hna = shape[:8]
    planned = _planned(shape)
    assert [p.name for p, _ in planned][:4] == ["attn_in", "ff1_in", "ff1_out", "nonlin_in"]
    assert len(planned) == 20 and sum(p.attend for p, _ in planned) == 3
    for p, pl in planned:
        assert pl.bm == el.BM == 2 * 64
        assert pl.nw == (el.ATTEND_NW if p.attend else el.LINEAR_NW)
        assert pl.bn % pl.nw == 0 and pl.bn % 8 == 0
        assert 0 < pl.bn <= max(el.LINEAR_BN) and pl.bn // 2 <= 128
        assert 3 <= pl.stages <= el.MAX_STAGES and pl.smem_bytes <= el.SMEM_LIMIT
        assert (pl.bm * el.BK * 2) % 1024 == 0 and (pl.bn * el.BK * 2) % 1024 == 0
        assert p.n % 2 == 0 and p.k % 8 == 0
        if shape != LAYER_SHAPES["tiny"]:
            assert p.k % 16 == 0
        if p.attend:
            width = p.zdiv * p.n  # the value buffer's row: H vd or hna
            assert p.m == p.k == t_pad and p.batches == b * p.zdiv
            assert pl.nw == 16 and pl.bn <= (16 if p.zdiv > 1 else el.NONLIN_TILE_N)
            n_tiles = -(-p.n // pl.bn)
            assert n_tiles <= (1 if p.zdiv > 1 else 2) and (n_tiles - 1) * pl.bn < p.n
            for head in range(p.zdiv):
                start = head * p.n - el.head_shift(head, p.n)
                assert start % 8 == 0 and start >= 0          # box starts 16-byte aligned
                assert el.head_shift(head, p.n) + p.n <= n_tiles * pl.bn
            strides = (2 * t_pad, 2 * t_pad * t_pad, 2 * width, 2 * t_pad * width)
            inner = (64 * 2, 16 * 2)                           # 128- and 32-byte swizzle
        else:
            assert p.m == b * t_pad and p.batches == 1 and pl.bn in el.LINEAR_BN
            n_tiles = -(-p.n // pl.bn)
            assert (n_tiles - 1) * pl.bn < p.n <= n_tiles * pl.bn
            strides = (2 * p.k,)                               # A [M, K] and W^T [N, K]
            inner = (el.BK * 2,)
        assert all(s % 16 == 0 for s in strides)
        assert all(16 <= i <= 128 for i in inner)
    widths = {p.name: p.n for p, _ in planned}
    assert widths["attn_in"] == h * (2 * qd + pd) and widths["sa1_in"] == h * vd
    assert widths["nonlin_in"] == 3 * hna and widths["conv1_in"] == 2 * d


@pytest.mark.parametrize("shape", LAYER_SHAPES.values(), ids=LAYER_SHAPES.keys())
def test_epilogue_map_covers_each_output_once(shape):
    """The mirror of the epilogue's m64nNk16 register map sends the 256
    consumer threads' accumulators onto each element of a 128 x bn tile
    exactly once, in whole column pairs (the bf16x2 / float2 stores), each
    warpgroup on its own 64 rows; the tiles' valid parts (rows < M, a
    head's shifted columns) cover each output element of every product
    exactly once."""
    planned = _planned(shape)
    for nw, nj in {(pl.nw, pl.bn // pl.nw) for _, pl in planned}:
        rows, cols = el.epilogue_map(nw, nj)
        bn = nw * nj
        assert rows.shape == (256, bn // 2)
        hits = torch.bincount((rows * bn + cols).flatten(), minlength=128 * bn)
        assert hits.shape == (128 * bn,) and bool((hits == 1).all())
        assert torch.equal(rows[:, 0::2], rows[:, 1::2])
        assert torch.equal(cols[:, 1::2], cols[:, 0::2] + 1) and bool((cols % 2 == 0)[:, 0::2].all())
        assert bool(((rows // 64) == (torch.arange(256) // 128)[:, None]).all())
    b, t_pad = shape[:2]
    for p, pl in planned:
        out_rows = b * t_pad
        out_cols = p.zdiv * p.n
        count = np.zeros((out_rows, out_cols), np.int8)
        for r0, c0, nrows, ncols, shift in el.product_tiles(p, pl):
            assert 0 < nrows <= pl.bm and 0 < ncols and shift + ncols <= pl.bn
            count[r0:r0 + nrows, c0:c0 + ncols] += 1
        assert (count == 1).all(), p.name


def test_tile_plan_raises_on_shapes_the_kernel_cannot_take():
    """A shape outside the kernel's plans raises in the wrapper (it never
    falls back): a value head wider than its 16-column tile, a nonlin
    attention wider than two 192-column tiles, a linear's depth off the
    16-byte TMA stride."""
    shape = LAYER_SHAPES["tiny"]
    wide_heads = shape[:6] + (20,) + shape[7:]
    with pytest.raises(ValueError, match="sa1_attend"):
        _planned(wide_heads)
    wide_nonlin = shape[:7] + (400,) + shape[8:]
    with pytest.raises(ValueError, match="nonlin_attend"):
        _planned(wide_nonlin)
    odd_ff = shape[:8] + (76,) + shape[9:]
    with pytest.raises(ValueError, match="ff1_out"):
        _planned(odd_ff)


def test_kernel_operands_hold_the_k_major_copies():
    """The products read each linear weight as its K-major copy [d_out,
    d_in], kept with the layer's operands and rebuilt with its
    kernel_layout(); the 42 operands stay in the TPU kernel's layout."""
    cfg = tz.ZipformerConfig(**TINY)
    torch.manual_seed(1)
    layer = tz.ZipformerLayer(64, 96, 2, 15, cfg)
    flat, _ = layer.kernel_layout()
    ops = el.kernel_operands(layer, flat)
    assert ops.flat is flat and el.kernel_operands(layer, flat) is ops
    wt = ops.flat_t
    assert [i for i, w in enumerate(wt) if w is not None] == list(el.LINEAR_WEIGHTS)
    for i in el.LINEAR_WEIGHTS:
        assert wt[i].is_contiguous() and torch.equal(wt[i], flat[i].t())
    assert torch.equal(wt[0], layer.attn_in_proj.weight.to(torch.bfloat16))
    assert list(ops.ptrs) == [w.data_ptr() for w in flat]
    with torch.no_grad():
        layer.conv2.out_proj.weight.mul_(2.0)
    flat2, _ = layer.kernel_layout()
    again = el.kernel_operands(layer, flat2)
    assert again is not ops and torch.equal(again.flat_t[36], flat2[36].t())
