# The port's streaming Zipformer (models/zipformer_streaming.py) against the
# JAX package's streaming_step on TINY_ZIPFORMER, with the same weights
# (biases, norms, bypasses and downsample weights perturbed, so that every
# term of the step is exercised) converted by models/convert.py and the same
# numpy fbank chunks: float32 over 7 consecutive chunks at left context 64
# and 128 (every step's output and every state tensor), from a converted
# mid-stream JAX state, in bfloat16, and the embed's chunk invariance.
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sherpa_vietnamese_asr_tpu.models.zipformer as jz
import sherpa_vietnamese_asr_tpu.models.zipformer_streaming as jzs
from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER as JAX_TINY
from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models import zipformer as tz
from sherpa_vietnamese_asr_tpu_torch.models import zipformer_streaming as tzs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32: max |port - JAX| over max |JAX|, per step output and per state
# tensor. Both run full float32 on the CPU; summation order alone gives
# about 1e-6 here.
TOL = 1e-4
# bfloat16 (JAX with excess precision off): per step, max and mean
# |port - JAX| over mean |JAX|, the plain bf16 layer's gates
# (tests/test_torch_encoder_layer.py). Both round at the same points; the
# remaining difference is the order of bf16 sums inside the products.
BF16_MAX, BF16_MEAN = 0.12, 0.015
PERTURBED = ("bias", "dw_bias", "log_scale", "bypass_scale", "bypass_mid_scale",
             "out_bypass_scale", "weights")

_PERTURB = r'''
def perturbed(params, seed):
    """params with every bias, norm, bypass and downsample weight moved by
    N(0, 0.1): random init leaves them at constants that hide a dropped term."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))
    new = []
    for path, leaf in leaves:
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in PERTURBED:
            leaf = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        new.append(leaf)
    return jax.tree_util.tree_unflatten(tree, new)
'''
exec(_PERTURB)

_BF16_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import sherpa_vietnamese_asr_tpu.models.zipformer as jz
import sherpa_vietnamese_asr_tpu.models.zipformer_streaming as jzs
from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER

spec = json.loads(sys.argv[1])
PERTURBED = tuple(spec["perturbed"])
''' + _PERTURB + r'''
cfg = dataclasses.replace(TINY_ZIPFORMER, compute_dtype="bfloat16")
scfg = jzs.StreamingConfig(chunk_frames=32, left_frames=spec["left"])
params = perturbed(jz.init_zipformer_params(jax.random.PRNGKey(0), cfg), 1)
chunks = np.load(spec["inputs"])["chunks"]
state = jzs.init_streaming_state(cfg, scfg, chunks.shape[1])
step = jax.jit(lambda p, s, x: jzs.streaming_step(p, s, x, cfg, scfg))
out = {}
for i, x in enumerate(chunks):
    o, state = step(params, state, jnp.asarray(x))
    out[f"out{i}"] = np.asarray(o)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(spec["out"], **out)
'''


def _jax_cfg(**kw):
    return dataclasses.replace(JAX_TINY, **kw)


def _port_encoder(params, jcfg):
    enc = tz.ZipformerEncoder(tz.ZipformerConfig(**dataclasses.asdict(jcfg)))
    convert._load(enc, convert.encoder_state_dict(params))
    return enc.eval()


def _chunks(n, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, batch, 64, 80)).astype(np.float32)


def _assert_close(got, ref, what, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err, float(np.abs(ref).max()))


def _leaves(state):
    out = []
    tzs.map_state(out.append, state)
    return out


def _assert_state_close(got, ref_jax, jcfg, what):
    ref = convert.streaming_state_from_numpy(jax.tree.map(np.asarray, ref_jax), jcfg,
                                             device="cpu")
    got_l, ref_l = _leaves(got), _leaves(ref)
    assert len(got_l) == len(ref_l)
    for i, (g, r) in enumerate(zip(got_l, ref_l)):
        _assert_close(g, r.numpy(), f"{what} state leaf {i}")


@pytest.fixture(scope="module")
def f32_setup():
    jcfg = _jax_cfg()
    params = perturbed(jz.init_zipformer_params(jax.random.PRNGKey(0), jcfg), 1)
    return jcfg, params, _port_encoder(params, jcfg)


def _jax_step(jcfg, scfg):
    return jax.jit(functools.partial(jzs.streaming_step, cfg=jcfg, scfg=scfg))


@pytest.mark.parametrize("left", [64, 128])
def test_streaming_step_matches_jax_over_consecutive_chunks(f32_setup, left):
    """7 chunks (224 embed frames, past the 64- and 128-frame caches): every
    step's output and every state tensor within TOL."""
    jcfg, params, enc = f32_setup
    jscfg = jzs.StreamingConfig(chunk_frames=32, left_frames=left)
    scfg = tzs.StreamingConfig(chunk_frames=32, left_frames=left)
    chunks = _chunks(7, 2, seed=left)
    jstate = jzs.init_streaming_state(jcfg, jscfg, 2)
    state = tzs.init_streaming_state(enc.cfg, scfg, 2, device="cpu")
    _assert_state_close(state, jstate, jcfg, "init")
    step = _jax_step(jcfg, jscfg)
    for i, x in enumerate(chunks):
        ref, jstate = step(params, jstate, jnp.asarray(x))
        out, state = tzs.streaming_step(enc, state, torch.from_numpy(x), scfg)
        assert out.shape == (2, 16, jcfg.output_dim)
        _assert_close(out, ref, f"step {i} output")
        _assert_state_close(state, jstate, jcfg, f"step {i}")


def test_streaming_step_from_converted_mid_stream_state(f32_setup):
    """JAX runs three chunks; both packages go on from its state (converted
    by streaming_state_from_numpy) for three more."""
    jcfg, params, enc = f32_setup
    jscfg = jzs.StreamingConfig(chunk_frames=32, left_frames=128)
    scfg = tzs.StreamingConfig(chunk_frames=32, left_frames=128)
    chunks = _chunks(6, 1, seed=7)
    step = _jax_step(jcfg, jscfg)
    jstate = jzs.init_streaming_state(jcfg, jscfg, 1)
    for x in chunks[:3]:
        _, jstate = step(params, jstate, jnp.asarray(x))
    state = convert.streaming_state_from_numpy(jax.tree.map(np.asarray, jstate), jcfg,
                                               device="cpu")
    assert state["convnext_tail"].shape == (1, jcfg.embed_layer3_channels, 6,
                                            tzs.embed_freq_dim(enc.cfg))
    for i, x in enumerate(chunks[3:]):
        ref, jstate = step(params, jstate, jnp.asarray(x))
        out, state = tzs.streaming_step(enc, state, torch.from_numpy(x), scfg)
        _assert_close(out, ref, f"step {i + 3} output")
        _assert_state_close(state, jstate, jcfg, f"step {i + 3}")


def test_converter_rejects_a_state_of_another_depth(f32_setup):
    jcfg, _, _ = f32_setup
    jstate = jax.tree.map(np.asarray, jzs.init_streaming_state(
        jcfg, jzs.StreamingConfig(), 1))
    jstate["stacks"] = jstate["stacks"][:-1]
    with pytest.raises(ValueError):
        convert.streaming_state_from_numpy(jstate, jcfg, device="cpu")


def _tree(ref, prefix, like):
    leaves = [ref[prefix + jax.tree_util.keystr(path)]
              for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)


def test_bf16_streaming_step_matches_jax_without_excess_precision(tmp_path):
    """bfloat16 over 4 chunks at left 64, the JAX step in a subprocess with
    XLA's excess precision off (with it on, XLA:CPU keeps some of the step's
    bf16 roundings in f32): per step within BF16_MAX / BF16_MEAN."""
    chunks = _chunks(4, 2, seed=11)
    inputs, out_path = str(tmp_path / "in.npz"), str(tmp_path / "ref.npz")
    np.savez(inputs, chunks=chunks)
    spec = {"left": 64, "inputs": inputs, "out": out_path, "perturbed": PERTURBED}
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               SVT_DISABLE_COMPILE_CACHE="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", _BF16_REFERENCE, json.dumps(spec)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(out_path))
    jcfg = _jax_cfg(compute_dtype="bfloat16")
    like = jax.eval_shape(lambda k: jz.init_zipformer_params(k, jcfg), jax.random.PRNGKey(0))
    enc = _port_encoder(_tree(ref, "p/", like), jcfg)
    scfg = tzs.StreamingConfig(chunk_frames=32, left_frames=64)
    state = tzs.init_streaming_state(enc.cfg, scfg, 2, device="cpu")
    for i, x in enumerate(chunks):
        out, state = tzs.streaming_step(enc, state, torch.from_numpy(x), scfg)
        r = ref[f"out{i}"]
        d = np.abs(out.numpy() - r)
        scale = float(np.abs(r).mean())
        assert out.dtype == torch.float32 and np.isfinite(out.numpy()).all()
        assert d.max() <= BF16_MAX * scale and d.mean() <= BF16_MEAN * scale, (
            i, float(d.max()) / scale, float(d.mean()) / scale)


def test_streaming_embed_chunking_invariant(f32_setup):
    """The causal cached ConvNeXt makes the embed's output independent of
    where chunk boundaries fall: two chunks in sequence == one pass (the
    port's mirror of the JAX package's test)."""
    _, _, enc = f32_setup
    cfg = enc.cfg
    rng = np.random.default_rng(3)
    look = 7
    x = torch.from_numpy(rng.standard_normal((2, look + 128, cfg.num_features))
                         .astype(np.float32))
    tail0 = torch.zeros(2, cfg.embed_layer3_channels, 6, tzs.embed_freq_dim(cfg))
    with torch.no_grad():
        full, _ = tzs._streaming_embed(enc.encoder_embed, x, tail0, torch.float32)
        h1, tail1 = tzs._streaming_embed(enc.encoder_embed, x[:, : look + 64], tail0,
                                         torch.float32)
        h2, _ = tzs._streaming_embed(enc.encoder_embed, x[:, 64:], tail1, torch.float32)
    np.testing.assert_allclose(torch.cat([h1, h2], dim=1).numpy(), full.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_init_streaming_state_defaults_to_the_card():
    """Like the model constructors, the zero state goes to the card unless
    the caller names the CPU, and raises on a host without one."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import TINY_ZIPFORMER

    cfg = TINY_ZIPFORMER
    scfg = tzs.StreamingConfig(chunk_frames=16, left_frames=64)
    state = tzs.init_streaming_state(cfg, scfg, 1, device="cpu")
    assert state["fbank_tail"].device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tzs.init_streaming_state(cfg, scfg, 1)
