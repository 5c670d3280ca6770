# The port's attention weights (sherpa_vietnamese_asr_tpu_torch/ops/
# attention.py, plain twin on the CPU) against the JAX package's XLA path
# (zipformer._attention_weights) and its Pallas kernel in interpret mode.
import numpy as np
import pytest
import torch

import sherpa_vietnamese_asr_tpu.models.zipformer as Z
from sherpa_vietnamese_asr_tpu_torch.ops import attention as tatt
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

torch.set_num_threads(2)

HEADS = 2


def _setup(t, lens_list, pos_dtype="float32"):
    import jax
    import jax.numpy as jnp

    cfg = Z.ZipformerConfig(
        num_encoder_layers=(1,), downsampling_factor=(1,),
        encoder_dim=(64,), ffn_dim=(96,), num_heads=(HEADS,),
        cnn_module_kernel=(15,), query_head_dim=16, pos_head_dim=4,
        value_head_dim=8, pos_dim=16, pos_dtype=pos_dtype)
    params = Z.init_zipformer_params(jax.random.PRNGKey(0), cfg)
    layer = params["stacks"][0]["layers"][0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((len(lens_list), t, 64)).astype(np.float32)
    lens = np.asarray(lens_list, np.int32)
    mask = jnp.asarray(np.arange(t)[None, :] >= lens[:, None])
    pos_emb = Z.compact_rel_pos_emb(t, cfg.pos_dim)
    ref = np.asarray(Z._attention_weights(layer, jnp.asarray(x),
                                          jnp.asarray(pos_emb), mask, HEADS,
                                          cfg))
    proj = np.asarray(Z.linear(layer["attn_in_proj"], jnp.asarray(x)))
    qd, pd = cfg.query_head_dim, cfg.pos_head_dim
    b = len(lens_list)
    q = proj[..., : HEADS * qd].reshape(b, t, HEADS, qd)
    k = proj[..., HEADS * qd: 2 * HEADS * qd].reshape(b, t, HEADS, qd)
    pq = proj[..., 2 * HEADS * qd:].reshape(b, t, HEADS, pd)
    w_pos = np.asarray(layer["attn_pos_proj"]["weight"])
    return cfg, layer, (q, k, pq, w_pos, pos_emb, lens, mask), ref


def _port(inputs, pos_dtype=torch.float32):
    q, k, pq, w_pos, pos_emb, lens, _ = inputs
    def t(a):
        return torch.from_numpy(np.array(a))

    return tatt.attention_weights(t(q), t(k), t(pq), t(w_pos), t(pos_emb),
                                  t(lens), pos_dtype=pos_dtype).numpy()


@pytest.mark.parametrize("t,lens_list", [(37, [37, 20, 0]), (130, [97]),
                                         (200, [200, 150])])
def test_plain_matches_jax_xla(t, lens_list):
    """float32 pos scores: the same math, 1e-5. A lens = 0 row (the batch
    padding's (0, 1) spans) gives the uniform softmax, not NaN."""
    _, _, inputs, ref = _setup(t, lens_list)
    got = _port(inputs)
    assert got.shape == ref.shape == (len(lens_list), HEADS, t, t)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    for i, ln in enumerate(lens_list):
        if ln == 0:
            np.testing.assert_allclose(got[i], 1.0 / t, atol=1e-7)


def test_plain_bf16_pos_scores_match_jax_xla():
    """pos_dtype="bfloat16" rounds the position table and scores to bf16 in
    both packages; one bf16 ulp of a score moves a weight by < 1e-2."""
    _, _, inputs, ref = _setup(64, [64, 40], pos_dtype="bfloat16")
    got = _port(inputs, pos_dtype=torch.bfloat16)
    assert np.abs(got - ref).max() < 1e-2


@pytest.mark.parametrize("t,lens_list", [(200, [200, 150, 0]), (130, [97])])
def test_plain_matches_pallas_interpret(t, lens_list):
    """The TPU kernel writes bf16 weights: 2e-2 on the valid region, key
    sums 1 +- 2e-2."""
    from jax.experimental.pallas import tpu as pltpu

    from sherpa_vietnamese_asr_tpu.ops.attention import attention_weights_pallas

    cfg, layer, inputs, _ = _setup(t, lens_list)
    q, k, pq, w_pos, pos_emb, lens, mask = inputs
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(attention_weights_pallas(
            q, k, pq, layer["attn_pos_proj"]["weight"], pos_emb, mask, cfg))
    got = _port(inputs)
    for i, ln in enumerate(lens_list):
        assert np.abs(got[i, :, :ln, :ln] - ref[i, :, :ln, :ln]).max(
            initial=0.0) < 2e-2
        np.testing.assert_allclose(got[i].sum(-2), 1.0, atol=2e-2)


def test_cpu_tensor_runs_plain_twin_without_launch(monkeypatch):
    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    tatt.launches = 0
    _, _, inputs, ref = _setup(20, [20])
    got = _port(inputs)
    assert tatt.launches == 0
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_kernel_head_dims_cover_the_model_configs():
    """The CUDA kernel is instantiated for the head dims of the shipped
    configs (30M and 68M) and of the tiny test config."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import TINY_ZIPFORMER
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
        ZIPFORMER_30M, ZIPFORMER_68M,
    )

    for cfg in (ZIPFORMER_30M, ZIPFORMER_68M, TINY_ZIPFORMER):
        assert (cfg.query_head_dim, cfg.pos_head_dim) in tatt._KERNEL_HEAD_DIMS
