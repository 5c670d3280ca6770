# The port's Zipformer encoder, RNN-T decoder and joiner against the JAX
# package's, with the JAX weights converted by models/convert.py.
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    import jax

    from sherpa_vietnamese_asr_tpu.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.convert import (
        asr_model_from_numpy,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        TINY_ZIPFORMER as T_TINY,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig

    jm = random_asr_model(vocab_size=50, beam_size=4, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    tm = asr_model_from_numpy(
        enc, dec, joi, dataclasses.replace(T_TINY, pos_dtype="float32"),
        RnntConfig(**dataclasses.asdict(jm.rnnt_cfg)), jm.id2token,
        device="cpu", beam_size=4)
    return jm, tm


@pytest.mark.parametrize("lens", [[103, 103], [103, 61, 0], [40]])
def test_encoder_matches_jax(models, lens):
    """Mixed lengths, a length-0 chunk and the padded tail: outputs within
    1e-4 and the same output lengths."""
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.models.zipformer import zipformer_encoder

    jm, tm = models
    t_in = max(lens)
    x = np.random.default_rng(0).standard_normal(
        (len(lens), t_in, 80)).astype(np.float32)
    ref, ref_lens = zipformer_encoder(jm.enc_params, jnp.asarray(x),
                                      jnp.asarray(lens, jnp.int32), jm.zip_cfg)
    got, got_lens = tm.encoder(torch.from_numpy(x),
                               torch.tensor(lens, dtype=torch.int32))
    assert got_lens.tolist() == np.asarray(ref_lens).tolist()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_decoder_and_joiner_match_jax(models):
    import jax.numpy as jnp

    from sherpa_vietnamese_asr_tpu.models.rnnt import (
        decoder_forward, joiner_forward,
    )
    from sherpa_vietnamese_asr_tpu_torch.models import rnnt as trnnt

    jm, tm = models
    rng = np.random.default_rng(1)
    y = rng.integers(0, 50, (3, 5, 2)).astype(np.int32)
    ref_d = np.asarray(decoder_forward(jm.dec_params, jnp.asarray(y),
                                       jm.rnnt_cfg))
    got_d = trnnt.decoder_forward(tm.decoder, torch.from_numpy(y).long())
    np.testing.assert_allclose(got_d.detach().numpy(), ref_d, atol=1e-5, rtol=0)
    eo = rng.standard_normal((3, 1, jm.rnnt_cfg.encoder_out_dim)).astype(
        np.float32)
    ref_j = np.asarray(joiner_forward(jm.joi_params, jnp.asarray(eo),
                                      jnp.asarray(ref_d)))
    got_j = trnnt.joiner_forward(tm.joiner, torch.from_numpy(eo),
                                 torch.from_numpy(np.array(ref_d)))
    np.testing.assert_allclose(got_j.detach().numpy(), ref_j, atol=1e-5, rtol=0)


def test_random_model_has_the_jax_shapes():
    """random_asr_model builds the JAX package's parameter shapes at true
    30M width (values come from a torch.Generator)."""
    import jax

    from sherpa_vietnamese_asr_tpu.models import rnnt as jrnnt
    from sherpa_vietnamese_asr_tpu.models import zipformer as jzip
    from sherpa_vietnamese_asr_tpu_torch.models import convert, registry

    zcfg, rcfg = jzip.ZIPFORMER_30M, jrnnt.RnntConfig(encoder_out_dim=256)
    shapes = jax.eval_shape(
        lambda k: (jzip.init_zipformer_params(k, zcfg),
                   jrnnt.init_decoder_params(k, rcfg),
                   jrnnt.init_joiner_params(k, rcfg)),
        jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = registry.random_asr_model(vocab_size=2000, device="cpu")
    for module, state in ((tm.encoder, convert.encoder_state_dict(zeros[0])),
                          (tm.decoder, convert.decoder_state_dict(zeros[1])),
                          (tm.joiner, convert.joiner_state_dict(zeros[2]))):
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == {k: v.shape for k, v in state.items()}


def test_joiner_kernel_layout_is_cached_until_a_weight_changes():
    """The beam kernel's joiner weights: [d_in, d_out] contiguous float32,
    built once, rebuilt after an in-place change of a parameter."""
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Joiner, RnntConfig

    joi = Joiner(RnntConfig(vocab_size=7, decoder_dim=8, joiner_dim=6,
                            encoder_out_dim=5))
    first = joi.kernel_layout()
    assert [tuple(x.shape) for x in first] == [(5, 6), (6,), (8, 6), (6,),
                                               (6, 7), (7,)]
    assert all(x.is_contiguous() and x.dtype == torch.float32 for x in first)
    torch.testing.assert_close(first[4], joi.output.weight.t(), rtol=0, atol=0)
    assert joi.kernel_layout()[4] is first[4]
    with torch.no_grad():
        joi.output.weight.add_(1.0)
    again = joi.kernel_layout()
    assert again[4] is not first[4]
    torch.testing.assert_close(again[4], joi.output.weight.t(), rtol=0, atol=0)


def test_fp32_policy_turns_tf32_off_and_the_encoder_checks_it():
    from sherpa_vietnamese_asr_tpu_torch.models import zipformer

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="use_full_fp32"):
            zipformer._check_full_fp32()
        zipformer.use_full_fp32()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        zipformer._check_full_fp32()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _constructor(name):
    from sherpa_vietnamese_asr_tpu_torch.models import convert, registry

    return {"random_asr_model": (registry, registry.random_asr_model),
            "asr_model_from_numpy": (convert, convert.asr_model_from_numpy)}[name]


@pytest.mark.parametrize("name", ["random_asr_model", "asr_model_from_numpy"])
def test_model_constructors_default_to_the_card(name):
    import inspect

    _, fn = _constructor(name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["random_asr_model", "asr_model_from_numpy"])
def test_model_default_raises_without_cuda_and_builds_nothing(name, monkeypatch):
    """Without a card the default device raises before any module is built:
    no silent CPU model."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import TINY_ZIPFORMER
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig

    module, fn = _constructor(name)

    def no_build(*args, **kwargs):
        raise AssertionError("a model was built without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(module, "build_modules", no_build)
    args = ({}, {}, {}, TINY_ZIPFORMER, RnntConfig(), []) \
        if name == "asr_model_from_numpy" else ()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)


def test_random_model_asks_for_cuda_by_default(monkeypatch):
    """With a card present the default model goes to it; device="cpu" keeps
    it on the CPU."""
    from sherpa_vietnamese_asr_tpu_torch.models import registry

    placed = []

    def record(self, device):
        placed.append(torch.device(device))
        return self

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(registry.AsrModel, "to", record)
    registry.random_asr_model(vocab_size=20, zip_cfg=registry.TINY_ZIPFORMER)
    registry.random_asr_model(vocab_size=20, zip_cfg=registry.TINY_ZIPFORMER,
                              device="cpu")
    assert [d.type for d in placed] == ["cuda", "cpu"]
