# The port's ONNX checkpoint import and export against the JAX package's:
#   (a) the JAX exporter's directory of a tiny model loads, through the
#       port's load_zipformer_rnnt and load_asr_model, into exactly
#       models/convert's state dicts of the JAX trees (strict name pass);
#   (b) the port's writer gives files the JAX loader reads back into the JAX
#       trees;
#   (c) prefixed, renamed and Constant-node tensors load through the
#       fallback; a missing tensor raises ImportReport;
#   (d) tokens.txt round trip; the device default raises without a card.
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.models import convert
from sherpa_vietnamese_asr_tpu_torch.models import onnx_import as oi
from sherpa_vietnamese_asr_tpu_torch.models import registry as treg
from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import (
    export_asr_dir,
    write_tokens,
)
from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import GraphBuilder
from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig

torch.set_num_threads(2)


def _jax_tiny(seed=0, vocab=50):
    from sherpa_vietnamese_asr_tpu.models.registry import (
        TINY_ZIPFORMER, random_asr_model,
    )
    return random_asr_model(vocab_size=vocab, seed=seed, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))


def _port_cfgs(jm):
    return (ZipformerConfig(**dataclasses.asdict(jm.zip_cfg)),
            RnntConfig(**dataclasses.asdict(jm.rnnt_cfg)))


def _jax_states(jm):
    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    return (convert.encoder_state_dict(enc), convert.decoder_state_dict(dec),
            convert.joiner_state_dict(joi))


def _assert_states_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k in want:
        g = np.asarray(got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k])
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape and g.dtype == np.float32, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A tiny JAX model written by the JAX exporter, with its tokens."""
    from sherpa_vietnamese_asr_tpu.models.onnx_export_rnnt import (
        export_asr_dir as jax_export,
    )
    jm = _jax_tiny()
    d = tmp_path_factory.mktemp("jax_export") / "tiny-model"
    jax_export(jm, str(d), t_in=103)
    write_tokens(str(d / "tokens.txt"), jm.id2token)
    return jm, d


def tiny_registry(monkeypatch, jm):
    """Let both packages' load_asr_model take a tiny directory as their
    30M configuration (they choose 30M or 68M from the directory's name,
    with the real models' 512-wide decoder)."""
    import sherpa_vietnamese_asr_tpu.models.registry as jreg
    from sherpa_vietnamese_asr_tpu.models.rnnt import RnntConfig as JaxRnnt

    zc, rc = _port_cfgs(jm)
    dims = dict(decoder_dim=rc.decoder_dim, joiner_dim=rc.joiner_dim)
    monkeypatch.setattr(jreg, "ZIPFORMER_30M", jm.zip_cfg)
    monkeypatch.setattr(jreg, "RnntConfig", functools.partial(JaxRnnt, **dims))
    monkeypatch.setattr(treg, "ZIPFORMER_30M", zc)
    monkeypatch.setattr(treg, "RnntConfig", functools.partial(RnntConfig, **dims))


def test_jax_export_loads_into_converted_state_dicts(jax_dir, monkeypatch):
    jm, d = jax_dir
    zc, rc = _port_cfgs(jm)
    want = _jax_states(jm)
    got = oi.load_zipformer_rnnt(str(d), zc, rc)
    for g, w in zip(got, want):
        _assert_states_equal(g, w)

    # The strict name pass alone takes every encoder tensor.
    init = oi._strip_prefixes(oi.read_onnx(oi._find(str(d), "encoder-"))["initializers"])
    state = oi._template(treg.ZipformerEncoder(zc))
    assert oi.map_initializers(init, oi.zipformer_name_map(zc), state) == []

    tiny_registry(monkeypatch, jm)
    model = treg.load_asr_model(str(d), beam_size=3, device="cpu")
    assert model.id2token == jm.id2token and model.beam_size == 3
    assert model.device.type == "cpu"
    for module, w in zip((model.encoder, model.decoder, model.joiner), want):
        _assert_states_equal(module.state_dict(), w)


def test_port_writer_reads_back_in_jax(tmp_path):
    """export_asr_dir of the converted model -> the JAX loader gives the
    JAX trees back, leaf for leaf."""
    from sherpa_vietnamese_asr_tpu.models.onnx_import import load_zipformer_rnnt

    jm = _jax_tiny(seed=3)
    zc, rc = _port_cfgs(jm)
    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    tm = convert.asr_model_from_numpy(enc, dec, joi, zc, rc, jm.id2token,
                                      device="cpu")
    paths = export_asr_dir(tm, str(tmp_path))
    assert treg.load_tokens(paths["tokens"]) == jm.id2token
    got = load_zipformer_rnnt(str(tmp_path), jm.zip_cfg, jm.rnnt_cfg)
    want = (jm.enc_params, jm.dec_params, jm.joi_params)
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(a.reshape(b.shape), b)


def _rewrite(src, dst, rename=lambda k: k, constants=()):
    """Copy an initializer-only file under new names; `constants` become
    Constant nodes instead of initializers."""
    b = GraphBuilder()
    for k, v in oi.read_onnx(str(src))["initializers"].items():
        if k in constants:
            b.node("Constant", [], outputs=rename(k), value=np.asarray(v))
        else:
            b.init(rename(k), v)
    dst.write_bytes(b.build())


@pytest.fixture(scope="module")
def port_dir(jax_dir, tmp_path_factory):
    """The same weights through the port's writer: its files keep the name
    map's (icefall's state-dict) order, as torch exports do, which the
    fallback's order term relies on."""
    jm, _ = jax_dir
    zc, rc = _port_cfgs(jm)
    enc, dec, joi = jax.tree.map(np.asarray, (jm.enc_params, jm.dec_params,
                                              jm.joi_params))
    tm = convert.asr_model_from_numpy(enc, dec, joi, zc, rc, jm.id2token,
                                      device="cpu")
    d = tmp_path_factory.mktemp("port_export")
    export_asr_dir(tm, str(d))
    return jm, d


@pytest.mark.parametrize("kind", ["prefixed", "renamed", "constant_nodes"])
def test_fallback_resolves_renamed_names(port_dir, tmp_path, kind):
    jm, d = port_dir
    zc, rc = _port_cfgs(jm)
    want = _jax_states(jm)
    names = list(oi.read_onnx(oi._find(str(d), "encoder-"))["initializers"])
    opaque = {k: f"onnx::MatMul_{i}" for i, k in enumerate(names)
              if k.endswith("in_proj.weight") and ".layers.0." in k}
    assert len(opaque) >= 6
    rename, constants = {
        "prefixed": (lambda k: "model." + k, ()),
        "renamed": (lambda k: opaque.get(k, k), ()),
        "constant_nodes": (lambda k: k, [k for k in names if "conv_module1" in k]),
    }[kind]
    for role in ("encoder", "decoder", "joiner"):
        src = oi._find(str(d), role + "-")
        dst = tmp_path / src.rsplit("/", 1)[-1]
        _rewrite(src, dst, rename if role == "encoder" else (lambda k: "module." + k),
                 constants)
    got = oi.load_zipformer_rnnt(str(tmp_path), zc, rc)
    for g, w in zip(got, want):
        _assert_states_equal(g, w)


def test_missing_tensor_raises_import_report(jax_dir, tmp_path):
    jm, d = jax_dir
    zc, rc = _port_cfgs(jm)
    for role in ("encoder", "decoder", "joiner"):
        src = oi._find(str(d), role + "-")
        dst = tmp_path / src.rsplit("/", 1)[-1]
        init = oi.read_onnx(src)["initializers"]
        b = GraphBuilder()
        for k, v in init.items():
            if k != "encoder.encoders.1.encoder.layers.0.norm.bias":
                b.init(k, v)
        dst.write_bytes(b.build())
    with pytest.raises(oi.ImportReport, match="encoder"):
        oi.load_zipformer_rnnt(str(tmp_path), zc, rc)


def test_load_asr_model_defaults_to_the_card(jax_dir):
    """Without a card the default device raises before any file is read."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    _, d = jax_dir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.load_asr_model(str(d))
