# The port's numpy graph executor and graph emitters against the JAX
# package's, on the CPU:
#   * models/onnx_exec.run_onnx equals the JAX run_onnx, bit for bit, on the
#     op cases of tests/test_onnx_exec.py (the same graph bytes and feeds);
#   * models/onnx_synth.GraphBuilder writes the JAX builder's bytes;
#   * build_encoder_graph / build_decoder_graph / build_joiner_graph and the
#     four aux builders emit bytes equal to the JAX builders' for the same
#     weights (the JAX trees reach the port through models/convert.py);
#   * run_onnx of each graph agrees with the port's CPU forward within
#     models/verify_assets' gates (MAX_ABS, REL_L2);
#   * which aux graphs the port's loaders read back (only DNSMOS's).
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.models import onnx_exec as jexec
from sherpa_vietnamese_asr_tpu.models import onnx_synth as jsynth

from sherpa_vietnamese_asr_tpu_torch.models import onnx_exec as texec
from sherpa_vietnamese_asr_tpu_torch.models import onnx_synth as tsynth
from sherpa_vietnamese_asr_tpu_torch.models.verify_assets import MAX_ABS, REL_L2

torch.set_num_threads(2)


def _lstm_inits(rng, inp, hid, bidirectional):
    def mat(rows, cols):
        return rng.standard_normal((rows, cols)).astype(np.float32) * 0.3

    dirs = 2 if bidirectional else 1
    return {"w": np.stack([mat(4 * hid, inp) for _ in range(dirs)]),
            "r": np.stack([mat(4 * hid, hid) for _ in range(dirs)]),
            "b": np.stack([mat(1, 8 * hid)[0] for _ in range(dirs)])}


def _gru_inits(rng, inp, hid):
    return {"w": rng.standard_normal((1, 3 * hid, inp)).astype(np.float32) * 0.3,
            "r": rng.standard_normal((1, 3 * hid, hid)).astype(np.float32) * 0.3,
            "b": rng.standard_normal((1, 6 * hid)).astype(np.float32) * 0.3}


def _case(name, rng):
    """(op, feeds, inits, n_out, attrs) of one tests/test_onnx_exec.py case."""
    n = rng.standard_normal
    f32 = np.float32
    i64 = np.int64
    x3 = n((2, 6, 5)).astype(f32)
    cases = {
        "conv1d_grouped_dilated": lambda: ("Conv", {"x": n((2, 8, 37)).astype(f32)},
                                           {"w": n((12, 2, 5)).astype(f32), "b": n(12).astype(f32)},
                                           1, dict(strides=(2,), pads=(3, 3), dilations=(2,), group=4)),
        "conv2d": lambda: ("Conv", {"x": n((1, 3, 17, 19)).astype(f32)},
                           {"w": n((6, 3, 3, 3)).astype(f32)}, 1,
                           dict(strides=(2, 1), pads=(1, 0, 1, 0), dilations=(1, 1), group=1)),
        "conv_transpose1d": lambda: ("ConvTranspose", {"x": n((2, 4, 11)).astype(f32)},
                                     {"w": n((4, 1, 32)).astype(f32)}, 1, dict(strides=(16,))),
        "lstm_bidirectional": lambda: ("LSTM", {"x": n((7, 3, 5)).astype(f32)},
                                       _lstm_inits(rng, 5, 4, True), 3,
                                       dict(direction="bidirectional", hidden_size=4)),
        "gru": lambda: ("GRU", {"x": n((6, 2, 4)).astype(f32)}, _gru_inits(rng, 4, 5), 2,
                        dict(hidden_size=5, linear_before_reset=1)),
        "max_pool": lambda: ("MaxPool", {"x": n((2, 3, 15, 13)).astype(f32)}, {}, 1,
                             dict(kernel_shape=(3, 3), strides=(2, 2), pads=(1, 1, 1, 1))),
        "average_pool": lambda: ("AveragePool", {"x": n((2, 3, 15, 13)).astype(f32)}, {}, 1,
                                 dict(kernel_shape=(2, 2), strides=(2, 2))),
        "batch_norm": lambda: ("BatchNormalization", {"x": n((2, 5, 9)).astype(f32)},
                               {"s": n(5).astype(f32), "b": n(5).astype(f32),
                                "m": n(5).astype(f32), "v": (rng.random(5) + 0.5).astype(f32)},
                               1, dict(epsilon=1e-5)),
        "layer_norm": lambda: ("LayerNormalization", {"x": n((2, 5, 9)).astype(f32)},
                               {"g": n(9).astype(f32), "b": n(9).astype(f32)}, 1, dict(axis=-1)),
        "softmax": lambda: ("Softmax", {"x": n((3, 7)).astype(f32)}, {}, 1, dict(axis=1)),
        "log_softmax": lambda: ("LogSoftmax", {"x": n((3, 7)).astype(f32)}, {}, 1, dict(axis=-1)),
        "prelu": lambda: ("PRelu", {"x": n((2, 3, 4)).astype(f32)},
                          {"s": np.asarray([0.1, 0.3, 0.5], f32)}, 1, {}),
        "transpose": lambda: ("Transpose", {"x": x3}, {}, 1, dict(perm=(2, 0, 1))),
        "reshape": lambda: ("Reshape", {"x": x3}, {"s": np.asarray([2, -1], i64)}, 1, {}),
        "split": lambda: ("Split", {"x": x3}, {}, 3, dict(axis=1)),
        "slice": lambda: ("Slice", {"x": x3}, {"st": np.asarray([1], i64), "en": np.asarray([4], i64),
                                               "ax": np.asarray([1], i64), "sp": np.asarray([2], i64)},
                          1, {}),
        "slice_attrs": lambda: ("Slice", {"x": np.arange(10, dtype=f32)}, {}, 1,
                                dict(starts=(-3,), ends=(2147483647,), axes=(0,))),
        "unsqueeze": lambda: ("Unsqueeze", {"x": x3}, {"ax": np.asarray([0, 3], i64)}, 1, {}),
        "gather": lambda: ("Gather", {"x": x3}, {"i": np.asarray([2, 0], i64)}, 1, dict(axis=1)),
        "pad": lambda: ("Pad", {"x": x3}, {"p": np.asarray([0, 0, 2, 0, 0, 3], i64)}, 1, {}),
        "reduce_mean": lambda: ("ReduceMean", {"x": x3}, {}, 1, dict(axes=(2,), keepdims=0)),
        "gemm": lambda: ("Gemm", {"a": n((4, 3)).astype(f32)},
                         {"w": n((5, 3)).astype(f32), "c": n(5).astype(f32)}, 1,
                         dict(transB=1, alpha=2.0, beta=0.5)),
    }
    for op in ("Relu", "Sigmoid", "Tanh", "Erf", "Softplus"):
        cases[op.lower()] = (lambda op=op: (op, {"x": n((3, 7)).astype(f32)}, {}, 1, {}))
    return cases[name]()


def _build(synth, op, feeds, inits, n_out, attrs, tail=()):
    b = synth.GraphBuilder()
    ins = [b.input(k) for k in feeds]
    for k, v in inits.items():
        ins.append(b.init(k, v))
    ins += [b.input(k) for k in tail]
    out = b.node(op, ins, n_out=n_out, **attrs)
    for o in (out if isinstance(out, list) else [out]):
        b.output(o)
    return b.build()


CASES = ["conv1d_grouped_dilated", "conv2d", "conv_transpose1d", "lstm_bidirectional",
         "gru", "max_pool", "average_pool", "batch_norm", "layer_norm", "relu", "sigmoid",
         "tanh", "erf", "softplus", "softmax", "log_softmax", "prelu", "transpose",
         "reshape", "split", "slice", "slice_attrs", "unsqueeze", "gather", "pad",
         "reduce_mean", "gemm", "lstm_sequence_lens", "gru_sequence_lens"]


@pytest.mark.parametrize("name", CASES)
def test_run_onnx_equals_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "lstm_sequence_lens":
        op, n_out, attrs = "LSTM", 3, dict(direction="bidirectional", hidden_size=5)
        feeds = {"x": rng.standard_normal((8, 3, 4)).astype(np.float32)}
        inits = _lstm_inits(rng, 4, 5, True)
        tail = {"lens": np.array([8, 5, 3], np.int32),
                "h0": rng.standard_normal((2, 3, 5)).astype(np.float32),
                "c0": rng.standard_normal((2, 3, 5)).astype(np.float32)}
    elif name == "gru_sequence_lens":
        op, n_out, attrs = "GRU", 2, dict(hidden_size=5, linear_before_reset=1)
        feeds = {"x": rng.standard_normal((7, 3, 4)).astype(np.float32)}
        inits = _gru_inits(rng, 4, 5)
        tail = {"lens": np.array([7, 4, 2], np.int32),
                "h0": rng.standard_normal((1, 3, 5)).astype(np.float32)}
    else:
        op, feeds, inits, n_out, attrs = _case(name, rng)
        tail = {}
    data = _build(tsynth, op, feeds, inits, n_out, attrs, tail)
    assert data == _build(jsynth, op, feeds, inits, n_out, attrs, tail)
    got = texec.run_onnx(data, {**feeds, **tail})
    want = jexec.run_onnx(data, {**feeds, **tail})
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _gate(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= MAX_ABS
    assert np.linalg.norm(got - ref) <= REL_L2 * np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# RNN-T graphs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def asr():
    from sherpa_vietnamese_asr_tpu.models.registry import TINY_ZIPFORMER, random_asr_model

    from tests.test_torch_slice import _convert

    jm = random_asr_model(vocab_size=60, seed=3, zip_cfg=dataclasses.replace(
        TINY_ZIPFORMER, pos_dtype="float32"))
    return jm, _convert(jm, beam_size=4)


def test_rnnt_graphs_equal_jax_bytes(asr):
    from sherpa_vietnamese_asr_tpu.models import onnx_export_rnnt as jx

    from sherpa_vietnamese_asr_tpu_torch.models import onnx_export_rnnt as tx

    jm, tm = asr
    j_enc = jx.invert_zipformer_to_torch(jm.enc_params, jm.zip_cfg)
    j_dec, j_joi = jx.invert_rnnt_to_torch(jm.dec_params, jm.joi_params)
    t_enc = tx.invert_zipformer_to_torch(tx._numpy_state(tm.encoder), tm.zip_cfg)
    t_dec, t_joi = tx.invert_rnnt_to_torch(tx._numpy_state(tm.decoder),
                                           tx._numpy_state(tm.joiner))
    for t_in in (96, 103):
        assert tx.build_encoder_graph(t_enc, tm.zip_cfg, t_in) == \
            jx.build_encoder_graph(j_enc, jm.zip_cfg, t_in)
    assert tx.build_decoder_graph(t_dec, tm.rnnt_cfg) == \
        jx.build_decoder_graph(j_dec, jm.rnnt_cfg)
    assert tx.build_joiner_graph(t_joi) == jx.build_joiner_graph(j_joi)


def test_rnnt_graphs_execute_like_the_port(asr, tmp_path):
    """export_asr_dir(..., t_in) against the port's CPU forwards; without
    t_in the files hold initializers only, and both read back the same."""
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_import
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx

    _, tm = asr
    t_in = 103
    paths = export_asr_dir(tm, str(tmp_path / "exec"), t_in)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, t_in, 80)).astype(np.float32) * 0.5
    (enc_onnx,) = texec.run_onnx(paths["encoder"], {"x": x})
    enc, lens = tm.encoder(torch.from_numpy(x), torch.tensor([t_in]))
    _gate(enc_onnx, enc[:, : int(lens[0])].numpy())

    y = rng.integers(0, 60, (5, 2)).astype(np.int64)
    (dec_onnx,) = texec.run_onnx(paths["decoder"], {"y": y})
    with torch.no_grad():
        dec = tm.decoder(torch.from_numpy(y))
        eo = torch.from_numpy(rng.standard_normal((5, tm.zip_cfg.output_dim)).astype(np.float32))
        logits = tm.joiner(eo, dec).numpy()
    _gate(dec_onnx, dec.numpy())
    (logits_onnx,) = texec.run_onnx(paths["joiner"], {
        "encoder_out": eo.numpy(), "decoder_out": dec_onnx.astype(np.float32)})
    _gate(logits_onnx, logits)

    weights = export_asr_dir(tm, str(tmp_path / "weights"))
    for role in ("encoder", "decoder", "joiner"):
        assert read_onnx(weights[role])["nodes"] == []
        assert read_onnx(paths[role])["nodes"]
    for d in (tmp_path / "exec", tmp_path / "weights"):
        got = onnx_import.load_zipformer_rnnt(str(d), tm.zip_cfg, tm.rnnt_cfg)
        for module, state in zip((tm.encoder, tm.decoder, tm.joiner), got):
            for k, v in module.state_dict().items():
                np.testing.assert_array_equal(state[k], v.numpy())


# ---------------------------------------------------------------------------
# Aux graphs
# ---------------------------------------------------------------------------

def _exec(data, feeds):
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx

    g = read_onnx(data)
    assert g["nodes"], "emitted graph has no nodes"
    names = [n for n in g["inputs"] if n not in g["initializers"]]
    assert len(names) == len(feeds)
    return texec.run_onnx(g, dict(zip(names, feeds)))


def _jax_params(init, seed, cfg):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def _pyannet(rng):
    from sherpa_vietnamese_asr_tpu.models.pyannet import PyanNetConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.pyannet import init_pyannet_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig

    kw = dict(sinc_filters=8, conv_channels=6, lstm_hidden=4, lstm_layers=2, linear_dim=5)
    p = _jax_params(init_pyannet_params, 0, JaxCfg(**kw))
    model = convert.pyannet_from_numpy(convert.pyannet_state_dict(p), PyanNetConfig(**kw),
                                       device="cpu")
    audio = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(audio)).numpy()
    return (p, JaxCfg(**kw), 2, 4000), (model, 2, 4000), [audio], [ref]


def _resnet(rng):
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import TINY_RESNET as JAX_TINY
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import init_resnet_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import TINY_RESNET

    p = _jax_params(init_resnet_params, 3, JAX_TINY)
    # non-trivial BatchNorm statistics, so the folded constants are checked
    for blk in [p] + [b for stage in p["stages"] for b in stage]:
        for key in ("bn1", "bn2", "down_bn"):
            if key in blk:
                bn = blk[key]
                bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32) * 0.1
                bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    model = convert.resnet_from_numpy(convert.resnet_state_dict(p), TINY_RESNET, device="cpu")
    feats = rng.standard_normal((2, 40, 80)).astype(np.float32)
    with torch.no_grad():
        ref = model.resnet_frame_features(torch.from_numpy(feats)).numpy()
    return (p, JAX_TINY, 2, 40), (model, 2, 40), [feats], [ref]


def _vibert(rng):
    from sherpa_vietnamese_asr_tpu.models.vibert import TINY_VIBERT as JAX_TINY
    from sherpa_vietnamese_asr_tpu.models.vibert import init_vibert_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import TINY_VIBERT

    p = _jax_params(init_vibert_params, 7, JAX_TINY)
    model = convert.vibert_from_numpy(convert.vibert_state_dict(p), TINY_VIBERT, device="cpu")
    b, t, w = 2, 16, 6
    ids = rng.integers(0, 200, (b, t)).astype(np.int64)
    mask = np.ones((b, t), np.int64)
    mask[0, 12:] = 0
    types = np.zeros((b, t), np.int64)
    offs = np.sort(rng.integers(0, 12, (b, w)), axis=1).astype(np.int64)
    with torch.no_grad():
        r1, r2 = model.vibert_forward(*(torch.from_numpy(a) for a in (ids, mask, types, offs)))
    return (p, JAX_TINY, b, t, w), (model, b, t, w), [ids, mask, types, offs], \
        [r1.numpy(), r2.numpy()]


def _dnsmos(rng):
    from sherpa_vietnamese_asr_tpu.models.dnsmos import DnsmosConfig as JaxCfg
    from sherpa_vietnamese_asr_tpu.models.dnsmos import init_dnsmos_params

    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import INPUT_SAMPLES, DnsmosConfig

    p = _jax_params(init_dnsmos_params, 11, JaxCfg())
    model = convert.dnsmos_from_numpy(convert.dnsmos_state_dict(p), DnsmosConfig(), device="cpu")
    audio = (0.1 * rng.standard_normal((1, INPUT_SAMPLES))).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(audio)).numpy()
    return (p, JaxCfg(), 1), (model, 1), [audio], [ref]


AUX = {"pyannet": (_pyannet, "build_pyannet_graph"),
       "resnet": (_resnet, "build_resnet_encoder_graph"),
       "vibert": (_vibert, "build_vibert_graph"),
       "dnsmos": (_dnsmos, "build_dnsmos_graph")}


@pytest.mark.parametrize("family", list(AUX))
def test_aux_graph_equals_jax_and_executes_like_the_port(family):
    from sherpa_vietnamese_asr_tpu.models import onnx_export_aux as jx

    from sherpa_vietnamese_asr_tpu_torch.models import onnx_export_aux as tx

    make, builder = AUX[family]
    jax_args, port_args, feeds, refs = make(np.random.default_rng(0))
    data = getattr(tx, builder)(*port_args)
    assert data == getattr(jx, builder)(*jax_args)
    outs = _exec(data, feeds)
    assert len(outs) == len(refs)
    for got, ref in zip(outs, refs):  # DNSMOS's graph: the rfft as two DFT products
        _gate(got, ref)


@pytest.mark.parametrize("family,readable", [("pyannet", False), ("resnet", False),
                                             ("vibert", False), ("dnsmos", True)])
def test_which_aux_graphs_the_loaders_read(family, readable, tmp_path):
    """Only load_dnsmos reads its executable graph back (to the same
    weights); the others refuse theirs, so the rehearsal writes
    initializer-only files for them."""
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_export_aux as tx
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_import as oi

    make, builder = AUX[family]
    _, port_args, _, _ = make(np.random.default_rng(0))
    path = tmp_path / f"{family}.onnx"
    path.write_bytes(getattr(tx, builder)(*port_args))
    if family == "resnet":
        seg_1 = port_args[0].resnet.seg_1
        np.save(tmp_path / "w.npy", seg_1.weight.detach().numpy())
        np.save(tmp_path / "b.npy", seg_1.bias.detach().numpy())
        load = lambda: oi.load_resnet_speaker(str(path), str(tmp_path / "w.npy"),  # noqa: E731
                                              str(tmp_path / "b.npy"))
    else:
        load = lambda: getattr(oi, f"load_{family}")(str(path))  # noqa: E731
    if not readable:
        with pytest.raises(oi.ImportReport, match="not found"):
            load()
        return
    state, _ = load()
    want = port_args[0].state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)
