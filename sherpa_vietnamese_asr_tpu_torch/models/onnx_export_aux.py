# The VAD, punctuation and quality models' checkpoint files, written from
# this package's modules, and the executable graphs of the auxiliary model
# families.
#
# export_silero_file, export_vibert_files and export_dnsmos_file write files
# that hold initializers only, which models/onnx_import.load_silero_vad,
# load_vibert and load_dnsmos (this package's and the JAX package's) read
# back:
#   * silero_vad_16k_op15.onnx carries the Silero v5 traced-graph names
#     (_model.stft.forward_basis_buffer, _model.encoder.{i}.reparam_conv.*,
#     _model.decoder.rnn.*, _model.decoder.decoder.2.*);
#   * ViBert mirrors the Hugging Face tree, so vibert-capu.onnx carries its
#     state-dict names, with vocab.txt beside it;
#   * sig_bak_ovr.onnx carries the TF/Keras layouts the structural loader
#     expects: conv kernels [O, I, 3, 3] in chain order, then the dense
#     weights as [in, out] (dense1 is square, so only that layout reads back
#     unambiguously); each bias follows its weight. The fixed mel matrix is
#     not written.
#
# build_pyannet_graph, build_resnet_encoder_graph, build_vibert_graph and
# build_dnsmos_graph are the graph half of
# sherpa_vietnamese_asr_tpu/models/onnx_export_aux.py: REAL node graphs
# that the numpy executor (models/onnx_exec.py) runs end to end, so each
# forward of this package can be held against an independent execution of
# the same weights (models/verify_assets.py). They take a PyanNet,
# ResNetSpeaker, ViBert or Dnsmos, read its weights as numpy in the JAX
# package's tree layout (_pyannet_tree and its siblings, the inverse of
# models/convert.py), and emit the JAX package's nodes, names and constants.
# Structural choices (NCHW layouts, LSTM gate order iofc, DFT-as-matmul)
# follow ONNX semantics. The loaders read back none of these graph files:
# their initializers carry graph names (embeddings.word, conv0.weight, ...)
# and the graphs fold constants (the sinc filter bank, the BatchNorm
# statistics, ViBERT's positions cut to T).

from __future__ import annotations

import math
import os

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import INPUT_SAMPLES
from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import (
    _initializers_only,
    _numpy_state,
)
from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import GraphBuilder


def export_vibert_files(model, vocab, out_dir: str) -> dict:
    """Write vibert-capu.onnx and vocab.txt (one WordPiece piece a line) for
    a float32 ViBert into out_dir; returns {file name: path}."""
    if model.int8:
        raise ValueError("export_vibert_files writes the float32 tier; the int8 "
                         "tier is quantized at load time (prefer_int8)")
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, name) for name in ("vibert-capu.onnx", "vocab.txt")}
    with open(paths["vibert-capu.onnx"], "wb") as f:
        f.write(_initializers_only(_numpy_state(model)))
    with open(paths["vocab.txt"], "w", encoding="utf-8") as f:
        f.writelines(f"{piece}\n" for piece in vocab)
    return paths


def export_silero_file(model, out_dir: str) -> str:
    """Write silero_vad_16k_op15.onnx for a SileroVad into out_dir; returns
    its path."""
    s = _numpy_state(model)
    tensors = {"_model.stft.forward_basis_buffer":
               np.concatenate([s["stft_cos"], s["stft_sin"]])[:, None, :]}
    for i in range(len(model.cfg.encoder_channels)):
        tensors[f"_model.encoder.{i}.reparam_conv.weight"] = s[f"encoder.{i}.weight"]
        tensors[f"_model.encoder.{i}.reparam_conv.bias"] = s[f"encoder.{i}.bias"]
    for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        tensors[f"_model.decoder.rnn.{leaf}"] = s[f"lstm.{leaf}_l0"]
    tensors["_model.decoder.decoder.2.weight"] = s["head.weight"][:, :, None]
    tensors["_model.decoder.decoder.2.bias"] = s["head.bias"]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "silero_vad_16k_op15.onnx")
    with open(path, "wb") as f:
        f.write(_initializers_only(tensors))
    return path


def export_dnsmos_file(model, out_dir: str) -> str:
    """Write sig_bak_ovr.onnx for a Dnsmos into out_dir; returns its path."""
    state = _numpy_state(model)
    tensors = {}
    for i in range(len(model.convs)):
        tensors[f"conv{i}.weight"] = state[f"convs.{i}.weight"]
        tensors[f"conv{i}.bias"] = state[f"convs.{i}.bias"]
    for name in ("dense1", "head"):
        tensors[f"{name}.weight"] = state[f"{name}.weight"].T
        tensors[f"{name}.bias"] = state[f"{name}.bias"]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "sig_bak_ovr.onnx")
    with open(path, "wb") as f:
        f.write(_initializers_only(tensors))
    return path


# ---------------------------------------------------------------------------
# Module -> the JAX package's parameter tree (numpy; inverse of convert.py)
# ---------------------------------------------------------------------------

def _w(state, name):
    """A torch Linear's weight as [in, out]."""
    return state[name].T


def _lin(state, prefix):
    return {"weight": _w(state, f"{prefix}.weight"), "bias": state[f"{prefix}.bias"]}


def _pyannet_tree(model) -> dict:
    s = _numpy_state(model)
    cfg = model.cfg
    n_convs = sum(1 for k in s if k.startswith("sincnet.conv1d.") and k.endswith(".weight"))
    lstm = []
    for k in range(cfg.lstm_layers):
        layer = {}
        for suffix, direction in (("", "fwd"), ("_reverse", "bwd")):
            layer[direction] = {
                "wi": s[f"lstm.weight_ih_l{k}{suffix}"].T,
                "wh": s[f"lstm.weight_hh_l{k}{suffix}"].T,
                "b": s[f"lstm.bias_ih_l{k}{suffix}"] + s[f"lstm.bias_hh_l{k}{suffix}"]}
        lstm.append(layer)
    return {
        "sinc_low_hz": s["sincnet.conv1d.0.low_hz_"],
        "sinc_band_hz": s["sincnet.conv1d.0.band_hz_"],
        "wav_norm": {"scale": s["sincnet.wav_norm1d.weight"],
                     "bias": s["sincnet.wav_norm1d.bias"]},
        "norms": [{"scale": s[f"sincnet.norm1d.{i}.weight"],
                   "bias": s[f"sincnet.norm1d.{i}.bias"]} for i in range(n_convs + 1)],
        "convs": [{"weight": s[f"sincnet.conv1d.{i + 1}.weight"].transpose(2, 1, 0),
                   "bias": s[f"sincnet.conv1d.{i + 1}.bias"]} for i in range(n_convs)],
        "lstm": lstm,
        "linear1": _lin(s, "linear.0"),
        "linear2": _lin(s, "linear.1"),
        "classifier": _lin(s, "classifier"),
    }


def _bn_tree(s, prefix):
    return {"scale": s[f"{prefix}.weight"], "bias": s[f"{prefix}.bias"],
            "mean": s[f"{prefix}.running_mean"], "var": s[f"{prefix}.running_var"]}


def _tfio(w):
    """torch conv kernel [O, I, kF, kT] -> the JAX ResNet's [kT, kF, I, O]."""
    return w.transpose(3, 2, 1, 0)


def _resnet_tree(model) -> dict:
    s = _numpy_state(model)
    stages = []
    for stage, n_blocks in enumerate(model.cfg.blocks):
        blocks = []
        for j in range(n_blocks):
            pre = f"resnet.layer{stage + 1}.{j}"
            blk = {"conv1": _tfio(s[f"{pre}.conv1.weight"]), "bn1": _bn_tree(s, f"{pre}.bn1"),
                   "conv2": _tfio(s[f"{pre}.conv2.weight"]), "bn2": _bn_tree(s, f"{pre}.bn2")}
            if f"{pre}.shortcut.0.weight" in s:
                blk["down_conv"] = _tfio(s[f"{pre}.shortcut.0.weight"])
                blk["down_bn"] = _bn_tree(s, f"{pre}.shortcut.1")
            blocks.append(blk)
        stages.append(blocks)
    return {"conv1": _tfio(s["resnet.conv1.weight"]), "bn1": _bn_tree(s, "resnet.bn1"),
            "stages": stages}


def _vibert_tree(model) -> dict:
    if model.int8:
        raise ValueError("build_vibert_graph emits the float32 tier")
    s = _numpy_state(model)

    def ln(prefix):
        return {"scale": s[f"{prefix}.weight"], "bias": s[f"{prefix}.bias"]}

    layers = []
    for i in range(model.cfg.layers):
        pre = f"bert.encoder.layer.{i}"
        lp = {dst: _lin(s, f"{pre}.{src}") for dst, src in (
            ("q", "attention.self.query"), ("k", "attention.self.key"),
            ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
            ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense"))}
        lp["attn_ln"] = ln(f"{pre}.attention.output.LayerNorm")
        lp["ffn_ln"] = ln(f"{pre}.output.LayerNorm")
        layers.append(lp)
    return {"word_emb": s["bert.embeddings.word_embeddings.weight"],
            "pos_emb": s["bert.embeddings.position_embeddings.weight"],
            "type_emb": s["bert.embeddings.token_type_embeddings.weight"],
            "emb_ln": ln("bert.embeddings.LayerNorm"),
            "layers": layers,
            "labels_head": _lin(s, "classifier"),
            "d_tags_head": _lin(s, "detector")}


def _dnsmos_tree(model) -> dict:
    s = _numpy_state(model)
    return {"mel": s["mel"],
            "convs": [{"weight": s[f"convs.{i}.weight"].transpose(2, 3, 1, 0),  # OIHW -> HWIO
                       "bias": s[f"convs.{i}.bias"]} for i in range(len(model.convs))],
            "dense1": _lin(s, "dense1"),
            "head": _lin(s, "head")}


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Shared emit helpers
# ---------------------------------------------------------------------------

def _emit_instance_norm_nct(b, x, c_scale, c_bias, eps=1e-5):
    """Instance norm over time for [B, C, T]: per-sample, per-channel.
    c_scale/c_bias: [C] numpy or None (non-affine)."""
    mu = b.node("ReduceMean", [x, b.const(np.asarray([2], np.int64))],
                keepdims=1)
    cen = b.node("Sub", [x, mu])
    var = b.node("ReduceMean",
                 [b.node("Mul", [cen, cen]),
                  b.const(np.asarray([2], np.int64))], keepdims=1)
    std = b.node("Sqrt", [b.node("Add", [var, b.const(_np(eps))])])
    out = b.node("Div", [cen, std])
    if c_scale is not None:
        out = b.node("Mul", [out, b.const(_np(c_scale).reshape(-1, 1))])
        out = b.node("Add", [out, b.const(_np(c_bias).reshape(-1, 1))])
    return out


def _emit_linear(b, x, w, bias, name=None):
    """x @ w + bias with w [d_in, d_out]."""
    y = b.node("MatMul", [x, b.init(name + ".weight", _np(w))
                          if name else b.const(_np(w))])
    return b.node("Add", [y, b.init(name + ".bias", _np(bias))
                          if name else b.const(_np(bias))])


def _emit_layer_norm(b, x, scale, bias, eps):
    return b.node("LayerNormalization",
                  [x, b.const(_np(scale)), b.const(_np(bias))],
                  axis=-1, epsilon=float(eps))


# ---------------------------------------------------------------------------
# PyanNet (models/pyannet.PyanNet twin)
# ---------------------------------------------------------------------------

def _sinc_filter_bank(params, cfg) -> np.ndarray:
    """Numpy twin of PyanNet.sinc_filters -> ONNX Conv weight [F, 1, K].
    The (low, band) parameterization is resolved into a fixed filter bank at
    export time, exactly like pyannote's own ONNX export does."""
    low = cfg.min_low_hz + np.abs(_np(params["sinc_low_hz"]))  # [F, 1]
    high = np.clip(low + cfg.min_band_hz + np.abs(_np(params["sinc_band_hz"])),
                   cfg.min_low_hz, cfg.sample_rate / 2)
    band = (high - low)[:, 0]
    n = (cfg.sinc_kernel - 1) // 2
    t = np.arange(-n, 0, dtype=np.float32)[None, :] / cfg.sample_rate
    window = np.hamming(cfg.sinc_kernel).astype(np.float32)[:n][None, :]
    f_low = 2 * math.pi * low
    f_high = 2 * math.pi * high
    left = ((np.sin(f_high * t) - np.sin(f_low * t))
            / (2 * math.pi * t / 2)) * window
    center = 2 * band[:, None]
    filters = np.concatenate([left, center, left[:, ::-1]], axis=1)
    filters = filters / (2 * band[:, None] + 1e-8)
    return filters[:, None, :].astype(np.float32)  # [F, 1, K]


def _emit_bilstm(b, x, layer_params, hidden, t_len, batch):
    """x: [T, B, D] -> [T, B, 2H] via one bidirectional ONNX LSTM node.

    JAX package's tree layout: wi [D, 4H] with gate order (i,f,g,o)
    along the last axis, bias added on the input side only. ONNX wants
    W [2, 4H, D] rows in order (i, o, f, c)."""
    h = hidden

    def reorder(wi):  # [D, 4H] -> [4H, D] in iofc order
        wi = _np(wi)
        i, f, g, o = (wi[:, k * h:(k + 1) * h].T for k in range(4))
        return np.concatenate([i, o, f, g], axis=0)

    def bias(bv):  # [4H] (ifgo) -> [8H] (Wb iofc ++ Rb zeros)
        bv = _np(bv)
        i, f, g, o = (bv[k * h:(k + 1) * h] for k in range(4))
        return np.concatenate([i, o, f, g, np.zeros(4 * h, np.float32)])

    w = np.stack([reorder(layer_params["fwd"]["wi"]),
                  reorder(layer_params["bwd"]["wi"])])
    r = np.stack([reorder(layer_params["fwd"]["wh"]),
                  reorder(layer_params["bwd"]["wh"])])
    bb = np.stack([bias(layer_params["fwd"]["b"]),
                   bias(layer_params["bwd"]["b"])])
    y = b.node("LSTM", [x, b.const(w), b.const(r), b.const(bb)],
               n_out=3, direction="bidirectional", hidden_size=h)[0]
    # [T, 2, B, H] -> [T, B, 2H]
    y = b.node("Transpose", [y], perm=(0, 2, 1, 3))
    return b.node("Reshape",
                  [y, b.const(np.asarray([t_len, batch, 2 * h], np.int64))])


def build_pyannet_graph(model, batch: int = 1, t_in: int = 160000) -> bytes:
    """audio [B, t_in] -> log-softmax powerset scores [B, T', 7] for a
    PyanNet."""
    params, cfg = _pyannet_tree(model), model.cfg
    b = GraphBuilder()
    x = b.input("audio")
    # [B, T] -> [B, 1, T]; wav-level instance norm (affine, 1 channel)
    x = b.node("Unsqueeze", [x, b.const(np.asarray([1], np.int64))])
    wn = params.get("wav_norm")
    x = _emit_instance_norm_nct(
        b, x, _np(wn["scale"]) if wn else None,
        _np(wn["bias"]) if wn else None)
    # Sinc front-end as a plain strided Conv with the resolved filter bank
    x = b.node("Conv", [x, b.init("sincnet.conv.weight",
                                  _sinc_filter_bank(params, cfg))],
               strides=(cfg.sinc_stride,))
    x = b.node("Abs", [x])
    t = (t_in - cfg.sinc_kernel) // cfg.sinc_stride + 1

    norms = params.get("norms") or [None] * 3

    def block_tail(b_, x_, t_, norm):
        x_ = b_.node("MaxPool", [x_], kernel_shape=(cfg.pool,),
                     strides=(cfg.pool,))
        t_ = t_ // cfg.pool
        sc = _np(norm["scale"]) if norm else None
        bi = _np(norm["bias"]) if norm else None
        x_ = _emit_instance_norm_nct(b_, x_, sc, bi)
        return b_.node("LeakyRelu", [x_], alpha=0.01), t_

    x, t = block_tail(b, x, t, norms[0])
    for ci, conv in enumerate(params["convs"]):
        # JAX weight [K, I, O] -> ONNX [O, I, K]
        w = np.transpose(_np(conv["weight"]), (2, 1, 0))
        x = b.node("Conv", [x, b.init(f"sincnet.conv{ci + 1}.weight", w),
                            b.init(f"sincnet.conv{ci + 1}.bias",
                                   _np(conv["bias"]))])
        t = t - cfg.conv_kernel + 1
        x, t = block_tail(b, x, t, norms[ci + 1])

    # [B, C, T] -> [T, B, C] for the LSTM stack
    x = b.node("Transpose", [x], perm=(2, 0, 1))
    d = cfg.conv_channels
    for li, layer in enumerate(params["lstm"]):
        x = _emit_bilstm(b, x, layer, cfg.lstm_hidden, t, batch)
        d = 2 * cfg.lstm_hidden
    x = b.node("Transpose", [x], perm=(1, 0, 2))  # [B, T, 2H]
    x = b.node("LeakyRelu",
               [_emit_linear(b, x, params["linear1"]["weight"],
                             params["linear1"]["bias"], "linear1")],
               alpha=0.01)
    x = b.node("LeakyRelu",
               [_emit_linear(b, x, params["linear2"]["weight"],
                             params["linear2"]["bias"], "linear2")],
               alpha=0.01)
    x = _emit_linear(b, x, params["classifier"]["weight"],
                     params["classifier"]["bias"], "classifier")
    b.output(b.node("LogSoftmax", [x], axis=-1))
    return b.build()


# ---------------------------------------------------------------------------
# ResNet34 speaker-embedding frame encoder (models/resnet_speaker.py twin)
# ---------------------------------------------------------------------------

def _emit_conv_bn(b, x, conv_w, bn, name, strides=(1, 1), pads=(1, 1, 1, 1)):
    """JAX HWIO conv weight + BN dict -> Conv + BatchNormalization nodes."""
    w = np.transpose(_np(conv_w), (3, 2, 0, 1))  # HWIO -> OIHW
    x = b.node("Conv", [x, b.init(name + ".weight", w)],
               strides=strides, pads=pads)
    return b.node("BatchNormalization",
                  [x, b.const(_np(bn["scale"])), b.const(_np(bn["bias"])),
                   b.const(_np(bn["mean"])), b.const(_np(bn["var"]))],
                  epsilon=1e-5)


def build_resnet_encoder_graph(model, batch: int, t_in: int) -> bytes:
    """fbank [B, T, M] -> frame features [B, C*M', T'] for a ResNetSpeaker
    (the reference's embedding_encoder.onnx contract; pooling + projection
    stay external)."""
    params, cfg = _resnet_tree(model), model.cfg
    b = GraphBuilder()
    x = b.input("feats")
    x = b.node("Unsqueeze", [x, b.const(np.asarray([1], np.int64))])
    x = b.node("Relu", [_emit_conv_bn(b, x, params["conv1"], params["bn1"],
                                      "conv1")])
    for stage, blocks in enumerate(params["stages"]):
        for bi, block in enumerate(blocks):
            stride = 2 if (stage > 0 and bi == 0) else 1
            nm = f"stage{stage}.block{bi}"
            h = b.node("Relu", [_emit_conv_bn(
                b, x, block["conv1"], block["bn1"], nm + ".conv1",
                strides=(stride, stride))])
            h = _emit_conv_bn(b, h, block["conv2"], block["bn2"],
                              nm + ".conv2")
            if "down_conv" in block:
                x = _emit_conv_bn(b, x, block["down_conv"], block["down_bn"],
                                  nm + ".down", strides=(stride, stride),
                                  pads=(0, 0, 0, 0))
            x = b.node("Relu", [b.node("Add", [h, x])])
    # [B, C, T', M'] -> [B, C, M', T'] -> [B, C*M', T']
    t_out = cfg.out_time(t_in)
    x = b.node("Transpose", [x], perm=(0, 1, 3, 2))
    b.output(b.node("Reshape", [x, b.const(np.asarray(
        [batch, cfg.frame_feature_dim, t_out], np.int64))]))
    return b.build()


# ---------------------------------------------------------------------------
# ViBERT Seq2Labels (models/vibert.ViBert twin)
# ---------------------------------------------------------------------------

def build_vibert_graph(model, batch: int, t: int, w_words: int) -> bytes:
    """(input_ids, attention_mask, token_type_ids, input_offsets) ->
    (logits_labels [B, W, n_labels], logits_d_tags [B, W, n_d_tags]) for a
    float32 ViBert."""
    params, cfg = _vibert_tree(model), model.cfg
    b = GraphBuilder()
    ids = b.input("input_ids")
    mask = b.input("attention_mask")
    types = b.input("token_type_ids")
    offs = b.input("input_offsets")
    h = cfg.hidden
    hd = h // cfg.heads

    x = b.node("Gather", [b.init("embeddings.word", _np(params["word_emb"])),
                          ids], axis=0)
    x = b.node("Add", [x, b.const(_np(params["pos_emb"])[:t])])
    x = b.node("Add", [x, b.node(
        "Gather", [b.init("embeddings.type", _np(params["type_emb"])), types],
        axis=0)])
    x = _emit_layer_norm(b, x, params["emb_ln"]["scale"],
                         params["emb_ln"]["bias"], cfg.layer_norm_eps)

    # additive attention mask: (1 - mask) * -1e9 -> [B, 1, 1, T]
    neg = b.node("Mul", [b.node("Sub", [b.const(_np(1.0)),
                                        b.node("Cast", [mask], to=1)]),
                         b.const(_np(-1e9))])
    neg = b.node("Reshape", [neg, b.const(np.asarray([batch, 1, 1, t],
                                                     np.int64))])

    def heads_split(v):  # [B, T, H] -> [B, h, T, d]
        v = b.node("Reshape", [v, b.const(np.asarray(
            [batch, t, cfg.heads, hd], np.int64))])
        return b.node("Transpose", [v], perm=(0, 2, 1, 3))

    for li, lp in enumerate(params["layers"]):
        nm = f"layer{li}"
        q = heads_split(_emit_linear(b, x, lp["q"]["weight"],
                                     lp["q"]["bias"], nm + ".q"))
        k = heads_split(_emit_linear(b, x, lp["k"]["weight"],
                                     lp["k"]["bias"], nm + ".k"))
        v = heads_split(_emit_linear(b, x, lp["v"]["weight"],
                                     lp["v"]["bias"], nm + ".v"))
        scores = b.node("MatMul", [q, b.node("Transpose", [k],
                                             perm=(0, 1, 3, 2))])
        scores = b.node("Div", [scores, b.const(_np(math.sqrt(hd)))])
        attn = b.node("Softmax", [b.node("Add", [scores, neg])], axis=-1)
        ctx = b.node("MatMul", [attn, v])  # [B, h, T, d]
        ctx = b.node("Transpose", [ctx], perm=(0, 2, 1, 3))
        ctx = b.node("Reshape", [ctx, b.const(np.asarray([batch, t, h],
                                                         np.int64))])
        ao = _emit_linear(b, ctx, lp["attn_out"]["weight"],
                          lp["attn_out"]["bias"], nm + ".attn_out")
        x = _emit_layer_norm(b, b.node("Add", [x, ao]),
                             lp["attn_ln"]["scale"], lp["attn_ln"]["bias"],
                             cfg.layer_norm_eps)
        f = _emit_linear(b, x, lp["ffn_in"]["weight"], lp["ffn_in"]["bias"],
                         nm + ".ffn_in")
        # exact gelu: 0.5 * f * (1 + erf(f / sqrt(2)))
        g = b.node("Erf", [b.node("Div", [f, b.const(_np(math.sqrt(2.0)))])])
        f = b.node("Mul", [b.node("Mul", [f, b.const(_np(0.5))]),
                           b.node("Add", [g, b.const(_np(1.0))])])
        fo = _emit_linear(b, f, lp["ffn_out"]["weight"], lp["ffn_out"]["bias"],
                          nm + ".ffn_out")
        x = _emit_layer_norm(b, b.node("Add", [x, fo]),
                             lp["ffn_ln"]["scale"], lp["ffn_ln"]["bias"],
                             cfg.layer_norm_eps)

    # gather word-initial hidden states: [B, W] -> [B, W, H] GatherElements
    oi = b.node("Unsqueeze", [b.node("Cast", [offs], to=7),
                              b.const(np.asarray([2], np.int64))])
    oi = b.node("Expand", [oi, b.const(np.asarray([batch, w_words, h],
                                                  np.int64))])
    gathered = b.node("GatherElements", [x, oi], axis=1)
    b.output(_emit_linear(b, gathered, params["labels_head"]["weight"],
                          params["labels_head"]["bias"], "labels_head"),)
    b.output(_emit_linear(b, gathered, params["d_tags_head"]["weight"],
                          params["d_tags_head"]["bias"], "d_tags_head"))
    return b.build()


# ---------------------------------------------------------------------------
# DNSMOS (models/dnsmos.Dnsmos twin)
# ---------------------------------------------------------------------------

def build_dnsmos_graph(model, batch: int) -> bytes:
    """audio [B, 144160] -> raw (SIG, BAK, OVRL) [B, 3] for a Dnsmos. The
    rfft becomes two DFT matmuls (|X|^2 = (x@cos)^2 + (x@sin)^2) so the
    numpy executor needs no FFT op."""
    params, cfg = _dnsmos_tree(model), model.cfg
    b = GraphBuilder()
    x = b.input("audio")
    n_fft, hop = cfg.n_fft, cfg.hop
    n_frames = 1 + (INPUT_SAMPLES - n_fft) // hop
    n_spec = n_fft // 2 + 1
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).astype(np.int64)
    frames = b.node("Gather", [x, b.const(idx)], axis=1)  # [B, T, K]
    frames = b.node("Mul", [frames,
                            b.const(np.hanning(n_fft).astype(np.float32))])
    nk = np.arange(n_fft)[:, None] * np.arange(n_spec)[None, :]
    ang = 2.0 * np.pi * nk / n_fft
    re = b.node("MatMul", [frames, b.const(np.cos(ang).astype(np.float32))])
    im = b.node("MatMul", [frames, b.const(np.sin(ang).astype(np.float32))])
    power = b.node("Add", [b.node("Mul", [re, re]), b.node("Mul", [im, im])])
    mel = b.node("MatMul", [power, b.init("mel", _np(params["mel"]))])
    mel = b.node("Clip", [mel, b.const(_np(1e-10)), b.const(_np(3.4e38))])
    x = b.node("Mul", [b.node("Log", [mel]),
                       b.const(_np(1.0 / math.log(10.0)))])
    x = b.node("Unsqueeze", [x, b.const(np.asarray([1], np.int64))])
    t, m = n_frames, cfg.n_mels
    for ci, conv in enumerate(params["convs"]):
        w = np.transpose(_np(conv["weight"]), (3, 2, 0, 1))
        x = b.node("Conv", [x, b.init(f"conv{ci}.weight", w),
                            b.init(f"conv{ci}.bias", _np(conv["bias"]))],
                   pads=(1, 1, 1, 1))
        x = b.node("Relu", [x])
        x = b.node("MaxPool", [x], kernel_shape=(2, 2), strides=(2, 2))
        t, m = t // 2, m // 2
    x = b.node("GlobalAveragePool", [x])
    x = b.node("Flatten", [x], axis=1)
    x = b.node("Relu", [_emit_linear(b, x, params["dense1"]["weight"],
                                     params["dense1"]["bias"], "dense1")])
    b.output(_emit_linear(b, x, params["head"]["weight"],
                          params["head"]["bias"], "head"))
    return b.build()
