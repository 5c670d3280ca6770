# ONNX export of the Zipformer RNN-T (encoder / decoder / joiner).
#
# Port of sherpa_vietnamese_asr_tpu/models/onnx_export_rnnt.py.
# invert_zipformer_to_torch and invert_rnnt_to_torch turn this package's
# state dicts back into the icefall / sherpa-onnx initializer names, as the
# inverse of models/onnx_import's name maps. The graph half is the JAX
# module's, node for node: build_encoder_graph, build_decoder_graph and
# build_joiner_graph wire those initializers into an executable op graph
# that models/onnx_exec.py runs as a numpy-only oracle (plain ONNX Conv
# nodes and a GatherElements relative-position lookup, independent of the
# encoder's own formulation). The encoder graph is emitted for ONE static
# input length T and batch 1; the decoder/joiner graphs are shape-generic
# in the batch dimension.
#
# export_asr_dir writes a model directory that load_zipformer_rnnt (this
# package's and the JAX package's) reads: with t_in, the executable graphs
# (models/golden.run_exec_stack, models/verify_assets); without, files that
# hold the initializers only.

from __future__ import annotations

import os

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import (
    DECODER_NAME_MAP,
    JOINER_NAME_MAP,
    zipformer_name_map,
)
from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import GraphBuilder
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import compact_rel_pos_emb


def _numpy_state(module):
    return {k: v.detach().cpu().numpy()
            for k, v in module.state_dict().items()}


def _invert(name_map, state):
    """{source name: tensor}: each destination's value in the file's
    layout (the ConvNeXt pointwise convs go back to [O, I, 1, 1])."""
    out = {}
    for name, (key, transform) in name_map.items():
        t = np.asarray(state[key], np.float32)
        if transform is not None:  # onnx_import._pointwise
            t = t[:, :, None, None]
        out[name] = np.array(t)
    return out


def invert_zipformer_to_torch(enc_state, zcfg):
    """{icefall initializer name: torch-layout numpy tensor} for the
    encoder, from a ZipformerEncoder state dict (numpy values)."""
    return _invert(zipformer_name_map(zcfg), enc_state)


def invert_rnnt_to_torch(dec_state, joi_state):
    """Torch-layout tensors for the decoder/joiner files (sherpa naming)."""
    return (_invert(DECODER_NAME_MAP, dec_state),
            _invert(JOINER_NAME_MAP, joi_state))


def _initializers_only(tensors) -> bytes:
    """A ModelProto whose graph holds only `tensors` as initializers, in
    order."""
    b = GraphBuilder()
    for name, arr in tensors.items():
        b.init(name, arr)
    return b.build()


# ---------------------------------------------------------------------------
# Graph-emission helpers
# ---------------------------------------------------------------------------

class _Emit:
    """Shared emission idioms over a GraphBuilder + torch tensor dict."""

    def __init__(self, tensors):
        self.b = GraphBuilder()
        self.t = tensors
        self._transposed = {}

    def init_named(self, name):
        return self.b.init(name, self.t[name])

    def c(self, arr, hint="c"):
        return self.b.const(np.asarray(arr), hint)

    def f32(self, v):
        return self.c(np.float32(v), "k")

    def linear(self, x, prefix, bias=True):
        """x @ W.T + b with torch-layout initializer `prefix.weight`."""
        w = self.t[f"{prefix}.weight"]
        if prefix not in self._transposed:
            wi = self.b.init(f"{prefix}.weight", w)
            self._transposed[prefix] = self.b.node(
                "Transpose", [wi], perm=[1, 0])
        y = self.b.node("MatMul", [x, self._transposed[prefix]])
        if bias and f"{prefix}.bias" in self.t:
            y = self.b.node("Add", [y, self.init_named(f"{prefix}.bias")])
        return y

    def swoosh_l(self, x):
        """SwooshL(x) = softplus(x-4) - 0.08x - 0.035."""
        b = self.b
        sp = b.node("Softplus", [b.node("Sub", [x, self.f32(4.0)])])
        y = b.node("Sub", [sp, b.node("Mul", [x, self.f32(0.08)])])
        return b.node("Sub", [y, self.f32(0.035)])

    def swoosh_r(self, x):
        """SwooshR(x) = softplus(x-1) - 0.08x - 0.313261687."""
        b = self.b
        sp = b.node("Softplus", [b.node("Sub", [x, self.f32(1.0)])])
        y = b.node("Sub", [sp, b.node("Mul", [x, self.f32(0.08)])])
        return b.node("Sub", [y, self.f32(0.313261687)])

    def bias_norm(self, x, prefix):
        """x * exp(log_scale) / rms(x - bias) over the last axis."""
        b = self.b
        d = b.node("Sub", [x, self.init_named(f"{prefix}.bias")])
        m = b.node("ReduceMean", [b.node("Mul", [d, d])],
                   axes=[-1], keepdims=1)
        rms = b.node("Sqrt", [b.node("Add", [m, self.f32(1e-12)])])
        scale = b.node("Exp", [self.init_named(f"{prefix}.log_scale")])
        return b.node("Div", [b.node("Mul", [x, scale]), rms])

    def slice_axis(self, x, axis, start, end, step=1):
        b = self.b
        return b.node("Slice", [
            x, self.c(np.asarray([start], np.int64), "st"),
            self.c(np.asarray([end], np.int64), "en"),
            self.c(np.asarray([axis], np.int64), "ax"),
            self.c(np.asarray([step], np.int64), "sp")])

    def reshape(self, x, shape):
        return self.b.node(
            "Reshape", [x, self.c(np.asarray(shape, np.int64), "sh")])

    def bypass(self, x_orig, x, scale_name):
        """x_orig + (x - x_orig) * clip(scale, 0, 1)."""
        b = self.b
        s = b.node("Clip", [self.init_named(scale_name),
                            self.f32(0.0), self.f32(1.0)])
        return b.node("Add", [x_orig, b.node(
            "Mul", [b.node("Sub", [x, x_orig]), s])])


# ---------------------------------------------------------------------------
# Encoder graph
# ---------------------------------------------------------------------------

def _emit_encoder_embed(e: _Emit, x, t_in, zcfg):
    """Conv2dSubsampling + ConvNeXt: [1,T,80] -> [1,T',D0], T' = (T-7)//2."""
    b = e.b
    f = zcfg.num_features
    h = b.node("Unsqueeze", [x, e.c(np.asarray([1], np.int64), "ax")])
    # conv.0: k3x3, time valid / freq same  (pads are [t0,f0,t1,f1])
    h = b.node("Conv", [h, e.init_named("encoder_embed.conv.0.weight"),
                        e.init_named("encoder_embed.conv.0.bias")],
               pads=[0, 1, 0, 1])
    h = e.swoosh_r(h)
    # conv.2: k3x3 stride 2 both, valid
    h = b.node("Conv", [h, e.init_named("encoder_embed.conv.2.weight"),
                        e.init_named("encoder_embed.conv.2.bias")],
               strides=[2, 2])
    h = e.swoosh_r(h)
    # conv.4: k3x3 stride (1,2), valid
    h = b.node("Conv", [h, e.init_named("encoder_embed.conv.4.weight"),
                        e.init_named("encoder_embed.conv.4.bias")],
               strides=[1, 2])
    h = e.swoosh_r(h)
    # ConvNeXt block (residual): depthwise 7x7 pad 3 -> pw1 -> SwooshL -> pw2
    c3 = zcfg.embed_layer3_channels
    g = b.node("Conv", [
        h, e.init_named("encoder_embed.convnext.depthwise_conv.weight"),
        e.init_named("encoder_embed.convnext.depthwise_conv.bias")],
        pads=[3, 3, 3, 3], group=c3)
    g = b.node("Conv", [
        g, e.init_named("encoder_embed.convnext.pointwise_conv1.weight"),
        e.init_named("encoder_embed.convnext.pointwise_conv1.bias")])
    g = e.swoosh_l(g)
    g = b.node("Conv", [
        g, e.init_named("encoder_embed.convnext.pointwise_conv2.weight"),
        e.init_named("encoder_embed.convnext.pointwise_conv2.bias")])
    h = b.node("Add", [h, g])
    # [1,C,T',F'] -> [1,T',C*F'] (channel-major flatten, icefall order)
    t_out = (t_in - 7) // 2
    f_out = (((f - 1) // 2) - 1) // 2
    h = b.node("Transpose", [h], perm=[0, 2, 1, 3])
    h = e.reshape(h, [1, t_out, c3 * f_out])
    h = e.linear(h, "encoder_embed.out")
    h = e.bias_norm(h, "encoder_embed.out_norm")
    return h, t_out


def _emit_attention_weights(e: _Emit, x, lb, t, heads, zcfg):
    """softmax(q k^T + rel-pos scores): [1,T,D] -> [1,H,T(query),S(key)].

    Rel-pos realized directly — pos_full[b,h,t,r] gathered at r = T-1+t-s —
    rather than via the encoder's own formulation (see the module header).
    """
    b = e.b
    qd, pd = zcfg.query_head_dim, zcfg.pos_head_dim
    proj = e.linear(x, f"{lb}.self_attn_weights.in_proj")
    q = e.slice_axis(proj, 2, 0, heads * qd)
    k = e.slice_axis(proj, 2, heads * qd, 2 * heads * qd)
    pq = e.slice_axis(proj, 2, 2 * heads * qd, heads * (2 * qd + pd))
    q = b.node("Transpose", [e.reshape(q, [1, t, heads, qd])],
               perm=[0, 2, 1, 3])                      # [1,H,T,qd]
    k = b.node("Transpose", [e.reshape(k, [1, t, heads, qd])],
               perm=[0, 2, 3, 1])                      # [1,H,qd,T]
    scores = b.node("MatMul", [q, k])                  # [1,H,T,T]
    pos_emb = e.c(compact_rel_pos_emb(t, zcfg.pos_dim), "pos_emb")
    wi = b.init(f"{lb}.self_attn_weights.linear_pos.weight",
                e.t[f"{lb}.self_attn_weights.linear_pos.weight"])
    pos_lin = b.node("MatMul", [pos_emb, b.node("Transpose", [wi],
                                                perm=[1, 0])])
    pos_lin = b.node("Transpose", [e.reshape(pos_lin,
                                             [2 * t - 1, heads, pd])],
                     perm=[1, 2, 0])                   # [H,pd,2T-1]
    pqh = b.node("Transpose", [e.reshape(pq, [1, t, heads, pd])],
                 perm=[0, 2, 1, 3])                    # [1,H,T,pd]
    pos_full = b.node("MatMul", [pqh, pos_lin])        # [1,H,T,2T-1]
    ti, si = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    idx = np.broadcast_to((t - 1 + ti - si)[None, None],
                          (1, heads, t, t)).astype(np.int64)
    pos_scores = b.node("GatherElements",
                        [pos_full, e.c(idx, "relidx")], axis=3)
    scores = b.node("Add", [scores, pos_scores])
    return b.node("Softmax", [scores], axis=3)


def _emit_conv_module(e: _Emit, x, prefix, t, d, kernel):
    """GLU gate -> depthwise time conv (same pad) -> SwooshR -> out proj."""
    b = e.b
    proj = e.linear(x, f"{prefix}.in_proj")
    v, g = b.node("Split", [proj], n_out=2, axis=2)
    h = b.node("Mul", [v, b.node("Sigmoid", [g])])
    h = b.node("Transpose", [h], perm=[0, 2, 1])  # [1,D,T]
    pad = (kernel - 1) // 2
    h = b.node("Conv", [h, e.init_named(f"{prefix}.depthwise_conv.weight"),
                        e.init_named(f"{prefix}.depthwise_conv.bias")],
               pads=[pad, pad], group=d)
    h = e.swoosh_r(h)
    h = b.node("Transpose", [h], perm=[0, 2, 1])
    return e.linear(h, f"{prefix}.out_proj")


def _emit_encoder_layer(e: _Emit, x, lb, t, d, heads, zcfg, kernel):
    """One Zipformer2 layer (order mirrors zipformer.encoder_layer)."""
    b = e.b
    vd = zcfg.value_head_dim
    x_orig = x
    attn = _emit_attention_weights(e, x, lb, t, heads, zcfg)  # [1,H,T,S]

    def ff(xx, k):
        h = e.linear(xx, f"{lb}.feed_forward{k}.in_proj")
        return e.linear(e.swoosh_l(h), f"{lb}.feed_forward{k}.out_proj")

    def self_attn(xx, k):
        v = e.linear(xx, f"{lb}.self_attn{k}.in_proj")
        v = b.node("Transpose", [e.reshape(v, [1, t, heads, vd])],
                   perm=[0, 2, 1, 3])                  # [1,H,S,vd]
        o = b.node("MatMul", [attn, v])                # [1,H,T,vd]
        o = e.reshape(b.node("Transpose", [o], perm=[0, 2, 1, 3]),
                      [1, t, heads * vd])
        return e.linear(o, f"{lb}.self_attn{k}.out_proj")

    x = b.node("Add", [x, ff(x, 1)])
    # NonlinAttention (head-0 weights)
    na = f"{lb}.nonlin_attention"
    proj = e.linear(x, f"{na}.in_proj")
    s, v, y = b.node("Split", [proj], n_out=3, axis=2)
    v2 = b.node("Mul", [b.node("Tanh", [s]), v])
    attn0 = e.reshape(e.slice_axis(attn, 1, 0, 1), [1, t, t])
    o = b.node("Mul", [b.node("MatMul", [attn0, v2]), y])
    x = b.node("Add", [x, e.linear(o, f"{na}.out_proj")])
    x = b.node("Add", [x, self_attn(x, 1)])
    x = b.node("Add", [x, _emit_conv_module(e, x, f"{lb}.conv_module1",
                                            t, d, kernel)])
    x = b.node("Add", [x, ff(x, 2)])
    x = e.bypass(x_orig, x, f"{lb}.bypass_mid.bypass_scale")
    x = b.node("Add", [x, self_attn(x, 2)])
    x = b.node("Add", [x, _emit_conv_module(e, x, f"{lb}.conv_module2",
                                            t, d, kernel)])
    x = b.node("Add", [x, ff(x, 3)])
    x = e.bias_norm(x, f"{lb}.norm")
    return e.bypass(x_orig, x, f"{lb}.bypass.bypass_scale")


def _emit_downsample(e: _Emit, x, t, d, ds, weights_name):
    """Softmax-weighted within-group average; tail padded by edge-repeat."""
    b = e.b
    if ds == 1:
        return x, t
    pad = (-t) % ds
    if pad:
        last = e.slice_axis(x, 1, t - 1, t)
        x = b.node("Concat", [x] + [last] * pad, axis=1)
    groups = (t + pad) // ds
    w = b.node("Softmax", [e.init_named(weights_name)], axis=-1)
    w = e.reshape(w, [1, 1, ds, 1])
    x = e.reshape(x, [1, groups, ds, d])
    x = b.node("ReduceSum", [b.node("Mul", [x, w])], axes=[2], keepdims=0)
    return x, groups


def _emit_upsample(e: _Emit, x, groups, d, ds, t_full):
    b = e.b
    if ds == 1:
        return x
    x = e.reshape(x, [1, groups, 1, d])
    x = b.node("Tile", [x, e.c(np.asarray([1, 1, ds, 1], np.int64), "rep")])
    x = e.reshape(x, [1, groups * ds, d])
    return e.slice_axis(x, 1, 0, t_full)


def build_encoder_graph(tensors, zcfg, t_in: int) -> bytes:
    """Executable encoder ONNX: input x [1,t_in,80] f32 -> encoder_out
    [1, output_length(t_in), output_dim]. Static-shape export (see module
    docstring); initializer names/layouts match zipformer_name_map."""
    e = _Emit(tensors)
    b = e.b
    x = b.input("x")
    h, t_full = _emit_encoder_embed(e, x, t_in, zcfg)
    outputs = []
    cur_d = zcfg.encoder_dim[0]
    for i in range(len(zcfg.num_encoder_layers)):
        ds = zcfg.downsampling_factor[i]
        d = zcfg.encoder_dim[i]
        heads = zcfg.num_heads[i]
        kernel = zcfg.cnn_module_kernel[i]
        base = f"encoder.encoders.{i}" + ("" if ds == 1 else ".encoder")
        # convert channels
        if d < cur_d:
            h = e.slice_axis(h, 2, 0, d)
        elif d > cur_d:
            h = b.node("Concat", [h, e.c(
                np.zeros((1, t_full, d - cur_d), np.float32), "chpad")],
                axis=2)
        cur_d = d
        h_orig = h
        hs, t_ds = _emit_downsample(
            e, h, t_full, d, ds, f"encoder.encoders.{i}.downsample.bias")
        for j in range(zcfg.num_encoder_layers[i]):
            hs = _emit_encoder_layer(e, hs, f"{base}.layers.{j}", t_ds, d,
                                     heads, zcfg, kernel)
        hs = _emit_upsample(e, hs, t_ds, d, ds, t_full)
        if ds != 1:
            h = e.bypass(h_orig, hs,
                         f"encoder.encoders.{i}.out_combiner.bypass_scale")
        else:
            h = hs
        outputs.append(h)
    # full-dim output: newest stack first, widen with earlier stacks' slices
    out_dim = zcfg.output_dim
    pieces = [outputs[-1]]
    cur = zcfg.encoder_dim[-1]
    for i in range(len(outputs) - 2, -1, -1):
        d = zcfg.encoder_dim[i]
        if d > cur:
            pieces.append(e.slice_axis(outputs[i], 2, cur, d))
            cur = d
    full = pieces[0] if len(pieces) == 1 else b.node(
        "Concat", pieces, axis=2)
    if cur < out_dim:
        full = b.node("Concat", [full, e.c(
            np.zeros((1, t_full, out_dim - cur), np.float32), "odpad")],
            axis=2)
    out, _ = _emit_downsample(e, full, t_full, out_dim, 2,
                              "encoder.downsample_output.bias")
    b.output(b.node("Identity", [out], outputs="encoder_out"))
    return b.build()


# ---------------------------------------------------------------------------
# Decoder / joiner graphs (batch-generic)
# ---------------------------------------------------------------------------

def build_decoder_graph(dec_tensors, rcfg) -> bytes:
    """Stateless decoder: y [N, context_size] int64 -> decoder_out [N, D]."""
    e = _Emit(dec_tensors)
    b = e.b
    y = b.input("y")
    emb = b.node("Gather", [e.init_named("embedding.weight"), y], axis=0)
    emb = b.node("Transpose", [emb], perm=[0, 2, 1])  # [N, D, K]
    w = dec_tensors["conv.weight"]                    # [D, D/G, K]
    groups = w.shape[0] // w.shape[1]
    h = b.node("Conv", [emb, e.init_named("conv.weight")], group=groups)
    h = b.node("Squeeze", [h, e.c(np.asarray([2], np.int64), "ax")])
    b.output(b.node("Relu", [h], outputs="decoder_out"))
    return b.build()


def build_joiner_graph(joi_tensors) -> bytes:
    """Joiner: encoder_out [N,E], decoder_out [N,D] -> logits [N,V]."""
    e = _Emit(joi_tensors)
    b = e.b
    enc = b.input("encoder_out")
    dec = b.input("decoder_out")
    h = b.node("Tanh", [b.node("Add", [e.linear(enc, "encoder_proj"),
                                       e.linear(dec, "decoder_proj")])])
    b.output(b.node("Identity", [e.linear(h, "output_linear")],
                    outputs="logits"))
    return b.build()


def write_tokens(path: str, id2token) -> None:
    """sherpa-onnx tokens.txt: 'piece id' per line."""
    with open(path, "w", encoding="utf-8") as f:
        for i, piece in enumerate(id2token):
            f.write(f"{piece} {i}\n")


def asr_graphs(model, t_in: int | None = None) -> dict:
    """{"encoder", "decoder", "joiner": ONNX bytes} of an AsrModel: with
    t_in the executable graphs (the encoder at static batch 1 and t_in
    frames), without, the initializers only."""
    enc_t = invert_zipformer_to_torch(_numpy_state(model.encoder),
                                      model.zip_cfg)
    dec_t, joi_t = invert_rnnt_to_torch(_numpy_state(model.decoder),
                                        _numpy_state(model.joiner))
    if t_in is None:
        return {"encoder": _initializers_only(enc_t),
                "decoder": _initializers_only(dec_t),
                "joiner": _initializers_only(joi_t)}
    return {"encoder": build_encoder_graph(enc_t, model.zip_cfg, t_in),
            "decoder": build_decoder_graph(dec_t, model.rnnt_cfg),
            "joiner": build_joiner_graph(joi_t)}


def export_asr_dir(model, out_dir: str, t_in: int | None = None) -> dict:
    """Write encoder/decoder/joiner .onnx (asr_graphs) and tokens.txt for an
    AsrModel. Filenames follow the sherpa-onnx convention
    load_zipformer_rnnt discovers. Returns {role: path}.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for role, data in asr_graphs(model, t_in).items():
        paths[role] = os.path.join(out_dir, f"{role}-epoch-99-avg-1.onnx")
        with open(paths[role], "wb") as f:
            f.write(data)
    paths["tokens"] = os.path.join(out_dir, "tokens.txt")
    write_tokens(paths["tokens"], model.id2token)
    return paths
