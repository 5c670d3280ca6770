# ONNX checkpoint import for the port: read the initializers of .onnx files
# and map them onto this package's state dicts.
#
# Port of sherpa_vietnamese_asr_tpu/models/onnx_import.py. The file reader
# (read_onnx with _decode_tensor, _decode_attribute and Constant-node
# folding), _strip_prefixes and ImportReport are copied unchanged, on the
# port's own utils/protowire. map_initializers and _fallback_match keep the
# reference's two phases (resolve every expected name, then apply in map
# order), its group defaults and its shape, file-order and name-similarity
# fallback with the same diagnostics; an entry names a key of a destination
# state dict instead of a setter closure into a JAX tree.
#
# The name maps go from icefall's state-dict names to the keys of this
# package's modules (models/convert.encoder_state_dict is the truth for
# those keys). Both sides are torch layout, so a tensor loads as it is
# stored, except the ConvNeXt pointwise convs ([O, I, 1, 1] -> [O, I]).
# The loaders return state dicts of numpy float32 arrays, never modules:
# load_zipformer_rnnt for an ASR model directory, load_silero_vad for
# silero_vad_16k_op15.onnx, load_pyannet for segmentation-community-1.onnx
# and load_resnet_speaker for embedding_encoder.onnx with its projection's
# .npy files, load_campp for campplus_cn_en_common_200k.onnx and
# load_convtasnet for convtasnet_16k.onnx (these modules mirror the upstream
# trees, so their name maps are the identity), load_vibert and load_dnsmos.

from __future__ import annotations

import os
import struct

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.utils import protowire as pw

# ONNX field numbers (onnx/onnx.proto)
_MODEL_GRAPH = 7
_GRAPH_NODE = 1
_GRAPH_INITIALIZER = 5
_GRAPH_INPUT = 11
_GRAPH_OUTPUT = 12
_TENSOR_DIMS = 1
_TENSOR_DATA_TYPE = 2
_TENSOR_SEGMENT = 3
_TENSOR_FLOAT_DATA = 4
_TENSOR_INT32_DATA = 5
_TENSOR_STRING_DATA = 6
_TENSOR_INT64_DATA = 7
_TENSOR_NAME = 8
_TENSOR_RAW_DATA = 9
_TENSOR_DOUBLE_DATA = 10
_NODE_INPUT = 1
_NODE_OUTPUT = 2
_NODE_NAME = 3
_NODE_OP_TYPE = 4
_NODE_ATTRIBUTE = 5
_VALUEINFO_NAME = 1
# AttributeProto fields (onnx/onnx.proto)
_ATTR_NAME = 1
_ATTR_F = 2
_ATTR_I = 3
_ATTR_S = 4
_ATTR_T = 5
_ATTR_FLOATS = 7
_ATTR_INTS = 8
_ATTR_STRINGS = 9
_ATTR_TYPE = 20

_DTYPE = {
    1: np.dtype("<f4"), 2: np.dtype("u1"), 3: np.dtype("i1"),
    4: np.dtype("<u2"), 5: np.dtype("<i2"), 6: np.dtype("<i4"),
    7: np.dtype("<i8"), 9: np.dtype("bool"), 10: np.dtype("<f2"),
    11: np.dtype("<f8"), 12: np.dtype("<u4"), 13: np.dtype("<u8"),
}


def _decode_tensor(buf: bytes):
    f = pw.parse_fields(buf)
    name = f.get(_TENSOR_NAME, [b""])[0].decode("utf-8")
    dims = []
    for d in f.get(_TENSOR_DIMS, []):
        if isinstance(d, bytes):  # packed repeated
            dims.extend(pw.parse_packed_varints(d))
        else:
            dims.append(d)
    dtype_id = f.get(_TENSOR_DATA_TYPE, [1])[0]
    dt = _DTYPE.get(dtype_id)
    if dt is None:
        raise ValueError(f"tensor {name}: unsupported data_type {dtype_id}")
    if _TENSOR_RAW_DATA in f:
        arr = np.frombuffer(f[_TENSOR_RAW_DATA][0], dt)
    elif _TENSOR_FLOAT_DATA in f:
        vals = f[_TENSOR_FLOAT_DATA]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            arr = np.frombuffer(vals[0], "<f4")
        else:  # unpacked fixed32 values
            arr = np.array([struct.unpack("<f", struct.pack("<I", v))[0]
                            for v in vals], np.float32)
    elif _TENSOR_INT64_DATA in f:
        vals = f[_TENSOR_INT64_DATA]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            arr = np.array(pw.parse_packed_varints(vals[0]), np.int64)
        else:
            arr = np.array(vals, np.int64)
    elif _TENSOR_INT32_DATA in f:
        vals = f[_TENSOR_INT32_DATA]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            raw = np.array(pw.parse_packed_varints(vals[0]), np.int64)
        else:
            raw = np.array(vals, np.int64)
        if dtype_id == 10:  # fp16 stored in int32_data
            arr = raw.astype(np.uint16).view(np.float16)
        else:
            arr = raw.astype(dt)
    elif _TENSOR_DOUBLE_DATA in f:
        vals = f[_TENSOR_DOUBLE_DATA]
        arr = np.array([struct.unpack("<d", struct.pack("<Q", v))[0]
                        for v in vals], np.float64)
    else:
        arr = np.zeros(0, dt)
    shape = tuple(int(d) for d in dims)
    if shape:
        arr = arr.reshape(shape)
    if arr.dtype in (np.float16, np.float64):
        arr = arr.astype(np.float32)
    return name, arr


def _i64(v: int) -> int:
    """Varint-decoded int64 two's-complement sign fix."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_attribute(buf: bytes):
    """AttributeProto -> (name, python value).

    Type resolution follows the wire content rather than the `type` enum so
    synthesized files may omit it: tensor > s > floats > ints > f > i.
    """
    f = pw.parse_fields(buf)
    name = f.get(_ATTR_NAME, [b""])[0].decode()
    if _ATTR_T in f:
        _, arr = _decode_tensor(f[_ATTR_T][0])
        return name, arr
    if _ATTR_STRINGS in f:
        return name, [s.decode("utf-8", "replace") for s in f[_ATTR_STRINGS]]
    if _ATTR_FLOATS in f:
        vals = []
        for v in f[_ATTR_FLOATS]:
            if isinstance(v, bytes):  # packed fixed32
                vals.extend(np.frombuffer(v, "<f4").tolist())
            else:
                vals.append(struct.unpack("<f", struct.pack("<I", v))[0])
        return name, vals
    if _ATTR_INTS in f:
        vals = []
        for v in f[_ATTR_INTS]:
            if isinstance(v, bytes):  # packed varints
                vals.extend(_i64(x) for x in pw.parse_packed_varints(v))
            else:
                vals.append(_i64(v))
        return name, vals
    if _ATTR_S in f:
        return name, f[_ATTR_S][0].decode("utf-8", "replace")
    if _ATTR_F in f:
        return name, struct.unpack("<f", struct.pack("<I", f[_ATTR_F][0]))[0]
    if _ATTR_I in f:
        return name, _i64(f[_ATTR_I][0])
    return name, None


def read_onnx(path_or_bytes):
    """Parse an ONNX file.

    Returns dict with:
      initializers: {name: np.ndarray}
      nodes: [(op_type, [inputs], [outputs], name)]
      attrs: [{attr_name: value}] aligned with nodes
      inputs / outputs: [names]
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    model = pw.parse_fields(buf)
    if _MODEL_GRAPH not in model:
        raise ValueError("no graph in ONNX model")
    graph = pw.parse_fields(model[_MODEL_GRAPH][0])

    initializers = {}
    for t in graph.get(_GRAPH_INITIALIZER, []):
        name, arr = _decode_tensor(t)
        initializers[name] = arr

    nodes, attrs = [], []
    for nb in graph.get(_GRAPH_NODE, []):
        nf = pw.parse_fields(nb)
        nodes.append((
            nf.get(_NODE_OP_TYPE, [b""])[0].decode(),
            [x.decode() for x in nf.get(_NODE_INPUT, [])],
            [x.decode() for x in nf.get(_NODE_OUTPUT, [])],
            nf.get(_NODE_NAME, [b""])[0].decode(),
        ))
        attrs.append(dict(_decode_attribute(ab)
                          for ab in nf.get(_NODE_ATTRIBUTE, [])))
        # Constant-node weights: some real exports carry tensors as
        # Constant nodes instead of graph initializers — fold them in so
        # importer name maps see them uniformly.
        op, _ins, outs, _nm = nodes[-1]
        if op == "Constant" and outs and "value" in attrs[-1] \
                and outs[0] not in initializers:
            val = attrs[-1]["value"]
            if isinstance(val, np.ndarray):
                initializers[outs[0]] = val

    def names(field):
        out = []
        for vb in graph.get(field, []):
            vf = pw.parse_fields(vb)
            out.append(vf.get(_VALUEINFO_NAME, [b""])[0].decode())
        return out

    return {
        "initializers": initializers,
        "nodes": nodes,
        "attrs": attrs,
        "inputs": names(_GRAPH_INPUT),
        "outputs": names(_GRAPH_OUTPUT),
    }




# ---------------------------------------------------------------------------
# Name mapping into state dicts
# ---------------------------------------------------------------------------

def _strip_prefixes(initializers):
    """Torch ONNX exports may prefix state-dict names (e.g. 'encoder.');
    normalize by stripping common wrapper prefixes."""
    out = {}
    for k, v in initializers.items():
        k2 = k
        for pre in ("onnx::", "model.", "module."):
            if k2.startswith(pre):
                k2 = k2[len(pre):]
        out[k2] = v
    return out


class ImportReport(Exception):
    pass


def _entry(e):
    """Name-map entry -> (dest_key, transform, group, default). Entries are
    2-tuples normally; 4-tuples add an all-or-nothing default group (e.g.
    BatchNorm folded into the preceding conv by the exporter)."""
    if len(e) == 2:
        return e[0], e[1], None, None
    return e[0], e[1], e[2], e[3]


def _fits(shape, dest_shape):
    """A file tensor of `shape` loads into a destination of `dest_shape`: the
    same shape, or a one-element tensor for a scalar (read_onnx gives a
    0-dim initializer one dimension)."""
    return tuple(shape) == tuple(dest_shape) or (
        dest_shape == () and tuple(shape) == (1,))


def _fallback_match(initializers, name_map, state, missing, used, label=""):
    """Topology/shape-based matching for renamed initializers.

    For each missing expected name, candidate file tensors are those whose
    transformed shape equals the destination's shape in `state`; ties
    resolve by Hungarian assignment over name similarity + file-order
    distance (torch exports keep state-dict order). Returns {expected_name:
    actual_name} or raises ImportReport when the assignment is
    infeasible/ambiguous.
    """
    import difflib

    unused = [k for k in initializers if k not in used]
    if not unused:
        raise ImportReport(
            f"[{label}] {len(missing)} expected tensors missing and no "
            f"unmatched tensors left in the file, e.g. {missing[:8]}")
    exp_pos = {k: i for i, k in enumerate(name_map)}
    act_pos = {k: i for i, k in enumerate(initializers)}
    n_exp = max(len(name_map) - 1, 1)
    n_act = max(len(initializers) - 1, 1)
    big = 1e9
    cost = np.full((len(missing), len(unused)), big, np.float64)
    for i, e in enumerate(missing):
        key, transform, _g, _d = _entry(name_map[e])
        dest_shape = np.shape(state[key])
        for j, a in enumerate(unused):
            arr = initializers[a]
            try:
                t = arr if transform is None else transform(arr)
            except Exception:
                continue
            if not _fits(np.shape(np.asarray(t)), dest_shape):
                continue
            # Order is the reliable signal (torch exports keep state-dict
            # order); name similarity only breaks ties — with opaque
            # renames its noise must stay below one position step.
            sim = difflib.SequenceMatcher(None, e, a).ratio()
            order = abs(exp_pos[e] / n_exp - act_pos[a] / n_act)
            cost[i, j] = order + 0.05 * (1.0 - sim)
    from scipy.optimize import linear_sum_assignment
    # Pad rectangular: scipy handles len(missing) <= len(unused); if more
    # expected than available, it's infeasible anyway.
    if len(missing) > len(unused):
        raise ImportReport(
            f"[{label}] {len(missing)} expected tensors missing but only "
            f"{len(unused)} unmatched tensors in the file")
    rows, cols = linear_sum_assignment(cost)
    out = {}
    for i, j in zip(rows, cols):
        if cost[i, j] >= big:
            raise ImportReport(
                f"[{label}] no shape-compatible tensor in the file for "
                f"expected '{missing[i]}' (fallback matching failed)")
        out[missing[i]] = unused[j]
    return out


def map_initializers(initializers, name_map, state, strict=True, label="",
                     fallback_match=False):
    """Apply {source_name: (dest_key, transform[, group, default])} over
    initializers into `state`.

    state: {dest_key: array} holding each destination's current value (its
    shape is the expected post-transform shape); a matched tensor replaces
    it as float32, after transform (None = identity). Grouped entries with
    defaults (see _entry) are filled with the default when the WHOLE group
    is absent — e.g. BatchNorm stats constant-folded into the conv by the
    exporter. With fallback_match=True, remaining missing names are resolved
    against unmatched file tensors by shape + name-similarity + file order
    (_fallback_match); real exports rename initializers freely. Raises
    ImportReport listing missing/unused names when strict. Returns the
    missing names.
    """
    matches = {}  # expected name -> actual file name
    missing = []
    for src in name_map:
        if src in initializers:
            matches[src] = src
        else:
            missing.append(src)
    used = set(matches.values())
    defaulted = set()
    if missing:
        groups = {}
        for src, e in name_map.items():
            _k, _t, g, _d = _entry(e)
            if g is not None:
                groups.setdefault(g, []).append(src)
        # Groups missing in FULL are candidates for defaults (exporter
        # folded them, e.g. BatchNorm into the preceding conv). A partially
        # present group is treated as plain renames: its missing members
        # must fallback-match or the strict check surfaces them.
        whole_groups = [g for g, members in groups.items()
                        if all(m in missing for m in members)]
        in_whole_group = {m for g in whole_groups for m in groups[g]}
        plain_missing = [m for m in missing if m not in in_whole_group]
        if plain_missing and fallback_match:
            matched = _fallback_match(initializers, name_map, state,
                                      plain_missing, used, label=label)
            matches.update(matched)
            used.update(matched.values())
        if fallback_match:
            # Renamed-but-present beats identity defaults: only default a
            # group when no shape-compatible unused tensors exist for ALL
            # of its members.
            for g in whole_groups:
                members = groups[g]
                try:
                    gm = _fallback_match(initializers, name_map, state,
                                         members, used, label=label)
                except ImportReport:
                    gm = None
                if gm is not None and len(gm) == len(members):
                    matches.update(gm)
                    used.update(gm.values())
                else:
                    defaulted.update(members)
        else:
            defaulted.update(in_whole_group)
    # Apply in name_map order.
    for src, e in name_map.items():
        key, transform, _g, default = _entry(e)
        if src in matches:
            arr = initializers[matches[src]]
            arr = np.asarray(arr if transform is None else transform(arr))
            if not _fits(arr.shape, np.shape(state[key])):
                raise ImportReport(
                    f"[{label}] {matches[src]}: shape {arr.shape}, expected "
                    f"{np.shape(state[key])} for {key}")
            state[key] = np.array(arr.reshape(np.shape(state[key])),
                                  np.float32)
        elif src in defaulted:
            state[key] = np.full(np.shape(state[key]), default, np.float32)
    missing = [m for m in name_map if m not in matches and m not in defaulted]
    if strict and missing:
        unused = sorted(set(initializers) - used)
        raise ImportReport(
            f"[{label}] {len(missing)} expected tensors missing, e.g. "
            f"{missing[:8]}; {len(unused)} unmatched in file, e.g. "
            f"{unused[:8]}")
    return missing


def _pointwise(a):
    """ConvNeXt pointwise conv [O, I, 1, 1] -> Linear weight [O, I]."""
    return a.reshape(a.shape[0], -1)


def zipformer_name_map(zcfg):
    """icefall Zipformer2 state-dict names -> (ZipformerEncoder state-dict
    key, transform). Every tensor is torch layout on both sides; only the
    ConvNeXt pointwise convs change shape. A non-downsampled stack has no
    downsample or out_combiner tensors: its `downsample.weights` and
    `out_bypass_scale` keep their constructed values (the encoder never
    reads them)."""
    m = {}
    # Conv2dSubsampling convs are a Sequential with activations between:
    # indices 0, 2, 4 in icefall's zipformer2 subsampling.
    for src_idx, dst in (("0", "conv1"), ("2", "conv2"), ("4", "conv3")):
        for leaf in ("weight", "bias"):
            m[f"encoder_embed.conv.{src_idx}.{leaf}"] = (
                f"encoder_embed.{dst}.{leaf}", None)
    for leaf in ("weight", "bias"):
        m[f"encoder_embed.convnext.depthwise_conv.{leaf}"] = (
            f"encoder_embed.convnext_dw.{leaf}", None)
    for k in (1, 2):
        m[f"encoder_embed.convnext.pointwise_conv{k}.weight"] = (
            f"encoder_embed.convnext_pw{k}.weight", _pointwise)
        m[f"encoder_embed.convnext.pointwise_conv{k}.bias"] = (
            f"encoder_embed.convnext_pw{k}.bias", None)
    for name in ("out.weight", "out.bias", "out_norm.bias",
                 "out_norm.log_scale"):
        m[f"encoder_embed.{name}"] = (f"encoder_embed.{name}", None)

    for i, ds in enumerate(zcfg.downsampling_factor):
        # Non-downsampled stacks are Zipformer2Encoder ("encoder.encoders.i.
        # layers.j"); downsampled stacks wrap it ("...i.encoder.layers.j").
        base = f"encoder.encoders.{i}" + ("" if ds == 1 else ".encoder")
        sp = f"stacks.{i}"
        if ds != 1:
            m[f"encoder.encoders.{i}.downsample.bias"] = (
                f"{sp}.downsample.weights", None)
            m[f"encoder.encoders.{i}.out_combiner.bypass_scale"] = (
                f"{sp}.out_bypass_scale", None)
        for j in range(zcfg.num_encoder_layers[i]):
            lb, p = f"{base}.layers.{j}", f"{sp}.layers.{j}"
            for leaf in ("weight", "bias"):
                m[f"{lb}.self_attn_weights.in_proj.{leaf}"] = (
                    f"{p}.attn_in_proj.{leaf}", None)
            m[f"{lb}.self_attn_weights.linear_pos.weight"] = (
                f"{p}.attn_pos_proj.weight", None)
            modules = [(f"self_attn{k}", f"self_attn{k}") for k in (1, 2)]
            modules += [(f"feed_forward{k}", f"ff{k}") for k in (1, 2, 3)]
            modules += [("nonlin_attention", "nonlin_attn")]
            modules += [(f"conv_module{k}", f"conv{k}") for k in (1, 2)]
            for src, dst in modules:
                for proj in ("in_proj", "out_proj"):
                    for leaf in ("weight", "bias"):
                        m[f"{lb}.{src}.{proj}.{leaf}"] = (
                            f"{p}.{dst}.{proj}.{leaf}", None)
            for k in (1, 2):
                m[f"{lb}.conv_module{k}.depthwise_conv.weight"] = (
                    f"{p}.conv{k}.dw_weight", None)
                m[f"{lb}.conv_module{k}.depthwise_conv.bias"] = (
                    f"{p}.conv{k}.dw_bias", None)
            m[f"{lb}.norm.bias"] = (f"{p}.norm.bias", None)
            m[f"{lb}.norm.log_scale"] = (f"{p}.norm.log_scale", None)
            m[f"{lb}.bypass.bypass_scale"] = (f"{p}.bypass_scale", None)
            m[f"{lb}.bypass_mid.bypass_scale"] = (f"{p}.bypass_mid_scale",
                                                  None)
    m["encoder.downsample_output.bias"] = ("downsample_output.weights", None)
    return m


# sherpa-onnx decoder and joiner names -> Decoder / Joiner state-dict keys.
DECODER_NAME_MAP = {
    "embedding.weight": ("embedding", None),
    "conv.weight": ("conv_weight", None),
}
JOINER_NAME_MAP = {
    f"{src}.{leaf}": (f"{dst}.{leaf}", None)
    for src, dst in (("encoder_proj", "encoder_proj"),
                     ("decoder_proj", "decoder_proj"),
                     ("output_linear", "output"))
    for leaf in ("weight", "bias")
}


def _template(module):
    """{key: numpy float32} of a freshly constructed module: the shapes the
    name map checks against, and the constructed values of keys no file
    tensor maps to."""
    return {k: v.detach().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


def _find(model_dir, prefix):
    files = [f for f in os.listdir(model_dir)
             if f.startswith(prefix) and f.endswith(".onnx")]
    fl = [f for f in files if "int8" not in f]
    pick = (fl or files)
    if not pick:
        raise FileNotFoundError(f"no {prefix}*.onnx in {model_dir}")
    return os.path.join(model_dir, sorted(pick)[0])


def load_zipformer_rnnt(model_dir, zcfg, rcfg):
    """Load encoder/decoder/joiner ONNX files into state dicts.

    File discovery matches the reference: encoder-*/decoder-*/joiner-*.onnx
    preferring non-int8 variants. Returns (encoder, decoder, joiner) state
    dicts of numpy float32 for ZipformerEncoder(zcfg), Decoder(rcfg) and
    Joiner(rcfg), every key present. Missing tensors raise ImportReport
    after the shape/topology fallback, listing the names found.
    """
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
        ZipformerEncoder,
    )

    enc_init = _strip_prefixes(read_onnx(_find(model_dir, "encoder-"))
                               ["initializers"])
    dec_init = _strip_prefixes(read_onnx(_find(model_dir, "decoder-"))
                               ["initializers"])
    joi_init = _strip_prefixes(read_onnx(_find(model_dir, "joiner-"))
                               ["initializers"])

    joi = _template(Joiner(rcfg))
    dec = _template(Decoder(rcfg))
    map_initializers(joi_init, JOINER_NAME_MAP, joi, label="joiner",
                     fallback_match=True)
    map_initializers(dec_init, DECODER_NAME_MAP, dec, label="decoder",
                     fallback_match=True)

    enc = _template(ZipformerEncoder(zcfg))
    enc_map = zipformer_name_map(zcfg)
    mapped = {key for key, *_ in enc_map.values()}
    unmapped = set(enc) - mapped
    constructed = {f"stacks.{i}.{leaf}"
                   for i, ds in enumerate(zcfg.downsampling_factor) if ds == 1
                   for leaf in ("downsample.weights", "out_bypass_scale")}
    if unmapped - constructed or mapped - set(enc):
        raise ImportReport(
            f"[encoder] name map out of step with ZipformerEncoder: "
            f"unmapped {sorted(unmapped - constructed)[:8]}, unknown "
            f"{sorted(mapped - set(enc))[:8]}")
    missing = map_initializers(enc_init, enc_map, enc, strict=False,
                               label="encoder")
    if missing:
        # Real exports may rename initializers (wrapper prefixes, opset
        # rewrites); resolve the remainder by shape + file order + name
        # similarity before giving up with a full diagnostic.
        try:
            map_initializers(enc_init, enc_map, enc, strict=True,
                             label="encoder", fallback_match=True)
        except ImportReport:
            unused = sorted(set(enc_init) - set(enc_map))
            raise ImportReport(
                f"[encoder] {len(missing)}/{len(enc_map)} expected tensors "
                f"missing even after shape/topology fallback, e.g. "
                f"{missing[:6]}; {len(unused)} unmatched names in the file, "
                f"e.g. {unused[:12]}")
    return enc, dec, joi


def load_silero_vad(path, cfg=None):
    """Load silero_vad_16k_op15.onnx into (state, cfg) for
    models/silero_vad.SileroVad.

    Maps the Silero v5 traced-graph initializer names:
      _model.stft.forward_basis_buffer        [2*n_freq, 1, filter_len]
      _model.encoder.{i}.reparam_conv.weight  [C_out, C_in, 3] (+ .bias)
      _model.decoder.rnn.weight_ih/weight_hh  [4H, in] (torch LSTMCell ifgo)
      _model.decoder.rnn.bias_ih/bias_hh
      _model.decoder.decoder.2.weight         [1, H, 1] conv head (+ .bias)
    The STFT basis rows carry the window, so they replace the synthetic DFT
    basis wholesale (magnitude output is sign-invariant in the imag rows).
    The LSTM's two biases are summed into one (`lstm.bias_ih_l0`;
    `lstm.bias_hh_l0` is zero), as the reference sums them.
    """
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import (
        SileroVadConfig,
    )

    g = read_onnx(path)
    init = g["initializers"]

    def pick(suffix):
        hits = [k for k in init if k.endswith(suffix)]
        if len(hits) != 1:
            raise ImportReport(
                f"[silero] expected exactly one *{suffix}, found {hits}; "
                f"names: {sorted(init)[:12]}")
        return init[hits[0]]

    basis = pick("stft.forward_basis_buffer")
    if basis.ndim != 3 or basis.shape[0] % 2:
        raise ImportReport(f"[silero] bad stft basis shape {basis.shape}")
    n_freq = basis.shape[0] // 2
    filt = basis.shape[2]

    f32 = np.float32
    state = {"stft_cos": basis[:n_freq, 0, :].astype(f32),
             "stft_sin": basis[n_freq:, 0, :].astype(f32)}
    channels = []
    i = 0
    while True:
        hits = [k for k in init
                if f"encoder.{i}." in k and k.endswith(".weight")]
        if not hits:
            break
        w = init[hits[0]]
        bkey = hits[0][: -len("weight")] + "bias"
        state[f"encoder.{i}.weight"] = w.astype(f32)
        state[f"encoder.{i}.bias"] = np.asarray(
            init.get(bkey, np.zeros(w.shape[0], f32)), f32)
        channels.append(w.shape[0])
        i += 1
    if not channels:
        raise ImportReport(
            f"[silero] no encoder convs found; names: {sorted(init)[:12]}")

    wh = pick("rnn.weight_hh")
    bias = pick("rnn.bias_ih") + pick("rnn.bias_hh")
    state.update({
        "lstm.weight_ih_l0": pick("rnn.weight_ih").astype(f32),
        "lstm.weight_hh_l0": wh.astype(f32),
        "lstm.bias_ih_l0": bias.astype(f32),
        "lstm.bias_hh_l0": np.zeros_like(bias, f32),
        "head.weight": pick("decoder.2.weight")[:, :, 0].astype(f32),
        "head.bias": pick("decoder.2.bias").astype(f32),
    })
    if cfg is None:
        cfg = SileroVadConfig(stft_filter_len=filt, n_freq=n_freq,
                              encoder_channels=tuple(channels),
                              lstm_dim=wh.shape[1])
    return state, cfg


def pyannet_name_map(cfg):
    """pyannote.audio PyanNet state-dict names (segmentation-community-1.onnx)
    -> PyanNet state-dict keys: the same names, the module mirrors the
    upstream tree."""
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet

    return {k: (k, None) for k in PyanNet(cfg).state_dict()}


def load_pyannet(path, cfg=None):
    """Load segmentation-community-1.onnx into (state, cfg) for
    models/pyannet.PyanNet. The config is derived from the file's tensor
    shapes unless given. Each LSTM direction's two biases are summed into
    bias_ih (bias_hh zero), as the JAX package keeps one gate bias."""
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, PyanNetConfig

    init = _strip_prefixes(read_onnx(path)["initializers"])
    if cfg is None:
        low = init.get("sincnet.conv1d.0.low_hz_")
        if low is None:
            raise ImportReport(
                "[pyannet] sincnet.conv1d.0.low_hz_ not found; first names: "
                f"{sorted(init)[:8]}")
        n_lstm = 0
        while f"lstm.weight_ih_l{n_lstm}" in init:
            n_lstm += 1
        cfg = PyanNetConfig(
            sinc_filters=low.shape[0],
            conv_channels=init["sincnet.conv1d.1.weight"].shape[0],
            lstm_hidden=init["lstm.weight_hh_l0"].shape[1],
            lstm_layers=n_lstm,
            linear_dim=init["linear.0.weight"].shape[0],
            num_classes=init["classifier.weight"].shape[0])
    state = _template(PyanNet(cfg))
    map_initializers(init, pyannet_name_map(cfg), state, label="pyannet",
                     fallback_match=True)
    for k in [k for k in state if k.startswith("lstm.bias_ih_")]:
        hh = k.replace("bias_ih_", "bias_hh_")
        state[k] = state[k] + state[hh]
        state[hh] = np.zeros_like(state[hh])
    return state, cfg


def resnet_speaker_name_map(cfg):
    """wespeaker ResNet34 names under the 'resnet.' prefix
    (embedding_encoder.onnx) -> ResNetSpeaker state-dict keys: the same
    names. Each BatchNorm is a group with identity defaults, used when the
    exporter folded the whole group into the convolution (running_var
    1 - 1e-5, so that var + eps is 1)."""
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeaker

    defaults = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
                "running_var": 1.0 - 1e-5}
    m = {}
    for k in ResNetSpeaker(cfg).state_dict():
        if k.startswith("resnet.seg_1.") or k.endswith(".num_batches_tracked"):
            continue  # the projection comes from its own .npy files
        prefix, leaf = k.rsplit(".", 1)
        if ".bn" in k or ".shortcut.1." in k:
            m[k] = (k, None, prefix, defaults[leaf])
        else:
            m[k] = (k, None)
    return m


def load_resnet_speaker(encoder_onnx_path, weight_npy_path, bias_npy_path,
                        cfg=None):
    """Load embedding_encoder.onnx + resnet_seg_1_{weight,bias}.npy into
    (state, cfg) for models/resnet_speaker.ResNetSpeaker. The config (base
    channels, blocks per stage, embedding width) is derived from the files
    unless given."""
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
        ResNetSpeaker,
        ResNetSpeakerConfig,
    )

    init = _strip_prefixes(read_onnx(encoder_onnx_path)["initializers"])
    weight = np.load(weight_npy_path)
    bias = np.load(bias_npy_path)
    if cfg is None:
        c1 = init.get("resnet.conv1.weight")
        if c1 is None:
            raise ImportReport(
                "[resnet] resnet.conv1.weight not found; first names: "
                f"{sorted(init)[:8]}")
        blocks = []
        stage = 1
        while f"resnet.layer{stage}.0.conv1.weight" in init:
            j = 0
            while f"resnet.layer{stage}.{j}.conv1.weight" in init:
                j += 1
            blocks.append(j)
            stage += 1
        cfg = ResNetSpeakerConfig(base_channels=c1.shape[0], blocks=tuple(blocks),
                                  embed_dim=weight.shape[0])
    state = _template(ResNetSpeaker(cfg))
    map_initializers(init, resnet_speaker_name_map(cfg), state, label="resnet",
                     fallback_match=True)
    for key, arr in (("resnet.seg_1.weight", weight), ("resnet.seg_1.bias", bias)):
        if arr.shape != state[key].shape:
            raise ImportReport(f"[resnet] {key}: shape {arr.shape}, expected "
                               f"{state[key].shape}")
        state[key] = arr.astype(np.float32)
    return state, cfg


def vibert_name_map(cfg):
    """Hugging Face BERT names of vibert-capu.onnx (BertModel as `bert`, the
    `classifier` and `detector` heads) -> ViBert state-dict keys: the same
    names, the module mirrors the upstream tree."""
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBert

    return {k: (k, None) for k in ViBert(cfg).state_dict()}


def load_vibert(path, cfg=None):
    """Load vibert-capu.onnx into (state, cfg) for models/vibert.ViBert. The
    config is inferred from the initializers unless given (vocab, hidden,
    layers, intermediate, positions, labels, detect tags), with heads =
    hidden // 64 (the BERT convention)."""
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBert, ViBertConfig

    init = _strip_prefixes(read_onnx(path)["initializers"])
    if cfg is None:
        we = init.get("bert.embeddings.word_embeddings.weight")
        if we is None:
            raise ImportReport(
                "[vibert] bert.embeddings.word_embeddings.weight not found; "
                f"first names: {sorted(init)[:8]}")
        vocab, hidden = we.shape
        layers = 0
        while f"bert.encoder.layer.{layers}.attention.self.query.weight" in init:
            layers += 1
        cfg = ViBertConfig(
            vocab_size=vocab, hidden=hidden, layers=layers,
            heads=max(1, hidden // 64),
            intermediate=init["bert.encoder.layer.0.intermediate.dense.weight"].shape[0],
            max_position=init["bert.embeddings.position_embeddings.weight"].shape[0],
            n_labels=init["classifier.weight"].shape[0],
            n_d_tags=init["detector.weight"].shape[0])
    state = _template(ViBert(cfg))
    map_initializers(init, vibert_name_map(cfg), state, label="vibert",
                     fallback_match=True)
    return state, cfg


def load_dnsmos(path, cfg=None):
    """Load DNSMOS sig_bak_ovr.onnx into (state, cfg) for models/dnsmos.Dnsmos.

    The export came from TF/Keras, so its initializer names are not
    torch-style; the mapping is structural, as the JAX package's: 3x3 conv
    kernels in graph order (HWIO natively, or [O, I, 3, 3]), chained by
    their input channels, then the last two dense layers by shape, each
    bias the first unused 1-D tensor of its width. Raises ImportReport when
    the structure differs."""
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import DnsmosConfig, _mel_matrix

    g = read_onnx(path)
    init = g["initializers"]
    order = []  # graph order: weight-bearing node inputs, then the rest
    for _op, ins, _outs, _name in g["nodes"]:
        for name in ins:
            if name in init and name not in order:
                order.append(name)
    for name in init:
        if name not in order:
            order.append(name)

    convs, denses, biases = [], [], {}
    for name in order:
        a = init[name]
        if a.ndim == 4 and 3 in a.shape:
            if a.shape[0] == 3 and a.shape[1] == 3:  # HWIO (TF native)
                convs.append(a)
            elif a.shape[2] == 3 and a.shape[3] == 3:  # OIHW (torch-style)
                convs.append(np.transpose(a, (2, 3, 1, 0)))
        elif a.ndim == 2:
            denses.append(a)
        elif a.ndim == 1:
            biases[name] = a
    if len(convs) < 2 or len(denses) < 2:
        raise ImportReport(
            f"[dnsmos] structural scan found {len(convs)} convs / "
            f"{len(denses)} denses; names: {sorted(init)[:12]}")

    chain = []
    c_in = 1
    for a in convs:
        if a.shape[2] != c_in:
            a = np.transpose(a, (0, 1, 3, 2))
        if a.shape[2] != c_in:
            raise ImportReport(
                f"[dnsmos] conv chain broken at {a.shape} (want in={c_in})")
        chain.append(a)
        c_in = a.shape[3]

    def dense_to(d, d_in):
        if d.shape[0] == d_in:
            return d
        if d.shape[1] == d_in:
            return d.T
        raise ImportReport(f"[dnsmos] dense {d.shape} does not take {d_in}")

    d1 = dense_to(denses[-2], c_in)
    head = dense_to(denses[-1], d1.shape[1])
    if head.shape[1] != 3:
        raise ImportReport(f"[dnsmos] head {head.shape} is not 3-wide")
    if cfg is None:
        cfg = DnsmosConfig(channels=tuple(a.shape[3] for a in chain), dense=d1.shape[1])

    used = set()

    def find_bias(c):
        for name, b in biases.items():
            if b.shape[0] == c and name not in used:
                used.add(name)
                return b
        return np.zeros((c,), np.float32)

    f32 = np.float32
    state = {"mel": _mel_matrix(cfg).T.astype(f32)}
    for i, a in enumerate(chain):  # HWIO -> OIHW
        state[f"convs.{i}.weight"] = np.transpose(a, (3, 2, 0, 1)).astype(f32)
        state[f"convs.{i}.bias"] = find_bias(a.shape[3]).astype(f32)
    state["dense1.weight"] = d1.T.astype(f32)
    state["dense1.bias"] = find_bias(d1.shape[1]).astype(f32)
    state["head.weight"] = head.T.astype(f32)
    state["head.bias"] = find_bias(3).astype(f32)
    return state, cfg


def campp_name_map(cfg):
    """3D-Speaker CAM++ names (campplus_cn_en_common_200k.onnx) -> Campp
    state-dict keys: the same names, the module mirrors the upstream tree.
    Each BatchNorm is a group with identity defaults, used when the exporter
    folded the whole group into the convolution (running_var 1 - 1e-5, so
    that var + eps is 1)."""
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import Campp

    defaults = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
                "running_var": 1.0 - 1e-5}
    bn_prefixes = {k.rsplit(".", 1)[0] for k in Campp(cfg).state_dict()
                   if k.endswith(".running_var")}
    m = {}
    for k in Campp(cfg).state_dict():
        if k.endswith(".num_batches_tracked"):
            continue
        prefix, leaf = k.rsplit(".", 1)
        m[k] = (k, None, prefix, defaults[leaf]) if prefix in bn_prefixes else (k, None)
    return m


def load_campp(path, cfg=None):
    """Load campplus_cn_en_common_200k.onnx into (state, cfg) for
    models/campplus.Campp. The config is derived from the file's tensor
    shapes unless given, as the JAX package's load_campp derives it."""
    from sherpa_vietnamese_asr_tpu_torch.models.campplus import Campp, CamppConfig

    init = _strip_prefixes(read_onnx(path)["initializers"])
    if cfg is None:
        tdnn_w = init.get("xvector.tdnn.linear.weight")
        if tdnn_w is None:
            raise ImportReport(
                "[campp] xvector.tdnn.linear.weight not found; first names: "
                f"{sorted(init)[:8]}")
        init_ch, fcm_out = tdnn_w.shape[:2]
        mc = init["head.conv1.weight"].shape[0]
        layers = []
        bi = 1
        while f"xvector.block{bi}.tdnnd1.linear1.weight" in init:
            j = 1
            while f"xvector.block{bi}.tdnnd{j}.linear1.weight" in init:
                j += 1
            layers.append(j - 1)
            bi += 1
        growth = init["xvector.block1.tdnnd1.cam_layer.linear_local.weight"].shape[0]
        bn_ch = init["xvector.block1.tdnnd1.linear1.weight"].shape[0]
        cfg = CamppConfig(num_mels=fcm_out // mc * 8, m_channels=mc,
                          init_channels=init_ch, growth_rate=growth,
                          bn_size=bn_ch // growth, block_layers=tuple(layers),
                          dilations=(1, 2, 2)[: len(layers)],
                          embed_dim=init["xvector.dense.linear.weight"].shape[0])
    state = _template(Campp(cfg))
    map_initializers(init, campp_name_map(cfg), state, label="campp",
                     fallback_match=True)
    return state, cfg


def convtasnet_name_map(cfg):
    """asteroid Conv-TasNet names (convtasnet_16k.onnx) -> ConvTasNet
    state-dict keys: the same names, the module mirrors the upstream tree."""
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import ConvTasNet

    return {k: (k, None) for k in ConvTasNet(cfg).state_dict()}


def load_convtasnet(path, cfg=None):
    """Load convtasnet_16k.onnx into (state, cfg) for
    models/convtasnet.ConvTasNet. The config is derived from the file's
    tensor shapes unless given, as the JAX package's load_convtasnet derives
    it (the stride is half the filter length)."""
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import (
        ConvTasNet,
        ConvTasNetConfig,
    )

    init = _strip_prefixes(read_onnx(path)["initializers"])
    if cfg is None:
        enc = init.get("encoder.filterbank._filters")
        if enc is None:
            raise ImportReport(
                "[convtasnet] encoder.filterbank._filters not found; first "
                f"names: {sorted(init)[:8]}")
        n_filters, _, kernel = enc.shape
        n_tcn = 0
        while f"masker.TCN.{n_tcn}.res_conv.weight" in init:
            n_tcn += 1
        base = ConvTasNetConfig()
        n_blocks = base.n_blocks if n_tcn % base.n_blocks == 0 else n_tcn
        cfg = ConvTasNetConfig(
            n_filters=n_filters, kernel=kernel, stride=kernel // 2,
            bottleneck=init["masker.bottleneck.1.weight"].shape[0],
            hidden=init["masker.TCN.0.shared_block.0.weight"].shape[0],
            skip=init["masker.TCN.0.skip_conv.weight"].shape[0],
            conv_kernel=init["masker.TCN.0.shared_block.3.weight"].shape[2],
            n_blocks=n_blocks, n_repeats=n_tcn // n_blocks,
            n_src=init["masker.mask_net.1.weight"].shape[0] // n_filters)
    state = _template(ConvTasNet(cfg))
    map_initializers(init, convtasnet_name_map(cfg), state, label="convtasnet",
                     fallback_match=True)
    return state, cfg
