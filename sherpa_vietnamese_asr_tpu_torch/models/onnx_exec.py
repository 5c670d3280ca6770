# Copied from sherpa_vietnamese_asr_tpu/models/onnx_exec.py (host numpy; only the package path changes).
# First-party ONNX graph executor (numpy, host-side).
#
# The reference app runs every model through onnxruntime InferenceSessions
# (reference core/asr_engine.py:903-1020, core/hardware_accel.py:555-624).
# This framework's device path is jitted JAX; this module is the ORT-free
# *oracle*: it executes an ONNX graph parsed by models/onnx_import.read_onnx
# strictly per ONNX operator semantics, so every JAX model forward and every
# importer name-map can be validated against graph execution of a
# structurally-real export (the reference's own correctness pattern —
# export-time numeric parity, e.g. convert_onnx/export_convtasnet_onnx.py:
# 66-89). It also lets the framework run any of the reference's real .onnx
# assets directly on host when present.
#
# Supported op set: the ~45 ops used by the reference's nine model exports
# (convs incl. grouped/dilated/transposed, bidirectional LSTM, attention
# primitives, norms, pools, shape plumbing). Ops follow opset 13-17
# semantics; axes-as-input and axes-as-attribute are both accepted where the
# spec moved them between opsets.

from __future__ import annotations

import numpy as np

_ONNX_TO_NP = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _ints(v):
    return [int(x) for x in v]


def _axes(ins, attrs, idx=1):
    """Axes from input tensor (opset>=13/18) or attribute."""
    if len(ins) > idx and ins[idx] is not None:
        return _ints(np.atleast_1d(ins[idx]))
    a = attrs.get("axes")
    return None if a is None else _ints(np.atleast_1d(a))


# ---------------------------------------------------------------------------
# Convolutions / pooling
# ---------------------------------------------------------------------------

def _conv(x, w, b, strides, pads, dilations, group):
    """ONNX Conv: x [N,C,*S], w [M,C/g,*K], pads [b0..bn,e0..en]."""
    nd = x.ndim - 2
    strides = strides or [1] * nd
    dilations = dilations or [1] * nd
    pads = pads or [0] * (2 * nd)
    xp = np.pad(x, [(0, 0), (0, 0)]
                + [(pads[i], pads[nd + i]) for i in range(nd)])
    k = w.shape[2:]
    out_sp = [(xp.shape[2 + i] - (dilations[i] * (k[i] - 1) + 1))
              // strides[i] + 1 for i in range(nd)]
    n, c = x.shape[:2]
    m = w.shape[0]
    cg, mg = c // group, m // group
    out = np.zeros((n, m, *out_sp), np.result_type(x, w))
    for kidx in np.ndindex(*k):
        sl = tuple(
            slice(dilations[i] * kidx[i],
                  dilations[i] * kidx[i] + strides[i] * (out_sp[i] - 1) + 1,
                  strides[i])
            for i in range(nd))
        xs = xp[(slice(None), slice(None)) + sl]  # [N, C, *out]
        wk = w[(slice(None), slice(None)) + kidx]  # [M, C/g]
        if group == 1:
            out += np.einsum("nc...,mc->nm...", xs, wk)
        else:
            for g in range(group):
                out[:, g * mg:(g + 1) * mg] += np.einsum(
                    "nc...,mc->nm...", xs[:, g * cg:(g + 1) * cg],
                    wk[g * mg:(g + 1) * mg])
    if b is not None:
        out += b.reshape((1, m) + (1,) * nd)
    return out.astype(np.result_type(x, w))


def _conv_transpose(x, w, b, strides, pads, output_padding, group):
    """ONNX ConvTranspose: x [N,C,*S], w [C,M/g,*K]."""
    nd = x.ndim - 2
    strides = strides or [1] * nd
    pads = pads or [0] * (2 * nd)
    output_padding = output_padding or [0] * nd
    k = w.shape[2:]
    in_sp = x.shape[2:]
    full = [(in_sp[i] - 1) * strides[i] + k[i] + output_padding[i]
            for i in range(nd)]
    n, c = x.shape[:2]
    mg = w.shape[1]
    m = mg * group
    cg = c // group
    out = np.zeros((n, m, *full), np.result_type(x, w))
    for kidx in np.ndindex(*k):
        wk = w[(slice(None), slice(None)) + kidx]  # [C, M/g]
        sl = tuple(slice(kidx[i], kidx[i] + strides[i] * (in_sp[i] - 1) + 1,
                         strides[i]) for i in range(nd))
        for g in range(group):
            contrib = np.einsum("nc...,cm->nm...",
                                x[:, g * cg:(g + 1) * cg],
                                wk[g * cg:(g + 1) * cg])
            out[(slice(None), slice(g * mg, (g + 1) * mg)) + sl] += contrib
    crop = tuple(slice(pads[i], full[i] - pads[nd + i]) for i in range(nd))
    out = out[(slice(None), slice(None)) + crop]
    if b is not None:
        out += b.reshape((1, m) + (1,) * nd)
    return out.astype(np.result_type(x, w))


def _pool(x, kernel, strides, pads, mode, count_include_pad=0,
          ceil_mode=0):
    nd = x.ndim - 2
    strides = strides or [1] * nd
    pads = pads or [0] * (2 * nd)
    fill = -np.inf if mode == "max" else 0.0
    xp = np.pad(x, [(0, 0), (0, 0)]
                + [(pads[i], pads[nd + i]) for i in range(nd)],
                constant_values=fill)

    def osz(i):
        num = xp.shape[2 + i] - kernel[i]
        return (-(-num // strides[i]) if ceil_mode else num // strides[i]) + 1

    out_sp = [osz(i) for i in range(nd)]
    if ceil_mode:  # re-pad so every window is full
        need = [(out_sp[i] - 1) * strides[i] + kernel[i] - xp.shape[2 + i]
                for i in range(nd)]
        if any(v > 0 for v in need):
            xp = np.pad(xp, [(0, 0), (0, 0)]
                        + [(0, max(0, v)) for v in need],
                        constant_values=fill)
    acc = None
    for kidx in np.ndindex(*kernel):
        sl = tuple(slice(kidx[i], kidx[i] + strides[i] * (out_sp[i] - 1) + 1,
                         strides[i]) for i in range(nd))
        xs = xp[(slice(None), slice(None)) + sl]
        acc = xs.copy() if acc is None else (
            np.maximum(acc, xs) if mode == "max" else acc + xs)
    if mode == "avg":
        if count_include_pad:
            acc /= float(np.prod(kernel))
        else:
            ones = np.ones((1, 1) + x.shape[2:], x.dtype)
            cnt = _pool(ones, kernel, strides, pads, "avg",
                        count_include_pad=1, ceil_mode=ceil_mode)
            acc /= np.maximum(cnt * float(np.prod(kernel)), 1.0)
    return acc.astype(x.dtype)


# ---------------------------------------------------------------------------
# LSTM / GRU (ONNX gate orders: LSTM iofc, GRU zrh)
# ---------------------------------------------------------------------------

def _lstm(ins, attrs):
    x, w, r = ins[0], ins[1], ins[2]
    b = ins[3] if len(ins) > 3 else None
    seq_lens = ins[4] if len(ins) > 4 else None
    h0 = ins[5] if len(ins) > 5 else None
    c0 = ins[6] if len(ins) > 6 else None
    direction = attrs.get("direction", "forward")
    hid = int(attrs.get("hidden_size", r.shape[2]))
    t_len, batch, _ = x.shape
    dirs = 2 if direction == "bidirectional" else 1
    if b is None:
        b = np.zeros((dirs, 8 * hid), x.dtype)
    if h0 is None:
        h0 = np.zeros((dirs, batch, hid), x.dtype)
    if c0 is None:
        c0 = np.zeros((dirs, batch, hid), x.dtype)

    def sigmoid(z):
        return 1.0 / (1.0 + np.exp(-z))

    y = np.zeros((t_len, dirs, batch, hid), x.dtype)
    yh = np.zeros((dirs, batch, hid), x.dtype)
    yc = np.zeros((dirs, batch, hid), x.dtype)
    for d in range(dirs):
        reverse = (direction == "reverse") or d == 1
        wi, wo, wf, wc = np.split(w[d], 4, axis=0)
        ri, ro, rf, rc = np.split(r[d], 4, axis=0)
        wb = np.split(b[d][: 4 * hid], 4)
        rb = np.split(b[d][4 * hid:], 4)
        h, c = h0[d].copy(), c0[d].copy()
        steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
        for t in steps:
            xt = x[t]
            i = sigmoid(xt @ wi.T + h @ ri.T + wb[0] + rb[0])
            o = sigmoid(xt @ wo.T + h @ ro.T + wb[1] + rb[1])
            f = sigmoid(xt @ wf.T + h @ rf.T + wb[2] + rb[2])
            g = np.tanh(xt @ wc.T + h @ rc.T + wb[3] + rb[3])
            c_new = f * c + i * g
            h_new = o * np.tanh(c_new)
            if seq_lens is not None:
                # ORT semantics: Y is zero on dead steps, but the carried
                # state freezes (forward: Y_h = h at the lane's last valid
                # frame; reverse: dead steps precede valid ones in this
                # iteration order, so h stays h0 until the first valid frame).
                live = (t < seq_lens).reshape(-1, 1)
                y[t, d] = np.where(live, h_new, 0.0)
                h = np.where(live, h_new, h)
                c = np.where(live, c_new, c)
            else:
                h, c = h_new, c_new
                y[t, d] = h
        yh[d], yc[d] = h, c
    return [y, yh, yc]


def _gru(ins, attrs):
    x, w, r = ins[0], ins[1], ins[2]
    b = ins[3] if len(ins) > 3 else None
    seq_lens = ins[4] if len(ins) > 4 else None
    h0 = ins[5] if len(ins) > 5 else None
    direction = attrs.get("direction", "forward")
    hid = int(attrs.get("hidden_size", r.shape[2]))
    lbr = int(attrs.get("linear_before_reset", 0))
    t_len, batch, _ = x.shape
    dirs = 2 if direction == "bidirectional" else 1
    if b is None:
        b = np.zeros((dirs, 6 * hid), x.dtype)
    if h0 is None:
        h0 = np.zeros((dirs, batch, hid), x.dtype)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    y = np.zeros((t_len, dirs, batch, hid), x.dtype)
    yh = np.zeros((dirs, batch, hid), x.dtype)
    for d in range(dirs):
        reverse = (direction == "reverse") or d == 1
        wz, wr, wh = np.split(w[d], 3, axis=0)
        rz, rr, rh = np.split(r[d], 3, axis=0)
        wb = np.split(b[d][: 3 * hid], 3)
        rb = np.split(b[d][3 * hid:], 3)
        h = h0[d].copy()
        steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
        for t in steps:
            xt = x[t]
            z = sigmoid(xt @ wz.T + h @ rz.T + wb[0] + rb[0])
            rg = sigmoid(xt @ wr.T + h @ rr.T + wb[1] + rb[1])
            if lbr:
                hh = np.tanh(xt @ wh.T + wb[2] + rg * (h @ rh.T + rb[2]))
            else:
                hh = np.tanh(xt @ wh.T + (rg * h) @ rh.T + wb[2] + rb[2])
            h_new = (1 - z) * hh + z * h
            if seq_lens is not None:
                # Same masking contract as _lstm: zero Y on dead steps,
                # freeze the carried state at the last valid frame.
                live = (t < seq_lens).reshape(-1, 1)
                y[t, d] = np.where(live, h_new, 0.0)
                h = np.where(live, h_new, h)
            else:
                h = h_new
                y[t, d] = h
        yh[d] = h
    return [y, yh]


# ---------------------------------------------------------------------------
# Dispatch table
# ---------------------------------------------------------------------------

def _softmax(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def _reduce(fn, ins, attrs, default_keepdims=1):
    x = ins[0]
    axes = _axes(ins, attrs)
    keep = bool(attrs.get("keepdims", default_keepdims))
    if axes is None and int(attrs.get("noop_with_empty_axes", 0)):
        return x
    ax = None if axes is None else tuple(axes)
    return fn(x, axis=ax, keepdims=keep)


def _slice(ins, attrs):
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:
        starts = _ints(np.atleast_1d(ins[1]))
        ends = _ints(np.atleast_1d(ins[2]))
        axes = (_ints(np.atleast_1d(ins[3]))
                if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (_ints(np.atleast_1d(ins[4]))
                 if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
    else:  # opset <10 attribute form
        starts = _ints(attrs["starts"])
        ends = _ints(attrs["ends"])
        axes = _ints(attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        big = np.iinfo(np.int32).max
        en = None if en >= big else en
        en2 = None if (sp < 0 and en is not None and en < -x.shape[ax]) else en
        sl[ax] = slice(st, en2, sp)
    return x[tuple(sl)]


def _pad_op(ins, attrs):
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:
        pads = _ints(ins[1])
        cval = float(ins[2]) if len(ins) > 2 and ins[2] is not None else 0.0
    else:
        pads = _ints(attrs["pads"])
        cval = float(attrs.get("value", 0.0))
    mode = attrs.get("mode", "constant")
    nd = x.ndim
    width = [(pads[i], pads[nd + i]) for i in range(nd)]
    if mode == "constant":
        return np.pad(x, width, constant_values=cval)
    return np.pad(x, width, mode={"reflect": "reflect", "edge": "edge"}[mode])


def _gemm(ins, attrs):
    a, bm = ins[0], ins[1]
    c = ins[2] if len(ins) > 2 and ins[2] is not None else 0.0
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        bm = bm.T
    return (float(attrs.get("alpha", 1.0)) * (a @ bm)
            + float(attrs.get("beta", 1.0)) * c)


def _batchnorm(ins, attrs):
    x, scale, b, mean, var = ins[:5]
    eps = float(attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape))
            / np.sqrt(var.reshape(shape) + eps)
            * scale.reshape(shape) + b.reshape(shape))


def _layernorm(ins, attrs):
    x, scale = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 and ins[2] is not None else None
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-5))
    axes = tuple(range(axis % x.ndim, x.ndim))
    mu = x.mean(axis=axes, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=axes, keepdims=True)
    out = (x - mu) / np.sqrt(var + eps) * scale
    return out + b if b is not None else out


def _split(ins, attrs, n_out):
    x = ins[0]
    axis = int(attrs.get("axis", 0))
    if len(ins) > 1 and ins[1] is not None:
        sizes = _ints(ins[1])
    elif "split" in attrs:
        sizes = _ints(attrs["split"])
    else:
        n = int(attrs.get("num_outputs", n_out))
        q, rem = divmod(x.shape[axis], n)
        sizes = [q + 1] * rem + [q] * (n - rem) if rem else [q] * n
    idx = np.cumsum(sizes)[:-1]
    return np.split(x, idx, axis=axis)


def _erf(x):
    from scipy.special import erf
    return erf(x)


_UNARY = {
    "Relu": lambda x: np.maximum(x, 0),
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Tanh": np.tanh,
    "Sqrt": np.sqrt,
    "Exp": np.exp,
    "Log": np.log,
    "Neg": np.negative,
    "Abs": np.abs,
    "Erf": _erf,
    "Floor": np.floor,
    "Ceil": np.ceil,
    "Round": lambda x: np.round(x),  # banker's rounding, matches ONNX
    "Not": np.logical_not,
    "Softplus": lambda x: np.logaddexp(x, 0.0),
    "Identity": lambda x: x,
    "Sign": np.sign,
    "Reciprocal": lambda x: 1.0 / x,
}

_BINARY = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
    "Div": lambda a, b: (a / b if np.issubdtype(
        np.result_type(a, b), np.floating) else a // b),
    "Pow": np.power,
    "Equal": np.equal, "Greater": np.greater, "Less": np.less,
    "GreaterOrEqual": np.greater_equal, "LessOrEqual": np.less_equal,
    "And": np.logical_and, "Or": np.logical_or,
    "Mod": np.mod,
}

_REDUCE = {
    "ReduceMean": np.mean, "ReduceSum": np.sum, "ReduceMax": np.max,
    "ReduceMin": np.min, "ReduceProd": np.prod,
    "ReduceL2": lambda x, axis, keepdims: np.sqrt(
        np.sum(np.square(x), axis=axis, keepdims=keepdims)),
}


def run_onnx(graph, feeds, outputs=None):
    """Execute a parsed ONNX graph.

    graph: dict from models.onnx_import.read_onnx (bytes/path also accepted).
    feeds: {input_name: np.ndarray}
    outputs: names to return (default: graph outputs). Returns list of arrays.
    """
    if isinstance(graph, (bytes, bytearray, str)):
        from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx
        graph = read_onnx(graph)
    env = dict(graph["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    attrs_list = graph.get("attrs") or [{}] * len(graph["nodes"])
    for (op, ins_n, outs_n, _node_name), attrs in zip(graph["nodes"],
                                                      attrs_list):
        ins = [env[i] if i else None for i in ins_n]
        x = ins[0] if ins else None
        if op in _UNARY:
            res = _UNARY[op](x)
        elif op in _BINARY:
            res = _BINARY[op](ins[0], ins[1])
        elif op in _REDUCE:
            res = _reduce(_REDUCE[op], ins, attrs)
        elif op == "MatMul":
            res = ins[0] @ ins[1]
        elif op == "Gemm":
            res = _gemm(ins, attrs)
        elif op == "Conv":
            res = _conv(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else None,
                        _ints(attrs.get("strides", [])),
                        _ints(attrs.get("pads", [])),
                        _ints(attrs.get("dilations", [])),
                        int(attrs.get("group", 1)))
        elif op == "ConvTranspose":
            res = _conv_transpose(ins[0], ins[1],
                                  ins[2] if len(ins) > 2 else None,
                                  _ints(attrs.get("strides", [])),
                                  _ints(attrs.get("pads", [])),
                                  _ints(attrs.get("output_padding", [])),
                                  int(attrs.get("group", 1)))
        elif op == "LSTM":
            res = _lstm(ins, attrs)
        elif op == "GRU":
            res = _gru(ins, attrs)
        elif op == "MaxPool":
            res = _pool(x, _ints(attrs["kernel_shape"]),
                        _ints(attrs.get("strides", [])),
                        _ints(attrs.get("pads", [])), "max",
                        ceil_mode=int(attrs.get("ceil_mode", 0)))
        elif op == "AveragePool":
            res = _pool(x, _ints(attrs["kernel_shape"]),
                        _ints(attrs.get("strides", [])),
                        _ints(attrs.get("pads", [])), "avg",
                        int(attrs.get("count_include_pad", 0)),
                        ceil_mode=int(attrs.get("ceil_mode", 0)))
        elif op == "GlobalAveragePool":
            res = x.mean(axis=tuple(range(2, x.ndim)), keepdims=True)
        elif op == "BatchNormalization":
            res = _batchnorm(ins, attrs)
        elif op == "LayerNormalization":
            res = _layernorm(ins, attrs)
        elif op == "Softmax":
            res = _softmax(x, int(attrs.get("axis", -1)))
        elif op == "LogSoftmax":
            ax = int(attrs.get("axis", -1))
            m = np.max(x, axis=ax, keepdims=True)
            z = x - m
            res = z - np.log(np.sum(np.exp(z), axis=ax, keepdims=True))
        elif op == "PRelu":
            slope = ins[1]
            shp = [1] * x.ndim
            if slope.ndim == 1 and x.ndim > 1:
                shp[1] = slope.shape[0] if slope.shape[0] > 1 else 1
                slope = slope.reshape(shp) if slope.size > 1 else slope
            res = np.where(x >= 0, x, x * slope)
        elif op == "LeakyRelu":
            a = float(attrs.get("alpha", 0.01))
            res = np.where(x >= 0, x, a * x)
        elif op == "Elu":
            a = float(attrs.get("alpha", 1.0))
            res = np.where(x >= 0, x, a * (np.exp(x) - 1.0))
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else \
                attrs.get("min")
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else \
                attrs.get("max")
            res = np.clip(x, lo, hi)
        elif op == "Transpose":
            perm = attrs.get("perm")
            res = np.transpose(x, None if perm is None else _ints(perm))
        elif op == "Reshape":
            shape = _ints(ins[1])
            res = x.reshape(shape)
        elif op == "Flatten":
            ax = int(attrs.get("axis", 1)) % (x.ndim + 1)
            res = x.reshape(int(np.prod(x.shape[:ax], initial=1)), -1)
        elif op == "Concat":
            res = np.concatenate([i for i in ins], axis=int(attrs["axis"]))
        elif op == "Split":
            res = _split(ins, attrs, len(outs_n))
        elif op == "Slice":
            res = _slice(ins, attrs)
        elif op == "Squeeze":
            ax = _axes(ins, attrs)
            res = np.squeeze(x, None if ax is None else tuple(ax))
        elif op == "Unsqueeze":
            ax = sorted(a % (x.ndim + len(_axes(ins, attrs)))
                        for a in _axes(ins, attrs))
            res = x
            for a in ax:
                res = np.expand_dims(res, a)
        elif op == "Gather":
            res = np.take(x, ins[1].astype(np.int64),
                          axis=int(attrs.get("axis", 0)))
        elif op == "GatherElements":
            res = np.take_along_axis(x, ins[1].astype(np.int64),
                                     axis=int(attrs.get("axis", 0)))
        elif op == "Pad":
            res = _pad_op(ins, attrs)
        elif op == "Cast":
            res = x.astype(_ONNX_TO_NP[int(attrs["to"])])
        elif op == "Shape":
            res = np.asarray(x.shape, np.int64)
        elif op == "Expand":
            res = x * np.ones(_ints(ins[1]), x.dtype) if \
                np.issubdtype(x.dtype, np.floating) else \
                np.broadcast_to(x, np.broadcast_shapes(
                    x.shape, tuple(_ints(ins[1])))).copy()
        elif op == "ConstantOfShape":
            val = attrs.get("value")
            fill = val.reshape(-1)[0] if val is not None else np.float32(0)
            res = np.full(_ints(x), fill,
                          val.dtype if val is not None else np.float32)
        elif op == "Constant":
            for key in ("value", "value_float", "value_int",
                        "value_floats", "value_ints"):
                if key in attrs:
                    res = np.asarray(attrs[key])
                    break
            else:
                raise ValueError("Constant node without value")
        elif op == "Range":
            res = np.arange(np.asarray(ins[0]).item(),
                            np.asarray(ins[1]).item(),
                            np.asarray(ins[2]).item(),
                            dtype=np.asarray(ins[0]).dtype)
        elif op == "Where":
            res = np.where(ins[0], ins[1], ins[2])
        elif op == "Min":
            res = ins[0]
            for other in ins[1:]:
                res = np.minimum(res, other)
        elif op == "Max":
            res = ins[0]
            for other in ins[1:]:
                res = np.maximum(res, other)
        elif op == "Einsum":
            res = np.einsum(attrs["equation"], *ins)
        elif op == "Tile":
            res = np.tile(x, _ints(ins[1]))
        elif op == "ArgMax":
            ax = int(attrs.get("axis", 0))
            res = np.argmax(x, axis=ax).astype(np.int64)
            if int(attrs.get("keepdims", 1)):
                res = np.expand_dims(res, ax)
        elif op == "CumSum":
            res = np.cumsum(x, axis=int(np.asarray(ins[1]).item()))
        elif op == "Dropout":
            res = x  # inference mode
        else:
            raise NotImplementedError(f"ONNX op {op} not supported")
        if not isinstance(res, (list, tuple)):
            res = [res]
        for name, val in zip(outs_n, res):
            if name:
                env[name] = np.asarray(val)
    return [env[o] for o in (outputs or graph["outputs"])]
