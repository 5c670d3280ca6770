# Copied from sherpa_vietnamese_asr_tpu/models/onnx_synth.py (host numpy; the package
# path changes, and GraphBuilder.build joins the graph's fields once).
# ONNX graph writer: synthesize structurally-real ONNX model files.
#
# The reference app ships every model as a torch.onnx.export'ed .onnx file
# with pinned SHA256 (reference build-portable/prepare_offline_build.py:
# 21-242). This environment has no model assets and no `onnx` package, so
# parity testing works the other way around: per-model synth_*() functions
# (tests/onnx_graphs.py) rebuild each export's graph — same initializer
# names, same op wiring — from random weights, and models/onnx_exec.py
# executes it as an ORT-free oracle against the JAX forwards.
#
# The builder emits the minimal ModelProto subset read_onnx understands:
# nodes with attributes, initializers, graph inputs/outputs.

from __future__ import annotations

import struct

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.utils import protowire as pw

_NP_TO_ONNX = {
    np.dtype("float32"): 1, np.dtype("uint8"): 2, np.dtype("int8"): 3,
    np.dtype("uint16"): 4, np.dtype("int16"): 5, np.dtype("int32"): 6,
    np.dtype("int64"): 7, np.dtype("bool"): 9, np.dtype("float16"): 10,
    np.dtype("float64"): 11, np.dtype("uint32"): 12, np.dtype("uint64"): 13,
}


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += pw.write_field(1, 0, d)  # dims
    out += pw.write_field(2, 0, _NP_TO_ONNX[arr.dtype])  # data_type
    out += pw.write_field(8, 2, name.encode())  # name
    out += pw.write_field(9, 2, arr.tobytes())  # raw_data
    return out


def _u64(v: int) -> int:
    return v & (2 ** 64 - 1)


def attribute_proto(name: str, value) -> bytes:
    out = pw.write_field(1, 2, name.encode())
    if isinstance(value, np.ndarray):
        out += pw.write_field(5, 2, tensor_proto("", value))  # t
        out += pw.write_field(20, 0, 4)  # type = TENSOR
    elif isinstance(value, str):
        out += pw.write_field(4, 2, value.encode())  # s
        out += pw.write_field(20, 0, 3)  # type = STRING
    elif isinstance(value, bool):
        out += pw.write_field(3, 0, int(value))
        out += pw.write_field(20, 0, 2)  # INT
    elif isinstance(value, int):
        out += pw.write_field(3, 0, _u64(value))  # i
        out += pw.write_field(20, 0, 2)  # INT
    elif isinstance(value, float):
        key = pw.write_varint((2 << 3) | 5)  # f, wire type fixed32
        out += key + struct.pack("<f", value)
        out += pw.write_field(20, 0, 1)  # FLOAT
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            packed = b"".join(pw.write_varint(_u64(int(v))) for v in value)
            out += pw.write_field(8, 2, packed)  # ints (packed)
            out += pw.write_field(20, 0, 7)  # INTS
        elif all(isinstance(v, (float, np.floating)) for v in value):
            packed = b"".join(struct.pack("<f", float(v)) for v in value)
            out += pw.write_field(7, 2, packed)  # floats (packed)
            out += pw.write_field(20, 0, 6)  # FLOATS
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += pw.write_field(9, 2, v.encode())  # strings
            out += pw.write_field(20, 0, 8)  # STRINGS
        else:
            raise TypeError(f"mixed attribute list for {name}: {value!r}")
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


class GraphBuilder:
    """Tiny ONNX graph construction API.

    >>> b = GraphBuilder()
    >>> x = b.input("x")
    >>> w = b.init("fc.weight", np.zeros((4, 3), np.float32))
    >>> y = b.node("MatMul", [x, w])
    >>> b.output(y)
    >>> model_bytes = b.build()
    """

    def __init__(self):
        self._nodes = []  # (op, inputs, outputs, attrs)
        self._inits = {}
        self._inputs = []
        self._outputs = []
        self._n = 0

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def input(self, name: str) -> str:
        self._inputs.append(name)
        return name

    def output(self, name: str) -> str:
        self._outputs.append(name)
        return name

    def init(self, name: str, arr) -> str:
        if name in self._inits:
            raise ValueError(f"duplicate initializer {name}")
        self._inits[name] = np.asarray(arr)
        return name

    def const(self, arr, hint: str = "c") -> str:
        """Anonymous constant initializer (deduplicates by content id)."""
        return self.init(self.fresh(hint), arr)

    def node(self, op: str, inputs, outputs=None, n_out: int = 1, **attrs):
        """Add a node; returns the single output name or a list of names."""
        if outputs is None:
            outputs = [self.fresh(op.lower()) for _ in range(n_out)]
        elif isinstance(outputs, str):
            outputs = [outputs]
        self._nodes.append((op, list(inputs), list(outputs), attrs))
        return outputs[0] if len(outputs) == 1 else outputs

    def build(self) -> bytes:
        # The graph's fields are joined once: appending them one by one
        # copies the graph so far each time (minutes for a full-size
        # encoder graph); the bytes are the same.
        fields = []
        for op, ins, outs, attrs in self._nodes:
            nb = b"".join(
                [pw.write_field(1, 2, i.encode()) for i in ins]
                + [pw.write_field(2, 2, o.encode()) for o in outs]
                + [pw.write_field(4, 2, op.encode())]
                + [pw.write_field(5, 2, attribute_proto(k, v))
                   for k, v in attrs.items()])
            fields.append(pw.write_field(1, 2, nb))
        for name, arr in self._inits.items():
            fields.append(pw.write_field(5, 2, tensor_proto(name, arr)))
        for n in self._inputs:
            fields.append(pw.write_field(11, 2, pw.write_field(1, 2, n.encode())))
        for n in self._outputs:
            fields.append(pw.write_field(12, 2, pw.write_field(1, 2, n.encode())))
        model = pw.write_field(1, 0, 8)  # ir_version
        model += pw.write_field(7, 2, b"".join(fields))
        return model
