# Copied from sherpa_vietnamese_asr_tpu/utils/protowire.py (pure Python; only the package path changes).
# Minimal protobuf wire-format reader — enough to extract tensors from ONNX
# model files without the `onnx`/`protobuf` Python packages (not available in
# this environment; ONNX checkpoints are the reference app's weight
# distribution format, see reference build-portable/prepare_offline_build.py).
#
# Wire format: https://protobuf.dev/programming-guides/encoding/
# We implement varint, 64-bit, length-delimited, and 32-bit wire types and a
# generic message parser returning {field_number: [raw values]}. The ONNX
# schema subset needed (ModelProto/GraphProto/TensorProto/NodeProto field
# numbers) lives in onnx_import.py.

from __future__ import annotations

import struct


def read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def parse_fields(buf: bytes):
    """Parse one message's fields.

    Returns {field_number: [value, ...]} where value is int for varint/fixed
    types and bytes for length-delimited fields.
    """
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {field})")
        fields.setdefault(field, []).append(val)
    return fields


def parse_packed_varints(buf: bytes):
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


# --- tiny writer (used by tests to synthesize ONNX files) ---

def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_field(field: int, wtype: int, payload) -> bytes:
    key = write_varint((field << 3) | wtype)
    if wtype == 0:
        return key + write_varint(payload)
    if wtype == 2:
        return key + write_varint(len(payload)) + payload
    raise ValueError(f"writer supports wire types 0/2 only, got {wtype}")
