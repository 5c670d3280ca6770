# Copied from sherpa_vietnamese_asr_tpu/models/gguf.py (numpy only; only the package path changes).
# Minimal first-party GGUF (v3) reader/writer.
#
# The reference's summarizer loads GGUF checkpoints in-process through
# llama-cpp-python (reference web_service/summarizer.py:310-474). Neither
# llama.cpp nor any GGUF library ships in this environment, so this module
# parses the format directly — the same inversion as models/onnx_import.py's
# wire-level ONNX parser. models/llama.py maps the tensors onto a JAX
# llama-family forward; web_service/summarizer.py gates the "local" backend
# on a *.gguf file being present.
#
# Format (ggml GGUF v3): little-endian
#   magic "GGUF" | version u32 | n_tensors u64 | n_kv u64
#   n_kv x (key: string, type: u32, value)       -- string = u64 len + bytes
#   n_tensors x (name: string, n_dims u32, dims u64[n] (innermost first),
#                ggml_type u32, offset u64)
#   padding to general.alignment (default 32), then tensor data blob.
# Quantization: F32/F16 passthrough; Q8_0 = blocks of 32 (f16 scale + 32 i8);
# k-quants Q4_K / Q5_K / Q6_K = super-blocks of 256 with 6-bit (Q4/Q5) or
# 8-bit (Q6) sub-scales — the formats real Gemma/llama distributions ship in
# (the reference accepts any llama.cpp-supported GGUF,
# reference web_service/summarizer.py:310-474).

from __future__ import annotations

import struct

import numpy as np

GGUF_MAGIC = b"GGUF"

# GGUF metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 \
    = range(13)

_SCALAR_FMT = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d"}

# ggml tensor types we read/write
GGML_F32, GGML_F16 = 0, 1
GGML_Q8_0 = 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
_Q8_BLOCK = 32
_QK_K = 256  # k-quant super-block size

# Per-type raw bytes per super-block (llama.cpp block_q*_K struct sizes).
_Q4K_BYTES = 2 + 2 + 12 + _QK_K // 2            # 144
_Q5K_BYTES = 2 + 2 + 12 + _QK_K // 8 + _QK_K // 2   # 176
_Q6K_BYTES = _QK_K // 2 + _QK_K // 4 + _QK_K // 16 + 2  # 210

_Q4K_DTYPE = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                       ("scales", "u1", (12,)), ("qs", "u1", (_QK_K // 2,))])
_Q5K_DTYPE = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                       ("scales", "u1", (12,)), ("qh", "u1", (_QK_K // 8,)),
                       ("qs", "u1", (_QK_K // 2,))])
_Q6K_DTYPE = np.dtype([("ql", "u1", (_QK_K // 2,)),
                       ("qh", "u1", (_QK_K // 4,)),
                       ("sc", "i1", (_QK_K // 16,)), ("d", "<f2")])


def _tensor_nbytes(ggml_type, n):
    """Raw byte count of an n-element tensor of the given ggml type."""
    if ggml_type == GGML_F32:
        return n * 4
    if ggml_type == GGML_F16:
        return n * 2
    if ggml_type == GGML_Q8_0:
        return (n // _Q8_BLOCK) * (2 + _Q8_BLOCK)
    if ggml_type == GGML_Q4_K:
        return (n // _QK_K) * _Q4K_BYTES
    if ggml_type == GGML_Q5_K:
        return (n // _QK_K) * _Q5K_BYTES
    if ggml_type == GGML_Q6_K:
        return (n // _QK_K) * _Q6K_BYTES
    raise NotImplementedError(f"ggml tensor type {ggml_type}")


def _unpack_scale_min_k4(scales):
    """llama.cpp get_scale_min_k4, vectorized: [B,12] u8 -> ([B,8], [B,8])
    6-bit scale and min factors for Q4_K/Q5_K super-blocks."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        mn[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0xF) | ((s[..., j - 4] >> 6) << 4)
        mn[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, mn


def _pack_scale_min_k4(sc, mn):
    """Inverse of _unpack_scale_min_k4: two [B,8] 6-bit int arrays -> [B,12]."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros(sc.shape[:-1] + (12,), np.uint8)
    for j in range(4):
        out[..., j] = (sc[..., j] & 63) | ((sc[..., j + 4] >> 4) << 6)
        out[..., j + 4] = (mn[..., j] & 63) | ((mn[..., j + 4] >> 4) << 6)
        out[..., j + 8] = (sc[..., j + 4] & 0xF) | ((mn[..., j + 4] & 0xF) << 4)
    return out


def _dequant_q4_k(raw, blocks):
    rec = np.frombuffer(raw, dtype=_Q4K_DTYPE, count=blocks)
    d = rec["d"].astype(np.float32)[:, None]
    dmin = rec["dmin"].astype(np.float32)[:, None]
    sc, mn = _unpack_scale_min_k4(rec["scales"])
    # qs[32j:32j+32] holds 64-group j: low nibbles -> elements 64j..64j+31
    # (scale pair 2j), high nibbles -> 64j+32..64j+63 (pair 2j+1).
    qs = rec["qs"].reshape(blocks, 4, 32)
    q = np.stack([qs & 0xF, qs >> 4], axis=2).astype(np.float32)  # [B,4,2,32]
    scale = (d * sc).reshape(blocks, 4, 2, 1)
    offs = (dmin * mn).reshape(blocks, 4, 2, 1)
    return (scale * q - offs).reshape(-1)


def _dequant_q5_k(raw, blocks):
    rec = np.frombuffer(raw, dtype=_Q5K_DTYPE, count=blocks)
    d = rec["d"].astype(np.float32)[:, None]
    dmin = rec["dmin"].astype(np.float32)[:, None]
    sc, mn = _unpack_scale_min_k4(rec["scales"])
    qs = rec["qs"].reshape(blocks, 4, 32)
    qh = rec["qh"].reshape(blocks, 1, 32)
    # 5th bit of element in 32-group g (g = 2j+half) is qh bit g.
    lo = np.stack([qs & 0xF, qs >> 4], axis=2)  # [B,4,2,32]
    g = np.arange(8).reshape(4, 2, 1)
    hi = ((qh[:, :, None, :] >> g) & 1).reshape(blocks, 4, 2, 32) << 4
    q = (lo | hi).astype(np.float32)
    scale = (d * sc).reshape(blocks, 4, 2, 1)
    offs = (dmin * mn).reshape(blocks, 4, 2, 1)
    return (scale * q - offs).reshape(-1)


def _dequant_q6_k(raw, blocks):
    rec = np.frombuffer(raw, dtype=_Q6K_DTYPE, count=blocks)
    ql = rec["ql"].reshape(blocks, 2, 2, 32)   # [B, half, lo32-pair, 32]
    qh = rec["qh"].reshape(blocks, 2, 32)      # [B, half, 32]
    q = np.empty((blocks, 2, 128), np.int32)   # per 128-element half
    q[:, :, 0:32] = (ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4)
    q[:, :, 32:64] = (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4)
    q[:, :, 64:96] = (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4)
    q[:, :, 96:128] = (ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4)
    q = q.reshape(blocks, _QK_K) - 32
    # Scale for element e is sc[e // 16].
    sc = np.repeat(rec["sc"].astype(np.float32), 16, axis=1)
    return (rec["d"].astype(np.float32)[:, None] * sc * q).reshape(-1)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        out = self.buf[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("truncated GGUF file")
        self.pos += n
        return out

    def scalar(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self):
        n = self.scalar("<Q")
        return self.take(n).decode("utf-8")

    def value(self, vtype):
        if vtype in _SCALAR_FMT:
            v = self.scalar(_SCALAR_FMT[vtype])
            return bool(v) if vtype == _BOOL else v
        if vtype == _BOOL:
            return bool(self.scalar("<B"))
        if vtype == _STR:
            return self.string()
        if vtype == _ARR:
            etype = self.scalar("<I")
            n = self.scalar("<Q")
            return [self.value(etype) for _ in range(n)]
        raise ValueError(f"unknown GGUF value type {vtype}")


def _dequant(raw, ggml_type, shape):
    n = int(np.prod(shape)) if shape else 1
    if ggml_type == GGML_F32:
        arr = np.frombuffer(raw, "<f4", count=n)
    elif ggml_type == GGML_F16:
        arr = np.frombuffer(raw, "<f2", count=n).astype(np.float32)
    elif ggml_type == GGML_Q8_0:
        blocks = n // _Q8_BLOCK
        rec = np.frombuffer(raw, dtype=np.dtype(
            [("d", "<f2"), ("q", "i1", (_Q8_BLOCK,))]), count=blocks)
        arr = (rec["d"].astype(np.float32)[:, None]
               * rec["q"].astype(np.float32)).reshape(-1)
    elif ggml_type == GGML_Q4_K:
        arr = _dequant_q4_k(raw, n // _QK_K)
    elif ggml_type == GGML_Q5_K:
        arr = _dequant_q5_k(raw, n // _QK_K)
    elif ggml_type == GGML_Q6_K:
        arr = _dequant_q6_k(raw, n // _QK_K)
    else:
        raise NotImplementedError(f"ggml tensor type {ggml_type}")
    # GGUF dims are innermost-first; numpy shape is outermost-first.
    return arr.reshape(tuple(reversed(shape))).astype(np.float32)


def read_gguf(path_or_bytes, load_tensors=True):
    """Parse a GGUF file -> {"metadata": {...}, "tensors": {name: f32 array}}.

    Supported tensor types: F32, F16, Q8_0, Q4_K, Q5_K, Q6_K — enough for
    real Gemma/llama distributions (Q4_K_M / Q5_K_M / Q6_K / Q8_0 files);
    other ggml types raise."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    r = _Reader(buf)
    if r.take(4) != GGUF_MAGIC:
        raise ValueError("not a GGUF file")
    version = r.scalar("<I")
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.scalar("<Q")
    n_kv = r.scalar("<Q")
    meta = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.scalar("<I")
        meta[key] = r.value(vtype)
    infos = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.scalar("<I")
        dims = [r.scalar("<Q") for _ in range(n_dims)]
        ggml_type = r.scalar("<I")
        offset = r.scalar("<Q")
        infos.append((name, dims, ggml_type, offset))
    align = int(meta.get("general.alignment", 32))
    data_start = (r.pos + align - 1) // align * align
    tensors = {}
    if load_tensors:
        for name, dims, ggml_type, offset in infos:
            n = int(np.prod(dims)) if dims else 1
            try:
                nbytes = _tensor_nbytes(ggml_type, n)
            except NotImplementedError:
                raise NotImplementedError(f"ggml tensor type {ggml_type} "
                                          f"for {name}") from None
            raw = buf[data_start + offset: data_start + offset + nbytes]
            tensors[name] = _dequant(raw, ggml_type, dims)
    return {"metadata": meta, "tensors": tensors,
            "infos": {name: (dims, t) for name, dims, t, _ in infos}}


# ---------------------------------------------------------------------------
# Writer (tests / synthetic checkpoints)
# ---------------------------------------------------------------------------

def _w_string(s):
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _w_value(v):
    if isinstance(v, (bool, np.bool_)):
        return struct.pack("<I", _BOOL) + struct.pack("<B", int(v))
    if isinstance(v, (int, np.integer)):
        v = int(v)
        return struct.pack("<I", _U32 if 0 <= v < 2 ** 32 else _I64) + (
            struct.pack("<I", v) if 0 <= v < 2 ** 32
            else struct.pack("<q", v))
    if isinstance(v, (float, np.floating)):
        return struct.pack("<I", _F32) + struct.pack("<f", float(v))
    if isinstance(v, str):
        return struct.pack("<I", _STR) + _w_string(v)
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, str) for x in v):
            body = b"".join(_w_string(x) for x in v)
            return (struct.pack("<I", _ARR) + struct.pack("<I", _STR)
                    + struct.pack("<Q", len(v)) + body)
        if all(isinstance(x, (float, np.floating)) for x in v):
            body = b"".join(struct.pack("<f", float(x)) for x in v)
            return (struct.pack("<I", _ARR) + struct.pack("<I", _F32)
                    + struct.pack("<Q", len(v)) + body)
        body = b"".join(struct.pack("<i", int(x)) for x in v)
        return (struct.pack("<I", _ARR) + struct.pack("<I", _I32)
                + struct.pack("<Q", len(v)) + body)
    raise TypeError(f"unsupported GGUF metadata value {v!r}")


def quantize_q8_0(arr):
    """f32 array (size % 32 == 0) -> Q8_0 raw bytes (llama.cpp layout)."""
    flat = np.asarray(arr, np.float32).reshape(-1, _Q8_BLOCK)
    d = np.abs(flat).max(axis=1) / 127.0
    d = np.where(d == 0, 1e-12, d)
    q = np.clip(np.round(flat / d[:, None]), -127, 127).astype(np.int8)
    rec = np.zeros(flat.shape[0], dtype=np.dtype(
        [("d", "<f2"), ("q", "i1", (_Q8_BLOCK,))]))
    rec["d"] = d.astype(np.float16)
    rec["q"] = q
    return rec.tobytes()


def quantize_q4_k(arr):
    """f32 array (size % 256 == 0) -> Q4_K raw bytes.

    A straightforward encoder (per-32-group affine scale/min, 6-bit
    quantized against the super-block max), not llama.cpp's error-search
    variant — the bit layout is identical, so it exercises the exact decode
    path real Q4_K_M files take."""
    flat = np.asarray(arr, np.float32).reshape(-1, 8, 32)
    blocks = flat.shape[0]
    gmin = np.minimum(flat.min(axis=2), 0.0)        # [B,8] <= 0
    gmax = np.maximum(flat.max(axis=2), 0.0)
    m_g = -gmin                                     # value = d*sc*q - dmin*mn
    t_g = (gmax + m_g) / 15.0
    d = t_g.max(axis=1, keepdims=True) / 63.0
    dmin = m_g.max(axis=1, keepdims=True) / 63.0
    d = np.where(d == 0, 1e-12, d)
    dmin = np.where(dmin == 0, 1e-12, dmin)
    # Round the f16 storage BEFORE deriving quants so decode is consistent.
    d = d.astype(np.float16).astype(np.float32)
    dmin = dmin.astype(np.float16).astype(np.float32)
    sc6 = np.clip(np.round(t_g / d), 0, 63)
    mn6 = np.clip(np.round(m_g / dmin), 0, 63)
    scale = np.where(sc6 == 0, 1e-12, d * sc6)[:, :, None]
    q = np.clip(np.round((flat + (dmin * mn6)[:, :, None]) / scale),
                0, 15).astype(np.uint8)
    rec = np.zeros(blocks, dtype=_Q4K_DTYPE)
    rec["d"] = d[:, 0].astype(np.float16)
    rec["dmin"] = dmin[:, 0].astype(np.float16)
    rec["scales"] = _pack_scale_min_k4(sc6, mn6)
    q = q.reshape(blocks, 4, 2, 32)
    rec["qs"] = (q[:, :, 0] | (q[:, :, 1] << 4)).reshape(blocks, 128)
    return rec.tobytes()


def quantize_q6_k(arr):
    """f32 array (size % 256 == 0) -> Q6_K raw bytes (llama.cpp layout)."""
    flat = np.asarray(arr, np.float32).reshape(-1, 16, 16)
    blocks = flat.shape[0]
    a_g = np.abs(flat).max(axis=2)                  # [B,16]
    t_g = a_g / 31.0                                # per-group scale target
    d = t_g.max(axis=1, keepdims=True) / 127.0
    d = np.where(d == 0, 1e-12, d).astype(np.float16).astype(np.float32)
    sc8 = np.clip(np.round(t_g / d), -128, 127)
    scale = np.where(sc8 == 0, 1e-12, d * sc8)[:, :, None]
    q = (np.clip(np.round(flat / scale), -32, 31).astype(np.int32) + 32
         ).astype(np.uint8).reshape(blocks, 2, 128)  # [B, half, 128]
    rec = np.zeros(blocks, dtype=_Q6K_DTYPE)
    rec["d"] = d[:, 0].astype(np.float16)
    rec["sc"] = sc8.astype(np.int8)
    ql = np.empty((blocks, 2, 64), np.uint8)
    ql[:, :, 0:32] = (q[:, :, 0:32] & 0xF) | ((q[:, :, 64:96] & 0xF) << 4)
    ql[:, :, 32:64] = (q[:, :, 32:64] & 0xF) | ((q[:, :, 96:128] & 0xF) << 4)
    qh = ((q[:, :, 0:32] >> 4) | ((q[:, :, 32:64] >> 4) << 2)
          | ((q[:, :, 64:96] >> 4) << 4) | ((q[:, :, 96:128] >> 4) << 6))
    rec["ql"] = ql.reshape(blocks, 128)
    rec["qh"] = qh.reshape(blocks, 64)
    return rec.tobytes()


_QUANTIZERS = {GGML_Q8_0: quantize_q8_0, GGML_Q4_K: quantize_q4_k,
               GGML_Q6_K: quantize_q6_k}


def write_gguf(path, metadata, tensors, q8_names=(), quant_types=None):
    """Write a GGUF v3 file. tensors: {name: np array (f32)}; names listed in
    q8_names are stored Q8_0 (size % 32 == 0 required); quant_types maps
    name -> ggml type (GGML_Q8_0/GGML_Q4_K/GGML_Q6_K) for per-tensor control;
    the rest F32."""
    align = int(metadata.get("general.alignment", 32))
    header = bytearray()
    header += GGUF_MAGIC + struct.pack("<I", 3)
    header += struct.pack("<Q", len(tensors))
    header += struct.pack("<Q", len(metadata))
    for k, v in metadata.items():
        header += _w_string(k) + _w_value(v)
    blobs, infos = [], []
    offset = 0
    for name, arr in tensors.items():
        arr = np.asarray(arr, np.float32)
        ttype = (quant_types or {}).get(
            name, GGML_Q8_0 if name in q8_names else GGML_F32)
        if ttype == GGML_F32:
            raw = arr.astype("<f4").tobytes()
        else:
            raw = _QUANTIZERS[ttype](arr)
        pad = (-len(raw)) % align
        infos.append((name, list(reversed(arr.shape)), ttype, offset))
        blobs.append(raw + b"\0" * pad)
        offset += len(raw) + pad
    for name, dims, ttype, off in infos:
        header += _w_string(name) + struct.pack("<I", len(dims))
        for dim in dims:
            header += struct.pack("<Q", dim)
        header += struct.pack("<I", ttype) + struct.pack("<Q", off)
    pad = (-len(header)) % align
    with open(path, "wb") as f:
        f.write(bytes(header) + b"\0" * pad + b"".join(blobs))
    return path
