# ctypes loaders for the native host-side libraries (native/*.cpp):
# audiokit (WAV decode with mono mixdown, polyphase resampling) for
# utils/audio_io.load_audio, and clusterkit (the UMAP SGD layout loop and the
# mutual-reachability Prim MST of the Senko long-audio route) for
# utils/clustering.py.
#
# After sherpa_vietnamese_asr_tpu/utils/native.py (get_lib, wav_decode_native,
# resample_native, get_clusterkit), with one difference: each library is
# built with g++ -O3 -shared -fPIC into build/native/ at the root of the
# checkout (never beside the source), named by a hash of its source so an
# edit rebuilds. Without g++ a loader returns None and the callers run their
# numpy fallbacks.

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")

_lock = threading.Lock()
_libs: dict = {}  # library name -> CDLL, or None once a build or load failed


def library_path(name: str = "clusterkit") -> str:
    with open(os.path.join(_NATIVE_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _build(name, lib_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC",
           os.path.join(_NATIVE_DIR, f"{name}.cpp"), "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib_path)


def _load(name, signatures):
    """The library `name`, built if needed, with each function's (restype,
    argtypes) from `signatures`; None if it cannot be built or loaded. One
    attempt a process."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        try:
            path = library_path(name)
            if not os.path.exists(path):
                _build(name, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            return None
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib


_c = ctypes
_AUDIOKIT = {
    "audiokit_wav_decode": (_c.c_int, [
        _c.c_char_p, _c.c_int64, _c.POINTER(_c.c_int32),
        _c.POINTER(_c.c_int32), _c.POINTER(_c.c_int64),
        _c.POINTER(_c.c_float)]),
    "audiokit_resample_len": (_c.c_int64, [_c.c_int64, _c.c_int32, _c.c_int32]),
    "audiokit_resample": (_c.c_int, [
        _c.POINTER(_c.c_float), _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32,
        _c.POINTER(_c.c_float)]),
}
_CLUSTERKIT = {
    "ck_umap_layout": (_c.c_int, [
        _c.POINTER(_c.c_float), _c.c_int64, _c.c_int32,
        _c.POINTER(_c.c_int32), _c.POINTER(_c.c_int32),
        _c.POINTER(_c.c_double), _c.c_int64, _c.c_int32,
        _c.c_float, _c.c_float, _c.c_float, _c.c_int32, _c.c_uint64]),
    "ck_mr_mst": (_c.c_int, [
        _c.POINTER(_c.c_float), _c.POINTER(_c.c_float), _c.c_int64, _c.c_int32,
        _c.POINTER(_c.c_int32), _c.POINTER(_c.c_int32), _c.POINTER(_c.c_float)]),
}


def get_audiokit():
    """Load (building if needed) the audiokit library; None if unavailable."""
    return _load("audiokit", _AUDIOKIT)


def get_clusterkit():
    """Load (building if needed) the clusterkit library; None if unavailable."""
    return _load("clusterkit", _CLUSTERKIT)


def wav_decode_native(path):
    """Returns (mono float32 array, rate) or None when native lib missing or
    the file is unsupported."""
    import numpy as np

    lib = get_audiokit()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    rate = ctypes.c_int32()
    channels = ctypes.c_int32()
    frames = ctypes.c_int64()
    rc = lib.audiokit_wav_decode(buf, len(buf), ctypes.byref(rate),
                                 ctypes.byref(channels), ctypes.byref(frames),
                                 None)
    if rc != 0:
        return None
    out = np.empty(frames.value, np.float32)
    rc = lib.audiokit_wav_decode(
        buf, len(buf), ctypes.byref(rate), ctypes.byref(channels),
        ctypes.byref(frames),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out, rate.value


def resample_native(x, sr_in, sr_out, num_zeros=16):
    """Polyphase resample via audiokit; None when unavailable."""
    import numpy as np

    lib = get_audiokit()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out_len = lib.audiokit_resample_len(len(x), sr_in, sr_out)
    out = np.empty(out_len, np.float32)
    rc = lib.audiokit_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sr_in, sr_out, num_zeros,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out
