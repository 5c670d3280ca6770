# ctypes loader for the native clusterkit library (native/clusterkit.cpp):
# the UMAP SGD layout loop and the mutual-reachability Prim MST of the Senko
# long-audio route (utils/clustering.py).
#
# After sherpa_vietnamese_asr_tpu/utils/native.py:get_clusterkit, with one
# difference: the library is built with g++ -O3 -shared -fPIC into
# build/native/ at the root of the checkout (never beside the source), named
# by a hash of the source so an edit rebuilds. Without g++ the loader returns
# None and utils/clustering.py runs its numpy fallbacks.

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "clusterkit.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libclusterkit_{digest}.so")


def _build(lib_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib_path)


def get_clusterkit():
    """Load (building if needed) the clusterkit library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            return None
        c = ctypes
        lib.ck_umap_layout.restype = c.c_int
        lib.ck_umap_layout.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int32,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_double), c.c_int64, c.c_int32,
            c.c_float, c.c_float, c.c_float, c.c_int32, c.c_uint64]
        lib.ck_mr_mst.restype = c.c_int
        lib.ck_mr_mst.argtypes = [
            c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int64, c.c_int32,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float)]
        _lib = lib
        return _lib
