# Build and load the package's hand-written CUDA kernels (csrc/*.cu).
#
# All kernels go into ONE shared library with a plain C interface, compiled
# by nvcc for sm_90a (Hopper; one nvcc per source, run in parallel, then one
# link) and loaded with ctypes. The library is built at
# first use into build/kernels/ at the repository root and keyed by a hash of
# the sources and flags, so an edited source rebuilds and an unchanged one
# loads at once. Each C entry point takes raw data pointers plus the CUDA
# stream, launches, and returns cudaGetLastError(); the Python wrappers in
# ops/ check arguments, allocate outputs and raise on a non-zero status.

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point; pointers and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints.
SIGNATURES = {
    # frames, twiddle, mel_first, mel_offsets, mel_weights, out
    # | n_frames, n_fft, n_mel, n_weights | floor | stream
    "svt_fbank_logmel": [_P] * 6 + [_I] * 4 + [_F, _P],
    # q, k, pq, pos, lens, out | B, H, T, qd, pd | stream
    "svt_attention_weights": [_P] * 6 + [_I] * 5 + [_P],
    # enc, lens, emb, conv_w, we, be, wdp, bdp, wo, bo,
    # hw_next, hw_delta, hw_node (null when S = 0),
    # rec_par, rec_tok, rec_lp, rec_met,
    # tokens, frames, tok_logp, entropy, num_tokens, total_logp
    # | B, T, E, D, ipg, K, J, V, beam, blank, unk, S | tsallis_max,
    # max_entropy | stream
    "svt_beam_search": [_P] * 23 + [_I] * 12 + [_F, _F, _P],
    # x, lens, poslin, weights (host array of 42 pointers), out,
    # ws_proj, ws_w, ws_a, ws_b, ws_c, ws_x
    # | B, T_pad, D, H, qd, pd, vd, hna, ff1, ff2, ff3, K, pos_rows | stream
    "svt_encoder_layer_bf16": [_P] * 11 + [_I] * 13 + [_P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then the toolkit's default location."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists(TOOLKIT_NVCC):
        path = TOOLKIT_NVCC
    if path is None:
        raise RuntimeError(
            "nvcc not found: building the CUDA kernels of "
            "sherpa_vietnamese_asr_tpu_torch needs the CUDA toolkit's nvcc "
            "on PATH or at /usr/local/cuda/bin/nvcc")
    return path


def sources() -> list[Path]:
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvt_kernels_{h.hexdigest()[:16]}.so"


def build(ptxas_info: bool = False) -> tuple[Path, float, str]:
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns (library path, seconds spent compiling, compiler output).
    ptxas_info adds `-Xptxas -v` (registers, shared memory and spills per
    kernel); it does not change the binary.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    # One nvcc per source, all started together, then one link.
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    ptxas = ["-Xptxas", "-v"] if ptxas_info else []
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *compile_flags, *ptxas, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs = [(obj, proc.communicate()[0], proc.returncode) for obj, proc in jobs]
    failed = [f"{obj.name}:\n{log}" for obj, log, rc in logs if rc != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               *[str(obj) for obj, _, _ in logs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link:\n{link.stdout}{link.stderr}")
    for obj, _, _ in logs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out, seconds, "".join(log for _, log, _ in logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.svt_error_string.argtypes = [_I]
            lib.svt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = library().svt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
