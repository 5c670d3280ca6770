# The punctuation and quality models' checkpoint files, written from this
# package's modules: vibert-capu.onnx with its vocab.txt from a ViBert, and
# sig_bak_ovr.onnx from a Dnsmos. Like models/onnx_export_diar.py the .onnx
# files hold initializers only, which models/onnx_import.load_vibert and
# load_dnsmos (this package's and the JAX package's) read back:
#   * ViBert mirrors the Hugging Face tree, so vibert-capu.onnx carries its
#     state-dict names;
#   * sig_bak_ovr.onnx carries the TF/Keras layouts the structural loader
#     expects: conv kernels [O, I, 3, 3] in chain order, then the dense
#     weights as [in, out] (dense1 is square, so only that layout reads back
#     unambiguously); each bias follows its weight. The fixed mel matrix is
#     not written.
# The executable graphs of the JAX package's onnx_export_aux (run by its
# numpy graph executor) are not ported.

from __future__ import annotations

import os

from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import (
    _initializers_only,
    _numpy_state,
)


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
