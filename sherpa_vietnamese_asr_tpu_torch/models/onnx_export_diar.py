# The diarization and separation models' checkpoint files, written from this
# package's modules: segmentation-community-1.onnx from a PyanNet,
# embedding_encoder.onnx with resnet_seg_1_{weight,bias}.npy from a
# ResNetSpeaker (the upstream split: the projection lives in the two .npy
# files), campplus_cn_en_common_200k.onnx from a Campp and
# convtasnet_16k.onnx from a ConvTasNet. Each module mirrors its upstream
# tree, so the files carry its state-dict names, which
# models/onnx_import.load_pyannet, load_resnet_speaker, load_campp and
# load_convtasnet (this package's and the JAX package's) read back. The
# .onnx files hold initializers only.

from __future__ import annotations

import os

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import (
    _initializers_only,
    _numpy_state,
)


def export_diarization_files(seg_model, emb_model, out_dir: str) -> dict:
    """Write the PyanNet and ResNet34 files into out_dir; returns
    {file name: path}."""
    seg = _numpy_state(seg_model)
    emb = {k: v for k, v in _numpy_state(emb_model).items()
           if not k.startswith("resnet.seg_1.") and not k.endswith(".num_batches_tracked")}
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, name) for name in (
        "segmentation-community-1.onnx", "embedding_encoder.onnx",
        "resnet_seg_1_weight.npy", "resnet_seg_1_bias.npy")}
    for name, tensors in (("segmentation-community-1.onnx", seg),
                          ("embedding_encoder.onnx", emb)):
        with open(paths[name], "wb") as f:
            f.write(_initializers_only(tensors))
    seg_1 = emb_model.resnet.seg_1
    np.save(paths["resnet_seg_1_weight.npy"], seg_1.weight.detach().cpu().numpy())
    np.save(paths["resnet_seg_1_bias.npy"], seg_1.bias.detach().cpu().numpy())
    return paths


def _state_file(model, out_dir, name) -> str:
    """Write `model`'s state dict (BatchNorm step counters left out) as the
    initializers of out_dir/name; returns the path."""
    state = {k: v for k, v in _numpy_state(model).items()
             if not k.endswith(".num_batches_tracked")}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "wb") as f:
        f.write(_initializers_only(state))
    return path


def export_campp_file(model, out_dir: str) -> str:
    """Write campplus_cn_en_common_200k.onnx for a Campp; returns its path."""
    return _state_file(model, out_dir, "campplus_cn_en_common_200k.onnx")


def export_convtasnet_file(model, out_dir: str) -> str:
    """Write convtasnet_16k.onnx for a ConvTasNet; returns its path."""
    return _state_file(model, out_dir, "convtasnet_16k.onnx")
