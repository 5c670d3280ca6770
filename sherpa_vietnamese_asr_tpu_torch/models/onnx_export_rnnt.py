# ONNX export of the Zipformer RNN-T's weights (encoder / decoder / joiner).
#
# Port of the weight half of sherpa_vietnamese_asr_tpu/models/
# onnx_export_rnnt.py: invert_zipformer_to_torch and invert_rnnt_to_torch
# turn this package's state dicts back into the icefall / sherpa-onnx
# initializer names, as the inverse of models/onnx_import's name maps, and
# export_asr_dir writes a model directory that load_zipformer_rnnt (this
# package's and the JAX package's) reads. Its files hold initializers only:
# emitting the executable op graph (the reference's build_*_graph, for its
# numpy graph executor) is not ported yet.

from __future__ import annotations

import os

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import (
    DECODER_NAME_MAP,
    JOINER_NAME_MAP,
    zipformer_name_map,
)
from sherpa_vietnamese_asr_tpu_torch.models.onnx_synth import tensor_proto
from sherpa_vietnamese_asr_tpu_torch.utils import protowire as pw


def _numpy_state(module):
    return {k: v.detach().cpu().numpy()
            for k, v in module.state_dict().items()}


def _invert(name_map, state):
    """{source name: tensor}: each destination's value in the file's
    layout (the ConvNeXt pointwise convs go back to [O, I, 1, 1])."""
    out = {}
    for name, (key, transform) in name_map.items():
        t = np.asarray(state[key], np.float32)
        if transform is not None:  # onnx_import._pointwise
            t = t[:, :, None, None]
        out[name] = np.array(t)
    return out


def invert_zipformer_to_torch(enc_state, zcfg):
    """{icefall initializer name: torch-layout numpy tensor} for the
    encoder, from a ZipformerEncoder state dict (numpy values)."""
    return _invert(zipformer_name_map(zcfg), enc_state)


def invert_rnnt_to_torch(dec_state, joi_state):
    """Torch-layout tensors for the decoder/joiner files (sherpa naming)."""
    return (_invert(DECODER_NAME_MAP, dec_state),
            _invert(JOINER_NAME_MAP, joi_state))


def _initializers_only(tensors) -> bytes:
    """A ModelProto whose graph holds only `tensors` as initializers, in
    order (the bytes onnx_synth.GraphBuilder builds for them, joined once
    instead of appended tensor by tensor)."""
    graph = b"".join(pw.write_field(5, 2, tensor_proto(name, arr))
                     for name, arr in tensors.items())
    return pw.write_field(1, 0, 8) + pw.write_field(7, 2, graph)


def write_tokens(path: str, id2token) -> None:
    """sherpa-onnx tokens.txt: 'piece id' per line."""
    with open(path, "w", encoding="utf-8") as f:
        for i, piece in enumerate(id2token):
            f.write(f"{piece} {i}\n")


def export_asr_dir(model, out_dir: str) -> dict:
    """Write encoder/decoder/joiner .onnx (initializers only) and tokens.txt
    for an AsrModel.

    Filenames follow the sherpa-onnx convention load_zipformer_rnnt
    discovers. Returns {role: path}.
    """
    enc_t = invert_zipformer_to_torch(_numpy_state(model.encoder),
                                      model.zip_cfg)
    dec_t, joi_t = invert_rnnt_to_torch(_numpy_state(model.decoder),
                                        _numpy_state(model.joiner))
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "encoder": os.path.join(out_dir, "encoder-epoch-99-avg-1.onnx"),
        "decoder": os.path.join(out_dir, "decoder-epoch-99-avg-1.onnx"),
        "joiner": os.path.join(out_dir, "joiner-epoch-99-avg-1.onnx"),
        "tokens": os.path.join(out_dir, "tokens.txt"),
    }
    for role, tensors in (("encoder", enc_t), ("decoder", dec_t),
                          ("joiner", joi_t)):
        with open(paths[role], "wb") as f:
            f.write(_initializers_only(tensors))
    write_tokens(paths["tokens"], model.id2token)
    return paths
