# Parameter trees of the JAX package -> this package's modules.
#
# The JAX package keeps parameters as nested dicts of arrays with [d_in,
# d_out] linears, HWIO conv kernels and [K, D] depthwise kernels. This module
# takes such trees as nested dicts of numpy arrays (np.asarray of every leaf)
# and loads them into ZipformerEncoder / Decoder / Joiner with every layout
# change done here, so the same weights run through both packages.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.registry import (
    AsrModel,
    build_modules,
    model_device,
)
from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["weight"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv2d(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["weight"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _bias_norm(out, prefix, p):
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.log_scale"] = np.asarray(p["log_scale"])


def _conv_module(out, prefix, p):
    _linear(out, f"{prefix}.in_proj", p["in_proj"])
    out[f"{prefix}.dw_weight"] = np.asarray(p["dw_weight"]).T[:, None, :]  # [K, D] -> [D, 1, K]
    out[f"{prefix}.dw_bias"] = np.asarray(p["dw_bias"])
    _linear(out, f"{prefix}.out_proj", p["out_proj"])


def encoder_state_dict(enc) -> dict:
    """JAX zipformer tree -> ZipformerEncoder state dict (numpy values)."""
    out = {}
    e = enc["encoder_embed"]
    for name in ("conv1", "conv2", "conv3", "convnext_dw"):
        _conv2d(out, f"encoder_embed.{name}", e[name])
    for name in ("convnext_pw1", "convnext_pw2", "out"):
        _linear(out, f"encoder_embed.{name}", e[name])
    _bias_norm(out, "encoder_embed.out_norm", e["out_norm"])
    for i, stack in enumerate(enc["stacks"]):
        sp = f"stacks.{i}"
        out[f"{sp}.downsample.weights"] = np.asarray(stack["downsample"]["weights"])
        out[f"{sp}.out_bypass_scale"] = np.asarray(stack["out_bypass_scale"])
        for j, lp in enumerate(stack["layers"]):
            p = f"{sp}.layers.{j}"
            _linear(out, f"{p}.attn_in_proj", lp["attn_in_proj"])
            _linear(out, f"{p}.attn_pos_proj", lp["attn_pos_proj"])
            for name in ("self_attn1", "self_attn2", "nonlin_attn"):
                _linear(out, f"{p}.{name}.in_proj", lp[name]["in_proj"])
                _linear(out, f"{p}.{name}.out_proj", lp[name]["out_proj"])
            for name in ("ff1", "ff2", "ff3"):
                _linear(out, f"{p}.{name}.in_proj", lp[name]["in"])
                _linear(out, f"{p}.{name}.out_proj", lp[name]["out"])
            _conv_module(out, f"{p}.conv1", lp["conv1"])
            _conv_module(out, f"{p}.conv2", lp["conv2"])
            _bias_norm(out, f"{p}.norm", lp["norm"])
            out[f"{p}.bypass_scale"] = np.asarray(lp["bypass_scale"])
            out[f"{p}.bypass_mid_scale"] = np.asarray(lp["bypass_mid_scale"])
    out["downsample_output.weights"] = np.asarray(
        enc["downsample_output"]["weights"])
    return out


def decoder_state_dict(dec) -> dict:
    # The grouped conv is [D, D/G, K] in both packages.
    return {"embedding": np.asarray(dec["embedding"]),
            "conv_weight": np.asarray(dec["conv_weight"])}


def joiner_state_dict(joi) -> dict:
    out = {}
    for name in ("encoder_proj", "decoder_proj", "output"):
        _linear(out, name, joi[name])
    return out


def _load(module, state):
    module.load_state_dict(
        {k: torch.tensor(np.asarray(v), dtype=torch.float32)
         for k, v in state.items()}, strict=True)


def asr_model_from_numpy(enc, dec, joi, zip_cfg: ZipformerConfig,
                         rnnt_cfg: RnntConfig, id2token, device="cuda",
                         name: str = "converted",
                         beam_size: int = 8) -> AsrModel:
    """Build an AsrModel from the JAX package's parameter trees (numpy
    leaves) on `device`, the card by default (raises without one)."""
    device = model_device(device)
    model = build_modules(name, zip_cfg, rnnt_cfg, id2token, beam_size)
    _load(model.encoder, encoder_state_dict(enc))
    _load(model.decoder, decoder_state_dict(dec))
    _load(model.joiner, joiner_state_dict(joi))
    return model.to(device)
