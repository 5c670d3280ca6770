# Parameter trees of the JAX package -> this package's modules.
#
# The JAX package keeps parameters as nested dicts of arrays with [d_in,
# d_out] linears, HWIO conv kernels and [K, D] depthwise kernels. This module
# takes such trees as nested dicts of numpy arrays (np.asarray of every leaf)
# and loads them into ZipformerEncoder / Decoder / Joiner (and the Silero
# VAD tree into models/silero_vad.SileroVad, the PyanNet and ResNet34
# diarization trees into models/pyannet.PyanNet and
# models/resnet_speaker.ResNetSpeaker, the ViBERT tree, float32 or int8, into
# models/vibert.ViBert, the DNSMOS tree into models/dnsmos.Dnsmos, and the
# CAM++ and Conv-TasNet trees into models/campplus.Campp and
# models/convtasnet.ConvTasNet, the summarizer's Llama tree into
# models/llama.Llama) with
# every layout change done here, so the same weights run through both
# packages. A streaming Zipformer state of the JAX package converts too
# (streaming_state_from_numpy), so both packages can go on from one
# mid-stream state.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.registry import (
    AsrModel,
    build_modules,
    model_device,
)
from sherpa_vietnamese_asr_tpu_torch.models.campplus import Campp, CamppConfig
from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import ConvTasNet, ConvTasNetConfig
from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import Dnsmos, DnsmosConfig
from sherpa_vietnamese_asr_tpu_torch.models.llama import Llama, LlamaConfig
from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
    ResNetSpeaker,
    ResNetSpeakerConfig,
)
from sherpa_vietnamese_asr_tpu_torch.models.rnnt import RnntConfig
from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import SileroVad, SileroVadConfig
from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBert, ViBertConfig
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig
from sherpa_vietnamese_asr_tpu_torch.models.zipformer_streaming import LAYER_CACHES


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


def silero_state_dict(params) -> dict:
    """JAX Silero VAD tree -> SileroVad state dict (numpy values): conv
    kernels [3, C_in, C_out] -> [C_out, C_in, 3], the LSTM's [in, 4D]
    weights transposed and its one bias in bias_ih_l0 (bias_hh_l0 zero), the
    head [D, 1] -> [1, D]."""
    out = {"stft_cos": np.asarray(params["stft_cos"]),
           "stft_sin": np.asarray(params["stft_sin"])}
    for i, layer in enumerate(params["encoder"]):
        out[f"encoder.{i}.weight"] = np.asarray(layer["weight"]).transpose(2, 1, 0)
        out[f"encoder.{i}.bias"] = np.asarray(layer["bias"])
    lstm = params["lstm"]
    out["lstm.weight_ih_l0"] = np.asarray(lstm["wi"]).T
    out["lstm.weight_hh_l0"] = np.asarray(lstm["wh"]).T
    out["lstm.bias_ih_l0"] = np.asarray(lstm["b"])
    out["lstm.bias_hh_l0"] = np.zeros_like(np.asarray(lstm["b"]))
    out["head.weight"] = np.asarray(params["out"]["weight"]).T
    out["head.bias"] = np.asarray(params["out"]["bias"])
    return out


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


def streaming_state_from_numpy(state, zip_cfg: ZipformerConfig, device="cuda") -> dict:
    """A JAX init_streaming_state / streaming_step state (numpy leaves) ->
    the state of models/zipformer_streaming.streaming_step on `device`, the
    card by default (raises without one). The ConvNeXt tail goes from the
    JAX package's NHWC [B, 6, F', C3] to [B, C3, 6, F']; every other
    tensor keeps its layout."""
    device = model_device(device)
    stacks = state["stacks"]
    if [len(s) for s in stacks] != list(zip_cfg.num_encoder_layers):
        raise ValueError(f"state has {[len(s) for s in stacks]} layers a stack, "
                         f"the config {list(zip_cfg.num_encoder_layers)}")

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    keys = LAYER_CACHES + ("conv1_tail", "conv2_tail")
    return {"fbank_tail": tensor(state["fbank_tail"]),
            "convnext_tail": tensor(np.asarray(state["convnext_tail"]).transpose(0, 3, 1, 2)),
            "stacks": [[{k: tensor(layer[k]) for k in keys} for layer in stack]
                       for stack in stacks]}


def silero_from_numpy(state, cfg: SileroVadConfig, device="cuda") -> SileroVad:
    """A SileroVad on `device`, the card by default (raises without one),
    from a SileroVad state dict of numpy arrays (silero_state_dict, or
    models/onnx_import.load_silero_vad)."""
    device = model_device(device)
    vad = SileroVad(cfg)
    _load(vad, state)
    return vad.to(device)


def pyannet_state_dict(params) -> dict:
    """JAX PyanNet tree -> PyanNet state dict (numpy values): conv kernels
    [K, C_in, C_out] -> [C_out, C_in, K], linears and LSTM weights
    transposed, each LSTM direction's one bias in bias_ih (bias_hh zero)."""
    out = {"sincnet.conv1d.0.low_hz_": np.asarray(params["sinc_low_hz"]),
           "sincnet.conv1d.0.band_hz_": np.asarray(params["sinc_band_hz"]),
           "sincnet.wav_norm1d.weight": np.asarray(params["wav_norm"]["scale"]),
           "sincnet.wav_norm1d.bias": np.asarray(params["wav_norm"]["bias"])}
    for i, norm in enumerate(params["norms"]):
        out[f"sincnet.norm1d.{i}.weight"] = np.asarray(norm["scale"])
        out[f"sincnet.norm1d.{i}.bias"] = np.asarray(norm["bias"])
    for i, conv in enumerate(params["convs"]):
        out[f"sincnet.conv1d.{i + 1}.weight"] = np.asarray(conv["weight"]).transpose(2, 1, 0)
        out[f"sincnet.conv1d.{i + 1}.bias"] = np.asarray(conv["bias"])
    for k, layer in enumerate(params["lstm"]):
        for suffix, direction in (("", "fwd"), ("_reverse", "bwd")):
            p = layer[direction]
            out[f"lstm.weight_ih_l{k}{suffix}"] = np.asarray(p["wi"]).T
            out[f"lstm.weight_hh_l{k}{suffix}"] = np.asarray(p["wh"]).T
            out[f"lstm.bias_ih_l{k}{suffix}"] = np.asarray(p["b"])
            out[f"lstm.bias_hh_l{k}{suffix}"] = np.zeros_like(np.asarray(p["b"]))
    _linear(out, "linear.0", params["linear1"])
    _linear(out, "linear.1", params["linear2"])
    _linear(out, "classifier", params["classifier"])
    return out


def _batch_norm(out, prefix, p):
    """A BatchNorm's statistics, and its affine where the tree has one."""
    for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
        if src in p:
            out[f"{prefix}.{dst}"] = np.asarray(p[src])
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_tfio(a):
    """JAX ResNet conv kernel [kT, kF, I, O] -> torch [O, I, kF, kT]."""
    return np.asarray(a).transpose(3, 2, 1, 0)


def resnet_state_dict(params) -> dict:
    """JAX ResNet34 tree -> ResNetSpeaker state dict (numpy values): conv
    kernels [kT, kF, I, O] -> [O, I, kF, kT], BatchNorm (scale, bias, mean,
    var) -> (weight, bias, running_mean, running_var), the projection as
    resnet.seg_1."""
    out = {"resnet.conv1.weight": _conv_tfio(params["conv1"])}
    _batch_norm(out, "resnet.bn1", params["bn1"])
    for stage, blocks in enumerate(params["stages"]):
        for j, blk in enumerate(blocks):
            pre = f"resnet.layer{stage + 1}.{j}"
            out[f"{pre}.conv1.weight"] = _conv_tfio(blk["conv1"])
            _batch_norm(out, f"{pre}.bn1", blk["bn1"])
            out[f"{pre}.conv2.weight"] = _conv_tfio(blk["conv2"])
            _batch_norm(out, f"{pre}.bn2", blk["bn2"])
            if "down_conv" in blk:
                out[f"{pre}.shortcut.0.weight"] = _conv_tfio(blk["down_conv"])
                _batch_norm(out, f"{pre}.shortcut.1", blk["down_bn"])
    out["resnet.seg_1.weight"] = np.asarray(params["proj"]["weight"])
    out["resnet.seg_1.bias"] = np.asarray(params["proj"]["bias"])
    return out


def pyannet_from_numpy(state, cfg: PyanNetConfig, device="cuda") -> PyanNet:
    """A PyanNet on `device`, the card by default (raises without one), from
    a PyanNet state dict of numpy arrays (pyannet_state_dict, or
    models/onnx_import.load_pyannet)."""
    device = model_device(device)
    model = PyanNet(cfg)
    _load(model, state)
    return model.to(device)


def resnet_from_numpy(state, cfg: ResNetSpeakerConfig, device="cuda") -> ResNetSpeaker:
    """A ResNetSpeaker on `device`, the card by default (raises without
    one), from a ResNetSpeaker state dict of numpy arrays (resnet_state_dict,
    or models/onnx_import.load_resnet_speaker)."""
    device = model_device(device)
    model = ResNetSpeaker(cfg)
    _load(model, state)
    return model.to(device)


def _vibert_linear(out, prefix, p):
    """A float32 linear, or the int8 tier's (weight_q [in, out] int8 and
    weight_scale [out])."""
    if "weight_q" in p:
        out[f"{prefix}.weight_q"] = np.asarray(p["weight_q"]).T
        out[f"{prefix}.weight_scale"] = np.asarray(p["weight_scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    else:
        _linear(out, prefix, p)


def _layer_norm(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def vibert_state_dict(params) -> dict:
    """JAX ViBERT tree (float32 or quantize_vibert_int8's) -> ViBert state
    dict (numpy values, the Hugging Face names): linears transposed to
    [out, in], layer norms' scale as weight."""
    out = {"bert.embeddings.word_embeddings.weight": np.asarray(params["word_emb"]),
           "bert.embeddings.position_embeddings.weight": np.asarray(params["pos_emb"]),
           "bert.embeddings.token_type_embeddings.weight": np.asarray(params["type_emb"])}
    _layer_norm(out, "bert.embeddings.LayerNorm", params["emb_ln"])
    for i, lp in enumerate(params["layers"]):
        pre = f"bert.encoder.layer.{i}"
        for src, dst in (("q", "attention.self.query"), ("k", "attention.self.key"),
                         ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                         ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            _vibert_linear(out, f"{pre}.{dst}", lp[src])
        _layer_norm(out, f"{pre}.attention.output.LayerNorm", lp["attn_ln"])
        _layer_norm(out, f"{pre}.output.LayerNorm", lp["ffn_ln"])
    _vibert_linear(out, "classifier", params["labels_head"])
    _vibert_linear(out, "detector", params["d_tags_head"])
    return out


def vibert_from_numpy(state, cfg: ViBertConfig, device="cuda") -> ViBert:
    """A ViBert on `device`, the card by default (raises without one), from
    a ViBert state dict of numpy arrays (vibert_state_dict, or
    models/onnx_import.load_vibert); the int8 tier when the state holds
    weight_q tensors."""
    device = model_device(device)
    model = ViBert(cfg, int8=any(k.endswith(".weight_q") for k in state))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    return model.to(device)


def dnsmos_state_dict(params) -> dict:
    """JAX DNSMOS tree -> Dnsmos state dict (numpy values): conv kernels
    HWIO -> OIHW, dense weights transposed, the mel matrix as it is."""
    out = {"mel": np.asarray(params["mel"])}
    for i, conv in enumerate(params["convs"]):
        _conv2d(out, f"convs.{i}", conv)
    _linear(out, "dense1", params["dense1"])
    _linear(out, "head", params["head"])
    return out


def dnsmos_from_numpy(state, cfg: DnsmosConfig, device="cuda") -> Dnsmos:
    """A Dnsmos on `device`, the card by default (raises without one), from
    a Dnsmos state dict of numpy arrays (dnsmos_state_dict, or
    models/onnx_import.load_dnsmos)."""
    device = model_device(device)
    model = Dnsmos(cfg)
    _load(model, state)
    return model.to(device)


def _conv1d_kio(a):
    """JAX conv1d kernel [K, I, O] -> torch [O, I, K]."""
    return np.asarray(a).transpose(2, 1, 0)


def campp_state_dict(params) -> dict:
    """JAX CAM++ tree -> Campp state dict (numpy values, the 3D-Speaker
    names): FCM kernels [kT, kF, I, O] -> [O, I, kF, kT], conv1d kernels
    [K, I, O] -> [O, I, K], the CAM linears and the embedding linear [I, O]
    -> 1x1 Conv1d [O, I, 1], BatchNorm (scale, bias, mean, var) ->
    (weight, bias, running_mean, running_var)."""
    fcm = params["fcm"]
    out = {"head.conv1.weight": _conv_tfio(fcm["conv1"]["weight"])}
    _batch_norm(out, "head.bn1", fcm["bn1"])
    for name in ("layer1", "layer2"):
        for j, blk in enumerate(fcm[name]):
            pre = f"head.{name}.{j}"
            out[f"{pre}.conv1.weight"] = _conv_tfio(blk["conv1"]["weight"])
            _batch_norm(out, f"{pre}.bn1", blk["bn1"])
            out[f"{pre}.conv2.weight"] = _conv_tfio(blk["conv2"]["weight"])
            _batch_norm(out, f"{pre}.bn2", blk["bn2"])
            if "shortcut_conv" in blk:
                out[f"{pre}.shortcut.0.weight"] = _conv_tfio(blk["shortcut_conv"]["weight"])
                _batch_norm(out, f"{pre}.shortcut.1", blk["shortcut_bn"])
    out["head.conv2.weight"] = _conv_tfio(fcm["conv2"]["weight"])
    _batch_norm(out, "head.bn2", fcm["bn2"])

    def lin_1x1(p):
        return np.asarray(p["weight"]).T[:, :, None]

    out["xvector.tdnn.linear.weight"] = _conv1d_kio(params["tdnn"]["weight"])
    _batch_norm(out, "xvector.tdnn.nonlinear.batchnorm", params["tdnn_bn"])
    for bi, block in enumerate(params["blocks"]):
        for j, layer in enumerate(block):
            pre = f"xvector.block{bi + 1}.tdnnd{j + 1}"
            _batch_norm(out, f"{pre}.nonlinear1.batchnorm", layer["bn1"])
            out[f"{pre}.linear1.weight"] = _conv1d_kio(layer["lin1"]["weight"])
            _batch_norm(out, f"{pre}.nonlinear2.batchnorm", layer["bn2"])
            out[f"{pre}.cam_layer.linear_local.weight"] = _conv1d_kio(
                layer["local"]["weight"])
            for k in ("cam1", "cam2"):
                name = f"{pre}.cam_layer.linear{k[-1]}"
                out[f"{name}.weight"] = lin_1x1(layer[k])
                out[f"{name}.bias"] = np.asarray(layer[k]["bias"])
        tr = params["transitions"][bi]
        _batch_norm(out, f"xvector.transit{bi + 1}.nonlinear.batchnorm", tr["bn"])
        out[f"xvector.transit{bi + 1}.linear.weight"] = _conv1d_kio(tr["conv"]["weight"])
    _batch_norm(out, "xvector.out_nonlinear.batchnorm", params["final_bn"])
    out["xvector.dense.linear.weight"] = lin_1x1(params["dense"]["lin"])
    _batch_norm(out, "xvector.dense.nonlinear.batchnorm", params["dense"]["bn"])
    return out


def campp_from_numpy(state, cfg: CamppConfig, device="cuda") -> Campp:
    """A Campp on `device`, the card by default (raises without one), from a
    Campp state dict of numpy arrays (campp_state_dict, or
    models/onnx_import.load_campp)."""
    device = model_device(device)
    model = Campp(cfg)
    _load(model, state)
    return model.to(device)


def convtasnet_state_dict(params) -> dict:
    """JAX Conv-TasNet tree -> ConvTasNet state dict (numpy values, asteroid's
    names): conv kernels [K, I, O] -> [O, I, K], gLN scale/bias -> gamma/beta
    [1, C, 1], PReLU alphas as they are, the decoder [N, L] -> [N, 1, L].
    asteroid's free filterbanks have no bias: a non-zero encoder bias in the
    tree raises."""
    if np.any(np.asarray(params["encoder"]["bias"]) != 0):
        raise ValueError("Conv-TasNet encoder bias: asteroid's filterbank has none")

    def conv(out, prefix, p):
        out[f"{prefix}.weight"] = _conv1d_kio(p["weight"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])

    def gln(out, prefix, p):
        out[f"{prefix}.gamma"] = np.asarray(p["scale"]).reshape(1, -1, 1)
        out[f"{prefix}.beta"] = np.asarray(p["bias"]).reshape(1, -1, 1)

    out = {"encoder.filterbank._filters": _conv1d_kio(params["encoder"]["weight"]),
           "decoder.filterbank._filters": np.asarray(params["decoder"])[:, None, :],
           "masker.mask_net.0.weight": np.asarray(params["mask_prelu"]).reshape(1)}
    gln(out, "masker.bottleneck.0", params["ln_in"])
    conv(out, "masker.bottleneck.1", params["bottleneck_in"])
    conv(out, "masker.mask_net.1", params["mask_out"])
    for i, blk in enumerate(params["blocks"]):
        pre = f"masker.TCN.{i}"
        conv(out, f"{pre}.shared_block.0", blk["in_conv"])
        out[f"{pre}.shared_block.1.weight"] = np.asarray(blk["prelu1"]).reshape(1)
        gln(out, f"{pre}.shared_block.2", blk["ln1"])
        conv(out, f"{pre}.shared_block.3", blk["dw_conv"])
        out[f"{pre}.shared_block.4.weight"] = np.asarray(blk["prelu2"]).reshape(1)
        gln(out, f"{pre}.shared_block.5", blk["ln2"])
        conv(out, f"{pre}.res_conv", blk["res_conv"])
        conv(out, f"{pre}.skip_conv", blk["skip_conv"])
    return out


def convtasnet_from_numpy(state, cfg: ConvTasNetConfig, device="cuda") -> ConvTasNet:
    """A ConvTasNet on `device`, the card by default (raises without one),
    from a ConvTasNet state dict of numpy arrays (convtasnet_state_dict, or
    models/onnx_import.load_convtasnet)."""
    device = model_device(device)
    model = ConvTasNet(cfg)
    _load(model, state)
    return model.to(device)


def llama_from_numpy(params, cfg: LlamaConfig, device="cuda") -> Llama:
    """A Llama on `device`, the card by default (raises without one), from
    the JAX package's tree of numpy arrays (init_llama_params mapped through
    np.asarray, or models/llama.gguf_params): its names and [d_in, d_out]
    layouts are the module's own; "output": None keeps the projection tied
    to tok_emb."""
    model = Llama(cfg, device=model_device(device))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = params
            for key in name.split("."):
                leaf = leaf[int(key)] if key.isdigit() else leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf, np.float32)))
        if params.get("output") is not None:
            model.output = torch.nn.Parameter(
                torch.from_numpy(np.array(params["output"], np.float32)).to(model.device),
                requires_grad=False)
    return model.to(model.device)
