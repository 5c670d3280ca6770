"""Models of a configuration with weights made from the seed on the device.

One torch.Generator on the model's device draws every weight in one call;
the values are loaded into the program's modules, and the same tensors, by
parameter name, go to the reference. Weights and kernels are N(0, 1 /
fan_in) (fan_in = the product of the torch shape past its first axis),
biases N(0, BIAS_STD^2); norm scales, bypass scales and downsample weights
keep their published initial values (0, 0.5, 0). Silero VAD keeps a fixed
DFT basis and zero biases, as its random initialisation does.

A stage model of the pipeline (portbench/harness/stages) is drawn from a
generator of its own, seeded seed + its seed_offset, so that the ASR
model's and Silero's draws are the same whether a cell has stages or not:
every weight of two axes or more N(0, 1 / fan_in), every bias N(0,
BIAS_STD^2), every other one-axis weight (a norm's scale) 1, and what the
stage's kind fills itself (band edges, norm statistics).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BIAS_STD = 0.05
DRAWN = ("weight", "embedding", "conv_weight", "dw_weight", "weight_ih_l0", "weight_hh_l0")
BIASES = ("bias", "dw_bias")


def _draw(module, generator, device, bias_std, skip=()):
    """Fill module's parameters from one draw; returns {name: tensor}."""
    params = [(n, p) for n, p in module.named_parameters() if n not in skip]
    total = sum(p.numel() for _, p in params)
    flat = torch.randn(total, generator=generator, device=device)
    out, i = {}, 0
    with torch.no_grad():
        for name, p in params:
            leaf = name.rsplit(".", 1)[-1]
            draw = flat[i: i + p.numel()].view(p.shape)
            i += p.numel()
            if leaf in DRAWN and p.dim() >= 2:
                p.copy_(draw / math.sqrt(math.prod(p.shape[1:])))
            elif leaf in BIASES or leaf.startswith("bias_"):
                p.copy_(draw * bias_std)
            out[name] = p.detach().clone()
    return out


def vocab(size):
    """<blk>, <sos/eos>, <unk>, then one word-opening syllable for every
    other id. Random weights emit one of a few ids at nearly every frame,
    which few depending on the seed; with distinct texts the host's
    per-word work (the overlap alignment's fuzzy matches above all) would
    swing with the seed by half, with one text it follows the frames."""
    return ["<blk>", "<sos/eos>", "<unk>"] + ["▁ta"] * (size - 3)


def zipformer_config(cfg):
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerConfig

    keys = {f.name for f in dataclasses.fields(ZipformerConfig)}
    return ZipformerConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in cfg.items() if k in keys})


def asr_model(cfg, seed, device):
    """(program AsrModel, reference weights) of configuration `cfg`."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import AsrModel
    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner, RnntConfig
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerEncoder

    zcfg = zipformer_config(cfg)
    rcfg = RnntConfig(vocab_size=cfg["vocab_size"], context_size=cfg["context_size"],
                      decoder_dim=cfg["decoder_dim"], joiner_dim=cfg["joiner_dim"],
                      encoder_out_dim=zcfg.output_dim)
    gen = torch.Generator(device=device).manual_seed(seed)
    enc, dec, joi = ZipformerEncoder(zcfg, device), Decoder(rcfg, device), Joiner(rcfg, device)
    weights = {}
    for prefix, module in (("", enc), ("decoder.", dec), ("joiner.", joi)):
        for name, w in _draw(module, gen, device, BIAS_STD).items():
            weights[prefix + name] = w
    model = AsrModel(name=cfg["name"], zip_cfg=zcfg, rnnt_cfg=rcfg, encoder=enc, decoder=dec,
                     joiner=joi, id2token=vocab(cfg["vocab_size"]),
                     beam_size=cfg["beam_size"])
    return model.to(device), weights


def silero(cfg, seed, device):
    """(program SileroVad, reference weights)."""
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import SileroVad, SileroVadConfig

    v = cfg["vad"]
    vcfg = SileroVadConfig(window=v["window"], context=v["context"],
                           stft_filter_len=v["stft_filter_len"], stft_hop=v["stft_hop"],
                           n_freq=v["n_freq"], encoder_channels=tuple(v["encoder_channels"]),
                           lstm_dim=v["lstm_dim"])
    vad = SileroVad(vcfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    weights = _draw(vad, gen, device, 0.0, skip=("stft_cos", "stft_sin"))
    k = np.arange(vcfg.stft_filter_len)[None, :]
    f = np.arange(vcfg.n_freq)[:, None]
    ang = -2.0 * np.pi * f * k / vcfg.stft_filter_len
    with torch.no_grad():
        for name, fn in (("stft_cos", np.cos), ("stft_sin", np.sin)):
            basis = torch.from_numpy(fn(ang).astype(np.float32)).to(device)
            getattr(vad, name).copy_(basis)
            weights[name] = basis
    return vad.to(device), weights


def stage(entry, seed, device):
    """(state for the program's loader, {name: numpy}, and the program's
    config) of one stage model of a configuration's "stages"."""
    from portbench.harness import stages

    kind = stages.plugin(entry["kind"])
    gen = torch.Generator(device=device).manual_seed(seed + entry["seed_offset"])
    with torch.device(device):
        module = kind.program_module(entry["widths"])
    params = [(n.rsplit(".", 1)[-1], p) for n, p in module.named_parameters()
              if n.rsplit(".", 1)[-1] not in kind.KEEP]
    drawn = [(leaf, p) for leaf, p in params if p.dim() >= 2 or leaf.startswith("bias")]
    flat = torch.randn(sum(p.numel() for _, p in drawn), generator=gen, device=device)
    i = 0
    with torch.no_grad():
        for leaf, p in drawn:
            draw = flat[i: i + p.numel()].view(p.shape)
            i += p.numel()
            p.copy_(draw / math.sqrt(math.prod(p.shape[1:])) if p.dim() >= 2 else draw * BIAS_STD)
        for _, p in params:
            if p.dim() < 2 and not any(p is q for _, q in drawn):
                p.fill_(1.0)
    kind.fill(module, gen, device)
    state = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    return state, module.cfg
