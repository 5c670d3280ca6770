# Model bundles: configs + modules + tokens for one ASR model.
#
# Port of sherpa_vietnamese_asr_tpu/models/registry.py. A bundle holds the
# encoder, decoder and joiner as PyTorch modules plus the host-side vocab;
# random_asr_model builds one at the true architecture sizes with weights
# drawn from an explicit torch.Generator (models/convert.py loads the JAX
# package's trees instead).

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner, RnntConfig
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    ZIPFORMER_30M,
    ZIPFORMER_68M,
    ZipformerConfig,
    ZipformerEncoder,
    use_full_fp32,
)

MODEL_30M = "zipformer-30m-rnnt-6000h"
MODEL_68M = "sherpa-onnx-zipformer-vi-2025-04-20"


@dataclasses.dataclass
class AsrModel:
    name: str
    zip_cfg: ZipformerConfig
    rnnt_cfg: RnntConfig
    encoder: ZipformerEncoder
    decoder: Decoder
    joiner: Joiner
    id2token: list  # token id -> BPE piece string
    hotword_tables: Any = None  # ops.beam_search.HotwordTables | None
    beam_size: int = 8

    @property
    def device(self) -> torch.device:
        return self.decoder.embedding.device

    def to(self, device) -> "AsrModel":
        for m in (self.encoder, self.decoder, self.joiner):
            m.to(device).eval()
        if self.hotword_tables is not None:
            self.hotword_tables = self.hotword_tables.to(device)
        if self.device.type == "cuda":
            use_full_fp32()
        return self


def model_device(device) -> torch.device:
    """The device a model is built on. Models go to the card unless the
    caller names the CPU; a CUDA device on a host without one raises, so a
    model never lands on the CPU by default."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"model device {device}: no CUDA device is available; pass "
            f"device=\"cpu\" to build the model on the CPU")
    return device


def synthetic_vocab(vocab_size: int, seed: int = 0) -> list:
    """Synthetic BPE-like vocab for tests/bench: ids 0/1/2 are
    <blk>/<sos/eos>/<unk>; ~60% of pieces start a word (U+2581 prefix)."""
    rng = np.random.default_rng(seed)
    letters = "aeiouybcdghklmnpqrstvx"
    vocab = ["<blk>", "<sos/eos>", "<unk>"]
    for i in range(3, vocab_size):
        n = int(rng.integers(1, 4))
        piece = "".join(rng.choice(list(letters)) for _ in range(n))
        if rng.random() < 0.6:
            piece = "▁" + piece
        vocab.append(piece)
    return vocab


TINY_ZIPFORMER = ZipformerConfig(
    num_encoder_layers=(1, 1, 1), downsampling_factor=(1, 2, 4),
    encoder_dim=(64, 96, 96), ffn_dim=(96, 128, 128), num_heads=(2, 2, 2),
    cnn_module_kernel=(15, 15, 7), query_head_dim=16, pos_head_dim=4,
    value_head_dim=8, pos_dim=16,
)


def build_modules(name, zip_cfg, rnnt_cfg, id2token, beam_size) -> AsrModel:
    """Modules on the CPU with uninitialised weights."""
    return AsrModel(name=name, zip_cfg=zip_cfg, rnnt_cfg=rnnt_cfg,
                    encoder=ZipformerEncoder(zip_cfg),
                    decoder=Decoder(rnnt_cfg), joiner=Joiner(rnnt_cfg),
                    id2token=id2token, beam_size=beam_size)


def _init_random_(module: nn.Module, generator: torch.Generator):
    """The JAX package's init scheme: every weight N(0, 1/fan_in) with
    fan_in = prod(shape[1:]) in torch layout; biases zero; BiasNorm,
    bypass and downsample parameters keep their constructed values."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "embedding", "conv_weight", "dw_weight"):
                p.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(math.prod(p.shape[1:])))
            elif leaf in ("bias", "dw_bias"):
                p.zero_()


def random_asr_model(name: str = MODEL_30M, vocab_size: int = 2000,
                     seed: int = 0, beam_size: int = 8,
                     compute_dtype: str = "float32",
                     zip_cfg: ZipformerConfig | None = None,
                     device="cuda",
                     generator: torch.Generator | None = None) -> AsrModel:
    """Random-weight model at the true architecture sizes (same shapes as the
    JAX package's random_asr_model; values come from `generator`, or from a
    CPU generator seeded with `seed`). compute_dtype is "float32" or
    "bfloat16"; master weights stay float32 either way, so one seed gives
    the same weights in both tiers. The model goes to `device`, the card
    by default (raises without one). Pass zip_cfg=TINY_ZIPFORMER and
    device="cpu" for fast CPU tests."""
    device = model_device(device)
    if zip_cfg is not None:
        zcfg = zip_cfg
    else:
        zcfg = ZIPFORMER_68M if name == MODEL_68M else ZIPFORMER_30M
    zcfg = dataclasses.replace(zcfg, compute_dtype=compute_dtype)
    dec_dim = 512 if zip_cfg is None else 128
    rcfg = RnntConfig(vocab_size=vocab_size, encoder_out_dim=zcfg.output_dim,
                      decoder_dim=dec_dim, joiner_dim=dec_dim)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = build_modules(name, zcfg, rcfg, synthetic_vocab(vocab_size, seed),
                          beam_size)
    for m in (model.encoder, model.decoder, model.joiner):
        _init_random_(m, generator)
    return model.to(device)
