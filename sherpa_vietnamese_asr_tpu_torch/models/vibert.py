# ViBERT-capu Seq2Labels model (GECToR-style punctuation and case restorer)
# in PyTorch.
#
# Port of sherpa_vietnamese_asr_tpu/models/vibert.py: a post-LN BERT encoder
# over subword ids (layer norm eps 1e-12 with the biased variance, exact
# GELU, an additive -1e9 mask added to the float32 scores before the
# softmax, positions 0..t-1, token types all zero in use), a gather at each
# word's first-subtoken offset, and two linear heads: the 15 edit labels and
# the 4 detect tags. The module keeps the upstream Hugging Face layout, so
# its state-dict keys are the names of vibert-capu.onnx
# (bert.encoder.layer.0.attention.self.query.weight, classifier.bias, ...)
# and linears are [out, in].
#
# The int8 weight-only tier (quantize_vibert_int8) keeps each linear's
# weight as int8 with one float32 scale per output channel, on the card as
# on the host, and computes (x @ q) * s + b in the config's compute dtype,
# as the JAX package's _linear does; that dtype is float32 unless the config
# says otherwise. The JAX package runs this model through XLA (no Pallas
# kernel), so attention here is its two products and a float32 softmax, and
# on the card every float32 product runs without TF32
# (models.zipformer.use_full_fp32); the forward refuses to run with it on.

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    _check_full_fp32,
    use_full_fp32,
)


@dataclasses.dataclass(frozen=True)
class ViBertConfig:
    vocab_size: int = 62000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    n_labels: int = 15
    n_d_tags: int = 4
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "float32"


TINY_VIBERT = ViBertConfig(vocab_size=200, hidden=32, layers=2, heads=2,
                           intermediate=64, max_position=128, n_labels=15,
                           n_d_tags=4)


class Int8Linear(nn.Module):
    """Weight-only int8 linear: weight_q [out, in] int8 and weight_scale
    [out], one scale per output channel; y = (x @ q) * s + b."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(d_out, d_in, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))


def _linear(lin, x, dt):
    if isinstance(lin, Int8Linear):
        # |q| <= 127 is exact in the compute dtype and the per-channel scale
        # commutes out of the contraction: (x @ q) * s == x @ (q * s).
        y = x.to(dt) @ lin.weight_q.to(dt).t()
        return y * lin.weight_scale.to(dt) + lin.bias.to(dt)
    return x.to(dt) @ lin.weight.to(dt).t() + lin.bias.to(dt)


class _Embeddings(nn.Module):
    def __init__(self, cfg: ViBertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.LayerNorm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)


def _layer(cfg: ViBertConfig, linear) -> nn.Module:
    h, inter = cfg.hidden, cfg.intermediate

    def mod(**children):
        m = nn.Module()
        for name, child in children.items():
            m.add_module(name, child)
        return m

    def norm():
        return nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    return mod(
        attention=mod(self=mod(query=linear(h, h), key=linear(h, h), value=linear(h, h)),
                      output=mod(dense=linear(h, h), LayerNorm=norm())),
        intermediate=mod(dense=linear(h, inter)),
        output=mod(dense=linear(inter, h), LayerNorm=norm()))


class ViBert(nn.Module):
    """Seq2Labels ViBERT; int8=True builds the int8 weight-only tier's
    structure (quantize_vibert_int8 fills it)."""

    def __init__(self, cfg: ViBertConfig = ViBertConfig(), int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.int8 = int8
        linear = Int8Linear if int8 else nn.Linear
        self.bert = nn.Module()
        self.bert.embeddings = _Embeddings(cfg)
        self.bert.encoder = nn.Module()
        self.bert.encoder.layer = nn.ModuleList(_layer(cfg, linear)
                                                for _ in range(cfg.layers))
        self.classifier = linear(cfg.hidden, cfg.n_labels)
        self.detector = linear(cfg.hidden, cfg.n_d_tags)

    @property
    def device(self) -> torch.device:
        return self.classifier.bias.device

    def to(self, *args, **kwargs) -> "ViBert":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    def bert_encoder(self, input_ids, attention_mask, token_type_ids):
        """[B, T] ids -> [B, T, H] float32 hidden states (post-LN BERT)."""
        cfg = self.cfg
        if input_ids.device.type == "cuda":
            _check_full_fp32()
        dt = getattr(torch, cfg.compute_dtype)
        emb = self.bert.embeddings
        b, t = input_ids.shape
        x = (emb.word_embeddings.weight[input_ids.long()]
             + emb.position_embeddings.weight[None, :t]
             + emb.token_type_embeddings.weight[token_type_ids.long()])
        x = emb.LayerNorm(x)
        neg = torch.where(attention_mask[:, None, None, :] == 0, -1e9, 0.0)
        hd = cfg.hidden // cfg.heads
        for layer in self.bert.encoder.layer:
            att = layer.attention.self
            q = _linear(att.query, x, dt).reshape(b, t, cfg.heads, hd)
            k = _linear(att.key, x, dt).reshape(b, t, cfg.heads, hd)
            v = _linear(att.value, x, dt).reshape(b, t, cfg.heads, hd)
            scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
            attn = torch.softmax(scores.float() + neg, dim=-1)
            ctx = torch.einsum("bhts,bshd->bthd", attn.to(dt), v).reshape(b, t, cfg.hidden)
            out = layer.attention.output
            x = out.LayerNorm(x + _linear(out.dense, ctx, dt).float())
            f = F.gelu(_linear(layer.intermediate.dense, x, dt), approximate="none")
            x = layer.output.LayerNorm(x + _linear(layer.output.dense, f, dt).float())
        return x

    def vibert_forward(self, input_ids, attention_mask, token_type_ids, input_offsets):
        """input_offsets: [B, W] first-subtoken index of each word (0-padded).
        Returns (logits_labels [B, W, n_labels], logits_d_tags [B, W,
        n_d_tags]), float32."""
        hidden = self.bert_encoder(input_ids, attention_mask, token_type_ids)
        offs = input_offsets.long()[:, :, None].expand(-1, -1, hidden.shape[-1])
        gathered = hidden.gather(1, offs)
        dt = getattr(torch, self.cfg.compute_dtype)
        return (_linear(self.classifier, gathered, dt).float(),
                _linear(self.detector, gathered, dt).float())

    forward = vibert_forward


def random_vibert(cfg: ViBertConfig = ViBertConfig(), seed: int = 0, device="cuda",
                  generator: torch.Generator | None = None) -> ViBert:
    """Random weights with the JAX package's init scheme
    (init_vibert_params): embeddings N(0, 0.02^2), layer norms one and
    zero, linear weights N(0, 1/d_in), biases zero. Values come from
    `generator`, or from a CPU generator seeded with `seed`; the model goes
    to `device`, the card by default (raises without one)."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = ViBert(cfg)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Embedding):
                module.weight.normal_(generator=generator).mul_(0.02)
            elif isinstance(module, nn.Linear):
                module.weight.normal_(generator=generator).mul_(
                    1.0 / math.sqrt(module.in_features))
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model.to(device)


def _quantize_weight(w: np.ndarray):
    """[out, in] float32 -> (int8 [out, in], float32 scale [out]): symmetric
    per-output-channel quantization, as quantize_vibert_int8 of the JAX
    package computes it on [in, out]."""
    w = np.asarray(w, np.float32)
    s = np.maximum(np.abs(w).max(axis=1), 1e-8) / 127.0
    q = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def quantize_vibert_int8(model: ViBert) -> ViBert:
    """The int8 weight-only tier of `model`, on its device: every linear of
    the layers and both heads quantized per output channel; embeddings,
    layer norms and biases stay float32."""
    qmodel = ViBert(model.cfg, int8=True)
    state = {}
    for key, value in model.state_dict().items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "weight" and isinstance(model.get_submodule(prefix), nn.Linear):
            q, s = _quantize_weight(value.detach().cpu().numpy())
            state[f"{prefix}.weight_q"] = torch.from_numpy(q)
            state[f"{prefix}.weight_scale"] = torch.from_numpy(s)
        else:
            state[key] = value.detach().cpu()
    qmodel.load_state_dict(state)
    return qmodel.to(model.device)
