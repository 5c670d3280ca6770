"""ViBERT-capu (dragonSwing/vibert-capu), plain: a GECToR-style Seq2Labels
model over BERT-base, subword ids -> for each word, 15 edit-label logits
and 4 detect-tag logits.

Written from the Hugging Face BERT encoder (post-LN: word + position +
token-type embeddings, LayerNorm at eps 1e-12; in each layer self-attention
of `heads` heads with the padding masked, the output linear, residual and
LayerNorm, the intermediate linear with the exact GELU, the output linear,
residual and LayerNorm) and GECToR's Seq2Labels head (each word's first
subword's hidden state through the label and detect linears). Weights by
the Hugging Face names (bert.encoder.layer.0.attention.self.query.weight,
classifier.bias, detector.weight, ...). Token types are all 0.

Departure: masked scores get -10000 added (the original BERT's constant);
a row with one unmasked position or more has the same softmax with any
constant that large.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision


def _norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"], w[name + ".bias"], eps)


def forward(P: Precision, w, widths, ids, attention, offsets):
    """ids, attention [B, T], offsets [B, W] -> (labels [B, W, 15],
    d_tags [B, W, 4]) float32."""
    eps = widths["layer_norm_eps"]
    heads = widths["heads"]
    b, t = ids.shape
    pre = "bert.embeddings."
    x = (w[pre + "word_embeddings.weight"][ids.long()] + w[pre + "position_embeddings.weight"][:t]
         + w[pre + "token_type_embeddings.weight"][0])
    x = _norm(w, pre + "LayerNorm", x, eps)
    masked = (1.0 - attention.float())[:, None, None, :] * -10000.0
    hd = widths["hidden"] // heads
    with P.active():
        for i in range(widths["layers"]):
            pre = f"bert.encoder.layer.{i}."

            def lin(name, v):
                return P.linear(v, w[pre + name + ".weight"], w[pre + name + ".bias"])

            q, k, v = (lin("attention.self." + n, x).reshape(b, t, heads, hd).transpose(1, 2)
                       for n in ("query", "key", "value"))
            scores = P.matmul(q, k.transpose(2, 3)) / math.sqrt(hd) + masked
            ctx = P.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, -1)
            x = _norm(w, pre + "attention.output.LayerNorm", x + lin("attention.output.dense", ctx), eps)
            h = F.gelu(lin("intermediate.dense", x))
            x = _norm(w, pre + "output.LayerNorm", x + lin("output.dense", h), eps)
        first = x.gather(1, offsets.long()[:, :, None].expand(-1, -1, x.shape[-1]))
        return (P.linear(first, w["classifier.weight"], w["classifier.bias"]),
                P.linear(first, w["detector.weight"], w["detector.bias"]))
