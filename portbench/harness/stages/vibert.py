"""Punctuation: ViBERT-capu (models/vibert.py) in GecBert's iterative
Seq2Labels decode (pipeline/gec.py), minibatches of 32 chunks of up to 56
words, up to 3 passes.

punct_logit_gap  widest |program - reference| of a word's label or detect
                 logit, over every real row of every forward the request
                 ran, the reference run on the program's own subword ids,
                 attention mask and word offsets (the chunking and the
                 WordPiece split are the program's host work, not checked
                 here); inf when the request ran no forward.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import vibert as ref

LOADER = "load_vibert_asset"
CHECKS = ("punct_logit_gap",)
KEEP = ()


def program_module(widths):
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBert, ViBertConfig

    return ViBert(ViBertConfig(**widths))


def fill(module, generator, device):
    pass


def captures(rec):
    from sherpa_vietnamese_asr_tpu_torch.models import vibert

    orig = vibert.ViBert.forward

    def forward(self, input_ids, attention_mask, token_type_ids, input_offsets):
        out = orig(self, input_ids, attention_mask, token_type_ids, input_offsets)
        if rec.capture is not None:
            rec.kept().setdefault("vibert", []).append(
                (input_ids, attention_mask, token_type_ids, input_offsets, *out))
        return out

    return [(vibert.ViBert, "forward", forward)]


def _calls(got, device):
    """Each forward's real rows: (ids, attention, offsets, labels, d_tags)."""
    for ids, att, types, offs, labels, dtags in got.get("vibert") or []:
        if bool(types.ne(0).any()):
            raise ValueError("token types other than 0")
        real = att.ne(0).any(dim=1)
        yield tuple(x[real].to(device) for x in (ids, att, offs, labels, dtags))


def judge(widths, w, got, ctx, device, P):
    calls = got.get("vibert") or []
    if not calls:
        return {"punct_logit_gap": math.inf}
    gap = 0.0
    for ids, att, offs, labels, dtags in _calls(got, device):
        want = ref.forward(P, w, widths, ids, att, offs)
        gap = max(gap, float((labels.float() - want[0]).abs().max()),
                  float((dtags.float() - want[1]).abs().max()))
    return {"punct_logit_gap": gap}


def control(widths, w, got, ctx, device, P):
    """The reference in precision P on the program's own inputs."""
    out = []
    for ids, att, offs, _, _ in _calls(got, device):
        out.append((ids, att, torch.zeros_like(ids), offs, *ref.forward(P, w, widths, ids, att, offs)))
    return {"vibert": out}
