"""Speaker embedding: WeSpeaker ResNet34 (models/resnet_speaker.py) in the
PureDiarizer's superblocks: kernel 1's fbank of each window, centred, the
frame features, statistics pooled under each speaker's frames of the
window's segmentation, projected to 256.

embed_cos_gap  widest 1 - cosine (in float64) between a (window, speaker)
               embedding of the program and the reference's, the reference
               computing its own fbank and features from the audio and
               pooling under the program's own segmentation classes; inf
               when the two disagree on which (window, speaker) has an
               embedding or the program made fewer windows.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.stages import pyannet as seg_stage
from portbench.reference import resnet_speaker as ref

LOADER = "load_embedding_split"
CHECKS = ("embed_cos_gap",)
KEEP = ()
BLOCK = 32


def program_module(widths):
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeaker, ResNetSpeakerConfig

    return ResNetSpeaker(ResNetSpeakerConfig(**dict(widths, blocks=tuple(widths["blocks"]))))


def fill(module, generator, device):
    """BatchNorm running statistics as a trained checkpoint has them, not
    at identity: means N(0, 0.1^2), variances exp(N(0, 0.2^2))."""
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=generator, device=device))
            elif name.endswith("running_var"):
                buf.copy_(torch.exp(0.2 * torch.randn(buf.shape, generator=generator, device=device)))


def captures(rec):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure

    orig = diarization_pure._superblock_body

    def superblock(seg_model, emb_model, block, n_windows, *a, **kw):
        out = orig(seg_model, emb_model, block, n_windows, *a, **kw)
        if rec.counting:  # kernel 1 once a superblock
            rec.launches["fbank"] += 1
        if rec.capture is not None:
            rec.kept().setdefault("superblocks", []).append((n_windows, out))
        return out

    return [(diarization_pure, "_superblock_body", superblock)]


def _program(got, device):
    """(classes [N, 589], embeddings [N, 3, D], has [N, 3]) of every window
    the program's superblocks made."""
    parts = got.get("superblocks") or []
    if not parts:
        return None
    am, emb, has = (torch.cat([o[i][:n].to(device) for n, o in parts]) for i in range(3))
    return am.long(), emb.double(), has.bool()


def judge(widths, w, got, ctx, device, P):
    wins = seg_stage.windows(ctx["audio"], device)
    prog = _program(got, device)
    if prog is None or prog[0].shape[0] < wins.shape[0]:
        return {"embed_cos_gap": math.inf}
    classes, emb, has = (x[: wins.shape[0]] for x in prog)
    gap = 0.0
    for i in range(0, wins.shape[0], BLOCK):
        want, want_has = ref.embeddings(P, w, widths, wins[i: i + BLOCK], classes[i: i + BLOCK])
        if not torch.equal(want_has, has[i: i + BLOCK]):
            return {"embed_cos_gap": math.inf}
        a, b = emb[i: i + BLOCK][want_has], want.double()[want_has]
        if a.shape[0]:
            cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
            gap = max(gap, float((1.0 - cos).max()))
    return {"embed_cos_gap": gap}


def control(widths, w, got, ctx, device, P):
    """The control's embeddings, pooled under the classes of the control's
    own segmentation (got["seg_logp"], from pyannet.control)."""
    wins = seg_stage.windows(ctx["audio"], device)
    classes = torch.cat(got["seg_logp"]).argmax(dim=-1)
    out = []
    for i in range(0, wins.shape[0], BLOCK):
        emb, has = ref.embeddings(P, w, widths, wins[i: i + BLOCK], classes[i: i + BLOCK])
        n = emb.shape[0]
        out.append((n, (classes[i: i + n].to(torch.int8), emb, has)))
    return {"superblocks": out}
