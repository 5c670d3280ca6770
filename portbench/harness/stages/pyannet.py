"""Segmentation: PyanNet of pyannote Community-1 (models/pyannet.py), run by
the PureDiarizer on 10 s windows every 1 s, 64 windows a superblock.

seg_rel_err  worst window's ||program - reference|| / ||reference|| of its
             589 x 7 powerset log-probabilities, over every window of the
             request (inf when the program scored fewer windows).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness.stages import quantized
from portbench.reference import pyannet as ref

LOADER = "load_segmentation"
CHECKS = ("seg_rel_err",)
KEEP = ("low_hz_", "band_hz_")
BLOCK = 64


def program_module(widths):
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, PyanNetConfig

    return PyanNet(PyanNetConfig(**widths))


def fill(module, generator, device):
    """SincNet's initial band edges: mel-spaced from 30 Hz to half the rate
    less the least low and band frequencies."""
    cfg = module.cfg
    top = cfg.sample_rate / 2 - (cfg.min_low_hz + cfg.min_band_hz)
    mel = np.linspace(2595 * np.log10(1 + 30.0 / 700), 2595 * np.log10(1 + top / 700), cfg.sinc_filters + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    with torch.no_grad():
        module.get_parameter("sincnet.conv1d.0.low_hz_").copy_(torch.tensor(hz[:-1, None], dtype=torch.float32))
        module.get_parameter("sincnet.conv1d.0.band_hz_").copy_(torch.tensor(np.diff(hz)[:, None],
                                                                             dtype=torch.float32))


def captures(rec):
    from sherpa_vietnamese_asr_tpu_torch.models import pyannet

    orig = pyannet.PyanNet.forward

    def forward(self, audio):
        out = orig(self, audio)
        if rec.capture is not None:
            rec.kept().setdefault("seg_logp", []).append(out)
        return out

    return [(pyannet.PyanNet, "forward", forward)]


def windows(audio, device):
    """[N, 160000] windows of the request's audio as the diarizer uploads it,
    on `device`."""
    x = quantized(audio)
    starts = ref.window_starts(len(x))
    padded = np.zeros(starts[-1] + ref.WINDOW, np.float32)
    padded[: len(x)] = x
    return torch.from_numpy(padded).to(device).unfold(0, ref.WINDOW, ref.STEP)[: len(starts)]


def reference_logp(widths, w, ctx, device, P):
    wins = windows(ctx["audio"], device)
    return torch.cat([ref.forward(P, w, widths, wins[i: i + BLOCK]) for i in range(0, len(wins), BLOCK)])


def judge(widths, w, got, ctx, device, P):
    want = reference_logp(widths, w, ctx, device, P)
    parts = got.get("seg_logp") or []
    have = torch.cat([p.to(device).float() for p in parts]) if parts else want[:0]
    if have.shape[0] < want.shape[0] or have.shape[1:] != want.shape[1:]:
        return {"seg_rel_err": math.inf}
    have = have[: want.shape[0]]
    err = torch.linalg.vector_norm(have - want, dim=(1, 2)) / torch.linalg.vector_norm(want, dim=(1, 2))
    return {"seg_rel_err": float(err.max())}


def control(widths, w, got, ctx, device, P):
    return {"seg_logp": [reference_logp(widths, w, ctx, device, P)]}
