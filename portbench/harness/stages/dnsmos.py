"""Quality: DNSMOS sig_bak_ovr (models/dnsmos.py) on up to three 9.01 s
windows of the speech-only audio (pipeline/quality.py analyze_speech), in
the pipeline's background thread on its own CUDA stream.

dnsmos_abs_err  widest |program - reference| of a window's raw SIG, BAK or
                OVRL score, the reference making the windows from the
                speech-only audio itself; inf when the program scored
                another number of windows.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dnsmos as ref

LOADER = "load_dnsmos_asset"
CHECKS = ("dnsmos_abs_err",)
KEEP = ()


def program_module(widths):
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import Dnsmos, DnsmosConfig

    return Dnsmos(DnsmosConfig(**dict(widths, channels=tuple(widths["channels"]))))


def fill(module, generator, device):
    pass


def captures(rec):
    from sherpa_vietnamese_asr_tpu_torch.models import dnsmos

    orig = dnsmos.Dnsmos.forward

    def forward(self, audio):
        out = orig(self, audio)
        if rec.capture is not None:
            rec.kept().setdefault("dnsmos", []).append(out)
        return out

    return [(dnsmos.Dnsmos, "forward", forward)]


def reference_scores(widths, w, ctx, device, P):
    wins = torch.from_numpy(ref.speech_windows(ctx["speech"])).to(device)
    return ref.forward(P, w, widths, wins) if len(wins) else wins[:, :3]


def judge(widths, w, got, ctx, device, P):
    want = reference_scores(widths, w, ctx, device, P)
    parts = got.get("dnsmos") or []
    have = torch.cat([p.to(device).float() for p in parts]) if parts else want[:0]
    if have.shape != want.shape:
        return {"dnsmos_abs_err": math.inf}
    return {"dnsmos_abs_err": float((have - want).abs().max()) if want.numel() else 0.0}


def control(widths, w, got, ctx, device, P):
    return {"dnsmos": [reference_scores(widths, w, ctx, device, P)]}
