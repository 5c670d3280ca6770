# Audio quality analysis (DNSMOS) — pipeline stage.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/quality.py: 9.01 s windows,
# zero-padded and never normalised (the model is level-sensitive), all of a
# call's windows in one forward of models/dnsmos.Dnsmos on the model's
# device, the raw scores mapped through Microsoft's polynomial fit;
# analyze_speech samples the speech-only audio at 15/50/85%, and
# compute_dnsmos_average slides windows with 50% overlap. With a mesh
# (parallel/sharding.py) a call's windows are split over its devices, one
# model replica each.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.parallel import sharding

DNSMOS_LEN = 144160  # 9.01 s @ 16 kHz

# Microsoft DNSMOS polynomial MOS mapping (audio_analyzer.py:287-293)
_P_OVR = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
_P_SIG = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
_P_BAK = np.poly1d([-0.13166888, 1.60915514, -0.39604546])


class QualityAnalyzer:
    """DNSMOS quality of speech. `model`, a models/dnsmos.Dnsmos, runs where
    it is unless `device` is given; without one the checkpoint from the
    asset registry, else a loudly flagged random model (torch.Generator
    seeded 0), goes to `device`, the card by default (raises without one)."""

    def __init__(self, model=None, mesh="auto", device=None):
        from sherpa_vietnamese_asr_tpu_torch.models import assets, convert
        from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import random_dnsmos

        if model is None:
            device = device or "cuda"
            loaded = assets.load_dnsmos_asset()
            if loaded is not None:
                model = convert.dnsmos_from_numpy(*loaded, device=device)
            else:
                assets.warn_random("DNSMOS quality model")
                model = random_dnsmos(seed=0, device=device)
        elif device is not None:
            model = model.to(device)
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        # mesh "auto": every card of a multi-card host, else None (one device).
        self.mesh = sharding.resolve(mesh)
        self.replicas = sharding.replicate(model, self.mesh)

    @staticmethod
    def _map_scores(raw):
        sig, bak, ovr = float(raw[0]), float(raw[1]), float(raw[2])
        return {
            "SIG": float(np.clip(_P_SIG(sig), 1.0, 5.0)),
            "BAK": float(np.clip(_P_BAK(bak), 1.0, 5.0)),
            "OVRL": float(np.clip(_P_OVR(ovr), 1.0, 5.0)),
        }

    def raw_scores(self, windows):
        """[N, 3] raw (SIG, BAK, OVRL) of up to 144160 samples each,
        zero-padded, in one forward a device."""
        batch = np.zeros((len(windows), DNSMOS_LEN), np.float32)
        for i, w in enumerate(windows):
            n = min(len(w), DNSMOS_LEN)
            batch[i, :n] = w[:n]
        pieces, n = sharding.shard_batch(batch, self.mesh, self.device)
        with torch.no_grad():
            outs = []
            for rep, x in zip(self.replicas, pieces):
                with sharding.device_scope(x.device):
                    outs.append(rep(x))
            return sharding.gather(outs, n)

    def compute_dnsmos_batch(self, windows):
        """windows: [N, <=144160] list/array -> list of score dicts.
        Inputs are zero-padded, never peak-normalized (level-sensitive)."""
        if not len(windows):
            return []
        return [self._map_scores(r) for r in self.raw_scores(windows)]

    def compute_dnsmos(self, audio):
        scores = self.compute_dnsmos_batch([np.asarray(audio, np.float32)])
        return scores[0] if scores else None

    def analyze_speech(self, concat_audio, positions=(0.15, 0.50, 0.85)):
        """Stratified sampling over speech-only audio -> averaged quality
        dict {dnsmos_sig, dnsmos_bak, dnsmos_ovrl} or None
        (reference asr_engine.py:2500-2528)."""
        concat_len = len(concat_audio)
        if concat_len < 8000:  # < 0.5 s of speech
            return None
        windows = []
        for pos in positions:
            center = int(concat_len * pos)
            start = max(0, center - DNSMOS_LEN // 2)
            end = min(concat_len, start + DNSMOS_LEN)
            if end - start >= 8000:
                windows.append(concat_audio[start:end])
        scores = self.compute_dnsmos_batch(windows)
        if not scores:
            return None
        return {
            "dnsmos_sig": round(float(np.mean([s["SIG"] for s in scores])), 2),
            "dnsmos_bak": round(float(np.mean([s["BAK"] for s in scores])), 2),
            "dnsmos_ovrl": round(float(np.mean([s["OVRL"] for s in scores])), 2),
        }

    def compute_dnsmos_average(self, audio):
        """Sliding 9.01 s windows with 50% overlap, averaged
        (audio_analyzer.py:306-331)."""
        audio = np.asarray(audio, np.float32)
        if len(audio) <= DNSMOS_LEN:
            return self.compute_dnsmos(audio)
        step = DNSMOS_LEN // 2
        windows = [audio[s: s + DNSMOS_LEN]
                   for s in range(0, len(audio) - DNSMOS_LEN + 1, step)]
        scores = self.compute_dnsmos_batch(windows)
        if not scores:
            return None
        return {k: float(np.mean([s[k] for s in scores]))
                for k in ("SIG", "BAK", "OVRL")}
