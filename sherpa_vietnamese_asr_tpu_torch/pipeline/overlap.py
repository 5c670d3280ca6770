# Overlap speaker separation: Conv-TasNet on 2-speaker overlap regions with
# CAM++ Hungarian stream<->speaker matching and context-audio stitching.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/overlap.py, with the same
# constants and rules:
#   * regions shorter than 1.0 s are dropped;
#   * speaker centroids come from clean (non-overlap) solo segments >= 1 s;
#   * Conv-TasNet separates the region; each stream is rescaled to 0.9 of
#     the mixture peak;
#   * streams are matched to participants by Hungarian assignment (scipy) on
#     cosine cost against the centroids;
#   * each stream is stitched with up to 3 s of the speaker's nearest clean
#     audio before and after, with 15 ms fades, for re-ASR.
# The models run on `device` (the card by default). An embedding's fbank is
# the ASR config's through ops/fbank.compute_fbank (kernel 1 on the card),
# CMVN over all its frames, then cut or zero-padded to the 1,000-frame
# budget with a mask, as in the JAX package: CAM++'s convolutions see the
# zeros after the end, so an exact-length embedding would differ in its
# last frames. The centroids' embeddings go through CAM++ in batches of
# EMBED_BATCH (each row as alone); the host parts are copied unchanged.

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sherpa_vietnamese_asr_tpu_torch.models import assets, convert
from sherpa_vietnamese_asr_tpu_torch.models.campplus import Campp, random_campp
from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import ConvTasNet, random_convtasnet
from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops

SAMPLE_RATE = 16000
CONTEXT_SEC_DEFAULT = 3.0
MIN_REGION_SEC = 0.4
MIN_REF_SEC = 1.0
MIN_OVERLAP_SEC = 1.0
FADE_MS = 15
EMBED_BATCH = 32


def _get(seg, key, default=None):
    if isinstance(seg, dict):
        return seg.get(key, default)
    return getattr(seg, key, default)


class OverlapSeparator:
    """Models are a ConvTasNet and a Campp on `device` (the card by default;
    raises without one). Without them, the asset registry, then loudly
    flagged random weights fill them in."""

    def __init__(self, convtasnet: ConvTasNet | None = None,
                 campp: Campp | None = None, context_sec=CONTEXT_SEC_DEFAULT,
                 embed_pad_sec=10.0, device="cuda"):
        self.device = model_device(device)
        if convtasnet is None:
            loaded = assets.load_convtasnet_asset()
            if loaded is not None:
                convtasnet = convert.convtasnet_from_numpy(*loaded, device=self.device)
        if campp is None:
            loaded = assets.load_campp_asset()
            if loaded is not None:
                campp = convert.campp_from_numpy(*loaded, device=self.device)
        if convtasnet is None:
            assets.warn_random("Conv-TasNet overlap separator")
            convtasnet = random_convtasnet(seed=0, device=self.device)
        if campp is None:
            assets.warn_random("speaker embedding (CAM++)")
            campp = random_campp(seed=1, device=self.device)
        self.convtasnet = convtasnet.to(self.device)
        self.campp = campp.to(self.device)
        self.ct_cfg = convtasnet.cfg
        self.campp_cfg = campp.cfg
        self.context_sec = context_sec
        self.fade_n = int(FADE_MS / 1000.0 * SAMPLE_RATE)
        self.embed_pad_frames = int(embed_pad_sec * 100)

    # -- embeddings ---------------------------------------------------------
    @torch.no_grad()
    def compute_embeddings(self, audios):
        """CAM++ embeddings of several clips, each L2-normalized; None for a
        clip under 300 ms or 10 frames. Fbank: the ASR config (povey,
        snip_edges=False, no scale) with per-clip CMVN."""
        cfg = fbank_ops.ASR_FBANK
        t_pad = self.embed_pad_frames
        out = [None] * len(audios)
        todo = [i for i, a in enumerate(audios)
                if len(a) >= int(0.3 * SAMPLE_RATE)
                and fbank_ops.num_frames(len(a), cfg) >= 10]
        for b in range(0, len(todo), EMBED_BATCH):
            rows = todo[b: b + EMBED_BATCH]
            fb = torch.zeros((len(rows), t_pad, cfg.num_bins), device=self.device)
            mask = torch.zeros((len(rows), t_pad), device=self.device)
            for r, i in enumerate(rows):
                a = torch.from_numpy(np.asarray(audios[i], np.float32)).to(self.device)
                feats = fbank_ops.compute_fbank(a, cfg)
                feats = (feats - feats.mean(dim=0, keepdim=True))[:t_pad]
                fb[r, : feats.shape[0]] = feats
                mask[r, : feats.shape[0]] = 1.0
            embs = self.campp(fb, mask).cpu().numpy()
            for r, i in enumerate(rows):
                emb = embs[r]
                norm = np.linalg.norm(emb)
                if norm > 1e-10:
                    emb = emb / norm
                out[i] = emb.astype(np.float32)
        return out

    def compute_embedding(self, audio):
        """CAM++ embedding, L2-normalized; None when < 300 ms."""
        return self.compute_embeddings([np.asarray(audio, np.float32)])[0]

    def compute_centroids(self, audio, segments, overlap_regions):
        """Per-speaker centroid from clean solo segments."""
        overlap_sorted = sorted(overlap_regions)

        def intersects(s, e):
            for os_, oe_ in overlap_sorted:
                if oe_ < s:
                    continue
                if os_ > e:
                    break
                if max(s, os_) < min(e, oe_):
                    return True
            return False

        clips, speakers = [], []
        for seg in segments:
            s = float(_get(seg, "start", 0))
            e = float(_get(seg, "end", s))
            spk = int(_get(seg, "speaker", -1))
            if spk < 0 or (e - s) < MIN_REF_SEC or intersects(s, e):
                continue
            clips.append(audio[int(s * SAMPLE_RATE): min(int(e * SAMPLE_RATE),
                                                          len(audio))])
            speakers.append(spk)
        embs = {}
        for spk, emb in zip(speakers, self.compute_embeddings(clips)):
            if emb is not None:
                embs.setdefault(spk, []).append(emb)
        centroids = {}
        for spk, lst in embs.items():
            c = np.mean(lst, axis=0)
            n = np.linalg.norm(c)
            if n > 1e-10:
                c /= n
            centroids[spk] = c.astype(np.float32)
        return centroids

    @staticmethod
    def participants_in_region(region, segments):
        t_s, t_e = region
        parts = set()
        for seg in segments:
            s = float(_get(seg, "start", 0))
            e = float(_get(seg, "end", s))
            spk = int(_get(seg, "speaker", -1))
            if spk >= 0 and max(s, t_s) < min(e, t_e):
                parts.add(spk)
        return sorted(parts)

    @staticmethod
    def _closest_clean_segment(segments, overlap_regions, spk, target_t,
                               direction):
        def intersects(s, e):
            return any(max(s, os_) < min(e, oe_)
                       for os_, oe_ in overlap_regions)

        candidates = []
        for seg in segments:
            s = float(_get(seg, "start", 0))
            e = float(_get(seg, "end", s))
            if int(_get(seg, "speaker", -1)) != spk or intersects(s, e):
                continue
            if direction == "before" and e <= target_t:
                candidates.append((s, e))
            elif direction == "after" and s >= target_t:
                candidates.append((s, e))
        if not candidates:
            return None
        return (max(candidates, key=lambda x: x[1]) if direction == "before"
                else min(candidates, key=lambda x: x[0]))

    # -- separation ----------------------------------------------------------
    def separate_region(self, audio, region, participants, centroids):
        if len(participants) != 2:
            return None
        if any(p not in centroids for p in participants):
            return None
        t_s, t_e = region
        if t_e - t_s < MIN_REGION_SEC:
            return None
        a_s = int(t_s * SAMPLE_RATE)
        a_e = min(int(t_e * SAMPLE_RATE), len(audio))
        region_audio = audio[a_s:a_e]
        if len(region_audio) < int(MIN_REGION_SEC * SAMPLE_RATE):
            return None

        x = torch.from_numpy(np.ascontiguousarray(region_audio, np.float32))
        ests = self.convtasnet(x[None].to(self.device))[0].cpu().numpy()

        mix_peak = float(np.abs(region_audio).max())
        if mix_peak < 1e-6:
            return None
        for j in range(ests.shape[0]):
            p = float(np.abs(ests[j]).max())
            if p > 0:
                ests[j] = ests[j] * (mix_peak * 0.9 / p)

        e0, e1 = self.compute_embeddings([ests[0], ests[1]])
        ps = list(participants)
        if e0 is None or e1 is None:
            return {ps[0]: ests[0], ps[1]: ests[1]}
        cost = np.array([
            [1.0 - float(e0 @ centroids[ps[0]]),
             1.0 - float(e0 @ centroids[ps[1]])],
            [1.0 - float(e1 @ centroids[ps[0]]),
             1.0 - float(e1 @ centroids[ps[1]])],
        ])
        rows, cols = linear_sum_assignment(cost)
        return {ps[c]: ests[r] for r, c in zip(rows, cols)}

    # -- context stitching ----------------------------------------------------
    def build_context_audio(self, audio, segments, overlap_regions, region,
                            spk, separated):
        ctx = self.context_sec
        before = self._closest_clean_segment(segments, overlap_regions, spk,
                                             region[0], "before")
        after = self._closest_clean_segment(segments, overlap_regions, spk,
                                            region[1], "after")
        chunks = []
        real_start = 0.0
        if before is not None:
            b_s, b_e = before
            b_s = max(b_s, b_e - ctx)
            a_s, a_e = int(b_s * SAMPLE_RATE), min(int(b_e * SAMPLE_RATE),
                                                   len(audio))
            if a_e > a_s:
                chunks.append(audio[a_s:a_e])
                real_start += (a_e - a_s) / SAMPLE_RATE
        chunks.append(np.asarray(separated, np.float32))
        real_end = real_start + len(separated) / SAMPLE_RATE
        if after is not None:
            s_t, e_t = after
            e_t = min(e_t, s_t + ctx)
            a_s, a_e = int(s_t * SAMPLE_RATE), min(int(e_t * SAMPLE_RATE),
                                                   len(audio))
            if a_e > a_s:
                chunks.append(audio[a_s:a_e])
        return self._concat_with_fade(chunks), real_start, real_end

    def _concat_with_fade(self, chunks):
        if not chunks:
            return np.zeros(0, np.float32)
        if len(chunks) == 1:
            return chunks[0].astype(np.float32)
        fn = self.fade_n
        fade_in = np.linspace(0, 1, fn, dtype=np.float32)
        fade_out = np.linspace(1, 0, fn, dtype=np.float32)
        parts = []
        for i, ch in enumerate(chunks):
            ch = ch.astype(np.float32).copy()
            if i > 0 and len(ch) > fn:
                ch[:fn] *= fade_in
            if i < len(chunks) - 1 and len(ch) > fn:
                ch[-fn:] *= fade_out
            parts.append(ch)
        return np.concatenate(parts)

    # -- entry point -----------------------------------------------------------
    def process(self, audio, segments, overlap_regions,
                progress_callback=None):
        """Returns per-region dicts with stitched per-speaker audio."""
        if not overlap_regions:
            return []
        regions = [r for r in overlap_regions
                   if (r[1] - r[0]) >= MIN_OVERLAP_SEC]
        if not regions:
            return []
        audio = np.asarray(audio, np.float32)
        centroids = self.compute_centroids(audio, segments, regions)
        results = []
        for i, region in enumerate(regions):
            if progress_callback:
                progress_callback(int(i / max(1, len(regions)) * 100))
            participants = self.participants_in_region(region, segments)
            if len(participants) != 2:
                continue
            if not all(p in centroids for p in participants):
                continue
            streams = self.separate_region(audio, region, participants,
                                           centroids)
            if streams is None:
                continue
            audio_per, rs_per, re_per = {}, {}, {}
            for spk, sep in streams.items():
                concat, rs, re = self.build_context_audio(
                    audio, segments, regions, region, spk, sep)
                audio_per[spk] = concat
                rs_per[spk] = rs
                re_per[spk] = re
            results.append({
                "start": region[0], "end": region[1],
                "participants": participants,
                "audio_per_speaker": audio_per,
                "real_start_per_speaker": rs_per,
                "real_end_per_speaker": re_per,
            })
        if progress_callback:
            progress_callback(100)
        return results

    @staticmethod
    def filter_words_in_window(words, real_start, real_end, real_offset=0.0):
        """Keep words whose midpoint is inside [real_start, real_end], with
        time shift to global coordinates."""
        out = []
        for w in words:
            ws = float(w.get("start", 0))
            we = float(w.get("end", ws))
            if real_start <= (ws + we) / 2.0 <= real_end:
                nw = dict(w)
                nw["start"] = ws + real_offset
                nw["end"] = we + real_offset
                out.append(nw)
        return out
