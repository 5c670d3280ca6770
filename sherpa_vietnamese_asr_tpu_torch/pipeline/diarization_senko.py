# Senko-style CAM++ diarizer — the fast alternative backend.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/diarization_senko.py:
#   * PyanNet segmentation as VAD with 10 s windows / 5 s step in batches of
#     32, overlap regions extracted from the powerset (additive API);
#   * sliding 1.5 s / 0.6 s CAM++ windows: each speech region's fbank
#     computed once (ops/fbank.compute_fbank at CAMPP_FBANK, CMVN over the
#     whole region; kernel 1 on the card), packed into [6144, 80] blocks of
#     at most 128 windows, the overlapped window views gathered inside the
#     block and embedded in one batched Campp call a block;
#   * Senko clustering: spectral (< 20 min) with p-pruning and eigengap
#     speaker count, UMAP+HDBSCAN (>= 20 min, utils/clustering.py on the
#     native clusterkit), minor-cluster filter, merge-by-cosine 0.875;
#   * post rules: merge gap <= 4 s, drop <= 0.78 s fragments, re-rank
#     speakers by total speaking time.
# The host parts (cosine_similarity, the clustering, the window plan and
# block packing, the VAD's region rules and the post rules) are copied from
# the JAX package, with one exception: senko_spectral runs
# diarization_pure.kmeans(x, k, n_init=1, seed=0) where the JAX package runs
# scikit-learn's KMeans(n_clusters=k, random_state=0), which the card's host
# does not have (scikit-learn's default n_init="auto" is one k-means++ run).
# The JAX package's fixed-block streamed fbank and fixed 32-window and
# 128-slot batches were compile workarounds; here each region's fbank is
# computed at its own length (the same frames and CMVN), and the last VAD
# batch and each block run only their real windows. The region fbanks and
# the blocks stay on the model's device; the audio is uploaded once.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models import assets, convert
from sherpa_vietnamese_asr_tpu_torch.models.campplus import Campp, random_campp
from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, random_pyannet
from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops
from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import kmeans

SAMPLE_RATE = 16000
VAD_BATCH = 32
POWERSET_MAP = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, 0, 1], [0, 1, 1]], dtype=np.float32)


def campp_window_block(campp: Campp, feat_block: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, w_frames: int) -> torch.Tensor:
    """[F_MAX, 80] packed region fbank + [W] window starts/lens ->
    [W, embed_dim] CAM++ embeddings. The overlapped 1.5 s window views are
    gathered inside the block; a window's frames after its length are
    zeroed, so the convolutions see the zeros of a zero-padded window."""
    steps = torch.arange(w_frames, device=feat_block.device)
    idx = (starts[:, None] + steps[None, :]).clamp_max(feat_block.shape[0] - 1)
    mask = (steps[None, :] < lens[:, None]).to(feat_block.dtype)
    feats = feat_block[idx] * mask[:, :, None]                 # [W, w, 80]
    return campp(feats, mask)


def cosine_similarity(x, y=None):
    if y is None:
        y = x
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-10)
    yn = y / (np.linalg.norm(y, axis=1, keepdims=True) + 1e-10)
    return xn @ yn.T


def senko_spectral(x, min_num_spks=1, max_num_spks=10, pval=0.02,
                   min_pnum=6, oracle_num=None):
    """Senko SpectralCluster: p-pruned cosine affinity, unnormalized
    Laplacian, eigengap count, k-means on spectral embeddings."""
    n = x.shape[0]
    if n <= 1:
        return np.zeros(n, np.int32)
    m = cosine_similarity(x)
    n_elems = int((1 - pval) * n)
    n_elems = max(min(n_elems, n - min_pnum), 0)
    for i in range(n):
        low = np.argsort(m[i])[:n_elems]
        m[i, low] = 0
    m = 0.5 * (m + m.T)
    np.fill_diagonal(m, 0)
    d = np.abs(m).sum(axis=1)
    lap = np.diag(d) - m
    lambdas, vecs = np.linalg.eigh(lap)
    if oracle_num is not None:
        k = oracle_num
    else:
        sub = lambdas[min_num_spks - 1: max_num_spks + 1]
        gaps = [float(sub[i + 1]) - float(sub[i]) for i in range(len(sub) - 1)]
        if not gaps:
            return np.zeros(n, np.int32)
        k = int(np.argmax(gaps)) + min_num_spks
    k = max(1, min(k, n))
    return kmeans(vecs[:, :k], k, n_init=1, seed=0).astype(np.int32)


def senko_umap_hdbscan(x, n_neighbors=20, n_components=60, min_samples=20,
                       min_cluster_size=10, metric="euclidean"):
    """Senko UmapHdbscan (long-audio route), same parameters as the
    reference call on utils/clustering.py's UMAP + HDBSCAN. Deterministic
    under the pinned layout seed."""
    del metric  # euclidean only, like the reference call site
    from sherpa_vietnamese_asr_tpu_torch.utils.clustering import (
        hdbscan_labels,
        umap_embed,
    )

    n_comp = max(min(n_components, x.shape[0] - 2), 2)
    red = umap_embed(x, n_neighbors=n_neighbors, min_dist=0.0,
                     n_components=n_comp)
    return hdbscan_labels(red, min_samples=min_samples,
                          min_cluster_size=min_cluster_size)


def senko_cluster(x, cluster_type="umap_hdbscan", cluster_line=10,
                  mer_cos=0.875, min_cluster_size=4, **kw):
    """Senko CommonClustering: cluster, filter minor clusters to nearest
    major centroid, iterative merge-by-cosine, relabel."""
    n = x.shape[0]
    if n < cluster_line:
        return np.ones(n, np.int32)
    if cluster_type == "umap_hdbscan":
        labels = senko_umap_hdbscan(x, min_cluster_size=min_cluster_size,
                                    **kw)
    else:
        labels = senko_spectral(x, **kw)

    cset = np.unique(labels)
    csize = np.array([(labels == i).sum() for i in cset])
    minor = np.where(csize < min_cluster_size)[0]
    if len(minor) > 0:
        major = np.where(csize >= min_cluster_size)[0]
        if len(major) > 0:
            major_cset = cset[major]
            centers = np.stack([x[labels == i].mean(0) for i in major_cset])
            minor_cset = set(cset[minor])
            for i in range(len(labels)):
                if labels[i] in minor_cset:
                    sim = cosine_similarity(x[i: i + 1], centers)
                    labels[i] = major_cset[sim.argmax()]
        else:
            labels = np.zeros(n, np.int32)

    if mer_cos is not None and mer_cos > 0:
        while True:
            cset = np.unique(labels)
            if len(cset) <= 1:
                break
            centers = np.stack([x[labels == i].mean(0) for i in cset])
            aff = np.triu(cosine_similarity(centers, centers), 1)
            idx = np.unravel_index(np.argmax(aff), aff.shape)
            if aff[idx] < mer_cos:
                break
            c1, c2 = cset[np.array(idx)]
            labels[labels == c2] = c1

    remap = {old: new for new, old in enumerate(np.unique(labels))}
    return np.array([remap[v] for v in labels], np.int32)


class SenkoCamppDiarizer:
    """CAM++ sliding-window diarizer with Senko clustering/post rules.

    Models are a PyanNet and a Campp on `device` (the card by default;
    raises without one). Without them, the asset registry, then loudly
    flagged random weights fill them in."""

    def __init__(self, seg_model: PyanNet | None = None,
                 campp_model: Campp | None = None, num_speakers=-1,
                 min_speakers=1, max_speakers=10, mer_cos=0.875, window=1.5,
                 step=0.6, min_duration_off=0.0, batch_size=32, device="cuda"):
        self.device = model_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if seg_model is None:
            loaded = assets.load_segmentation()
            if loaded is not None:
                seg_model = convert.pyannet_from_numpy(*loaded, device=self.device)
        if campp_model is None:
            loaded = assets.load_campp_asset()
            if loaded is not None:
                campp_model = convert.campp_from_numpy(*loaded, device=self.device)
        if seg_model is None:
            assets.warn_random("diarization segmentation (PyanNet)")
            seg_model = random_pyannet(seed=0, device=self.device)
        if campp_model is None:
            assets.warn_random("speaker embedding (CAM++)")
            campp_model = random_campp(seed=1, device=self.device)
        self.seg_model = seg_model.to(self.device)
        self.campp = campp_model.to(self.device)
        self.seg_cfg = seg_model.cfg
        self.campp_cfg = campp_model.cfg
        self.num_speakers = num_speakers
        self.min_speakers = max(1, min_speakers)
        self.max_speakers = max_speakers
        self.mer_cos = mer_cos
        self.window = window
        self.step = step
        self.min_duration_off = min_duration_off
        self.batch_size = batch_size
        # Fused-block geometry (tests shrink these to force block flushes).
        self.block_frames = 6144
        self.block_windows = 128
        self._last_overlap_regions = []

    @property
    def overlap_regions(self):
        return list(self._last_overlap_regions)

    # -- VAD via segmentation model (10 s window / 5 s step) -----------------
    @torch.no_grad()
    def _pyannote_vad(self, audio, min_speech=0.25, min_silence=0.1):
        chunk = int(10.0 * SAMPLE_RATE)
        step = int(5.0 * SAMPLE_RATE)
        total = len(audio)
        starts = []
        s = 0
        while s < total:
            starts.append(s)
            if s + chunk >= total:
                break
            s += step
        logits = []
        for b in range(0, len(starts), VAD_BATCH):
            group = starts[b: b + VAD_BATCH]
            batch = np.zeros((len(group), chunk), np.float32)
            for i, cs in enumerate(group):
                ce = min(cs + chunk, total)
                batch[i, : ce - cs] = audio[cs:ce]
            logits.append(self.seg_model(
                torch.from_numpy(batch).to(self.device)).cpu().numpy())
        seg_logits = np.concatenate(logits, axis=0)
        binarized = POWERSET_MAP[np.argmax(seg_logits, axis=-1)]
        n_frames = binarized.shape[1]
        frame_dur = 10.0 / n_frames
        total_dur = total / SAMPLE_RATE
        n_out = int(total_dur / frame_dur) + 1
        speech = np.zeros(n_out, np.float32)
        overlap = np.zeros(n_out, np.float32)
        count = np.zeros(n_out, np.float32)
        offs = np.arange(n_frames) * frame_dur
        for c, cs in enumerate(starts):
            out_f = ((cs / SAMPLE_RATE + offs) / frame_dur).astype(int)
            ok = (out_f >= 0) & (out_f < n_out)
            act = binarized[c].sum(axis=-1)
            np.add.at(count, out_f[ok], 1.0)
            np.add.at(speech, out_f[ok], (act[ok] > 0).astype(np.float32))
            np.add.at(overlap, out_f[ok], (act[ok] >= 2).astype(np.float32))
        speech_prob = np.where(count > 0, speech / np.maximum(count, 1), 0)
        overlap_prob = np.where(count > 0, overlap / np.maximum(count, 1), 0)

        def to_regions(mask, min_dur):
            regions, in_r, start_t = [], False, 0.0
            for f, a in enumerate(mask):
                t = f * frame_dur
                if a and not in_r:
                    start_t, in_r = t, True
                elif not a and in_r:
                    if t - start_t >= min_dur:
                        regions.append((start_t, min(t, total_dur)))
                    in_r = False
            if in_r:
                t = len(mask) * frame_dur
                if t - start_t >= min_dur:
                    regions.append((start_t, min(t, total_dur)))
            return regions

        self._last_overlap_regions = to_regions(overlap_prob > 0.5, 0.3)
        regions = to_regions(speech_prob > 0.5, min_speech)
        if not regions:
            return [(0.0, total_dur)]
        merged = [regions[0]]
        for s0, e0 in regions[1:]:
            if s0 - merged[-1][1] < min_silence:
                merged[-1] = (merged[-1][0], e0)
            else:
                merged.append((s0, e0))
        return merged

    # -- embeddings --------------------------------------------------------------
    @torch.no_grad()
    def _sliding_window_embeddings(self, audio, speech_regions,
                                   progress_callback=None):
        """Each region's fbank computed once on the device and packed into
        [block_frames, 80] blocks of at most block_windows windows; the
        overlapped window views are gathered inside each block
        (campp_window_block). Every block is enqueued before the one
        download of the embeddings."""
        cfg = fbank_ops.CAMPP_FBANK
        window_frames = int(self.window * 100)  # 150 for 1.5 s
        step_frames = int(self.step * 100)
        audio_dev = torch.from_numpy(audio).to(self.device)

        regions = []  # (region_fbank, [(pos, wlen, ws, we), ...])
        for rs, re_ in speech_regions:
            s0 = int(rs * SAMPLE_RATE)
            e0 = min(int(re_ * SAMPLE_RATE), len(audio))
            if e0 - s0 < 400:
                continue
            nf = fbank_ops.num_frames(e0 - s0, cfg)
            if nf < 10:
                continue
            region_fbank = fbank_ops.compute_fbank(audio_dev[s0:e0], cfg)
            wins = []
            if nf < window_frames:
                wins.append((0, nf, rs, re_))
            else:
                pos = 0
                while pos + window_frames < nf:
                    ws = rs + pos * 0.01
                    wins.append((pos, window_frames, ws, ws + self.window))
                    pos += step_frames
                tail = max(0, nf - window_frames)
                ws = rs + tail * 0.01
                wins.append((tail, window_frames, ws, ws + self.window))
            regions.append((region_fbank, wins))
        if not regions:
            return np.empty((0, self.campp_cfg.embed_dim), np.float32), []

        f_max, w_slots = self.block_frames, self.block_windows
        total_windows = sum(len(w) for _, w in regions)

        blocks = []  # (feat_block, starts, lens, [(ws, we), ...])

        def new_block():
            return torch.zeros((f_max, cfg.num_bins), dtype=torch.float32,
                               device=self.device)

        feat = new_block()
        starts, lens, times_blk = [], [], []
        rows = 0

        def flush():
            nonlocal feat, starts, lens, times_blk, rows
            if times_blk:
                blocks.append((feat, starts, lens, list(times_blk)))
            feat = new_block()
            starts, lens, times_blk = [], [], []
            rows = 0

        for fb, wins in regions:
            i = 0
            while i < len(wins):
                if len(starts) >= w_slots or \
                        rows + wins[i][1] > f_max:
                    flush()
                base = wins[i][0]
                # take every window whose span fits in the remaining rows
                j, end = i, base
                while (j < len(wins) and len(starts) + (j - i) < w_slots
                        and wins[j][0] + wins[j][1] <= base + (f_max - rows)):
                    end = max(end, wins[j][0] + wins[j][1])
                    j += 1
                seg = fb[base:end]
                feat[rows: rows + len(seg)] = seg
                for k in range(i, j):
                    pos, wlen, ws, we = wins[k]
                    starts.append(rows + pos - base)
                    lens.append(wlen)
                    times_blk.append((ws, we))
                rows += len(seg)
                i = j
        flush()

        embs, times = [], []
        done = 0
        for feat_b, st, ln, tb in blocks:
            embs.append(campp_window_block(
                self.campp, feat_b,
                torch.tensor(st, dtype=torch.int64).to(self.device),
                torch.tensor(ln, dtype=torch.int64).to(self.device), window_frames))
            times.extend(tb)
            done += len(tb)
            if progress_callback:
                progress_callback(30 + 50 * done / max(total_windows, 1))
        embeddings = torch.cat(embs).cpu().numpy()
        norms = np.linalg.norm(embeddings, axis=1)
        ok = norms > 1e-10
        embeddings[ok] /= norms[ok, None]
        return embeddings, times

    def _segments_from_labels(self, window_times, labels):
        if not window_times:
            return []
        segments = []
        cs, ce, cl = window_times[0][0], window_times[0][1], labels[0]
        for i in range(1, len(window_times)):
            ws, we = window_times[i]
            if labels[i] == cl and (ws - ce) < self.min_duration_off + 0.01:
                ce = we
            else:
                segments.append({"start": float(cs), "end": float(ce),
                                 "speaker": int(cl)})
                cs, ce, cl = ws, we, labels[i]
        segments.append({"start": float(cs), "end": float(ce),
                         "speaker": int(cl)})
        return segments

    def process(self, audio, progress_callback=None):
        """audio: float32 [L] @16 kHz -> [{'start','end','speaker'}]."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        duration = len(audio) / SAMPLE_RATE
        if duration < 0.5:
            return []
        speech_regions = self._pyannote_vad(audio) or [(0.0, duration)]
        embeddings, times = self._sliding_window_embeddings(
            audio, speech_regions, progress_callback)
        if embeddings.shape[0] == 0:
            return []

        if self.num_speakers > 0:
            min_spk = self.num_speakers
        else:
            min_spk = self.min_speakers
        n = embeddings.shape[0]
        if n <= 2:
            labels = np.zeros(n, np.int32)
        elif duration < 1200.0:
            labels = senko_cluster(embeddings, cluster_type="spectral",
                                   cluster_line=10, mer_cos=self.mer_cos,
                                   min_cluster_size=4, min_num_spks=min_spk,
                                   max_num_spks=15, pval=0.012)
        else:
            labels = senko_cluster(embeddings, cluster_type="umap_hdbscan",
                                   cluster_line=10, mer_cos=self.mer_cos,
                                   min_cluster_size=10, n_neighbors=40,
                                   n_components=60, min_samples=20,
                                   metric="cosine")

        segments = self._segments_from_labels(times, labels)

        # resolve window overlap at boundaries
        for i in range(len(segments) - 1):
            if segments[i]["end"] > segments[i + 1]["start"]:
                mid = (segments[i]["end"] + segments[i + 1]["start"]) / 2
                segments[i]["end"] = mid
                segments[i + 1]["start"] = mid

        # Senko post rules: merge gap <= 4 s; drop <= 0.78 s; final merge;
        # re-rank by speaking time.
        if len(segments) > 1:
            merged = [segments[0]]
            for seg in segments[1:]:
                prev = merged[-1]
                if seg["speaker"] == prev["speaker"] \
                        and seg["start"] - prev["end"] <= 4.0:
                    prev["end"] = seg["end"]
                else:
                    merged.append(seg)
            segments = merged
        if len(segments) > 1:
            filtered = []
            for i, seg in enumerate(segments):
                if seg["end"] - seg["start"] > 0.78:
                    filtered.append(seg)
                else:
                    prev_spk = filtered[-1]["speaker"] if filtered else None
                    next_spk = segments[i + 1]["speaker"] \
                        if i + 1 < len(segments) else None
                    if prev_spk is not None and prev_spk == next_spk:
                        filtered[-1]["end"] = seg["end"]
            if filtered:
                segments = filtered
        if len(segments) > 1:
            final = [segments[0]]
            for seg in segments[1:]:
                if seg["speaker"] == final[-1]["speaker"]:
                    final[-1]["end"] = seg["end"]
                else:
                    final.append(seg)
            segments = final

        durs = {}
        for seg in segments:
            durs[seg["speaker"]] = durs.get(seg["speaker"], 0) \
                + seg["end"] - seg["start"]
        rerank = {old: new for new, old in enumerate(
            sorted(durs, key=durs.get, reverse=True))}
        for seg in segments:
            seg["speaker"] = rerank[seg["speaker"]]
        if progress_callback:
            progress_callback(100)
        return segments
