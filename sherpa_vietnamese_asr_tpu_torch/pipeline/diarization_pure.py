# Production speaker diarization: the pyannote-Community-1 pipeline with its
# model stages on the card.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/diarization_pure.py:
#   sliding 10 s / 1 s windows -> PyanNet powerset logits -> hard binarize ->
#   Inference.aggregate speaker count -> masked-stats-pool ResNet34
#   embeddings (clean-frame preference) -> AHC(centroid, threshold) -> PLDA
#   transform -> VBx EM -> soft centroids -> cosine distances -> per-chunk
#   Hungarian constrained assignment -> cluster canonicalization ->
#   reconstruction -> top-k (capped at 1 = exclusive) binarization ->
#   segments.
#
# The host parts are copied unchanged from the JAX package (Seg, SW, SWF,
# pyannote_aggregate, binarize_scores, the PLDA and VBx functions, process(),
# the speaker count, overlap regions, clustering, canonicalization and
# reconstruction), with one exception: with num_speakers below the number
# of VBx clusters the JAX package runs scikit-learn's KMeans, which the
# card's host does not have; kmeans() below reproduces it in numpy (its
# header says where the two can still differ). The device stages are rewritten in torch: the fused superblock
# (_superblock_body, one upload of the int16 span, PyanNet over in-graph
# overlapped windows, one whole-span fbank through kernel 1 with per-chunk
# CMVN, ResNet34 frame features, masked statistics pooling and the
# projection; only the int8 argmax, the embeddings and the valid mask come
# back), the classic per-window path (_segment / _extract_embeddings) and
# compute_single_embedding. Superblocks keep the JAX package's power-of-two
# window bucketing and zero-padded tail, so every window sees the same
# samples; up to SVT_DIAR_INFLIGHT (default 3) superblocks are enqueued on
# the card ahead of the host. With a mesh (parallel/sharding.py) the file
# is uploaded once to each device and a dispatch is one superblock a
# device, one replica of both models each.

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.linalg import eigh
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist
from scipy.special import logsumexp, softmax

from sherpa_vietnamese_asr_tpu_torch.models import assets, convert, onnx_import
from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, random_pyannet
from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
    ResNetSpeaker,
    random_resnet_speaker,
)
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops
from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool
from sherpa_vietnamese_asr_tpu_torch.parallel import sharding

SAMPLE_RATE = 16000
CHUNK_DURATION = 10.0
CHUNK_STEP = 1.0
CHUNK_SAMPLES = int(CHUNK_DURATION * SAMPLE_RATE)
STEP_SAMPLES = int(CHUNK_STEP * SAMPLE_RATE)
NUM_SEG_FRAMES = 589
MAX_SPEAKERS_PER_CHUNK = 3
RF_START = 0.0
RF_DURATION = 0.0619375
RF_STEP = 0.016875

# Powerset order: silence, singles, pairs (pyannote Powerset,
# max_classes_per_frame=2) — reference pure_ort.py:118-132.
POWERSET_MAP = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, 0, 1], [0, 1, 1],
], dtype=np.float32)

DEFAULT_THRESHOLD = 0.6
DEFAULT_FA = 0.07
DEFAULT_FB = 0.8

# ---------------------------------------------------------------------------
# pyannote.core minimal replicas (sliding-window frame/time mapping)
# ---------------------------------------------------------------------------

class Seg:
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end

    @property
    def duration(self):
        return self.end - self.start

    @property
    def middle(self):
        return 0.5 * (self.start + self.end)

    def __and__(self, other):
        return Seg(max(self.start, other.start), min(self.end, other.end))


class SW:
    """SlidingWindow frame<->time mapping (pyannote.core semantics)."""
    __slots__ = ("start", "duration", "step")

    def __init__(self, start=0.0, duration=0.0, step=0.0):
        self.start, self.duration, self.step = start, duration, step

    def __getitem__(self, i):
        s = self.start + i * self.step
        return Seg(s, s + self.duration)

    def closest_frame(self, t):
        return int(np.rint((t - self.start - 0.5 * self.duration) / self.step))

    def range_to_segment(self, i0, n):
        s = self.start + (i0 - 0.5) * self.step + 0.5 * self.duration
        e = s + n * self.step
        if i0 == 0:
            s = self.start
        return Seg(s, e)

    def crop_loose(self, focus):
        i = int(np.ceil((focus.start - self.duration - self.start) / self.step))
        j = int(np.floor((focus.end - self.start) / self.step))
        return i, j + 1


class SWF:
    """SlidingWindowFeature: array + sliding window."""

    def __init__(self, data, sliding_window):
        self.data = data
        self.sliding_window = sliding_window

    def __iter__(self):
        for i in range(len(self.data)):
            yield self.sliding_window[i], self.data[i]

    def __len__(self):
        return len(self.data)

    @property
    def extent(self):
        return self.sliding_window.range_to_segment(0, len(self.data))

    def crop(self, focus, return_data=True):
        sw = self.sliding_window
        i, j = sw.crop_loose(focus)
        i, j = max(i, 0), min(j, len(self.data))
        if i >= j:
            data = np.empty((0,) + self.data.shape[1:], self.data.dtype)
            return data if return_data else SWF(data, sw)
        data = self.data[i:j]
        if return_data:
            return data
        return SWF(data, SW(start=sw[i].start, duration=sw.duration,
                            step=sw.step))


def pyannote_aggregate(data, chunk_sw, frame_sw, hamming=False,
                       skip_average=False, missing=np.nan,
                       warm_up=(0.0, 0.0)):
    """Exact replica of pyannote Inference.aggregate()
    (reference pure_ort.py:144-196)."""
    scores = SWF(data, chunk_sw)
    frames = SW(start=chunk_sw.start, duration=frame_sw.duration,
                step=frame_sw.step)
    num_chunks, frames_per_chunk, num_classes = data.shape
    eps = 1e-12
    hamming_w = (np.hamming(frames_per_chunk).reshape(-1, 1)
                 if hamming else np.ones((frames_per_chunk, 1)))
    warm_w = np.ones((frames_per_chunk, 1))
    wl = round(warm_up[0] / chunk_sw.duration * frames_per_chunk)
    if wl > 0:
        warm_w[:wl] = eps
    wr = round(warm_up[1] / chunk_sw.duration * frames_per_chunk)
    if wr > 0:
        warm_w[frames_per_chunk - wr:] = eps

    num_frames = frames.closest_frame(
        chunk_sw.start + chunk_sw.duration + (num_chunks - 1) * chunk_sw.step
        + 0.5 * frames.duration) + 1
    out = np.zeros((num_frames, num_classes), np.float32)
    weight = np.zeros((num_frames, num_classes), np.float32)
    seen = np.zeros((num_frames, num_classes), np.float32)
    for chunk, score in scores:
        mask = 1.0 - np.isnan(score).astype(np.float32)
        score = np.nan_to_num(score, nan=0.0)
        f0 = frames.closest_frame(chunk.start + 0.5 * frames.duration)
        n = min(frames_per_chunk, num_frames - f0)
        if n <= 0:
            continue
        w = mask[:n] * hamming_w[:n] * warm_w[:n]
        out[f0: f0 + n] += score[:n] * w
        weight[f0: f0 + n] += w
        seen[f0: f0 + n] = np.maximum(seen[f0: f0 + n], mask[:n])
    result = out if skip_average else out / np.maximum(weight, eps)
    result[seen == 0.0] = missing
    return SWF(result, frames)


def binarize_scores(data, sliding_window, onset=0.5, offset=0.5,
                    min_duration_on=0.0, min_duration_off=0.0):
    """Hysteresis binarization -> [(start, end, class)] sorted by start
    (reference pure_ort.py:211-263)."""
    num_frames, num_classes = data.shape
    timestamps = [sliding_window[i].middle for i in range(num_frames)]
    all_segments = []
    for k in range(num_classes):
        y = data[:, k]
        segs = []
        start = timestamps[0]
        active = y[0] > onset
        t = timestamps[0]
        for t, v in zip(timestamps[1:], y[1:]):
            if active:
                if v < offset:
                    segs.append([start, t])
                    start = t
                    active = False
            elif v > onset:
                start = t
                active = True
        if active:
            segs.append([start, t])
        if min_duration_off > 0.0 and len(segs) > 1:
            merged = [segs[0]]
            for s, e in segs[1:]:
                if s - merged[-1][1] <= min_duration_off:
                    merged[-1][1] = e
                else:
                    merged.append([s, e])
            segs = merged
        if min_duration_on > 0.0:
            segs = [s for s in segs if s[1] - s[0] >= min_duration_on]
        all_segments.extend((s, e, k) for s, e in segs)
    all_segments.sort(key=lambda x: x[0])
    return all_segments


# ---------------------------------------------------------------------------
# PLDA / VBx (host numpy — exact port of the VBx recipe the reference uses)
# ---------------------------------------------------------------------------

def l2_norm(x):
    if x.ndim == 1:
        return x / (np.linalg.norm(x) + 1e-10)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-10)


def prepare_plda(mean1, mean2, lda, plda_mu, plda_tr, plda_psi):
    """Precompute the within/between-class diagonalization
    (reference pure_ort.py:317-339)."""
    w = np.linalg.inv(plda_tr.T @ plda_tr)
    b = np.linalg.inv((plda_tr.T / plda_psi) @ plda_tr)
    acvar, wccn = eigh(b, w)
    return {"mean1": mean1, "mean2": mean2, "lda": lda, "plda_mu": plda_mu,
            "plda_tr": wccn.T[::-1], "plda_psi": acvar[::-1]}


def load_plda(npz_path):
    p = np.load(npz_path)
    if "plda_tr" in p:
        return {"mean1": p["mean1"], "mean2": p["mean2"], "lda": p["lda"],
                "plda_mu": p["mu"], "plda_tr": p["plda_tr"],
                "plda_psi": p["plda_psi"]}
    return prepare_plda(p["mean1"], p["mean2"], p["lda"], p["mu"], p["tr"],
                        p["psi"])


def xvec_transform(embeddings, pd):
    d_out = pd["lda"].shape[1]
    return l2_norm(
        (l2_norm(embeddings - pd["mean1"]) * np.sqrt(pd["lda"].shape[0]))
        @ pd["lda"] - pd["mean2"]) * np.sqrt(d_out)


def plda_transform(embeddings, pd, lda_dim=128):
    return (embeddings - pd["plda_mu"]) @ pd["plda_tr"].T[:, :lda_dim]


def vbx_cluster(fea, plda_psi, ahc_labels, fa, fb, max_iters=20):
    """VBx variational EM (reference pure_ort.py:353-378)."""
    t, d = fea.shape
    n_clusters = int(ahc_labels.max()) + 1
    qinit = np.zeros((t, n_clusters))
    qinit[np.arange(t), ahc_labels.astype(int)] = 1.0
    gamma = softmax(qinit * 7.0, axis=1)
    pi = np.ones(n_clusters) / n_clusters
    g = -0.5 * (np.sum(fea ** 2, axis=1, keepdims=True)
                + d * np.log(2 * np.pi))
    rho = fea * np.sqrt(plda_psi)
    prev_elbo = -np.inf
    for it in range(max_iters):
        inv_l = 1.0 / (1 + fa / fb * gamma.sum(axis=0, keepdims=True).T
                       * plda_psi)
        alpha = fa / fb * inv_l * gamma.T.dot(rho)
        log_p = fa * (rho.dot(alpha.T)
                      - 0.5 * (inv_l + alpha ** 2).dot(plda_psi) + g)
        lpi = np.log(pi + 1e-8)
        log_px = logsumexp(log_p + lpi, axis=-1)
        gamma = np.exp(log_p + lpi - log_px[:, None])
        pi = gamma.sum(axis=0)
        pi = pi / pi.sum()
        elbo = np.sum(log_px) + fb * 0.5 * np.sum(
            np.log(inv_l) - inv_l - alpha ** 2 + 1)
        if it > 0 and elbo - prev_elbo < 1e-4:
            break
        prev_elbo = elbo
    return gamma, pi

_KMEANS_CHUNK = 256  # scikit-learn's Lloyd chunk (CHUNK_SIZE of _k_means_lloyd.pyx)


def _sq_dist(a, b):
    """Squared distances [len(a), len(b)] as scikit-learn's
    _euclidean_distances gives them to k-means++: -2 a.b + |a|^2 + |b|^2,
    floored at 0; float32 rows go through float64 in its blocks of rows
    (_euclidean_distances_upcast) and come back as float32."""
    if a.dtype != np.float32:
        d = -2 * (a @ b.T)
        d += np.einsum("ij,ij->i", a, a)[:, None]
        d += np.einsum("ij,ij->i", b, b)[None, :]
        return np.maximum(d, 0)
    n_a, n_b, dim = len(a), len(b), a.shape[1]
    maxmem = max(((n_a + n_b) * dim + n_a * n_b) / 10, 10 * 2 ** 17)
    batch = max(int((-2 * dim + math.sqrt((2 * dim) ** 2 + 4 * maxmem)) / 2), 1)
    out = np.empty((n_a, n_b), np.float32)
    for i in range(0, n_a, batch):
        a64 = a[i: i + batch].astype(np.float64)
        a_sq = np.einsum("ij,ij->i", a64, a64)[:, None]
        for j in range(0, n_b, batch):
            b64 = b[j: j + batch].astype(np.float64)
            d = -2 * (a64 @ b64.T)
            d += a_sq
            d += np.einsum("ij,ij->i", b64, b64)[None, :]
            out[i: i + batch, j: j + batch] = d
    return np.maximum(out, 0)


def _kmeans_plusplus(x, n_clusters, rs):
    """Greedy k-means++ seeding with 2 + int(log k) local trials a centre,
    drawing from the RandomState `rs` in scikit-learn's order."""
    n = len(x)
    weight = np.ones(n, x.dtype)
    n_trials = 2 + int(np.log(n_clusters))
    centres = np.empty((n_clusters, x.shape[1]), x.dtype)
    centres[0] = x[rs.choice(n, p=weight / weight.sum())]
    closest = _sq_dist(centres[0:1], x)
    pot = closest @ weight
    for c in range(1, n_clusters):
        rand = rs.uniform(size=n_trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(ids, None, closest.size - 1, out=ids)
        cand = np.minimum(closest, _sq_dist(x[ids], x))
        cand_pot = cand @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot, closest = cand_pot[best], cand[best]
        centres[c] = x[ids[best]]
    return centres


def _assign(x, centres):
    """Nearest centre of each row (first on ties): |c|^2 - 2 x.c from the
    same BLAS gemm call scikit-learn's Lloyd step makes, chunk by chunk."""
    from scipy.linalg.blas import get_blas_funcs

    gemm = get_blas_funcs("gemm", (x,))
    c_sq = np.einsum("ij,ij->i", centres, centres)
    labels = np.empty(len(x), np.int32)
    for s in range(0, len(x), _KMEANS_CHUNK):
        xc = x[s: s + _KMEANS_CHUNK]
        d = np.repeat(c_sq[:, None], len(xc), axis=1)  # [k, chunk], column-major C
        d = gemm(-2.0, centres.T, xc.T, 1.0, np.asfortranarray(d), trans_a=1,
                 overwrite_c=1)
        labels[s: s + len(xc)] = d.argmin(axis=0)
    return labels


def _sq_norm_rows(a):
    """scikit-learn's _euclidean_dense_dense(squared=True) on each row:
    four squares a step, summed left to right, added to the running sum."""
    sq = a * a
    n4 = a.shape[1] // 4 * 4
    total = np.zeros(len(a), a.dtype)
    for i in range(0, n4, 4):
        total += ((sq[:, i] + sq[:, i + 1]) + sq[:, i + 2]) + sq[:, i + 3]
    for i in range(n4, a.shape[1]):
        total += sq[:, i]
    return total


def _lloyd(x, centres, max_iter, tol):
    """scikit-learn's _kmeans_single_lloyd: (labels, inertia)."""
    k = len(centres)
    labels_old = np.full(len(x), -1, np.int32)
    strict = False
    for _ in range(max_iter):
        labels = _assign(x, centres)
        new = np.zeros_like(centres)
        np.add.at(new, labels, x)  # row by row, in sample order
        weight = np.bincount(labels, minlength=k).astype(x.dtype)
        empty = np.flatnonzero(weight == 0)
        if len(empty):  # _relocate_empty_clusters_dense
            dist = ((x - centres[labels]) ** 2).sum(axis=1)
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            if dist.max() != 0:
                for new_id, far_id in zip(empty, far):
                    old_id = labels[far_id]
                    new[old_id] -= x[far_id]
                    new[new_id] = x[far_id]
                    weight[new_id] = 1
                    weight[old_id] -= 1
        biggest = np.argmax(weight)  # _average_centers
        for j in range(k):
            if weight[j] > 0:
                new[j] *= x.dtype.type(1.0 / float(weight[j]))
            else:
                new[j] = new[biggest]
        shift = np.sqrt(_sq_norm_rows(new - centres))
        centres = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _assign(x, centres)
    inertia = x.dtype.type(0)
    for d in _sq_norm_rows(x - centres[labels]):
        inertia += d
    return labels, inertia


def _same_clustering(a, b, k):
    mapping = np.full(k, -1)
    for p, q in zip(a, b):
        if mapping[p] == -1:
            mapping[p] = q
        elif mapping[p] != q:
            return False
    return True


def kmeans(x, n_clusters, n_init=3, seed=42, max_iter=300, tol=1e-4):
    """Labels [N] of KMeans(n_clusters, n_init, random_state=seed).fit(x) as
    scikit-learn (1.9) computes them: the rows centred on their mean, in
    x's dtype (float32 stays float32); np.random.RandomState(seed) drives
    every draw; greedy k-means++ seeding (2 + int(log k) local trials a
    centre); Lloyd's iterations until the labels repeat or the centres'
    squared shift is at most tol times the mean per-dimension variance,
    empty clusters refilled from the farthest points, a final relabel; the
    run of least inertia kept unless it is the same partition.

    What remains different: scikit-learn sums each cluster's members and
    the inertia in OpenMP threads, over blocks of rows merged in whatever
    order the threads finish, when x has more than 256 rows. Here they are
    summed row by row in order, as scikit-learn does with one thread. The
    centres can then differ in their last bit, which changes a label only
    where a row sits at an exact tie between two centres."""
    x = np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64)
                 else np.float64)
    tol_abs = np.mean(np.var(x, axis=0)) * tol
    x -= x.mean(axis=0)
    rs = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        labels, inertia = _lloyd(x, _kmeans_plusplus(x, n_clusters, rs),
                                 max_iter, tol_abs)
        if best is None or (inertia < best[0]
                            and not _same_clustering(labels, best[1], n_clusters)):
            best = (inertia, labels)
    return best[1]


def inflight_depth() -> int:
    """Superblocks enqueued on the card ahead of the host: SVT_DIAR_INFLIGHT,
    a positive integer, 3 when unset."""
    raw = os.environ.get("SVT_DIAR_INFLIGHT", "3")
    try:
        depth = int(raw)
    except ValueError:
        depth = 0
    if depth < 1:
        raise ValueError(f"SVT_DIAR_INFLIGHT={raw!r}: expected a positive integer")
    return depth


# ---------------------------------------------------------------------------
# Device stages (torch)
# ---------------------------------------------------------------------------

FRAMES_PER_CHUNK = 998          # 10 s chunk at 10 ms shift minus 2 (knf)
_FB_FRAMES_PER_STEP = STEP_SAMPLES // 160   # 100 fbank frames per 1 s step


def superblock_samples(n_windows: int) -> int:
    """Samples covering n_windows overlapped 10 s / 1 s chunks PLUS the
    fbank frames each chunk needs ((n-1)*100 + 998 frames of 400/160)."""
    need_frames = (n_windows - 1) * _FB_FRAMES_PER_STEP + FRAMES_PER_CHUNK
    fbank_need = (need_frames - 1) * 160 + 400
    seg_need = (n_windows - 1) * STEP_SAMPLES + CHUNK_SAMPLES
    return max(fbank_need, seg_need)

_SB_FBANK = dataclasses.replace(fbank_ops.RESNET_EMB_FBANK, cmvn=False)


@functools.lru_cache(maxsize=8)
def _powerset(device) -> torch.Tensor:
    return torch.from_numpy(POWERSET_MAP).to(device)


def _chunk_fbank(x: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Whole-span fbank once (kernel 1 on the card), then the chunk views
    [W, 998, 80] with per-chunk CMVN."""
    fb_full = fbank_ops.compute_fbank(x, _SB_FBANK)                  # [F_total, 80]
    fb = fb_full.unfold(0, FRAMES_PER_CHUNK, _FB_FRAMES_PER_STEP)[:n_windows]
    fb = fb.transpose(1, 2)                                          # [W, 998, 80]
    return fb - fb.mean(dim=1, keepdim=True)


def _pool_weights(binarized: torch.Tensor, t_feat: int, min_seg_frames: int):
    """Per-speaker pooling weights [W, 3, t_feat] at the frame-feature rate
    from each chunk's own binarization, clean frames (< 2 active speakers)
    preferred when plentiful, and the valid mask [W, 3]."""
    clean = binarized * (binarized.sum(dim=2, keepdim=True) < 2).to(torch.float32)
    use_clean = clean.sum(dim=1) > float(min_seg_frames)              # [W, 3]
    used = torch.where(use_clean[:, None, :], clean, binarized)       # [W, 589, 3]
    valid = used.sum(dim=1) >= 1.0
    feat_idx = torch.clamp(
        torch.arange(t_feat, device=binarized.device) * NUM_SEG_FRAMES // t_feat,
        0, NUM_SEG_FRAMES - 1)
    w = used[:, feat_idx, :].transpose(1, 2)                          # [W, 3, t_feat]
    valid = valid & (w.sum(dim=-1) >= 1.0)
    return w * valid[..., None].to(torch.float32), valid


@torch.no_grad()
def _superblock_body(seg_model: PyanNet, emb_model: ResNetSpeaker,
                     block: torch.Tensor, n_windows: int, min_seg_frames: int,
                     quantized: bool):
    """One superblock: a span of audio covering `n_windows` overlapped
    chunks, segmentation AND speaker embeddings.

    The windows overlap 10x (10 s window, 1 s step), so the span is uploaded
    once (int16 when quantized) and the overlapped views are built on the
    device; only the powerset argmax (int8), the embeddings and the valid
    mask need to come back.

    Returns (powerset_argmax int8 [W, 589], emb [W, 3, D], valid bool [W, 3]).
    Semantics identical to _segment + host masking + _embed_batch.
    """
    x = block.to(torch.float32)
    if quantized:
        x = x / 32768.0
    windows = x.unfold(0, CHUNK_SAMPLES, STEP_SAMPLES)[:n_windows]   # [W, 160000]
    am = seg_model(windows).argmax(dim=-1)                           # [W, 589]
    binarized = _powerset(x.device)[am]                              # [W, 589, 3]
    fb = _chunk_fbank(x, n_windows)
    w, valid = _pool_weights(binarized, emb_model.cfg.out_time(FRAMES_PER_CHUNK),
                             min_seg_frames)
    frame_feat = emb_model.resnet_frame_features(fb)
    emb = emb_model.project_embedding(masked_stats_pool(frame_feat, w))
    return am.to(torch.int8), emb, valid


@torch.no_grad()
def _embed_batch(emb_model: ResNetSpeaker, fbank_windows: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """fbank_windows [B, 998, 80] (already CMVN), weights [B, S, T'] ->
    [B, S, embed_dim]."""
    frame_feat = emb_model.resnet_frame_features(fbank_windows)
    return emb_model.project_embedding(masked_stats_pool(frame_feat, weights))


class PureDiarizer:
    """pyannote-Community-1 replica; see the module comment.

    Models are a PyanNet and a ResNetSpeaker on `device` (the card by
    default; raises without one). Without them, the files of `model_dir`
    (segmentation-community-1.onnx; embedding_encoder.onnx with
    resnet_seg_1_{weight,bias}.npy; plda_prepared.npz), then the asset
    registry, then loudly flagged random weights fill them in. PLDA data is
    a dict from load_plda()/prepare_plda() or None (identity PLDA: the
    xvec/PLDA transforms become identity-like projections).
    """

    def __init__(self, seg_model: PyanNet | None = None,
                 emb_model: ResNetSpeaker | None = None, plda_data=None,
                 threshold=DEFAULT_THRESHOLD, fa=DEFAULT_FA, fb=DEFAULT_FB,
                 min_duration_off=0.0, num_speakers=-1, min_speakers=None,
                 max_speakers=None, segmentation_batch_size=32,
                 embedding_batch_size=64, fused=True, superblock_windows=64,
                 transfer_dtype="int16", model_dir=None, mesh="auto",
                 device="cuda"):
        self.device = model_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        seg_state = emb_state = None
        if model_dir and seg_model is None:
            seg_onnx = os.path.join(model_dir, "segmentation-community-1.onnx")
            if os.path.exists(seg_onnx):
                seg_state = onnx_import.load_pyannet(seg_onnx)
        if model_dir and emb_model is None:
            files = [os.path.join(model_dir, f) for f in (
                "embedding_encoder.onnx", "resnet_seg_1_weight.npy",
                "resnet_seg_1_bias.npy")]
            if all(os.path.exists(p) for p in files):
                emb_state = onnx_import.load_resnet_speaker(*files)
        if model_dir and plda_data is None:
            plda_npz = os.path.join(model_dir, "plda_prepared.npz")
            if os.path.exists(plda_npz):
                plda_data = load_plda(plda_npz)

        # Central asset registry (models/assets.py) before random fallback.
        if seg_model is None and seg_state is None:
            seg_state = assets.load_segmentation()
        if emb_model is None and emb_state is None:
            emb_state = assets.load_embedding_split()
        if plda_data is None:
            plda_paths = assets.asset_paths("plda")
            if plda_paths is not None:
                plda_data = load_plda(plda_paths["plda_prepared.npz"])

        if seg_model is None and seg_state is not None:
            seg_model = convert.pyannet_from_numpy(*seg_state, device=self.device)
        if emb_model is None and emb_state is not None:
            emb_model = convert.resnet_from_numpy(*emb_state, device=self.device)
        if seg_model is None:
            assets.warn_random("diarization segmentation (PyanNet)")
            seg_model = random_pyannet(seed=0, device=self.device)
        if emb_model is None:
            assets.warn_random("speaker embedding (ResNet34)")
            emb_model = random_resnet_speaker(seed=1, device=self.device)
        self.seg_model = seg_model.to(self.device)
        self.emb_model = emb_model.to(self.device)
        # mesh "auto": every card of a multi-card host, else None (one
        # device); the fused path runs one superblock a mesh device.
        self.mesh = sharding.resolve(mesh)
        self.replicas = list(zip(sharding.replicate(self.seg_model, self.mesh),
                                 sharding.replicate(self.emb_model, self.mesh)))
        self.seg_cfg = seg_model.cfg
        self.emb_cfg = emb_model.cfg
        self.plda_data = plda_data
        self.threshold = threshold
        self.fa, self.fb = fa, fb
        self.min_duration_off = min_duration_off
        self.num_speakers = num_speakers
        self.min_speakers = min_speakers
        self.max_speakers = max_speakers
        self.segmentation_batch_size = segmentation_batch_size
        self.embedding_batch_size = embedding_batch_size
        # Fused superblock path: upload each audio span once, build the 10x
        # overlapped seg/embedding views on the device (_superblock_body).
        self.fused = fused
        self.superblock_windows = superblock_windows
        self.transfer_dtype = transfer_dtype
        self.speaker_centroids = None
        self._last_overlap_regions = []

    # -- public API --------------------------------------------------------
    @property
    def overlap_regions(self):
        return list(self._last_overlap_regions)

    def process(self, audio, progress_callback=None):
        """audio: float32 [L] @16 kHz -> [{'start','end','speaker'}]."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        duration = len(audio) / SAMPLE_RATE

        if self.fused:
            binarized, chunk_starts, embeddings = \
                self._segment_and_embed_fused(audio, progress_callback)
            num_chunks, num_seg_frames = binarized.shape[:2]
            self._last_overlap_regions = self._extract_overlap_regions(
                binarized, chunk_starts, num_seg_frames, duration)
            count = self._speaker_count(binarized)
        else:
            seg_logits, chunk_starts = self._segment(audio,
                                                     progress_callback)
            num_chunks, num_seg_frames = seg_logits.shape[:2]

            binarized = POWERSET_MAP[np.argmax(seg_logits, axis=-1)]
            del seg_logits
            self._last_overlap_regions = self._extract_overlap_regions(
                binarized, chunk_starts, num_seg_frames, duration)

            count = self._speaker_count(binarized)

            clean_frames = (binarized.sum(axis=2, keepdims=True)
                            < 2).astype(np.float32)
            clean_binarized = binarized * clean_frames
            emb_min_num_samples = 1680
            min_seg_frames = math.ceil(
                num_seg_frames * emb_min_num_samples / CHUNK_SAMPLES)
            embeddings = self._extract_embeddings(
                audio, binarized, clean_binarized, chunk_starts,
                min_seg_frames, progress_callback)

        single = (binarized.sum(axis=2, keepdims=True) == 1).astype(np.float32)
        num_clean = (binarized * single).sum(axis=1)
        train_mask = (num_clean >= 0.2 * num_seg_frames) \
            & ~np.isnan(embeddings[:, :, 0])

        max_cl = None
        if self.num_speakers > 0:
            max_cl = self.num_speakers
        elif self.max_speakers is not None:
            max_cl = self.max_speakers
        hard_clusters = self._cluster(embeddings, train_mask, binarized,
                                      max_clusters=max_cl)

        inactive = np.sum(binarized, axis=1) == 0
        hard_clusters[inactive] = -2
        hard_clusters, remap = self._canonicalize_clusters(hard_clusters,
                                                           binarized)
        if self.speaker_centroids is not None and remap:
            re = np.zeros_like(self.speaker_centroids)
            for old, new in remap.items():
                if old < self.speaker_centroids.shape[0] and new < re.shape[0]:
                    re[new] = self.speaker_centroids[old]
            self.speaker_centroids = re

        num_detected = int(hard_clusters.max()) + 1
        count.data = np.minimum(count.data, num_detected).astype(np.int8)
        count.data = np.minimum(count.data, 1).astype(np.int8)  # exclusive

        segments = self._reconstruct_and_diarize(
            binarized, hard_clusters, count, num_chunks, num_seg_frames)

        if self.min_duration_off > 0 and len(segments) > 1:
            merged = [segments[0]]
            for seg in segments[1:]:
                if (seg["speaker"] == merged[-1]["speaker"]
                        and seg["start"] - merged[-1]["end"]
                        <= self.min_duration_off):
                    merged[-1]["end"] = seg["end"]
                else:
                    merged.append(seg)
            segments = merged
        return segments

    # -- stages -------------------------------------------------------------
    def _window_starts(self, total_samples):
        """pyannote Inference.slide(): include last partial (zero-padded)
        chunk (reference pure_ort.py:709-726)."""
        duration = total_samples / SAMPLE_RATE
        starts, s = [], 0
        while True:
            starts.append(s)
            if (s + CHUNK_SAMPLES) / SAMPLE_RATE > duration:
                break
            s += STEP_SAMPLES
        return starts

    def _segment_and_embed_fused(self, audio, progress_callback=None):
        """Superblock pipeline: the file uploaded once, then per span of
        `superblock_windows` chunks one _superblock_body. Returns
        (binarized [N, 589, 3], chunk_starts, embeddings [N, 3, D] with NaN
        rows for invalid (inactive) chunk-speakers)."""
        total = len(audio)
        starts = self._window_starts(total)
        n = len(starts)
        # Power-of-two bucketing keeps the shapes few while short files
        # don't pay for a full-width superblock.
        w = 4
        while w < min(self.superblock_windows, n):
            w *= 2
        w = min(w, self.superblock_windows)
        sb_len = superblock_samples(w)
        quantized = self.transfer_dtype == "int16"
        if quantized:
            host_audio = np.clip(np.rint(np.asarray(audio, np.float32)
                                         * 32768.0), -32768, 32767
                                 ).astype(np.int16)
        else:
            host_audio = np.asarray(audio, np.float32)
        min_seg_frames = math.ceil(
            NUM_SEG_FRAMES * 1680 / CHUNK_SAMPLES)
        am_out = np.empty((n, NUM_SEG_FRAMES), np.int8)
        emb_out = np.full((n, MAX_SPEAKERS_PER_CHUNK,
                           self.emb_cfg.embed_dim), np.nan, np.float32)
        block_starts = list(range(0, n, w))
        # Every span at its full length, the tail zero-padded as the JAX
        # package builds each block, so every window sees the same samples.
        host = np.zeros(starts[block_starts[-1]] + sb_len, host_audio.dtype)
        take = min(total, len(host))
        host[:take] = host_audio[:take]
        samples = torch.from_numpy(host)
        devices = list(self.mesh.devices) if self.mesh else [self.device]
        if any(d.type == "cuda" for d in devices):
            samples = samples.pin_memory()
        # The file once on each distinct device.
        on_device = {d: samples.to(d, non_blocking=True) for d in dict.fromkeys(devices)}

        def drain(group):
            for b, outs, event in group:
                if event is not None:
                    event.synchronize()
                am, emb, valid = (t.numpy() for t in outs)
                take = min(w, n - b)
                am_out[b: b + take] = am[:take]
                sel = valid[:take]
                emb_out[b: b + take][sel] = emb[:take][sel]
            if progress_callback:
                progress_callback(int(min(group[-1][0] + w, n) / n * 85), 100)

        # Up to `depth` groups (a superblock a device) enqueued ahead of the
        # host: the next span's launches and the previous span's download
        # ride under device compute instead of a round trip per block.
        depth = inflight_depth()
        inflight = []
        for g in range(0, len(block_starts), len(devices)):
            group = []
            for b, dev, (seg, emb) in zip(block_starts[g: g + len(devices)], devices,
                                          self.replicas):
                s0 = starts[b]
                with sharding.device_scope(dev):
                    outs = _superblock_body(seg, emb, on_device[dev][s0: s0 + sb_len], w,
                                            min_seg_frames, quantized)
                    event = None
                    if dev.type == "cuda":
                        outs = tuple(t.to("cpu", non_blocking=True) for t in outs)
                        event = torch.cuda.Event()
                        event.record()
                group.append((b, outs, event))
            inflight.append(group)
            if len(inflight) >= depth:
                drain(inflight.pop(0))
        while inflight:
            drain(inflight.pop(0))
        binarized = POWERSET_MAP[am_out]
        return binarized, starts, emb_out

    @torch.no_grad()
    def _segment(self, audio, progress_callback=None):
        total = len(audio)
        starts = self._window_starts(total)
        bsz = self.segmentation_batch_size
        out = []
        for b in range(0, len(starts), bsz):
            group = starts[b: b + bsz]
            batch = np.zeros((bsz, CHUNK_SAMPLES), np.float32)
            for i, s in enumerate(group):
                e = min(s + CHUNK_SAMPLES, total)
                batch[i, : e - s] = audio[s:e]
            logits = self.seg_model(
                torch.from_numpy(batch).to(self.device)).cpu().numpy()
            out.append(logits[: len(group)])
            if progress_callback:
                progress_callback(int(min(b + bsz, len(starts))
                                      / len(starts) * 25), 100)
        return np.concatenate(out, axis=0), starts

    def _speaker_count(self, binarized):
        chunk_sw = SW(0.0, CHUNK_DURATION, CHUNK_STEP)
        frame_sw = SW(RF_START, RF_DURATION, RF_STEP)
        count = pyannote_aggregate(
            binarized.sum(axis=-1, keepdims=True), chunk_sw, frame_sw,
            hamming=False, skip_average=False, missing=0.0,
            warm_up=(0.0, 0.0))
        count.data = np.rint(count.data).astype(np.uint8)
        return count

    def _extract_overlap_regions(self, binarized, chunk_starts,
                                 num_seg_frames, duration, min_duration=0.3):
        """(start, end) spans where >= 2 speakers are active
        (reference pure_ort.py:512-552)."""
        frame_dur = CHUNK_DURATION / num_seg_frames
        n_out = int(duration / frame_dur) + 1
        overlap = np.zeros(n_out, np.float32)
        total = np.zeros(n_out, np.float32)
        frame_offsets = (np.arange(num_seg_frames) * frame_dur)
        for c, cs in enumerate(chunk_starts):
            t0 = cs / SAMPLE_RATE
            sums = binarized[c].sum(axis=-1)
            out_f = ((t0 + frame_offsets) / frame_dur).astype(int)
            valid = (out_f >= 0) & (out_f < n_out)
            np.add.at(total, out_f[valid], 1.0)
            np.add.at(overlap, out_f[valid], (sums[valid] >= 2).astype(
                np.float32))
        prob = np.where(total > 0, overlap / np.maximum(total, 1), 0.0)
        active = prob > 0.5
        regions, in_reg, start_t = [], False, 0.0
        for f, a in enumerate(active):
            t = f * frame_dur
            if a and not in_reg:
                start_t, in_reg = t, True
            elif not a and in_reg:
                if t - start_t >= min_duration:
                    regions.append((start_t, min(t, duration)))
                in_reg = False
        if in_reg:
            t = len(active) * frame_dur
            if t - start_t >= min_duration:
                regions.append((start_t, min(t, duration)))
        return regions

    def _extract_embeddings(self, audio, binarized, clean_binarized,
                            chunk_starts, min_seg_frames, progress_callback):
        num_chunks = binarized.shape[0]
        num_seg_frames = binarized.shape[1]
        frames_per_chunk = int(CHUNK_DURATION * 1000 / 10) - 2  # 998

        # Whole-audio fbank once (zero-padded by one chunk like the
        # reference), CMVN over the whole file.
        padded = np.concatenate([np.asarray(audio, np.float32),
                                 np.zeros(CHUNK_SAMPLES, np.float32)])
        with torch.no_grad():
            full_fbank = fbank_ops.compute_fbank(
                torch.from_numpy(padded).to(self.device),
                fbank_ops.RESNET_EMB_FBANK).cpu().numpy()
        n_total = full_fbank.shape[0]
        shift = int(SAMPLE_RATE * 0.01)

        # Frame-feature time subsampling: encoder downsamples time by 8.
        t_feat = None
        embeddings = np.full((num_chunks, MAX_SPEAKERS_PER_CHUNK,
                              self.emb_cfg.embed_dim), np.nan, np.float32)
        bsz = self.embedding_batch_size
        for b in range(0, num_chunks, bsz):
            group = list(range(b, min(b + bsz, num_chunks)))
            fb = np.zeros((bsz, frames_per_chunk, 80), np.float32)
            for i, c in enumerate(group):
                f0 = chunk_starts[c] // shift
                f1 = min(f0 + frames_per_chunk, n_total)
                if f1 > f0:
                    fb[i, : f1 - f0] = full_fbank[f0:f1]
                fb[i] -= fb[i].mean(axis=0, keepdims=True)
            if t_feat is None:
                t_feat = self.emb_cfg.out_time(frames_per_chunk)
                feat_idx = np.clip(
                    np.floor(np.arange(t_feat) * num_seg_frames / t_feat
                             ).astype(int), 0, num_seg_frames - 1)
            # Per-speaker weights at frame-feature rate; clean-mask preferred.
            weights = np.zeros((bsz, MAX_SPEAKERS_PER_CHUNK, t_feat),
                               np.float32)
            valid = np.zeros((bsz, MAX_SPEAKERS_PER_CHUNK), bool)
            for i, c in enumerate(group):
                for s in range(MAX_SPEAKERS_PER_CHUNK):
                    mask = binarized[c, :, s]
                    cm = clean_binarized[c, :, s]
                    used = cm if cm.sum() > min_seg_frames else mask
                    if used.sum() < 1:
                        continue
                    w = used[feat_idx].astype(np.float32)
                    if w.sum() < 1:  # match reference mfb.shape[0] < 9 guard
                        continue
                    weights[i, s] = w
                    valid[i, s] = True
            emb = _embed_batch(
                self.emb_model, torch.from_numpy(fb).to(self.device),
                torch.from_numpy(weights).to(self.device)).cpu().numpy()
            for i, c in enumerate(group):
                for s in range(MAX_SPEAKERS_PER_CHUNK):
                    if valid[i, s]:
                        embeddings[c, s] = emb[i, s]
            if progress_callback:
                progress_callback(25 + int(min(b + bsz, num_chunks)
                                           / num_chunks * 60), 100)
        return embeddings

    def _identity_plda(self, dim):
        """Fallback PLDA when no checkpoint is present: identity transforms
        (keeps the clustering path exercisable with random weights)."""
        lda_dim = min(dim, 128)
        eye = np.eye(dim, lda_dim).astype(np.float32)
        return {"mean1": np.zeros(dim, np.float32),
                "mean2": np.zeros(lda_dim, np.float32),
                "lda": eye,
                "plda_mu": np.zeros(lda_dim, np.float32),
                "plda_tr": np.eye(lda_dim, dtype=np.float32),
                "plda_psi": np.ones(lda_dim, np.float32)}

    def _cluster(self, all_embeddings, train_mask, segmentations,
                 max_clusters=None):
        num_chunks, num_speakers, dim = all_embeddings.shape
        train_emb = all_embeddings[train_mask]
        if len(train_emb) < 2:
            return np.zeros((num_chunks, num_speakers), np.int8)

        train_normed = l2_norm(train_emb)
        dendrogram = linkage(train_normed, method="centroid",
                             metric="euclidean")
        ahc = fcluster(dendrogram, self.threshold, criterion="distance") - 1
        _, ahc = np.unique(ahc, return_inverse=True)

        pd = self.plda_data or self._identity_plda(dim)
        emb_tf = xvec_transform(train_emb, pd)
        emb_plda = plda_transform(emb_tf, pd)
        gamma, pi = vbx_cluster(emb_plda, pd["plda_psi"][:emb_plda.shape[1]],
                                ahc, fa=self.fa, fb=self.fb)

        active = np.where(pi > 1e-7)[0]
        if len(active) == 0:
            active = np.array([0])
        w = gamma[:, active]
        centroids = (w.T @ train_emb) / (w.sum(axis=0, keepdims=True).T + 1e-8)

        if max_clusters and centroids.shape[0] > max_clusters:
            labels = kmeans(train_normed, max_clusters, n_init=3, seed=42)
            centroids = np.vstack([
                train_emb[labels == k].mean(axis=0)
                for k in range(max_clusters)])

        self.speaker_centroids = centroids.copy()

        flat = all_embeddings.reshape(-1, dim)
        # Invalid chunk-speakers carry NaN embeddings (below min_seg_frames
        # in the superblock path); zero-filling them made cosine cdist emit
        # NaN (0/0 norm) which crashed linear_sum_assignment below. Pin every
        # non-finite/zero-norm row to the max cosine distance instead — the
        # slot competes as "least similar to every centroid", and inactive
        # slots are overwritten by the `const` mask right after anyway.
        invalid = ~np.isfinite(flat).all(axis=1)
        dist = cdist(np.nan_to_num(flat, nan=0.0), centroids,
                     metric="cosine")
        dist[invalid] = 2.0
        np.nan_to_num(dist, nan=2.0, copy=False)
        soft = (2.0 - dist).reshape(num_chunks, num_speakers, -1)
        const = soft.min() - 1.0
        soft[segmentations.sum(axis=1) == 0] = const

        hard = -2 * np.ones((num_chunks, num_speakers), np.int8)
        for c, cost in enumerate(soft):
            speakers, clusters = linear_sum_assignment(cost, maximize=True)
            for s, k in zip(speakers, clusters):
                hard[c, s] = k
        return hard

    def _canonicalize_clusters(self, hard_clusters, activities):
        """Deterministic relabel by first active (chunk, frame, slot)
        (reference pure_ort.py:881-902)."""
        output = np.full_like(hard_clusters, -2)
        ids = sorted(int(k) for k in np.unique(hard_clusters) if k >= 0)
        keys = []
        for cid in ids:
            first = (10 ** 9, 10 ** 9, 10 ** 9)
            for c, s in np.argwhere(hard_clusters == cid):
                frames = np.flatnonzero(activities[c, :, s] > 0)
                if frames.size:
                    cand = (int(c), int(frames[0]), int(s))
                    if cand < first:
                        first = cand
            keys.append((first, cid))
        remap = {old: new for new, (_, old) in enumerate(sorted(keys))}
        for old, new in remap.items():
            output[hard_clusters == old] = new
        return output, remap

    def _reconstruct_and_diarize(self, activities, hard_clusters, count_swf,
                                 num_chunks, num_seg_frames):
        num_clusters = int(hard_clusters.max()) + 1
        if num_clusters <= 0:
            return []
        chunk_sw = SW(0.0, CHUNK_DURATION, CHUNK_STEP)
        frame_sw = SW(RF_START, RF_DURATION, RF_STEP)

        clustered = np.full((num_chunks, num_seg_frames, num_clusters),
                            np.nan, np.float32)
        for c in range(num_chunks):
            seg = activities[c]
            for k in np.unique(hard_clusters[c]):
                if k == -2:
                    continue
                sel = seg[:, hard_clusters[c] == k]
                clustered[c, :, k] = (sel.max(axis=1) if sel.ndim > 1
                                      else sel.ravel())

        activations = pyannote_aggregate(
            clustered, chunk_sw, frame_sw, hamming=False, skip_average=True,
            missing=0.0, warm_up=(0.0, 0.0))

        n_spk = activations.data.shape[1]
        max_spk = int(np.max(count_swf.data))
        if n_spk < max_spk:
            activations.data = np.pad(activations.data,
                                      ((0, 0), (0, max_spk - n_spk)))

        extent = activations.extent & count_swf.extent
        activations = activations.crop(extent, return_data=False)
        count_crop = count_swf.crop(extent, return_data=False)

        order = np.argsort(-activations.data, axis=-1)
        binary = np.zeros_like(activations.data)
        for t, ((_, c), speakers) in enumerate(zip(count_crop, order)):
            for i in range(min(int(c.item()), 1)):
                binary[t, speakers[i]] = 1.0

        raw = binarize_scores(binary, activations.sliding_window,
                              onset=0.5, offset=0.5, min_duration_on=0.0,
                              min_duration_off=self.min_duration_off)
        segments, speaker_map = [], {}
        for start, end, spk in raw:
            if spk not in speaker_map:
                speaker_map[spk] = len(speaker_map)
            segments.append({"start": round(start, 4), "end": round(end, 4),
                             "speaker": speaker_map[spk]})
        segments.sort(key=lambda s: s["start"])

        if self.speaker_centroids is not None and speaker_map:
            inv = {v: k for k, v in speaker_map.items()}
            re = np.zeros((len(speaker_map),
                           self.speaker_centroids.shape[1]), np.float32)
            for new_id, old_id in inv.items():
                if old_id < self.speaker_centroids.shape[0]:
                    re[new_id] = self.speaker_centroids[old_id]
            self.speaker_centroids = re
        return segments

    def compute_single_embedding(self, audio_segment):
        """Embedding of one short segment (gap-word verification,
        reference pure_ort.py:681-707). None if < ~0.1 s of frames."""
        cfg = fbank_ops.RESNET_EMB_FBANK
        audio_segment = np.asarray(audio_segment, np.float32)
        nf = fbank_ops.num_frames(len(audio_segment), cfg)
        if nf < 9:
            return None
        with torch.no_grad():
            fb = fbank_ops.compute_fbank(
                torch.from_numpy(audio_segment).to(self.device), cfg).cpu().numpy()
        # Fixed 998-frame bucket; mask the padding.
        frames_per_chunk = int(CHUNK_DURATION * 1000 / 10) - 2
        valid = min(fb.shape[0], frames_per_chunk)
        fb_pad = np.zeros((1, frames_per_chunk, fb.shape[1]), np.float32)
        fb_pad[0, :valid] = fb[:valid]
        t_feat = self.emb_cfg.out_time(frames_per_chunk)
        t_valid = max(1, self.emb_cfg.out_time(valid))
        weights = np.zeros((1, 1, t_feat), np.float32)
        weights[0, 0, :t_valid] = 1.0
        emb = _embed_batch(
            self.emb_model, torch.from_numpy(fb_pad).to(self.device),
            torch.from_numpy(weights).to(self.device)).cpu().numpy()
        return emb[0, 0]
