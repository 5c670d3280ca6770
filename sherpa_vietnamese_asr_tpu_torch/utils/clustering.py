# Copied from sherpa_vietnamese_asr_tpu/utils/clustering.py (host-only). Only
# the package path of get_clusterkit changes (this package's utils/native.py
# builds its own copy of native/clusterkit.cpp), and the reference path in
# the comment below. The numpy fallbacks stay as they are: they are the
# reference's host behaviour when no compiler is present.
# First-party UMAP + HDBSCAN for the Senko long-audio diarization path.
#
# The reference's >= 20 min clustering route is
#   umap.UMAP(n_neighbors=20, min_dist=0.0, n_components=60) followed by
#   hdbscan.HDBSCAN(min_samples=20, min_cluster_size=10)
# (reference core/speaker_diarization_senko_campp.py:263-281). Neither
# third-party package exists in the target environment, and a PCA+sklearn
# substitute is behaviorally divergent — so this module implements both
# algorithms from their published descriptions:
#
#   * UMAP (McInnes et al. 2018): exact kNN graph, smoothed-kNN fuzzy
#     simplicial set (per-point rho/sigma binary search), probabilistic
#     t-conorm symmetrization, spectral/PCA init, and the SGD cross-entropy
#     layout with negative sampling. The layout loop (the only part that
#     cannot be vectorized) runs in native C++ (native/clusterkit.cpp) with
#     a vectorized numpy fallback; both are deterministic under the pinned
#     seed (the third-party implementation is not reproducible by default).
#   * HDBSCAN (Campello et al. 2013): core distances, mutual-reachability
#     MST (native Prim with numpy fallback), single-linkage dendrogram,
#     condensed tree at min_cluster_size, and excess-of-mass cluster
#     extraction with noise = -1 (allow_single_cluster=False, matching the
#     reference call).
#
# Host-side numpy/C++ on purpose: N is a few thousand embedding windows,
# the shapes are data-dependent, and the work is latency-bound graph
# manipulation — a poor fit for the TPU (SURVEY.md section 2.4 host/device
# split).

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# Shared: blocked exact kNN
# ---------------------------------------------------------------------------

def knn(x, k, block=1024):
    """Exact euclidean kNN. Returns (idx, dist) [N, k], self INCLUDED at
    column 0 (distance 0), matching the graph construction the UMAP
    reference implementation builds on."""
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    k = min(k, n)
    sq = (x * x).sum(1)
    idx = np.empty((n, k), np.int64)
    dist = np.empty((n, k), np.float32)
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (x[s:e] @ x.T)
        np.maximum(d2, 0.0, out=d2)
        # Guarantee the self column survives fp cancellation noise.
        d2[np.arange(e - s), np.arange(s, e)] = -1.0
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx[s:e] = np.take_along_axis(part, order, axis=1)
        dist[s:e] = np.sqrt(np.maximum(
            np.take_along_axis(pd, order, axis=1), 0.0))
    return idx, dist


# ---------------------------------------------------------------------------
# UMAP
# ---------------------------------------------------------------------------

_SMOOTH_K_TOL = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def _smooth_knn_dist(dists, k, n_iter=64, local_connectivity=1.0):
    """Per-point (rho, sigma): rho = distance to the local_connectivity-th
    nonzero neighbor; sigma solves sum_j exp(-max(0, d_j - rho)/sigma) =
    log2(k) by bisection."""
    n = dists.shape[0]
    target = math.log2(k)
    rho = np.zeros(n, np.float32)
    sigma = np.zeros(n, np.float32)
    mean_all = float(dists.mean())
    for i in range(n):
        row = dists[i]
        nz = row[row > 0.0]
        if nz.shape[0] >= local_connectivity:
            li = int(math.floor(local_connectivity))
            frac = local_connectivity - li
            if li > 0:
                rho[i] = nz[li - 1]
                if frac > 0:
                    rho[i] += frac * (nz[li] - nz[li - 1])
            else:
                rho[i] = frac * nz[0]
        elif nz.shape[0] > 0:
            rho[i] = float(nz.max())
        lo, hi, mid = 0.0, np.inf, 1.0
        for _ in range(n_iter):
            psum = float(np.exp(-np.maximum(row[1:] - rho[i], 0.0)
                                / mid).sum())
            if abs(psum - target) < _SMOOTH_K_TOL:
                break
            if psum > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi is np.inf else (lo + hi) / 2.0
        sigma[i] = mid
        if rho[i] > 0.0:
            sigma[i] = max(sigma[i], _MIN_K_DIST_SCALE * float(row.mean()))
        else:
            sigma[i] = max(sigma[i], _MIN_K_DIST_SCALE * mean_all)
    return rho, sigma


def fuzzy_simplicial_set(idx, dist, n):
    """Directed membership strengths -> symmetrized COO
    (B = A + A^T - A o A^T). Returns (rows, cols, vals) with both edge
    orientations present."""
    k = idx.shape[1]
    rho, sigma = _smooth_knn_dist(dist, k)
    w = np.exp(-np.maximum(dist - rho[:, None], 0.0) / sigma[:, None])
    w[dist <= rho[:, None]] = 1.0
    w[:, 0] = 0.0  # no self loops
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1)
    vals = w.reshape(-1).astype(np.float64)
    keep = vals > 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # Symmetrize sparsely: match (i,j) with (j,i) via sorted linear keys.
    key = rows * n + cols
    tkey = cols * n + rows
    order = np.argsort(key, kind="stable")
    key_s, val_s = key[order], vals[order]
    pos = np.searchsorted(key_s, tkey)
    pos = np.clip(pos, 0, len(key_s) - 1)
    hit = key_s[pos] == tkey
    tval = np.where(hit, val_s[pos], 0.0)
    # union of keys: every undirected pair appears for each direction that
    # exists; emit sym value at both orientations, dedup via unique keys.
    sym = vals + tval - vals * tval
    all_key = np.concatenate([key, tkey])
    all_val = np.concatenate([sym, sym])
    all_rows = np.concatenate([rows, cols])
    all_cols = np.concatenate([cols, rows])
    uniq, first = np.unique(all_key, return_index=True)
    del uniq
    return all_rows[first], all_cols[first], all_val[first]


def _fit_ab(min_dist, spread):
    """Least-squares fit of 1/(1 + a x^(2b)) to the target membership curve
    (1 for x < min_dist, exp(-(x - min_dist)/spread) after). Deterministic
    coarse-to-fine grid search (no scipy)."""
    xs = np.linspace(0.0, 3.0 * spread, 300)[1:]
    target = np.where(xs < min_dist, 1.0,
                      np.exp(-(xs - min_dist) / spread))
    a_lo, a_hi, b_lo, b_hi = 0.05, 20.0, 0.2, 3.0
    best = (1.0, 1.0)
    for _ in range(6):
        a_grid = np.geomspace(a_lo, a_hi, 24)
        b_grid = np.linspace(b_lo, b_hi, 24)
        curve = 1.0 / (1.0 + a_grid[:, None, None]
                       * xs[None, None, :] ** (2.0 * b_grid[None, :, None]))
        err = ((curve - target) ** 2).sum(-1)
        ai, bi = np.unravel_index(int(err.argmin()), err.shape)
        best = (float(a_grid[ai]), float(b_grid[bi]))
        a_lo = a_grid[max(ai - 1, 0)]
        a_hi = a_grid[min(ai + 1, len(a_grid) - 1)]
        b_lo = b_grid[max(bi - 1, 0)]
        b_hi = b_grid[min(bi + 1, len(b_grid) - 1)]
    return best


def _make_epochs_per_sample(w, n_epochs):
    out = np.full(w.shape[0], -1.0)
    ns = n_epochs * (w / w.max())
    out[ns > 0] = float(n_epochs) / ns[ns > 0]
    return out


def _init_embedding(x, rows, cols, vals, n_components, seed):
    """Spectral init on the graph Laplacian when a dense eigh is affordable,
    PCA otherwise (documented deviation: the reference implementation falls
    back from sparse spectral to random on failure; PCA is deterministic and
    strictly closer to the spectral target). Scaled to max-abs 10."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n <= 2000 and n_components < n - 1:
        a = np.zeros((n, n), np.float64)
        a[rows, cols] = vals
        deg = a.sum(1)
        dis = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        lap = np.eye(n) - (dis[:, None] * a) * dis[None, :]
        evals, evecs = np.linalg.eigh(lap)
        del evals
        emb = evecs[:, 1:n_components + 1]
    else:
        xc = x - x.mean(0)
        # Deterministic truncated PCA via eigh of the covariance.
        cov = (xc.T @ xc) / max(n - 1, 1)
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1][:n_components]
        emb = xc @ evecs[:, order]
        if emb.shape[1] < n_components:
            emb = np.pad(emb, ((0, 0), (0, n_components - emb.shape[1])))
    emb = emb / max(float(np.abs(emb).max()), 1e-12) * 10.0
    emb = emb + rng.normal(0.0, 1e-4, emb.shape)
    return np.ascontiguousarray(emb, np.float32)


def _layout_numpy(emb, head, tail, eps, n_epochs, a, b, alpha0, neg_rate,
                  seed):
    """Vectorized fallback for the native layout loop. Same schedule and
    gradient formulas; within-epoch updates are batched and aggregated as
    PER-POINT MEANS (a sequential trace applies each clipped gradient to the
    already-moved point, so summing them would overshoot by the point's
    degree and diverge), and the negative-sample RNG differs — documented
    fallback, not bit-identical to clusterkit."""
    n, dim = emb.shape
    rng = np.random.default_rng(seed)
    next_sample = eps.copy()
    next_neg = eps / neg_rate

    def mean_add(acc, cnt, at, g):
        np.add.at(acc, at, g)
        np.add.at(cnt, at, 1.0)

    for epoch in range(n_epochs):
        alpha = alpha0 * (1.0 - epoch / n_epochs)
        act = next_sample <= epoch
        if act.any():
            acc = np.zeros_like(emb)
            cnt = np.zeros(n, np.float64)
            h, t = head[act], tail[act]
            cur, oth = emb[h], emb[t]
            diff = cur - oth
            d2 = (diff * diff).sum(1, keepdims=True)
            coeff = np.where(
                d2 > 0.0,
                (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0), 0.0)
            g = np.clip(coeff * diff, -4.0, 4.0) * alpha
            mean_add(acc, cnt, h, g)
            mean_add(acc, cnt, t, -g)
            next_sample[act] += eps[act]
            eps_neg = eps[act] / neg_rate
            n_neg = ((epoch - next_neg[act]) / eps_neg).astype(np.int64)
            mx = int(n_neg.max()) if n_neg.size else 0
            for s in range(mx):
                m = n_neg > s
                hm = h[m]
                other = rng.integers(0, n, hm.shape[0])
                diffn = emb[hm] - emb[other]
                nd2 = (diffn * diffn).sum(1, keepdims=True)
                coeffn = np.where(
                    nd2 > 0.0,
                    (2.0 * b) / ((0.001 + nd2) * (a * nd2 ** b + 1.0)), 0.0)
                gn = np.where(nd2 > 0.0,
                              np.clip(coeffn * diffn, -4.0, 4.0), 4.0) * alpha
                mean_add(acc, cnt, hm, gn)
            next_neg[act] += n_neg * eps_neg
            emb += acc / np.maximum(cnt, 1.0)[:, None]
    return emb


def umap_embed(x, n_neighbors=20, n_components=2, min_dist=0.0, spread=1.0,
               n_epochs=None, negative_sample_rate=5, initial_alpha=1.0,
               seed=0x5EED):
    """UMAP dimensionality reduction (see module docstring).

    x: [N, D] float; returns [N, n_components] float32. Deterministic for a
    fixed seed."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n <= 2:
        return np.zeros((n, n_components), np.float32)
    n_neighbors = min(n_neighbors, n - 1)
    n_components = min(n_components, max(n - 2, 1))
    idx, dist = knn(x, n_neighbors)
    rows, cols, vals = fuzzy_simplicial_set(idx, dist, n)
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    # Drop edges too weak to ever fire (reference: data < max/n_epochs).
    keep = vals >= vals.max() / n_epochs
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    emb = _init_embedding(x, rows, cols, vals, n_components, seed)
    a, b = _fit_ab(min_dist, spread)
    eps = _make_epochs_per_sample(vals, n_epochs)
    head = rows.astype(np.int32)
    tail = cols.astype(np.int32)
    from sherpa_vietnamese_asr_tpu_torch.utils.native import get_clusterkit
    lib = get_clusterkit()
    if lib is not None:
        import ctypes
        c_f = ctypes.POINTER(ctypes.c_float)
        rc = lib.ck_umap_layout(
            emb.ctypes.data_as(c_f), n, emb.shape[1],
            head.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.ascontiguousarray(eps).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            head.shape[0], int(n_epochs), float(a), float(b),
            float(initial_alpha), int(negative_sample_rate), int(seed) or 1)
        if rc == 0:
            return emb
    return _layout_numpy(emb, head, tail, eps, int(n_epochs), a, b,
                         initial_alpha, negative_sample_rate, seed)


# ---------------------------------------------------------------------------
# HDBSCAN
# ---------------------------------------------------------------------------

def _mr_mst_numpy(x, core):
    """Vectorized Prim over the implicit mutual-reachability graph."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    best = np.full(n, np.inf, np.float64)
    src = np.zeros(n, np.int64)
    in_tree = np.zeros(n, bool)
    in_tree[0] = True
    cur = 0
    edges = np.empty((n - 1, 3), np.float64)
    for t in range(n - 1):
        d = np.sqrt(np.maximum(
            sq[cur] + sq - 2.0 * (x @ x[cur]), 0.0))
        mr = np.maximum(np.maximum(d, core), core[cur])
        upd = mr < best
        best[upd] = mr[upd]
        src[upd] = cur
        masked = np.where(in_tree, np.inf, best)
        pick = int(masked.argmin())
        edges[t] = (src[pick], pick, best[pick])
        in_tree[pick] = True
        cur = pick
    return edges


def _mr_mst(x, core):
    n = x.shape[0]
    from sherpa_vietnamese_asr_tpu_torch.utils.native import get_clusterkit
    lib = get_clusterkit()
    if lib is not None:
        import ctypes
        a = np.empty(n - 1, np.int32)
        b = np.empty(n - 1, np.int32)
        w = np.empty(n - 1, np.float32)
        rc = lib.ck_mr_mst(
            np.ascontiguousarray(x, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            np.ascontiguousarray(core, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            n, x.shape[1],
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc == 0:
            out = np.empty((n - 1, 3), np.float64)
            out[:, 0], out[:, 1], out[:, 2] = a, b, w
            return out
    return _mr_mst_numpy(np.asarray(x, np.float32),
                         np.asarray(core, np.float64))


def _single_linkage(edges, n):
    """Sorted MST edges -> scipy-style linkage rows
    [left, right, dist, size]; new node t gets id n + t."""
    order = np.argsort(edges[:, 2], kind="stable")
    edges = edges[order]
    parent = np.arange(2 * n - 1, dtype=np.int64)
    size = np.ones(2 * n - 1, np.int64)
    # current cluster representative for each union-find root
    rep = np.arange(2 * n - 1, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    linkage = np.empty((n - 1, 4), np.float64)
    for t in range(n - 1):
        a, b, w = int(edges[t, 0]), int(edges[t, 1]), edges[t, 2]
        ra, rb = find(a), find(b)
        ca, cb = rep[ra], rep[rb]
        new = n + t
        linkage[t] = (ca, cb, w, size[ca] + size[cb])
        size[new] = size[ca] + size[cb]
        parent[ra] = new
        parent[rb] = new
        parent[new] = new
        rep[new] = new
    return linkage


def _condense_tree(linkage, n, min_cluster_size):
    """Condensed tree rows (parent, child, lambda, size): clusters keep ids,
    sub-min_cluster_size splits fall out as points."""
    root = 2 * n - 2
    relabel = {root: n}
    next_label = n + 1
    rows = []
    ignore = set()

    def node_points(node):
        out, stack = [], [node]
        while stack:
            v = stack.pop()
            if v < n:
                out.append(v)
            else:
                stack.append(int(linkage[v - n, 0]))
                stack.append(int(linkage[v - n, 1]))
        return out

    for node in range(root, n - 1, -1):
        if node in ignore:
            continue
        left = int(linkage[node - n, 0])
        right = int(linkage[node - n, 1])
        dist = linkage[node - n, 2]
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lsz = int(linkage[left - n, 3]) if left >= n else 1
        rsz = int(linkage[right - n, 3]) if right >= n else 1
        cur = relabel[node]
        for child, csz in ((left, lsz), (right, rsz)):
            if csz >= min_cluster_size:
                continue
            for p in node_points(child):
                rows.append((cur, p, lam, 1))
            if child >= n:
                ignore.update(
                    v for v in node_points_internal(linkage, child, n))
        big = [(c, s) for c, s in ((left, lsz), (right, rsz))
               if s >= min_cluster_size]
        if len(big) == 2:
            for child, csz in big:
                if child >= n:
                    relabel[child] = next_label
                    rows.append((cur, next_label, lam, csz))
                    next_label += 1
                else:  # only reachable when min_cluster_size <= 1
                    rows.append((cur, child, lam, 1))
        elif len(big) == 1:
            child = big[0][0]
            if child >= n:
                relabel[child] = cur
            else:
                rows.append((cur, child, lam, 1))
    return np.array(rows, np.float64)


def node_points_internal(linkage, node, n):
    """All internal-node ids in the subtree under `node` (inclusive)."""
    out, stack = [], [node]
    while stack:
        v = stack.pop()
        if v >= n:
            out.append(v)
            stack.append(int(linkage[v - n, 0]))
            stack.append(int(linkage[v - n, 1]))
    return out


def hdbscan_labels(x, min_samples=20, min_cluster_size=10):
    """HDBSCAN* labels (euclidean, excess-of-mass, no single cluster).
    Noise = -1. Deterministic."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n < 2:
        return np.zeros(n, np.int32)
    ms = min(min_samples, n - 1)
    _, dist = knn(x, ms + 1)
    core = dist[:, ms].astype(np.float64)
    edges = _mr_mst(x, core)
    linkage = _single_linkage(edges, n)
    if min_cluster_size > n:
        return np.full(n, -1, np.int32)
    ct = _condense_tree(linkage, n, min_cluster_size)
    parents = ct[:, 0].astype(np.int64)
    children = ct[:, 1].astype(np.int64)
    lams = ct[:, 2]
    sizes = ct[:, 3]
    cluster_ids = np.unique(parents)
    # birth lambda: lambda at which the cluster split off its parent
    birth = {int(n): 0.0}
    for p, c, lam in zip(parents, children, lams):
        if c >= n:
            birth[int(c)] = lam
    stability = {}
    for cid in cluster_ids:
        m = parents == cid
        stability[int(cid)] = float(
            ((np.minimum(lams[m], np.finfo(np.float64).max)
              - birth[int(cid)]) * sizes[m]).sum())
    # cluster tree edges
    is_cluster_child = children >= n
    tree_parent = parents[is_cluster_child]
    tree_child = children[is_cluster_child]
    kids = {}
    for p, c in zip(tree_parent, tree_child):
        kids.setdefault(int(p), []).append(int(c))
    selected = {}
    for cid in sorted((int(c) for c in cluster_ids), reverse=True):
        ch = kids.get(cid, [])
        sub = sum(stability[c] for c in ch)
        if cid == n:
            selected[cid] = False  # allow_single_cluster=False
            continue
        if ch and sub > stability[cid]:
            stability[cid] = sub
            selected[cid] = False
        else:
            selected[cid] = True
            # deselect all descendants
            stack = list(ch)
            while stack:
                v = stack.pop()
                selected[v] = False
                stack.extend(kids.get(v, []))
    labels = np.full(n, -1, np.int32)
    chosen = sorted(c for c, s in selected.items() if s)
    for li, cid in enumerate(chosen):
        stack = [cid]
        while stack:
            v = stack.pop()
            m = parents == v
            for c in children[m].astype(np.int64):
                if c < n:
                    labels[c] = li
                else:
                    stack.append(int(c))
    return labels
