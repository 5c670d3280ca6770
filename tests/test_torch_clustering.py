# The port's host clustering of the Senko backend against the JAX package's,
# on the same inputs from a numpy seed:
#   * utils/clustering.py (kNN, the fuzzy simplicial set, UMAP, HDBSCAN) and
#     pipeline/diarization_senko.senko_umap_hdbscan: equal arrays and labels,
#     both packages on their native clusterkit (each builds its own copy of
#     native/clusterkit.cpp) and both on the numpy fallback;
#   * senko_spectral and senko_cluster (spectral and UMAP+HDBSCAN routes):
#     labels equal to the JAX functions';
#   * diarization_pure.kmeans(x, k, n_init=1, seed=0), which senko_spectral
#     runs where the JAX package runs scikit-learn's KMeans(n_clusters=k,
#     random_state=0): labels equal to scikit-learn's on the spectral
#     embeddings senko_spectral gives it (scikit-learn under one OpenMP
#     thread, see kmeans' header).
# Tolerance: none, every array and label is compared for equality.
import numpy as np
import pytest

import sherpa_vietnamese_asr_tpu.utils.clustering as jc
import sherpa_vietnamese_asr_tpu.utils.native as jnative
import sherpa_vietnamese_asr_tpu_torch.utils.clustering as tc
import sherpa_vietnamese_asr_tpu_torch.utils.native as tnative


def _blobs(seed, n_centers=3, per=60, dim=32, sigma=0.08, noise=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = np.concatenate([c + sigma * rng.standard_normal((per, dim)) for c in centers]
                       + [rng.uniform(-1, 1, (noise, dim))])
    return x.astype(np.float32)


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages on their native library, or both on the numpy fallback."""
    if request.param == "native":
        assert jnative.get_clusterkit() is not None
        assert tnative.get_clusterkit() is not None
    else:
        monkeypatch.setattr(jnative, "get_clusterkit", lambda: None)
        monkeypatch.setattr(tnative, "get_clusterkit", lambda: None)
    return request.param


def test_native_library_is_built_under_build():
    lib = tnative.get_clusterkit()
    assert lib is not None
    path = tnative.library_path()
    assert path.startswith(tnative.BUILD_DIR) and path.endswith(".so")


def test_knn_and_fuzzy_set_match_jax():
    x = _blobs(0, noise=20)
    idx, dist = tc.knn(x, 12, block=64)
    idx_j, dist_j = jc.knn(x, 12, block=64)
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(dist, dist_j)
    for got, ref in zip(tc.fuzzy_simplicial_set(idx, dist, len(x)),
                        jc.fuzzy_simplicial_set(idx_j, dist_j, len(x))):
        np.testing.assert_array_equal(got, ref)


def test_umap_matches_jax(route):
    x = _blobs(1, per=50, noise=10)
    got = tc.umap_embed(x, n_neighbors=10, n_components=6)
    ref = jc.umap_embed(x, n_neighbors=10, n_components=6)
    np.testing.assert_array_equal(got, ref)


def test_hdbscan_matches_jax(route):
    rng = np.random.default_rng(2)
    centers = 7.0 * rng.standard_normal((4, 10))
    x = np.concatenate([c + rng.standard_normal((80, 10)) for c in centers]
                       + [20.0 * rng.uniform(-1, 1, (40, 10))])
    got = tc.hdbscan_labels(x, min_samples=15, min_cluster_size=10)
    ref = jc.hdbscan_labels(x, min_samples=15, min_cluster_size=10)
    np.testing.assert_array_equal(got, ref)
    assert len(set(got.tolist()) - {-1}) >= 2


def test_senko_long_audio_route_matches_jax(route):
    from sherpa_vietnamese_asr_tpu.pipeline import diarization_senko as jsenko

    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_senko as tsenko

    x = _blobs(3, n_centers=3, per=70, dim=192, sigma=0.09, noise=4)
    got = tsenko.senko_umap_hdbscan(x, min_samples=10, min_cluster_size=10,
                                    n_neighbors=20, n_components=12)
    ref = jsenko.senko_umap_hdbscan(x, min_samples=10, min_cluster_size=10,
                                    n_neighbors=20, n_components=12)
    np.testing.assert_array_equal(got, ref)
    kw = dict(cluster_type="umap_hdbscan", cluster_line=10, mer_cos=0.875,
              min_cluster_size=10, n_neighbors=40, n_components=60, min_samples=20)
    got = tsenko.senko_cluster(x, **kw)
    np.testing.assert_array_equal(got, jsenko.senko_cluster(x, **kw))
    if route == "native":  # the numpy layout merges these blobs in both packages
        assert len(set(got.tolist())) == 3


@pytest.mark.parametrize("seed,n_centers,sigma", [(4, 2, 0.05), (5, 3, 0.3), (6, 5, 0.6),
                                                  (7, 1, 0.2)])
def test_senko_spectral_and_cluster_match_jax(seed, n_centers, sigma):
    """Blobs from tight to overlapping; the eigengap picks k, the minor
    filter and the merge by cosine act on the spectral labels."""
    from sherpa_vietnamese_asr_tpu.pipeline import diarization_senko as jsenko

    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_senko as tsenko

    x = _blobs(seed, n_centers=n_centers, per=25, dim=32, sigma=sigma, noise=3)
    kw = dict(min_num_spks=1, max_num_spks=15, pval=0.012)
    np.testing.assert_array_equal(tsenko.senko_spectral(x, **kw),
                                  jsenko.senko_spectral(x, **kw))
    np.testing.assert_array_equal(tsenko.senko_spectral(x, oracle_num=2),
                                  jsenko.senko_spectral(x, oracle_num=2))
    for mer_cos in (0.875, 0.99):
        ckw = dict(cluster_type="spectral", cluster_line=10, mer_cos=mer_cos,
                   min_cluster_size=4, **kw)
        np.testing.assert_array_equal(tsenko.senko_cluster(x.copy(), **ckw),
                                      jsenko.senko_cluster(x.copy(), **ckw))
    small = x[:7]
    np.testing.assert_array_equal(tsenko.senko_cluster(small, cluster_type="spectral"),
                                  jsenko.senko_cluster(small, cluster_type="spectral"))


def _spectral_embedding(x, k, pval=0.012, min_pnum=6):
    """The [n, k] eigenvectors senko_spectral hands to k-means."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import cosine_similarity

    n = len(x)
    m = cosine_similarity(x)
    n_elems = max(min(int((1 - pval) * n), n - min_pnum), 0)
    for i in range(n):
        m[i, np.argsort(m[i])[:n_elems]] = 0
    m = 0.5 * (m + m.T)
    np.fill_diagonal(m, 0)
    lap = np.diag(np.abs(m).sum(axis=1)) - m
    return np.linalg.eigh(lap)[1][:, :k]


@pytest.mark.parametrize("seed,n_centers,k,n", [(8, 2, 2, 40), (9, 3, 3, 300),
                                                (10, 4, 6, 120), (11, 3, 2, 600)])
def test_kmeans_one_init_gives_sklearns_labels(seed, n_centers, k, n):
    from sklearn.cluster import KMeans
    from threadpoolctl import threadpool_limits

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import kmeans

    x = _blobs(seed, n_centers=n_centers, per=n // n_centers, dim=24, sigma=0.4)
    vecs = _spectral_embedding(x, k)
    assert vecs.dtype == np.float32
    got = kmeans(vecs, k, n_init=1, seed=0)
    with threadpool_limits(limits=1, user_api="openmp"):
        ref = KMeans(n_clusters=k, random_state=0).fit_predict(vecs)
    np.testing.assert_array_equal(got, ref)
