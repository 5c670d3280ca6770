# The port's diarization checkpoint loaders and host helpers, on the CPU:
#   * load_pyannet and load_resnet_speaker read files written from the
#     upstream module trees of tests/torch_refs.py (TorchPyanNet;
#     TorchResNetSpeaker with randomized BatchNorm statistics, its seg_1
#     projection in the two .npy files) into modules that agree with the
#     torch reference and with the JAX loaders' trees on the same input, the
#     configuration derived from the files; a file whose BatchNorms were
#     folded away by the exporter loads their identity defaults, as the JAX
#     loader does;
#   * the numpy k-means gives scikit-learn's partition on separable data,
#     and scikit-learn's labels on three overlapping Gaussians;
#   * SVT_DIAR_INFLIGHT must be a positive integer; mesh "auto" is None here.
# Models agree within 1e-4 (PyanNet log-probs, absolute) and 1e-4 of the
# reference's largest magnitude (ResNet frame features and embeddings).
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.torch_refs import (  # noqa: E402
    TorchPyanNet,
    TorchResNetSpeaker,
    randomize_bn_stats,
    state_dict_to_onnx,
)

torch.set_num_threads(2)


def _close(got, ref, tol=1e-4):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= tol * float(np.abs(np.asarray(ref)).max()), err


def test_load_pyannet_matches_torch_reference_and_jax(tmp_path):
    from sherpa_vietnamese_asr_tpu.models import onnx_import as joi
    from sherpa_vietnamese_asr_tpu.models.pyannet import pyannet_forward

    from sherpa_vietnamese_asr_tpu_torch.models import convert, onnx_import
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig

    cfg = PyanNetConfig(sinc_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=2,
                        linear_dim=24)
    torch.manual_seed(0)
    ref_model = TorchPyanNet(cfg).eval()
    with torch.no_grad():  # non-trivial affines; the LSTM's two biases are random
        for m in ref_model.sincnet.norm1d:
            m.weight.normal_(1.0, 0.1)
            m.bias.normal_(0.0, 0.1)
    path = tmp_path / "segmentation-community-1.onnx"
    state_dict_to_onnx(ref_model, str(path))

    state, got_cfg = onnx_import.load_pyannet(str(path))
    assert got_cfg == cfg
    assert not state["lstm.bias_hh_l1_reverse"].any()
    model = convert.pyannet_from_numpy(state, got_cfg, device="cpu")
    audio = (np.random.default_rng(0).standard_normal((2, 160000)) * 0.1).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
        want = ref_model(torch.from_numpy(audio)).numpy()
    jparams, jcfg = joi.load_pyannet(str(path))
    ref = np.asarray(pyannet_forward(jparams, jnp.asarray(audio), jcfg))
    assert got.shape == (2, 589, 7)
    assert float(np.abs(got - want).max()) <= 1e-4
    assert float(np.abs(got - ref).max()) <= 1e-4
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def _resnet_files(tmp_path, model, drop_bn=False):
    state = {k: v for k, v in model.state_dict().items()
             if not (drop_bn and (".bn" in k or ".shortcut.1." in k))}

    class _Holder(torch.nn.Module):
        def state_dict(self):
            return state

    enc = tmp_path / "embedding_encoder.onnx"
    state_dict_to_onnx(_Holder(), str(enc))
    w, b = tmp_path / "resnet_seg_1_weight.npy", tmp_path / "resnet_seg_1_bias.npy"
    np.save(w, model.resnet.seg_1.weight.detach().numpy())
    np.save(b, model.resnet.seg_1.bias.detach().numpy())
    return str(enc), str(w), str(b)


@pytest.mark.parametrize("drop_bn", [False, True])
def test_load_resnet_speaker_matches_torch_reference_and_jax(tmp_path, drop_bn):
    from sherpa_vietnamese_asr_tpu.models import onnx_import as joi
    from sherpa_vietnamese_asr_tpu.models.resnet_speaker import (
        project_embedding,
        resnet_frame_features,
    )

    from sherpa_vietnamese_asr_tpu_torch.models import convert, onnx_import
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import ResNetSpeakerConfig

    cfg = ResNetSpeakerConfig(base_channels=8, blocks=(2, 1, 1, 1), embed_dim=24)
    torch.manual_seed(1)
    ref_model = TorchResNetSpeaker(cfg).eval()
    randomize_bn_stats(ref_model, seed=1)
    files = _resnet_files(tmp_path, ref_model, drop_bn)

    state, got_cfg = onnx_import.load_resnet_speaker(*files)
    assert got_cfg == cfg
    jparams, jcfg = joi.load_resnet_speaker(*files)
    assert np.allclose(state["resnet.layer1.1.bn2.running_var"],
                       np.asarray(jparams["stages"][0][1]["bn2"]["var"]))
    if drop_bn:
        assert np.all(state["resnet.layer1.1.bn2.running_var"] == np.float32(1 - 1e-5))
        assert np.all(state["resnet.layer2.0.shortcut.1.weight"] == 1.0)
    model = convert.resnet_from_numpy(state, got_cfg, device="cpu")
    fb = np.random.default_rng(1).standard_normal((2, 300, 80)).astype(np.float32)
    with torch.no_grad():
        got = model.resnet_frame_features(torch.from_numpy(fb))
        stats = torch.cat([got.mean(-1), got.std(-1)], dim=-1)
        emb = model.project_embedding(stats).numpy()
        want = ref_model(torch.from_numpy(fb)).numpy() if not drop_bn else None
    got = got.numpy()
    ref = np.asarray(resnet_frame_features(jparams, jnp.asarray(fb), jcfg))
    assert got.shape == (2, cfg.frame_feature_dim, cfg.out_time(300))
    if want is not None:
        _close(got, want)
    _close(got, ref)
    _close(emb, np.asarray(project_embedding(jparams, jnp.asarray(stats.numpy()))))


def _separable(rng, k, n=40, d=8):
    centres = rng.standard_normal((k, d)) * 5.0
    labels = np.repeat(np.arange(k), n)
    x = centres[labels] + 0.3 * rng.standard_normal((k * n, d))
    order = rng.permutation(len(x))
    return x[order], labels[order]


def _same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("k", [3, 4])
def test_numpy_kmeans_gives_sklearns_partition(k):
    from sklearn.cluster import KMeans

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import kmeans, l2_norm

    x, truth = _separable(np.random.default_rng(k), k)
    x = l2_norm(x).astype(np.float32)  # _cluster runs it on normalised embeddings
    got = kmeans(x, k, n_init=3, seed=42)
    ref = KMeans(n_clusters=k, n_init=3, random_state=42).fit_predict(x)
    assert got.shape == (len(x),) and set(got.tolist()) == set(range(k))
    assert _same_partition(got, ref)
    assert _same_partition(got, truth)


def _overlapping(seed, n, d):
    """Three unit-variance Gaussians whose centres lie on the unit sphere
    (about 1.4 apart), L2-normalised as _cluster normalises embeddings."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import l2_norm

    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((3, d))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    x = np.concatenate([c + rng.standard_normal((n // 3, d)) for c in centres])
    return l2_norm(x[rng.permutation(len(x))])


@pytest.mark.parametrize("n,d,dtype", [(60, 8, np.float32), (240, 16, np.float64),
                                        (600, 32, np.float32)])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_gives_sklearns_labels_on_overlapping_clusters(n, d, dtype, k):
    """KMeans(k, n_init=3, random_state=42) as _cluster's JAX counterpart
    calls it. With more than 256 rows scikit-learn sums clusters in OpenMP
    threads whose merge order is not fixed (kmeans' header); one thread
    gives its deterministic order, which the port reproduces."""
    from sklearn.cluster import KMeans
    from threadpoolctl import threadpool_limits

    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import kmeans

    x = _overlapping(n + d + k, n, d).astype(dtype)
    got = kmeans(x, k, n_init=3, seed=42)
    with threadpool_limits(limits=1, user_api="openmp"):
        ref = KMeans(n_clusters=k, n_init=3, random_state=42).fit_predict(x.copy())
    assert _same_partition(got, ref)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("value", ["0", "-2", "three", "1.5", ""])
def test_svt_diar_inflight_must_be_a_positive_integer(monkeypatch, value):
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNetConfig, random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
        TINY_RESNET,
        random_resnet_speaker,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    monkeypatch.setenv("SVT_DIAR_INFLIGHT", "2")
    assert dp.inflight_depth() == 2
    monkeypatch.delenv("SVT_DIAR_INFLIGHT")
    assert dp.inflight_depth() == 3
    monkeypatch.setenv("SVT_DIAR_INFLIGHT", value)
    with pytest.raises(ValueError, match="SVT_DIAR_INFLIGHT"):
        dp.inflight_depth()
    seg = random_pyannet(PyanNetConfig(sinc_filters=8, conv_channels=6, lstm_hidden=4,
                                       lstm_layers=1, linear_dim=8), device="cpu")
    diar = dp.PureDiarizer(seg_model=seg, emb_model=random_resnet_speaker(
        TINY_RESNET, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="SVT_DIAR_INFLIGHT"):
        diar.process(np.zeros(16000 * 3, np.float32))
    # mesh "auto" is default_mesh(): None on a host without several cards.
    assert diar.mesh is None and diar.replicas == [(diar.seg_model, diar.emb_model)]
    assert dp.PureDiarizer(seg_model=seg, emb_model=diar.emb_model, device="cpu",
                           mesh=None).mesh is None
    assert jax.default_backend() == "cpu"
