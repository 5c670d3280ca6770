# Copied from sherpa_vietnamese_asr_tpu/models/assets.py (host-only; only the package path changes).
# Every loader (load_silero, load_segmentation, load_embedding_split,
# load_campp_asset, load_convtasnet_asset, load_vibert_asset and
# load_dnsmos_asset) returns the port's (state, cfg).
# Central model-asset registry: pinned identities, SHA256 verification,
# discovery, cached loading, and the random-weight policy.
#
# Mirrors the reference's pinned manifest (reference build-portable/
# prepare_offline_build.py:21-242 — every asset carries a source repo,
# revision, and per-file SHA256). Loaders return (params, cfg) pytrees via
# models/onnx_import.py, caching per process the way the reference caches
# ORT sessions across requests (reference core/asr_engine.py:736-893).
#
# Random-weight policy: production entry points (CLI transcribe/serve) must
# refuse to run inference-quality stages on random init unless the caller
# passes allow_random; library defaults warn UNMISTAKABLY (logging.warning +
# one-line stderr) so silent-garbage output is impossible.

from __future__ import annotations

import hashlib
import logging
import os
import sys

logger = logging.getLogger(__name__)

BASE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Pinned per-file SHA256 identities (facts copied from the reference
# manifest, build-portable/prepare_offline_build.py:21-242).
MANIFEST = {
    "zipformer-30m": {
        "local_dir": "zipformer-30m-rnnt-6000h",
        "source": "hf:hynt/Zipformer-30M-RNNT-6000h"
                  "@24ed30248e1c96bb690c81c24ab4e056f8cd9fce",
        "files": {
            "bpe.model": "002894e7a82d80ffa5e25008ec8c5496159db804005e2103"
                         "de96b01b4c13d445",
            "decoder-epoch-20-avg-10.onnx":
                "cf2aa385b82c9d5d40cd29c3188af52d0249b3b78f0d4b7eb84ad502d5"
                "0c7e7f",
            "encoder-epoch-20-avg-10.onnx":
                "b0daa9842a1f39d146e57d6e951edc8910ddd234cbb00e9b5015a5280a"
                "5ba221",
            "joiner-epoch-20-avg-10.onnx":
                "d861afe55f7ff43c90069cad0a5d07261a408be5c7fd2aac8c84b1f322"
                "5da021",
            "tokens.txt": "130879ce6a5814acd33eb06afb4add7551a1e695ad56a817"
                          "51770dd9ed3b0ac9",
        },
    },
    "zipformer-30m-streaming": {
        "local_dir": "zipformer-30m-rnnt-streaming-6000h",
        "source": "hf:hynt/Zipformer-30M-RNNT-Streaming-6000h"
                  "@c122fdc21cea4894fd775e9d3fe66ebbc787e26b",
        "files": {
            "bpe.model": "002894e7a82d80ffa5e25008ec8c5496159db804005e2103"
                         "de96b01b4c13d445",
            "decoder-epoch-31-avg-11-chunk-64-left-128.fp16.onnx":
                "12274189a3ef638905e0d966a4f1ab090c96447f165190c4aa6b8053ac"
                "49b014",
            "encoder-epoch-31-avg-11-chunk-64-left-128.fp16.onnx":
                "6674187064a527bb9447e05a46c99bcc1cd60fa9ed07f477209b332bd8"
                "e64568",
            "joiner-epoch-31-avg-11-chunk-64-left-128.fp16.onnx":
                "54f469ec6841deca336e33808514640be9bc1cb222dedfda312cdb2155"
                "ae37df",
            "tokens.txt": "130879ce6a5814acd33eb06afb4add7551a1e695ad56a817"
                          "51770dd9ed3b0ac9",
        },
    },
    "zipformer-68m": {
        "local_dir": "sherpa-onnx-zipformer-vi-2025-04-20",
        "source": "hf:csukuangfj/sherpa-onnx-zipformer-vi-2025-04-20"
                  "@0fc3fea3ccd9c50b439755fa8a6aba546cb3a7d4",
        "files": {
            "bpe.model": "289dbb44527c13c419ae3a4d8ce6a349f01a97f8777e6993"
                         "4a77e3692d2f10db",
            "decoder-epoch-12-avg-8.onnx":
                "d1d27cca84c824a8acf5ce6edf0f2c0880cfe295d2e69b95134de1707e"
                "1d9998",
            "encoder-epoch-12-avg-8.onnx":
                "d56645616305ceee63a1fa63a4da32e688130e937e67b11f69adf79712"
                "377717",
            "joiner-epoch-12-avg-8.onnx":
                "a186d4ddf04cac3ddfb095dc6e7f705dcd08bd79d4c67334f43c3a7337"
                "bf8d9a",
            "tokens.txt": "f536d03c2e95ebd2930cf0abec88e823bd17d3c1933da7ae"
                          "6a82db3b80605e15",
        },
    },
    "vibert-capu": {
        "local_dir": "vibert-capu",
        "source": "hf:welcomyou/vibert-capu-onnx"
                  "@a7754d037f4a9e29f7f3224f27acb60149eab874",
        "files": {
            "vibert-capu.onnx": "269a59c50977cef010292b1530a77df3073420ff6b"
                                "e409c1a55eeb77a8444e44",
            "vocab.txt": "b32ccb4ca8bee5eda7a0f55f7adebaa515be742c9f765151f"
                         "fefcd29fcb542a1",
            "vocabulary/labels.txt": "a31075cfa185b5d24c3b65c009ad0740636b2"
                                     "86090f78419eaba2d34202c2b45",
            "vocabulary/d_tags.txt": "926596d65d7b928a3d4dfb553c0cd2a8189f8"
                                     "f2ca7cb0ba26cfbb935b5c5dfad",
        },
    },
    "segmentation": {
        "local_dir": "pyannote-onnx",
        "source": "hf:altunenes/speaker-diarization-community-1-onnx"
                  "@e2e09da94ae093a56cd5a60a09b138ae3da1959c",
        "files": {
            "segmentation-community-1.onnx":
                "62d59a487d8ba877d0bd1638c53aa06a810bdb104fb776a27ec2204521"
                "711006",
        },
    },
    "embedding-split": {
        "local_dir": "pyannote-onnx",
        "source": "hf:welcomyou/pyannote-community-1-onnx-split"
                  "@cde44c2db938c8abb755853b9a87cb3179c47803",
        "files": {
            "embedding_encoder.onnx":
                "9903474d6230e5e858dc6b6382a0e3f6e402ea9b4210e1e2f2bee60a33"
                "830e7a",
            "resnet_seg_1_weight.npy":
                "ca91250bb69bea25bdc7c710e253a74450a415b3da587e53e04fd5a01a"
                "bbe4da",
            "resnet_seg_1_bias.npy":
                "51fcb6d0530993ad044a797310f4bfd6af266af0dbf364f6bc0008fdd6"
                "3520cd",
        },
    },
    "plda": {
        "local_dir": "pyannote-onnx",
        "source": "hf:pyannote/speaker-diarization-community-1"
                  "@3533c8cf8e369892e6b79ff1bf80f7b0286a54ee (prepared)",
        "files": {"plda_prepared.npz": None},  # produced locally: no pin
    },
    "campp": {
        "local_dir": "campp-3dspeaker",
        "source": "hf:welcomyou/campplus-3dspeaker-200k-onnx"
                  "@6265ff7af2a104d745b4389026ed9815c6c1c6ff",
        "files": {
            "campplus_cn_en_common_200k.onnx":
                "dd1740aa1e1ffa3895f96aef2166b8af2bb2ad09c00769dd275ee36aef"
                "6a2a7f",
        },
    },
    "silero-vad": {
        "local_dir": "silero-vad",
        "source": "github:snakers4/silero-vad (master data file)",
        "files": {
            "silero_vad_16k_op15.onnx":
                "7ed98ddbad84ccac4cd0aeb3099049280713df825c610a8ed34543318f"
                "1b2c49",
        },
    },
    "convtasnet": {
        "local_dir": "convtasnet-libri2mix-16k",
        "source": "hf:welcomyou/convtasnet-libri2mix-16k-onnx"
                  "@da50e0fa7789356790994bc898290134fef5d42d",
        "files": {
            "convtasnet_16k.onnx":
                "22185d8e13bf5251c0eeab09e52099ac76c063cd9a5e5df1f5c242f535"
                "f6f151",
        },
    },
    "dnsmos": {
        "local_dir": "dnsmos",
        "source": "github:microsoft/DNS-Challenge DNSMOS/sig_bak_ovr.onnx",
        "files": {
            "sig_bak_ovr.onnx":
                "269fbebdb513aa23cddfbb593542ecc540284a91849ac50516870e1ac7"
                "8f6edd",
        },
    },
}

_cache: dict = {}
_warned: set = set()


def models_dir() -> str:
    return os.environ.get("SVT_MODELS_DIR",
                          os.path.join(BASE_DIR, "models"))


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def asset_paths(key: str, verify: bool = True):
    """Resolve all files of an asset; None if any is missing.

    With verify=True a present-but-corrupt file raises ValueError (the
    reference verifies hashes at download time; we verify at load time too
    since assets may arrive by other means).
    """
    spec = MANIFEST[key]
    root = os.path.join(models_dir(), spec["local_dir"])
    out = {}
    for fname, sha in spec["files"].items():
        path = os.path.join(root, fname)
        if not os.path.exists(path):
            return None
        if verify and sha:
            got = sha256_file(path)
            if got != sha:
                raise ValueError(
                    f"asset {key}/{fname}: SHA256 mismatch "
                    f"(got {got[:16]}…, pinned {sha[:16]}…). "
                    f"Re-download via scripts/download_models.py.")
        out[fname] = path
    return out


def warn_random(component: str) -> None:
    """Unmistakable once-per-process warning that a component runs on
    RANDOM weights (output is garbage for real use; fine for tests/bench)."""
    if component in _warned:
        return
    _warned.add(component)
    msg = (f"[svt] WARNING: {component} is running with RANDOM weights — "
           f"no checkpoint found under {models_dir()}. Output is NOT "
           "meaningful. Download assets (scripts/download_models.py) or "
           "set SVT_MODELS_DIR.")
    # stderr print (unmissable, once per process) + a log-record for servers
    # with logging configured; logging alone would double-print via the
    # lastResort stderr handler when unconfigured.
    print(msg, file=sys.stderr)
    if logging.getLogger().handlers or logger.handlers:
        logger.warning(msg)


class RandomWeightError(RuntimeError):
    pass


def require_real_or_allowed(component: str, allow_random: bool) -> None:
    """CLI-grade gate: raise unless real weights exist or explicitly waived."""
    if allow_random:
        warn_random(component)
        return
    raise RandomWeightError(
        f"{component}: no checkpoint found under {models_dir()} and "
        "allow_random is off. Download models "
        "(scripts/download_models.py), set SVT_MODELS_DIR, or pass "
        "--allow-random to accept garbage output (tests/benchmarks only).")


def _cached(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


def load_silero(verify: bool = True):
    """(state, cfg) for models/silero_vad.py, or None if absent."""
    paths = asset_paths("silero-vad", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import (
        load_silero_vad,
    )
    return _cached("silero-vad", lambda: load_silero_vad(
        paths["silero_vad_16k_op15.onnx"]))


def load_segmentation(verify: bool = True):
    paths = asset_paths("segmentation", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_pyannet
    return _cached("segmentation", lambda: load_pyannet(
        paths["segmentation-community-1.onnx"]))


def load_embedding_split(verify: bool = True):
    paths = asset_paths("embedding-split", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import (
        load_resnet_speaker,
    )
    return _cached("embedding-split", lambda: load_resnet_speaker(
        paths["embedding_encoder.onnx"],
        paths["resnet_seg_1_weight.npy"],
        paths["resnet_seg_1_bias.npy"]))


def load_campp_asset(verify: bool = True):
    paths = asset_paths("campp", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_campp
    return _cached("campp", lambda: load_campp(
        paths["campplus_cn_en_common_200k.onnx"]))


def load_convtasnet_asset(verify: bool = True):
    paths = asset_paths("convtasnet", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_convtasnet
    return _cached("convtasnet", lambda: load_convtasnet(
        paths["convtasnet_16k.onnx"]))


def load_vibert_asset(verify: bool = True):
    paths = asset_paths("vibert-capu", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_vibert
    return _cached("vibert-capu", lambda: load_vibert(
        paths["vibert-capu.onnx"]))


def load_dnsmos_asset(verify: bool = True):
    paths = asset_paths("dnsmos", verify)
    if paths is None:
        return None
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_dnsmos
    return _cached("dnsmos", lambda: load_dnsmos(paths["sig_bak_ovr.onnx"]))


def asr_model_dir(key: str = "zipformer-30m"):
    """Directory of an ASR checkpoint set, or None if incomplete."""
    paths = asset_paths(key)
    if paths is None:
        return None
    return os.path.join(models_dir(), MANIFEST[key]["local_dir"])
