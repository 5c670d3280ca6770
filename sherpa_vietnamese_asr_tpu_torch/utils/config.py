# Copied from sherpa_vietnamese_asr_tpu/utils/config.py (pure Python; only the package path changes).
# Framework configuration: model registry, hotword preparation, pipeline
# config defaults and validation.
#
# Behavioral port of the relevant parts of reference core/config.py:
#   * MODEL_DOWNLOAD_INFO registry (:221-253) — pinned model identities;
#   * ensure_bpe_vocab / prepare_hotwords_file / get_hotwords_config
#     (:283-414) — using the pure-Python BPE (utils/bpe.py) instead of the
#     sentencepiece C++ module;
#   * the pipeline config-dict contract (reference asr_engine.py:1979-2012).
# CPU-thread tuning tables (:182-219) have no TPU analogue — batching and
# sharding replace them (SURVEY.md section 2.5) — so they are documented but
# not ported.

from __future__ import annotations

import os

BASE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MODEL_DOWNLOAD_INFO = {
    "sherpa-onnx-zipformer-vi-2025-04-20": {
        "name": "Sherpa-ONNX Zipformer Vietnamese",
        "hf_url": "https://huggingface.co/csukuangfj/"
                  "sherpa-onnx-zipformer-vi-2025-04-20",
        "description": "Primary Vietnamese ASR model (68M)",
        "files": ["encoder-epoch-12-avg-8.onnx",
                  "decoder-epoch-12-avg-8.onnx",
                  "joiner-epoch-12-avg-8.onnx"],
    },
    "zipformer-30m-rnnt-6000h": {
        "name": "Zipformer-30M-RNNT-6000h",
        "hf_url": "https://huggingface.co/hynt/Zipformer-30M-RNNT-6000h",
        "description": "Light/fast Vietnamese ASR model",
        "files": ["encoder-epoch-20-avg-10.onnx",
                  "decoder-epoch-20-avg-10.onnx",
                  "joiner-epoch-20-avg-10.onnx"],
    },
    "zipformer-30m-rnnt-streaming-6000h": {
        "name": "Zipformer-30M-RNNT-Streaming-6000h",
        "hf_url": "https://huggingface.co/hynt/"
                  "Zipformer-30M-RNNT-Streaming-6000h",
        "description": "Streaming ASR (chunk 64) for live recording",
        "files": ["encoder-epoch-31-avg-11-chunk-64-left-128.fp16.onnx",
                  "decoder-epoch-31-avg-11-chunk-64-left-128.fp16.onnx",
                  "joiner-epoch-31-avg-11-chunk-64-left-128.fp16.onnx"],
    },
    "vibert-capu": {
        "name": "ViBERT-capu",
        "hf_url": "https://huggingface.co/dragonSwing/vibert-capu",
        "description": "Vietnamese punctuation/capitalization model",
        "files": ["vibert-capu.onnx"],
    },
}

# Pipeline config keys accepted by TranscriberPipeline, with defaults and
# bounds (reference asr_engine.py:1979-2012 + web_service validation).
PIPELINE_CONFIG_SPEC = {
    "bypass_vad": (bool, False),
    "skip_preprocessing": (bool, False),
    "preprocess_rms_normalize": (bool, False),
    "preprocess_wpe": (bool, False),
    "restore_punctuation": (bool, False),
    "bypass_restorer": (bool, False),
    "punctuation_confidence": (float, 0.3, 0.0, 1.0),
    "case_confidence": (float, -1.0, -1.0, 1.0),
    "speaker_diarization": (bool, False),
    "speaker_model": (str, "pure_ort"),
    "num_speakers": (int, 0, 0, 32),
    "diarization_threshold": (float, 0.6, 0.0, 1.0),
    "overlap_separation": (bool, False),
    "rover_mode": (bool, False),
    "save_ram": (bool, False),
    "max_batch": (int, 8, 0, 128),  # 0 = auto (calibration autotune/HBM)
    "hotwords_file": (str, ""),
    "hotwords_score": (float, 1.5, 0.0, 10.0),
    "hotword_phrases": (list, None),
}


def validate_config(config):
    """Clamp/convert config values per PIPELINE_CONFIG_SPEC; unknown keys
    pass through untouched."""
    out = dict(config or {})
    for key, spec in PIPELINE_CONFIG_SPEC.items():
        if key not in out or out[key] is None:
            continue
        typ = spec[0]
        try:
            if typ is bool:
                out[key] = bool(out[key])
            elif typ is int:
                out[key] = int(out[key])
                if len(spec) > 2:
                    out[key] = max(spec[2], min(spec[3], out[key]))
            elif typ is float:
                out[key] = float(out[key])
                if len(spec) > 2:
                    out[key] = max(spec[2], min(spec[3], out[key]))
        except (TypeError, ValueError):
            out[key] = spec[1]
    return out


def ensure_bpe_vocab(model_path):
    """Generate bpe.vocab from bpe.model if missing (config.py:283-330)."""
    from sherpa_vietnamese_asr_tpu_torch.utils.bpe import BpeModel

    bpe_model = os.path.join(model_path, "bpe.model")
    bpe_vocab = os.path.join(model_path, "bpe.vocab")
    if os.path.exists(bpe_vocab):
        return bpe_vocab
    if not os.path.exists(bpe_model):
        return ""
    try:
        BpeModel.from_file(bpe_model).dump_vocab(bpe_vocab)
        return bpe_vocab
    except Exception:
        return ""


def prepare_hotwords_file(hotwords_path, base_dir=BASE_DIR):
    """Validate the hotwords file exists and has usable lines; returns its
    path or '' (config.py:333-380)."""
    if not hotwords_path:
        hotwords_path = os.path.join(base_dir, "hotword.txt")
    if not os.path.exists(hotwords_path):
        return ""
    try:
        with open(hotwords_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    return hotwords_path
    except OSError:
        pass
    return ""


def get_hotwords_config(model_path, base_dir=BASE_DIR, default_score=1.5):
    """Hotwords config for a model dir: requires a hotword file and a
    bpe.model; returns {} when hotwords are unavailable
    (mirrors reference get_hotwords_config usage in asr_engine.py:993-1005)."""
    hw_file = prepare_hotwords_file(None, base_dir)
    if not hw_file:
        return {}
    if not os.path.exists(os.path.join(model_path, "bpe.model")):
        return {}
    return {"hotwords_file": hw_file, "hotwords_score": default_score}


def build_hotword_tables_for_model(model_path, vocab_size,
                                   hotwords_file=None, default_score=1.5,
                                   base_dir=BASE_DIR):
    """End-to-end: hotword file + bpe.model -> dense device tables
    (HotwordTables) + phrase list, or (None, []) when unavailable."""
    from sherpa_vietnamese_asr_tpu_torch.ops.hotword import (
        build_hotword_tables, parse_hotwords_file,
    )
    from sherpa_vietnamese_asr_tpu_torch.utils.bpe import BpeModel

    hw_file = hotwords_file or prepare_hotwords_file(None, base_dir)
    bpe_path = os.path.join(model_path, "bpe.model")
    if not hw_file or not os.path.exists(bpe_path):
        return None, []
    phrases = parse_hotwords_file(hw_file, default_score)
    if not phrases:
        return None, []
    bpe = BpeModel.from_file(bpe_path)
    seqs, scores, kept = [], [], []
    for phrase, score in phrases:
        ids = bpe.encode(phrase)
        if ids:
            seqs.append(ids)
            scores.append(score)
            kept.append(phrase)
    if not seqs:
        return None, []
    tables, _graph = build_hotword_tables(seqs, scores, vocab_size)
    return tables, kept
