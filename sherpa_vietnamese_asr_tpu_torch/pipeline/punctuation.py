# Punctuation restorer wrapper: rule-based cleanup over the GEC model.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/punctuation.py.
# PunctuationRestorer and post_process are copied (colon removal, duplicate
# punctuation cleanup, comma limiting in short sentences, spacing
# normalisation, sentence-initial capitalisation), with one difference: a
# failure of the model propagates out of restore(), where the JAX package
# logs it and returns the text unpunctuated, so a punctuation stage that
# fails on the card never ends in a result that looks punctuated.
# build_punctuation_restorer is rewritten over the port's loaders; the model
# runs on the card through pipeline/gec.py unless the caller asks for the
# CPU.

from __future__ import annotations

import os
import re

SYNTHETIC_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [
    p for c in "abcdefghijklmnopqrstuvwxyz0123456789" for p in (c, "##" + c)]


def _read_vocab(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def build_punctuation_restorer(model_dir=None, confidence=0.3,
                               case_confidence=0.0, prefer_int8=False,
                               device="cuda", **gec_kw):
    """A PunctuationRestorer on `device`, the card by default (raises
    without one).

    The ViBERT comes from vibert-capu.onnx (+ vocab.txt) in model_dir, else
    from the asset registry (models/assets.load_vibert_asset), else it is a
    loudly flagged random 12-layer ViBERT (torch.Generator seeded 0) with a
    synthetic WordPiece vocab: the real shapes and cost, placeholder
    predictions. prefer_int8 quantizes its linears to the int8 weight-only
    tier (models/vibert.quantize_vibert_int8)."""
    from sherpa_vietnamese_asr_tpu_torch.models import assets, convert
    from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import (
        ViBertConfig,
        quantize_vibert_int8,
        random_vibert,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    device = model_device(device)
    loaded = vocab = None
    if model_dir:
        onnx_path = os.path.join(model_dir, "vibert-capu.onnx")
        vocab_path = os.path.join(model_dir, "vocab.txt")
        if os.path.exists(onnx_path):
            from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_vibert
            loaded = load_vibert(onnx_path)
        if os.path.exists(vocab_path):
            vocab = _read_vocab(vocab_path)
    if loaded is None:
        loaded = assets.load_vibert_asset()
        if loaded is not None:
            paths = assets.asset_paths("vibert-capu")
            if vocab is None and paths is not None:
                vocab = _read_vocab(paths["vocab.txt"])
    if loaded is not None:
        model = convert.vibert_from_numpy(*loaded, device=device)
    else:
        assets.warn_random("ViBERT punctuation model")
        model = random_vibert(ViBertConfig(), seed=0, device=device)
    if vocab is None:
        vocab = list(SYNTHETIC_VOCAB)
    if prefer_int8:
        model = quantize_vibert_int8(model)
    gec = GecBert(model, WordPieceTokenizer(vocab), confidence=confidence,
                  case_confidence=case_confidence, **gec_kw)
    return PunctuationRestorer(gec, confidence=confidence,
                               case_confidence=case_confidence)


class PunctuationRestorer:
    def __init__(self, gec_model, confidence=0.3, case_confidence=0.0):
        """gec_model: a pipeline.gec.GecBert instance (confidence values are
        already baked into it by the caller)."""
        self.gec_model = gec_model
        self.confidence = confidence
        self.case_confidence = case_confidence

    def restore(self, text, progress_callback=None, pause_hints=None):
        """Punctuated text. A failure of the model propagates (the JAX
        package logs it and returns the text unpunctuated)."""
        if not text or not text.strip():
            return ""
        results = self.gec_model(text, pause_hints=pause_hints,
                                 progress_callback=progress_callback)
        result = results[0] if isinstance(results, list) else results
        return self.post_process(result)

    @staticmethod
    def post_process(text):
        """Punctuation cleanup rules (punctuation_restorer_improved.py:80-133)."""
        text = text.replace(":", " ")
        text = re.sub(r",+", ",", text)
        text = re.sub(r"\.{4,}", "...", text)
        text = re.sub(r",\s*\.", ".", text)

        sentences = re.split(r"(?<=[.!?])\s+", text)
        cleaned = []
        for sent in sentences:
            words = sent.split()
            if len(words) < 8 and sent.count(",") > 1:
                parts = sent.split(",", 1)
                if len(parts) > 1:
                    second = parts[1].find(",")
                    if second != -1:
                        parts[1] = (parts[1][:second]
                                    + parts[1][second + 1:].replace(",", ""))
                    sent = parts[0] + "," + parts[1]
            cleaned.append(sent)
        text = " ".join(cleaned)

        text = re.sub(r"([,.!?])([^\s])", r"\1 \2", text)
        text = re.sub(r"\s+([,.!?])", r"\1", text)
        text = re.sub(r"^,\s*", "", text)
        text = re.sub(r"\.\s*,", ". ", text)
        text = re.sub(r"\s+", " ", text)
        text = re.sub(r"(^|[.!?]\s+)([^\W_])",
                      lambda m: m.group(1) + m.group(2).upper(), text)
        return text.strip()
