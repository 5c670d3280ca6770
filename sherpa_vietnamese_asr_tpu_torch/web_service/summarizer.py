# Copied from sherpa_vietnamese_asr_tpu/web_service/summarizer.py (host-only),
# with the "local" backend on the port's models/llama.py: the GGUF model is
# loaded once a (path, device), on the card unless the Summarizer is given
# the CPU, and generates there. One difference in behaviour: the JAX
# Summarizer.summarize falls back to the extractive summary on any exception
# of the LLM path. Here it falls back only for the reference's two reasons,
# LLM output that is no valid summary JSON (NoValidSummary) and an Ollama
# daemon that cannot be reached or answers with no JSON; a failure to load
# or run the local model propagates, so a fault on the card is never
# answered with an extractive summary that looks like success.
#
# Meeting summarizer: LLM backends (Ollama HTTP / in-process GGUF) with an
# offline extractive fallback.
#
# Behavioral port of reference web_service/summarizer.py: transcript chunking
# for long meetings, JSON-schema-validated summary output, backend
# availability probing (:310-474). The reference's llama-cpp-python
# in-process path is answered natively: models/gguf.py parses the GGUF
# checkpoint and models/llama.py runs it as a PyTorch forward on the
# card ("local" backend, gated on a *.gguf file being present —
# SVT_SUMMARIZER_GGUF or <models_dir>/summarizer/*.gguf). Ollama HTTP stays
# gated on reachability, and a deterministic extractive summarizer keeps the
# API functional offline.

from __future__ import annotations

import json
import re
import threading
import urllib.error
import urllib.request

SUMMARY_SCHEMA_KEYS = {"title", "summary", "key_points", "action_items"}
CHUNK_CHARS = 6000
OLLAMA_URL = "http://127.0.0.1:11434"


def ollama_available(base_url=OLLAMA_URL, timeout=2.0):
    try:
        with urllib.request.urlopen(base_url + "/api/tags", timeout=timeout):
            return True
    except (urllib.error.URLError, OSError):
        return False


def chunk_transcript(text, chunk_chars=CHUNK_CHARS):
    """Split on sentence boundaries into <= chunk_chars pieces
    (summarizer.py transcript chunking)."""
    sentences = re.split(r"(?<=[.!?])\s+", text)
    chunks, cur = [], ""
    for s in sentences:
        if len(cur) + len(s) + 1 > chunk_chars and cur:
            chunks.append(cur.strip())
            cur = s
        else:
            cur = (cur + " " + s).strip()
    if cur.strip():
        chunks.append(cur.strip())
    return chunks


def validate_summary(data):
    """Schema check: required keys, list types (summarizer.py:430-474)."""
    if not isinstance(data, dict):
        return False
    if not SUMMARY_SCHEMA_KEYS.issubset(data.keys()):
        return False
    if not isinstance(data.get("key_points"), list):
        return False
    if not isinstance(data.get("action_items"), list):
        return False
    return True


def _ollama_generate(prompt, model="gemma2", base_url=OLLAMA_URL,
                     timeout=120.0):
    body = json.dumps({"model": model, "prompt": prompt,
                       "stream": False, "format": "json"}).encode()
    req = urllib.request.Request(
        base_url + "/api/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode()).get("response", "")


def local_gguf_path():
    """Path of the in-process summarizer checkpoint, or None.

    SVT_SUMMARIZER_GGUF wins; otherwise the first *.gguf under
    <models_dir>/summarizer (reference keeps its GGUF next to the models,
    web_service/summarizer.py:310-364)."""
    import glob
    import os

    env = os.environ.get("SVT_SUMMARIZER_GGUF")
    if env:
        return env if os.path.exists(env) else None
    from sherpa_vietnamese_asr_tpu_torch.models import assets

    hits = sorted(glob.glob(os.path.join(assets.models_dir(), "summarizer",
                                         "*.gguf")))
    return hits[0] if hits else None


_LOCAL_LLM = {}
_LOCAL_LLM_LOCK = threading.Lock()


class NoValidSummary(RuntimeError):
    """No chunk of the LLM's output was a valid summary."""


def _local_llm(path, device="cuda"):
    """Load-once cache of (model, cfg, tokenizer, meta) for a GGUF path on
    a device."""
    from sherpa_vietnamese_asr_tpu_torch.models.llama import load_gguf_llama

    key = (path, str(device))
    with _LOCAL_LLM_LOCK:
        if key not in _LOCAL_LLM:
            _LOCAL_LLM[key] = load_gguf_llama(path, device=device)
        return _LOCAL_LLM[key]


def _local_generate(prompt, path, max_new_tokens=512, device="cuda"):
    """In-process GGUF generation (models/llama.py, greedy) on `device`."""
    from sherpa_vietnamese_asr_tpu_torch.models import llama

    model, cfg, tokenizer, meta = _local_llm(path, device)
    bos = meta.get("tokenizer.ggml.bos_token_id")
    eos = meta.get("tokenizer.ggml.eos_token_id")
    ids = ([int(bos)] if bos is not None else []) + tokenizer.encode(prompt)
    out = llama.generate(model, ids, max_new_tokens=max_new_tokens,
                         eos_id=int(eos) if eos is not None else None)
    return llama.detokenize(tokenizer, out)


def extractive_summary(text, max_points=5):
    """Deterministic offline fallback: lead + highest-information sentences
    by normalized term frequency."""
    sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", text)
                 if len(s.split()) >= 3]
    if not sentences:
        return {"title": "", "summary": text[:200], "key_points": [],
                "action_items": []}
    freq = {}
    for s in sentences:
        for w in re.findall(r"\w+", s.lower()):
            if len(w) > 2:
                freq[w] = freq.get(w, 0) + 1
    def score(s):
        words = re.findall(r"\w+", s.lower())
        return sum(freq.get(w, 0) for w in words) / (len(words) + 3)
    ranked = sorted(sentences, key=score, reverse=True)
    points = ranked[:max_points]
    # keep original order in key_points
    points = [s for s in sentences if s in set(points)][:max_points]
    return {
        "title": sentences[0][:80],
        "summary": " ".join(points[:3]),
        "key_points": points,
        "action_items": [],
    }


class Summarizer:
    def __init__(self, backend="auto", model="gemma2",
                 ollama_url=OLLAMA_URL, gguf_path=None, device="cuda"):
        self.model = model
        self.device = device
        self.ollama_url = ollama_url
        self.gguf_path = gguf_path or local_gguf_path()
        if backend == "auto":
            # Priority mirrors the reference (web_service/summarizer.py:
            # 310-474): in-process model first, HTTP daemon second,
            # deterministic extractive fallback always available.
            backend = ("local" if self.gguf_path
                       else "ollama" if ollama_available(ollama_url)
                       else "extractive")
        self.backend = backend

    def status(self):
        return {"backend": self.backend,
                "ollama_available": ollama_available(self.ollama_url),
                "local_gguf": self.gguf_path}

    def summarize(self, transcript):
        """Transcript text -> validated summary dict."""
        if self.backend in ("ollama", "local"):
            try:
                return self._summarize_llm(transcript)
            except NoValidSummary:
                pass  # fall through to extractive
            except (OSError, ValueError):  # URLError is an OSError
                if self.backend != "ollama":
                    raise
        return extractive_summary(transcript)

    def _summarize_llm(self, transcript):
        chunks = chunk_transcript(transcript)
        partials = []
        for chunk in chunks:
            prompt = (
                "Summarize this Vietnamese meeting transcript chunk as JSON "
                'with keys "title", "summary", "key_points" (list), '
                '"action_items" (list):\n\n' + chunk)
            if self.backend == "local":
                raw = _local_generate(prompt, self.gguf_path,
                                      device=self.device)
            else:
                raw = _ollama_generate(prompt, self.model, self.ollama_url)
            try:
                data = json.loads(raw)
            except ValueError:
                continue
            if validate_summary(data):
                partials.append(data)
        if not partials:
            raise NoValidSummary("no valid LLM summaries")
        if len(partials) == 1:
            return partials[0]
        return {
            "title": partials[0]["title"],
            "summary": " ".join(p["summary"] for p in partials),
            "key_points": [k for p in partials for k in p["key_points"]],
            "action_items": [a for p in partials for a in p["action_items"]],
        }
