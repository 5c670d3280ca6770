# Copied from sherpa_vietnamese_asr_tpu/web_service/server_config.py (stdlib only; only the package path changes).
# Persisted server settings — INI-backed key/value store mirroring reference
# web_service/config.py (ServerConfig: DEFAULTS table, load/save over
# config.ini, typed accessors). TPU adaptation: the reference's
# execution_provider values name ORT providers (cpu/cuda/openvino/...);
# here the analogue is the serving backend ("auto" = TPU when present) plus
# the calibrated serving dtype / batch, which `svt calibrate` and the
# /api/calibration endpoints persist the same way the reference persists its
# provider profile (reference server.py:586-651).

from __future__ import annotations

import configparser
import os
import threading

SECTION = "ServerSettings"


class ServerConfig:
    DEFAULTS = {
        "host": "0.0.0.0",
        "port": "8443",
        "max_upload_mb": "500",
        "anonymous_timeout_minutes": "120",
        "storage_per_user_gb": "5",
        "max_sessions": "100",
        "default_asr_model": "zipformer-30m-rnnt-6000h",
        "default_speaker_model": "pure_ort",
        "default_punctuation_confidence": "7",
        "default_case_confidence": "6",
        "default_diarization_threshold": "70",
        # Serving backend: "auto" (TPU when available) or "cpu" (forced
        # XLA-CPU fallback). The GPU-provider table the reference validates
        # has no TPU analogue.
        "execution_provider": "auto",
        # Calibrated serving profile (svt calibrate / /api/calibration/run)
        "serving_dtype": "float32",
        "max_batch": "0",  # 0 = resolve via calibration/HBM heuristic
        "jwt_expire_minutes": "480",
        "http_mode": "0",  # "1" = plain HTTP (no TLS)
        "admin_password_hash": "",
        "summarizer_model_path": "",
        "summarizer_ollama_model": "gemma3:4b",
        "summarizer_threads": "16",
        "summarizer_context_size": "32768",
        "summarizer_enabled": "0",
    }

    # PUT /api/admin/config validation (reference server.py:2112-2129)
    VALIDATORS = {
        "port": lambda v: 1 <= int(v) <= 65535,
        "max_upload_mb": lambda v: 1 <= int(v) <= 10000,
        "anonymous_timeout_minutes": lambda v: 1 <= int(v) <= 1440,
        "storage_per_user_gb": lambda v: 0 <= float(v) <= 1000,
        "max_sessions": lambda v: 1 <= int(v) <= 10000,
        "jwt_expire_minutes": lambda v: 5 <= int(v) <= 43200,
        "summarizer_threads": lambda v: 1 <= int(v) <= 128,
        "summarizer_context_size": lambda v: 1024 <= int(v) <= 262144,
        "summarizer_enabled": lambda v: str(v) in ("0", "1"),
        "http_mode": lambda v: str(v) in ("0", "1"),
        "execution_provider": lambda v: str(v).lower() in ("auto", "cpu",
                                                           "tpu"),
        "serving_dtype": lambda v: str(v) in ("float32", "bfloat16"),
        "max_batch": lambda v: 0 <= int(v) <= 256,
    }
    READONLY = {"admin_password_hash", "host"}

    def __init__(self, path=None):
        self.path = path
        self._lock = threading.Lock()
        self._config = configparser.ConfigParser()
        self.load()

    def load(self):
        with self._lock:
            self._config.clear()
            if self.path and os.path.exists(self.path):
                self._config.read(self.path, encoding="utf-8-sig")
            if not self._config.has_section(SECTION):
                self._config.add_section(SECTION)
            for key, default in self.DEFAULTS.items():
                if not self._config.has_option(SECTION, key):
                    self._config.set(SECTION, key, default)

    def save(self):
        if not self.path:
            return
        with self._lock:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as f:
                self._config.write(f)

    def get(self, key, fallback=None):
        with self._lock:
            return self._config.get(SECTION, key, fallback=fallback)

    def set(self, key, value):
        with self._lock:
            self._config.set(SECTION, key, str(value))

    def get_int(self, key):
        return int(self.get(key) or self.DEFAULTS.get(key, "0"))

    def get_float(self, key):
        return float(self.get(key) or self.DEFAULTS.get(key, "0"))

    @property
    def max_upload_bytes(self):
        return self.get_int("max_upload_mb") * 1024 * 1024

    def to_dict(self):
        with self._lock:
            return dict(self._config.items(SECTION))

    def validate(self, key, value):
        """True iff `value` is acceptable for `key` (unknown keys pass)."""
        fn = self.VALIDATORS.get(key)
        if fn is None:
            return True
        try:
            return bool(fn(value))
        except (ValueError, TypeError):
            return False
