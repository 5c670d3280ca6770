# Copied from sherpa_vietnamese_asr_tpu/web_service/auth.py (stdlib only; only the package path changes).
# Authentication: HMAC-SHA256 JWT, PBKDF2 password hashing, rate limiting
# and account lockout.
#
# Behavioral port of reference web_service/auth.py + server.py:185-300:
#   * JWT with persisted signing secret, expiry, and an in-memory
#     revocation list pruned by expiry;
#   * login rate limiting per IP (5 failures -> 15 min lockout) and per
#     account lockout, matching the reference thresholds;
# implemented on hashlib/hmac (PyJWT is not available in this environment).

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import threading
import time

TOKEN_TTL_SEC = 24 * 3600
MAX_LOGIN_FAILURES = 5
LOCKOUT_SEC = 15 * 60


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 100_000)
    return f"pbkdf2${_b64(salt)}${_b64(dk)}"


def verify_password(password: str, stored: str) -> bool:
    try:
        _, salt_s, dk_s = stored.split("$")
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 _unb64(salt_s), 100_000)
        return hmac.compare_digest(dk, _unb64(dk_s))
    except Exception:
        return False


class JwtAuth:
    def __init__(self, secret_path=None):
        if secret_path and os.path.exists(secret_path):
            with open(secret_path, "rb") as f:
                self.secret = f.read()
        else:
            self.secret = secrets.token_bytes(32)
            if secret_path:
                os.makedirs(os.path.dirname(os.path.abspath(secret_path)),
                            exist_ok=True)
                with open(secret_path, "wb") as f:
                    f.write(self.secret)
        self._revoked = {}  # token -> exp
        self._lock = threading.Lock()

    def create_token(self, payload: dict, ttl=TOKEN_TTL_SEC) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        body = dict(payload)
        body["exp"] = time.time() + ttl
        h = _b64(json.dumps(header).encode())
        p = _b64(json.dumps(body).encode())
        sig = hmac.new(self.secret, f"{h}.{p}".encode(),
                       hashlib.sha256).digest()
        return f"{h}.{p}.{_b64(sig)}"

    def verify_token(self, token: str) -> dict | None:
        try:
            h, p, s = token.split(".")
            expect = hmac.new(self.secret, f"{h}.{p}".encode(),
                              hashlib.sha256).digest()
            if not hmac.compare_digest(expect, _unb64(s)):
                return None
            payload = json.loads(_unb64(p))
            if payload.get("exp", 0) < time.time():
                return None
            if self.is_revoked(token):
                return None
            return payload
        except Exception:
            return None

    def revoke_token(self, token: str):
        try:
            payload = json.loads(_unb64(token.split(".")[1]))
            exp = payload.get("exp", time.time() + TOKEN_TTL_SEC)
        except Exception:
            exp = time.time() + TOKEN_TTL_SEC
        with self._lock:
            now = time.time()
            self._revoked = {t: e for t, e in self._revoked.items()
                             if e > now}
            self._revoked[token] = exp

    def is_revoked(self, token: str) -> bool:
        with self._lock:
            return token in self._revoked


class RateLimiter:
    """Per-key failure counting with lockout (server.py:205-300)."""

    def __init__(self, max_failures=MAX_LOGIN_FAILURES,
                 lockout_sec=LOCKOUT_SEC):
        self.max_failures = max_failures
        self.lockout_sec = lockout_sec
        self._failures = {}  # key -> [timestamps]
        self._lock = threading.Lock()

    def is_locked(self, key: str) -> bool:
        with self._lock:
            now = time.time()
            hits = [t for t in self._failures.get(key, [])
                    if now - t < self.lockout_sec]
            self._failures[key] = hits
            return len(hits) >= self.max_failures

    def record_failure(self, key: str):
        with self._lock:
            self._failures.setdefault(key, []).append(time.time())

    def clear(self, key: str | None = None):
        with self._lock:
            if key is None:
                self._failures.clear()
            else:
                self._failures.pop(key, None)

    def locked_keys(self):
        return [k for k in list(self._failures) if self.is_locked(k)]
