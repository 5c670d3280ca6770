# Copied from sherpa_vietnamese_asr_tpu/web_service/server.py (host-only), with
# the device-facing lines rewritten for the port: AppState takes the torch
# device the service runs on (the card unless the caller names the CPU);
# /api/version reports the port's backend and /api/calibration/status the
# torch.cuda devices; the live-stream recognizer is the port's
# MultiStreamRecognizer (a random Zipformer-30M on that device when there is
# no model provider); the summarizer and the calibration endpoints run the
# port's modules (the calibration on every backend of the host). One fault
# of the reference is fixed: a calibration run with autotune stored int() of
# autotune_max_batch's whole report (a TypeError); here it stores its
# best_batch.
#
# HTTP API server — stdlib ThreadingHTTPServer implementation of the
# reference web service's endpoint surface.
#
# Endpoint behavior mirrors reference web_service/server.py: anonymous
# sessions + JWT login, login rate limiting/lockout, upload -> process ->
# status/result flow over the strict-FIFO queue, speaker rename, user file
# listing, meetings CRUD, admin queue/users/stats, and a WebSocket (/ws)
# progress push (minimal RFC6455 server — FastAPI/uvicorn are not available
# in this environment; clients can also poll /api/files/{id}/status exactly
# like the reference's polling fallback).

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import struct
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from sherpa_vietnamese_asr_tpu_torch.web_service.auth import (
    JwtAuth,
    RateLimiter,
    hash_password,
    verify_password,
)
from sherpa_vietnamese_asr_tpu_torch.web_service.database import Database
from sherpa_vietnamese_asr_tpu_torch.web_service.queue_manager import QueueManager

MAX_JSON_BYTES = 1 * 1024 * 1024
MAX_RESULT_JSON_BYTES = 50 * 1024 * 1024  # upload-json / save-result cap
_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "Referrer-Policy": "same-origin",
}

# Upload extension allowlist (reference server.py:838-842)
ALLOWED_EXTENSIONS = {
    "mp3", "wav", "m4a", "flac", "aac", "wma", "ogg", "opus",
    "mp4", "mkv", "avi", "mov", "webm", "flv", "wmv",
}

AUDIO_MEDIA_TYPES = {
    "mp3": "audio/mpeg", "wav": "audio/wav", "m4a": "audio/mp4",
    "ogg": "audio/ogg", "flac": "audio/flac", "aac": "audio/aac",
    "wma": "audio/x-ms-wma", "opus": "audio/opus",
    "mp4": "video/mp4", "webm": "video/webm",
}

# _sanitize_asr_json bounds (reference server.py:732-734)
_MAX_SPEAKER_ID = 99
_MAX_TEXT_LEN = 50_000
_MAX_SEGMENTS = 100_000


def sanitize_asr_json(data: dict) -> dict:
    """Validate + sanitize a client-supplied ASR result before storing it
    (stored-XSS defense; reference server.py:736-838): keep only the
    allowed top-level keys, coerce/clamp each segment field, HTML-escape
    text and speaker names, and allowlist CSS colors."""
    import html as _html

    allowed_top = {"segments", "speaker_names", "model", "duration_sec",
                   "speaker_colors", "language", "sample_rate"}
    cleaned = {k: data[k] for k in allowed_top if k in data}

    raw_segs = data.get("segments", [])
    if not isinstance(raw_segs, list):
        raise ApiError(400, "segments must be an array")
    if len(raw_segs) > _MAX_SEGMENTS:
        raise ApiError(400, f"Too many segments (max {_MAX_SEGMENTS})")

    safe_segs = []
    for seg in raw_segs:
        if not isinstance(seg, dict):
            continue
        seg_type = str(seg.get("type", ""))
        if seg_type not in ("text", "speaker", "gap"):
            continue
        s = {"type": seg_type}
        if "speaker_id" in seg:
            try:
                spk = int(seg["speaker_id"])
                if 0 <= spk <= _MAX_SPEAKER_ID:
                    s["speaker_id"] = spk
            except (ValueError, TypeError):
                pass
        if "text" in seg:
            s["text"] = _html.escape(str(seg["text"])[:_MAX_TEXT_LEN],
                                     quote=False)
        if "speaker" in seg:
            s["speaker"] = _html.escape(str(seg["speaker"])[:200],
                                        quote=False)
        for tf in ("start", "end", "duration", "start_time"):
            if tf in seg:
                try:
                    s[tf] = float(seg[tf])
                except (ValueError, TypeError):
                    pass
        if "confidence" in seg:
            try:
                s["confidence"] = max(0.0, min(1.0,
                                               float(seg["confidence"])))
            except (ValueError, TypeError):
                pass
        safe_segs.append(s)
    cleaned["segments"] = safe_segs

    raw_names = cleaned.get("speaker_names", {})
    cleaned["speaker_names"] = {
        str(k)[:20]: _html.escape(str(v)[:200], quote=False)
        for k, v in list(raw_names.items())[:_MAX_SPEAKER_ID + 1]
    } if isinstance(raw_names, dict) else {}

    raw_colors = cleaned.get("speaker_colors", {})
    if isinstance(raw_colors, dict):
        color_re = re.compile(
            r"^(#[0-9a-fA-F]{3,8}|rgb\(\d{1,3},\s*\d{1,3},\s*\d{1,3}\))$")
        cleaned["speaker_colors"] = {
            str(k)[:20]: v
            for k, v in list(raw_colors.items())[:_MAX_SPEAKER_ID + 1]
            if isinstance(v, str) and color_re.match(v.strip())
        }
    else:
        cleaned.pop("speaker_colors", None)

    if "model" in cleaned:
        cleaned["model"] = str(cleaned["model"])[:200]
    if "duration_sec" in cleaned:
        try:
            cleaned["duration_sec"] = float(cleaned["duration_sec"])
        except (ValueError, TypeError):
            cleaned.pop("duration_sec", None)
    return cleaned


def delete_upload_artifacts(upload_dir, stored_filename):
    """Remove an upload and any converted .wav sibling (reference
    delete_upload_artifacts); returns how many files were removed."""
    removed = 0
    path = os.path.join(upload_dir, stored_filename)
    candidates = {path}
    if "." in stored_filename:
        candidates.add(path.rsplit(".", 1)[0] + ".wav")
    for p in candidates:
        if os.path.exists(p):
            os.remove(p)
            removed += 1
    return removed


def _safe_audio_filename(original_filename):
    """Sanitized download filename (reference server.py:1230-1236)."""
    import html as _html

    name = _html.unescape(str(original_filename or "audio")
                          .replace("\x00", ""))
    name = name.replace("\r", " ").replace("\n", " ").strip()
    name = os.path.basename(name.replace("\\", os.sep))
    return name[:240] or "audio"


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Sherpa Vietnamese ASR (GPU)</title>
<style>body{font-family:sans-serif;max-width:42em;margin:3em auto;
line-height:1.5}</style></head>
<body><h1>Sherpa Vietnamese ASR — GPU service</h1>
<p>The REST/WebSocket API is live. The browser frontend is out of scope for
this framework (see PARITY.md); use the CLI client or the API directly:</p>
<ul><li><code>POST /api/session</code> then <code>POST /api/upload</code>,
<code>POST /api/process/{id}</code>, poll
<code>GET /api/files/{id}/status</code></li>
<li><code>GET /ws</code> progress push, <code>GET /ws/stream</code> live
transcription</li><li><code>GET /api/version</code></li></ul>
</body></html>"""


class ApiError(Exception):
    def __init__(self, status, message):
        super().__init__(message)
        self.status = status
        self.message = message


class AppState:
    """Shared server state: db, auth, queue, websocket subscribers."""

    def __init__(self, db=None, model_provider=None, upload_dir=None,
                 pipeline_factory=None, data_dir=None, device="cuda"):
        from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
        from sherpa_vietnamese_asr_tpu_torch.web_service.server_config import (
            ServerConfig,
        )

        self.device = model_device(device)
        data_dir = data_dir or os.path.join(os.getcwd(), "web_data")
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.cert_dir = os.path.join(data_dir, "certs")
        self.config = ServerConfig(os.path.join(data_dir, "config.ini"))
        self.upload_dir = upload_dir or os.path.join(data_dir, "uploads")
        os.makedirs(self.upload_dir, exist_ok=True)
        self.db = db or Database(os.path.join(data_dir, "asr.db"))
        self.auth = JwtAuth(os.path.join(data_dir, "jwt.secret"))
        self.login_limiter = RateLimiter()
        self.account_limiter = RateLimiter()
        self._upload_times = {}  # key -> [monotonic timestamps]
        self._upload_lock = threading.Lock()
        self.bind_host = ""  # set by make_server (localhost-API allowlist)
        self.queue = QueueManager(self.db, model_provider or (lambda n: None),
                                  self.upload_dir,
                                  pipeline_factory=pipeline_factory,
                                  default_model=self.config.get(
                                      "default_asr_model"))
        self._ws_clients = []  # (session_id, socket)
        self._ws_lock = threading.Lock()
        self._model_provider = model_provider
        self._streamer = None          # lazy MultiStreamRecognizer
        self._streamer_lock = threading.Lock()
        self.queue.subscribe(self._push_event)
        # default admin account (reference seeds one on first run)
        if not self.db.get_user_by_username("admin"):
            self.db.create_user("admin", hash_password("admin"), role="admin")
        self._gc_stop = threading.Event()
        self._gc_thread = threading.Thread(target=self._session_gc_loop,
                                           daemon=True)
        self._gc_thread.start()

    def _session_gc_loop(self, interval_sec=60):
        """Expire stale anonymous sessions (reference session_manager's
        heartbeat GC); timeout comes from server config."""
        while not self._gc_stop.wait(interval_sec):
            try:
                self.cleanup_expired_sessions()
            except Exception:
                pass

    def shutdown(self):
        self._gc_stop.set()

    def check_upload_rate(self, key, max_per_minute=10):
        """Sliding-window upload rate limit per session/user (reference
        server.py:265-279)."""
        import time

        now = time.monotonic()
        with self._upload_lock:
            times = [t for t in self._upload_times.get(key, [])
                     if now - t < 60.0]
            if len(times) >= max_per_minute:
                self._upload_times[key] = times
                raise ApiError(429, "Too many uploads; slow down")
            times.append(now)
            self._upload_times[key] = times

    def ws_connected(self, session_id):
        with self._ws_lock:
            return any(sid == session_id for sid, _ in self._ws_clients)

    def kill_session(self, session_id):
        """Expire a session and cancel its queued/processing work
        (reference session_manager.kill_session)."""
        for item in self.db.get_waiting_queue():
            if item.get("session_id") == session_id:
                self.queue.cancel(item["file_id"])
        self.db.expire_session(session_id)

    def cleanup_expired_sessions(self):
        """One GC sweep now; returns the number of sessions expired."""
        timeout = self.config.get_int("anonymous_timeout_minutes")
        expired = self.db.get_expired_anonymous_sessions(timeout)
        for sess in expired:
            self.kill_session(sess["id"])
        return len(expired)

    # -- live streaming (shared batched recognizer) -------------------------
    def get_streamer(self, n_streams=8):
        with self._streamer_lock:
            if self._streamer is None:
                from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online \
                    import MultiStreamRecognizer
                model = self._model_provider(None) if self._model_provider \
                    else None
                if model is None:
                    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
                        random_asr_model,
                    )
                    model = random_asr_model(vocab_size=2000, beam_size=4,
                                             device=self.device)
                self._streamer = MultiStreamRecognizer(model,
                                                       n_streams=n_streams)
            return self._streamer

    # -- websocket push ---------------------------------------------------------
    def add_ws_client(self, session_id, sock):
        with self._ws_lock:
            self._ws_clients.append((session_id, sock))

    def remove_ws_client(self, sock):
        with self._ws_lock:
            self._ws_clients = [c for c in self._ws_clients
                                if c[1] is not sock]

    def _push_event(self, event):
        data = json.dumps(event, ensure_ascii=False).encode()
        frame = _ws_frame(data)
        dead = []
        with self._ws_lock:
            clients = list(self._ws_clients)
        for sid, sock in clients:
            try:
                sock.sendall(frame)
            except OSError:
                dead.append((sid, sock))
        if dead:
            with self._ws_lock:
                self._ws_clients = [c for c in self._ws_clients
                                    if c not in dead]


def _ws_frame(payload: bytes, opcode=0x1) -> bytes:
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state: AppState = None  # injected by make_server

    # -- helpers ------------------------------------------------------------
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send_json(self, obj, status=200):
        body = json.dumps(obj, ensure_ascii=False).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        for k, v in SECURITY_HEADERS.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_JSON_BYTES:
            raise ApiError(413, "Request body too large")
        if length == 0:
            return {}
        try:
            return json.loads(self.rfile.read(length).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise ApiError(400, "Invalid JSON body")

    def _session_id(self):
        return self.headers.get("X-Session-Id") or ""

    def _client_ip(self):
        return self.client_address[0]

    def _current_user(self):
        authz = self.headers.get("Authorization") or ""
        if not authz.startswith("Bearer "):
            return None
        payload = self.state.auth.verify_token(authz[7:])
        if not payload:
            return None
        return self.state.db.get_user_by_id(payload.get("user_id"))

    def _require_auth(self):
        user = self._current_user()
        if user is None or not user.get("is_active", 1):
            raise ApiError(401, "Authentication required")
        return user

    def _require_admin(self):
        user = self._require_auth()
        if user.get("role") != "admin":
            raise ApiError(403, "Admin access required")
        return user

    def _check_file_access(self, file_rec):
        if file_rec is None:
            raise ApiError(404, "File not found")
        user = self._current_user()
        if user and (user["id"] == file_rec.get("user_id")
                     or user.get("role") == "admin"):
            return
        if file_rec.get("session_id") == self._session_id() \
                and self._session_id():
            return
        raise ApiError(403, "Access denied")

    def _require_localhost(self):
        """Guard for the /api/local/* GUI-admin API (no JWT): loopback, or
        the configured bind IP when the server binds a concrete address
        (reference server.py:1849-1861)."""
        allowed = {"127.0.0.1", "::1", "localhost"}
        bind = self.state.bind_host
        if bind and bind not in ("0.0.0.0", "", "::"):
            allowed.add(bind)
        if self._client_ip() not in allowed:
            raise ApiError(403, "Only accessible from localhost")

    def _send_html(self, html, status=200):
        body = html.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        for k, v in SECURITY_HEADERS.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_file(self, path, media_type, download_name=None):
        """Stream a file from disk; attachment when download_name is set
        (RFC 5987 filename* encoding, reference server.py:1260-1268)."""
        from urllib.parse import quote

        size = os.path.getsize(path)
        self.send_response(200)
        self.send_header("Content-Type", media_type)
        self.send_header("Content-Length", str(size))
        if download_name:
            self.send_header(
                "Content-Disposition",
                f"attachment; filename*=UTF-8''{quote(download_name)}")
        for k, v in SECURITY_HEADERS.items():
            self.send_header(k, v)
        self.end_headers()
        with open(path, "rb") as f:
            while True:
                chunk = f.read(65536)
                if not chunk:
                    break
                self.wfile.write(chunk)

    def _upload_file_path(self, stored_filename):
        """Resolve a stored upload path with a traversal check (reference
        server.py:1181-1184)."""
        path = os.path.join(self.state.upload_dir, stored_filename)
        root = os.path.realpath(self.state.upload_dir)
        if not os.path.realpath(path).startswith(root + os.sep):
            raise ApiError(400, "Invalid file path")
        return path

    def _serve_stored_audio(self, stored_filename, original_filename,
                            download=False):
        """Serve an uploaded audio/video file, preferring a converted .wav
        next to it (reference file_audio, server.py:1171-1219)."""
        path = self._upload_file_path(stored_filename)
        wav_path = path.rsplit(".", 1)[0] + ".wav"
        if not download and os.path.exists(wav_path):
            self._send_file(wav_path, "audio/wav")
            return
        if not os.path.exists(path):
            raise ApiError(404, "Audio file not found")
        name = _safe_audio_filename(original_filename)
        ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
        self._send_file(path,
                        AUDIO_MEDIA_TYPES.get(ext,
                                              "application/octet-stream"),
                        download_name=name if download else None)

    # -- routing ---------------------------------------------------------------
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_DELETE(self):
        self._route("DELETE")

    def _route(self, method):
        path = self.path.split("?")[0]
        try:
            for pattern, meth, fn in ROUTES:
                if meth != method:
                    continue
                m = re.fullmatch(pattern, path)
                if m:
                    fn(self, *m.groups())
                    return
            raise ApiError(404, "Not found")
        except ApiError as e:
            self._send_json({"detail": e.message}, e.status)
        except BrokenPipeError:
            pass
        except Exception as e:
            self._send_json({"detail": f"Internal error: {e}"}, 500)

    # -- endpoints ----------------------------------------------------------------
    def ep_version(self):
        from sherpa_vietnamese_asr_tpu_torch import __version__

        self._send_json({"version": __version__,
                         "backend": f"torch-{self.state.device.type}"})

    def ep_models(self):
        from sherpa_vietnamese_asr_tpu_torch.utils.config import MODEL_DOWNLOAD_INFO

        self._send_json({
            "models": [{"id": k, "name": v["name"],
                        "description": v["description"]}
                       for k, v in MODEL_DOWNLOAD_INFO.items()]
            + [{"id": "rover-voting", "name": "ROVER (30M+68M)",
                "description": "Dual-model fusion"}],
        })

    def ep_defaults(self):
        """Config-driven defaults (reference server.py:558-573)."""
        cfg = self.state.config
        self._send_json({
            "asr_model": cfg.get("default_asr_model"),
            "speaker_model": cfg.get("default_speaker_model"),
            "punctuation_confidence":
                cfg.get_int("default_punctuation_confidence"),
            "case_confidence": cfg.get_int("default_case_confidence"),
            "diarization_threshold":
                cfg.get_int("default_diarization_threshold"),
            "execution_provider": cfg.get("execution_provider") or "auto",
            "serving_profile": self._calibration_profile(),
            "max_upload_mb": cfg.get_int("max_upload_mb"),
        })

    def ep_create_session(self):
        """Create (or return) a session. Mirrors reference
        server.py:651-696: an existing valid session is reused; at the
        max_sessions cap the longest-idle disconnected anonymous session is
        evicted, else 503."""
        existing = self.state.db.get_session(self._session_id())
        if existing:
            self._send_json({"session_id": existing["id"],
                             "is_anonymous": bool(
                                 existing.get("is_anonymous", 1)),
                             "user_id": existing.get("user_id")})
            return
        max_sessions = self.state.config.get_int("max_sessions")
        if self.state.db.get_active_session_count() >= max_sessions:
            oldest = self.state.db.get_oldest_idle_anonymous_session()
            if oldest and not self.state.ws_connected(oldest["id"]):
                self.state.kill_session(oldest["id"])
            else:
                raise ApiError(503, "Server full; try again later")
        sid = uuid.uuid4().hex
        self.state.db.create_session(
            sid, ip_address=self._client_ip(),
            user_agent=self.headers.get("User-Agent", ""))
        self._send_json({"session_id": sid, "is_anonymous": True,
                         "user_id": None})

    def ep_get_session(self):
        sess = self.state.db.get_session(self._session_id())
        if not sess:
            raise ApiError(404, "Session not found")
        self._send_json({"session": sess})

    def ep_heartbeat(self):
        self.state.db.update_heartbeat(self._session_id())
        self._send_json({"ok": True})

    def ep_login(self):
        ip = self._client_ip()
        if self.state.login_limiter.is_locked(ip):
            raise ApiError(429, "Too many failed logins; try again later")
        body = self._read_json()
        username = str(body.get("username", ""))[:64]
        password = str(body.get("password", ""))[:256]
        if self.state.account_limiter.is_locked(username):
            raise ApiError(429, "Account temporarily locked")
        user = self.state.db.get_user_by_username(username)
        if not user or not verify_password(password, user["password_hash"]) \
                or not user.get("is_active", 1):
            self.state.login_limiter.record_failure(ip)
            self.state.account_limiter.record_failure(username)
            raise ApiError(401, "Invalid credentials")
        self.state.login_limiter.clear(ip)
        self.state.account_limiter.clear(username)
        token = self.state.auth.create_token(
            {"user_id": user["id"], "role": user["role"]})
        if self._session_id():
            self.state.db.link_session_to_user(self._session_id(),
                                               user["id"])
        self._send_json({"token": token, "user": {
            "id": user["id"], "username": user["username"],
            "role": user["role"]}})

    def ep_me(self):
        user = self._require_auth()
        self._send_json({"user": {"id": user["id"],
                                  "username": user["username"],
                                  "role": user["role"]}})

    def ep_logout(self):
        authz = self.headers.get("Authorization") or ""
        if authz.startswith("Bearer "):
            self.state.auth.revoke_token(authz[7:])
        self._send_json({"ok": True})

    def ep_change_password(self):
        user = self._require_auth()
        body = self._read_json()
        if not verify_password(str(body.get("old_password", "")),
                               user["password_hash"]):
            raise ApiError(401, "Wrong password")
        new = str(body.get("new_password", ""))
        if len(new) < 4:
            raise ApiError(400, "Password too short")
        self.state.db.update_user(user["id"],
                                  password_hash=hash_password(new))
        self._send_json({"ok": True})

    def ep_upload(self):
        """Upload an audio/video file. Validation chain mirrors reference
        server.py:845-940: rate limit, extension allowlist, anonymous
        single-file cleanup, size cap while streaming to disk, per-user
        storage quota."""
        import html as _html

        sid = self._session_id()
        user = self._current_user()
        if (not sid or not self.state.db.get_session(sid)) and not user:
            raise ApiError(401, "Valid session required")
        self.state.check_upload_rate(sid or str(user["id"]))
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ApiError(400, "Empty upload")
        max_size = self.state.config.max_upload_bytes
        filename = os.path.basename(
            self.headers.get("X-Filename") or "upload.wav")
        if not re.fullmatch(r"[\w .()\[\]-]{1,255}", filename):
            raise ApiError(400, "Invalid filename")
        ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
        if ext not in ALLOWED_EXTENSIONS:
            raise ApiError(400, f"Unsupported format: .{ext}")
        # Anonymous sessions keep ONE file: drop previous uploads first.
        if not user and sid:
            for old in self.state.db.delete_session_files(sid):
                delete_upload_artifacts(self.state.upload_dir, old)
        stored = f"{uuid.uuid4().hex}_{filename}"
        dest = os.path.join(self.state.upload_dir, stored)
        remaining = length
        written = 0
        with open(dest, "wb") as f:
            while remaining > 0:
                chunk = self.rfile.read(min(65536, remaining))
                if not chunk:
                    break
                written += len(chunk)
                if written > max_size:
                    f.close()
                    os.remove(dest)
                    raise ApiError(
                        413, "File too large (max "
                        f"{self.state.config.get('max_upload_mb')} MB)")
                f.write(chunk)
                remaining -= len(chunk)
        if user and float(user.get("storage_limit_gb") or 0) > 0:
            limit = int(float(user["storage_limit_gb"]) * 1024 ** 3)
            used = int(user.get("storage_used_bytes") or 0)
            if used + written > limit:
                os.remove(dest)
                raise ApiError(400, "Storage limit exceeded")
        safe_name = _html.escape(filename[:500], quote=False)
        file_id = self.state.db.create_file(
            sid, safe_name, stored, file_size_bytes=written,
            user_id=user["id"] if user else None)
        if user:
            self.state.db.update_user_storage(user["id"])
        self._send_json({"file_id": file_id, "filename": filename,
                         "size": written})

    def ep_process(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        if rec["status"] in ("queued", "processing"):
            raise ApiError(409, "Already queued")
        config = self._read_json()
        position = self.state.queue.add_to_queue(
            file_id, rec["session_id"], config)
        self._send_json({"ok": True, "queue_position": position})

    def ep_cancel(self, file_id):
        file_id = int(file_id)
        self._check_file_access(self.state.db.get_file(file_id))
        ok = self.state.queue.cancel(file_id)
        self._send_json({"ok": ok})

    def ep_status(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        item = self.state.db.get_queue_item(file_id) or {}
        self._send_json({
            "status": rec["status"],
            "progress_percent": item.get("progress_percent", 0),
            "progress_message": item.get("progress_message", ""),
            "queue_position": self.state.db.get_queue_position(file_id),
        })

    def ep_result(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        if rec["status"] != "completed" or not rec.get("asr_result_json"):
            raise ApiError(409, f"Not completed (status={rec['status']})")
        self._send_json({"result": json.loads(rec["asr_result_json"]),
                         "speaker_names": json.loads(
                             rec.get("speaker_names_json") or "{}")})

    def ep_rename_speakers(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        body = self._read_json()
        names = body.get("speaker_names", {})
        if not isinstance(names, dict):
            raise ApiError(400, "speaker_names must be a mapping")
        self.state.db.push_edit_history(
            file_id, "rename-speakers", rec.get("asr_result_json"),
            rec.get("speaker_names_json"))
        self.state.db.update_file(
            file_id, speaker_names_json=json.dumps(names,
                                                   ensure_ascii=False))
        self._send_json({"ok": True})

    def ep_split_speaker(self, file_id):
        """Split a speaker at a text segment (reference server.py:1325-1422):
        inserts a speaker separator before the target segment, with scope
        'single' restoring the original speaker afterwards."""
        import html as _html

        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        body = self._read_json()
        seg_index = body.get("seg_index")
        new_speaker = _html.escape(
            str(body.get("new_speaker", "")).strip()[:200], quote=False)
        scope = body.get("scope", "to_end")
        if seg_index is None or not rec.get("asr_result_json"):
            raise ApiError(400, "Invalid request")
        data = json.loads(rec["asr_result_json"])
        segments = data.get("segments", [])
        speaker_names = data.get("speaker_names", {})

        max_id = max([s.get("speaker_id", 0) for s in segments
                      if s.get("type") == "speaker"] + [-1])
        new_id = None
        for sid, name in speaker_names.items():
            if name == new_speaker:
                new_id = int(sid)
                break
        if new_id is None:
            new_id = max_id + 1
            speaker_names[str(new_id)] = new_speaker

        text_idx = 0
        target_pos = None
        current_sep = None
        for i, seg in enumerate(segments):
            if seg.get("type") == "speaker":
                current_sep = seg
            elif seg.get("type") == "text":
                if text_idx == int(seg_index):
                    target_pos = i
                    break
                text_idx += 1
        if target_pos is not None:
            segments.insert(target_pos, {
                "type": "speaker", "speaker": new_speaker,
                "speaker_id": new_id,
                "start_time": segments[target_pos + 1].get("start_time", 0)
                if target_pos + 1 < len(segments) else 0,
            })
            if scope == "single" and current_sep:
                restore_pos = target_pos + 2
                restore_time = (segments[restore_pos].get("start_time", 0)
                                if restore_pos < len(segments) else 0)
                segments.insert(restore_pos, {
                    "type": "speaker",
                    "speaker": current_sep.get("speaker", ""),
                    "speaker_id": current_sep.get("speaker_id", 0),
                    "start_time": restore_time,
                })
        data["segments"] = segments
        data["speaker_names"] = speaker_names
        self.state.db.push_edit_history(
            file_id, "split-speaker", rec.get("asr_result_json"),
            rec.get("speaker_names_json"))
        self.state.db.update_file(
            file_id,
            asr_result_json=json.dumps(data, ensure_ascii=False),
            speaker_names_json=json.dumps(speaker_names, ensure_ascii=False))
        self._send_json({"success": True, "result": data})

    def ep_merge_speaker(self, file_id):
        """Merge a speaker block up/down, optionally partially at seg_index
        (reference server.py:1424-1535)."""
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        body = self._read_json()
        block_index = body.get("block_index")
        direction = body.get("direction", "up")
        seg_index = body.get("seg_index")
        if block_index is None or not rec.get("asr_result_json"):
            raise ApiError(400, "Invalid request")
        data = json.loads(rec["asr_result_json"])
        segments = data.get("segments", [])
        sep_idx = [i for i, s in enumerate(segments)
                   if s.get("type") == "speaker"]
        block_index = int(block_index)
        if block_index < 0 or block_index >= len(sep_idx):
            raise ApiError(400, "Invalid block index")
        cur_i = sep_idx[block_index]
        cur_sep = segments[cur_i]

        actual = None
        if seg_index is not None:
            count = 0
            for i, s in enumerate(segments):
                if s.get("type") == "text":
                    if count == int(seg_index):
                        actual = i
                        break
                    count += 1
        next_i = (sep_idx[block_index + 1]
                  if block_index + 1 < len(sep_idx) else len(segments))
        block_texts = [i for i in range(cur_i + 1, next_i)
                       if segments[i].get("type") == "text"]

        if direction == "up" and block_index > 0:
            last = (actual is None or not block_texts
                    or actual >= block_texts[-1])
            segments.pop(cur_i)
            if not last:
                insert_pos = actual  # actual shifted -1 by pop, +1 to insert after
                restore_time = (segments[insert_pos].get("start_time", 0)
                                if insert_pos < len(segments) else 0)
                segments.insert(insert_pos, {
                    "type": "speaker",
                    "speaker": cur_sep.get("speaker", ""),
                    "speaker_id": cur_sep.get("speaker_id", 0),
                    "start_time": restore_time,
                })
        elif direction == "down" and block_index < len(sep_idx) - 1:
            nxt_i = sep_idx[block_index + 1]
            nxt_sep = segments[nxt_i]
            first = (actual is None or not block_texts
                     or actual <= block_texts[0])
            segments.pop(nxt_i)
            if not first:
                segments.insert(actual, {
                    "type": "speaker",
                    "speaker": nxt_sep.get("speaker", ""),
                    "speaker_id": nxt_sep.get("speaker_id", 0),
                    "start_time": segments[actual].get("start_time", 0)
                    if actual < len(segments) else 0,
                })
        data["segments"] = segments
        self.state.db.push_edit_history(
            file_id, "merge-speaker", rec.get("asr_result_json"),
            rec.get("speaker_names_json"))
        self.state.db.update_file(
            file_id, asr_result_json=json.dumps(data, ensure_ascii=False))
        self._send_json({"success": True, "result": data})

    def ep_undo_edit(self, file_id):
        """Undo the most recent transcript edit (split/merge/rename/save):
        restores the pre-edit snapshot from the persisted per-file undo
        stack — the web analogue of the reference desktop editor's undo
        (reference tab_file.py:285-360)."""
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        snap = self.state.db.pop_edit_history(file_id)
        if not snap:
            raise ApiError(409, "Nothing to undo")
        self.state.db.update_file(
            file_id,
            asr_result_json=snap["asr_result_json"],
            speaker_names_json=snap["speaker_names_json"])
        data = (json.loads(snap["asr_result_json"])
                if snap["asr_result_json"] else None)
        self._send_json({
            "success": True, "undone_op": snap["op"], "result": data,
            "speaker_names": json.loads(snap["speaker_names_json"] or "{}"),
            "remaining": len(self.state.db.get_edit_history(file_id))})

    def ep_edit_history(self, file_id):
        """Newest-first list of undoable edits for a file."""
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        self._send_json(
            {"history": self.state.db.get_edit_history(file_id)})

    def ep_user_files(self):
        user = self._require_auth()
        self._send_json({"files": [
            {k: f[k] for k in ("id", "original_filename", "status",
                               "duration_sec", "created_at")}
            for f in self.state.db.get_user_files(user["id"])]})

    def ep_delete_file(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        delete_upload_artifacts(self.state.upload_dir,
                                rec["stored_filename"])
        self.state.db.delete_file(file_id)
        self.state.db.remove_from_queue(file_id)
        if rec.get("user_id"):
            self.state.db.update_user_storage(rec["user_id"])
        self._send_json({"ok": True})

    def ep_meetings(self):
        user = self._require_auth()
        self._send_json(
            {"meetings": self.state.db.get_user_meetings(user["id"])})

    def ep_meeting(self, meeting_id):
        user = self._require_auth()
        m = self.state.db.get_meeting(int(meeting_id))
        if not m or (m["user_id"] != user["id"]
                     and user.get("role") != "admin"):
            raise ApiError(404, "Meeting not found")
        self._send_json({"meeting": m})

    def ep_update_meeting(self, meeting_id):
        user = self._require_auth()
        m = self.state.db.get_meeting(int(meeting_id))
        if not m or m["user_id"] != user["id"]:
            raise ApiError(404, "Meeting not found")
        body = self._read_json()
        updates = {k: body[k] for k in ("meeting_name", "asr_result_json")
                   if k in body}
        self.state.db.update_meeting(int(meeting_id), **updates)
        self._send_json({"ok": True})

    def ep_delete_meeting(self, meeting_id):
        user = self._require_auth()
        m = self.state.db.get_meeting(int(meeting_id))
        if not m or m["user_id"] != user["id"]:
            raise ApiError(404, "Meeting not found")
        self.state.db.delete_meeting(int(meeting_id))
        self._send_json({"ok": True})

    def ep_stats(self):
        self._require_admin()
        self._send_json({"stats": self.state.db.get_stats()})

    def ep_queue_state(self):
        self._require_admin()
        self._send_json({"queue": self.state.db.get_waiting_queue(),
                         "paused": self.state.queue.paused,
                         "current": self.state.queue.current_file_id})

    def ep_queue_pause(self):
        self._require_admin()
        self.state.queue.pause()
        self._send_json({"ok": True})

    def ep_queue_resume(self):
        self._require_admin()
        self.state.queue.resume()
        self._send_json({"ok": True})

    def ep_queue_cancel(self, file_id):
        self._require_admin()
        self._send_json({"ok": self.state.queue.cancel(int(file_id))})

    def ep_admin_users(self):
        self._require_admin()
        users = [{k: u[k] for k in ("id", "username", "role", "is_active",
                                    "storage_limit_gb", "created_at")}
                 for u in self.state.db.get_all_users()]
        self._send_json({"users": users})

    # Shared user-management bodies (used by /api/admin/* with JWT and the
    # localhost-only /api/local/* GUI-admin aliases, reference
    # server.py:1925-1994 / 2034-2094).
    def _h_create_user(self):
        body = self._read_json()
        username = str(body.get("username", "")).strip()[:64]
        password = str(body.get("password", ""))
        if not re.fullmatch(r"[\w.-]{2,64}", username):
            raise ApiError(400, "Username must be at least 2 characters")
        if len(password) < 8:
            raise ApiError(400, "Password must be at least 8 characters")
        if self.state.db.get_user_by_username(username):
            raise ApiError(409, f"Username '{username}' already exists")
        uid = self.state.db.create_user(
            username, hash_password(password),
            role=body.get("role", "user"),
            storage_limit_gb=float(body.get("storage_limit_gb", 5.0)))
        self._send_json({"ok": True, "user_id": uid, "username": username})

    def _h_update_user(self, user_id):
        body = self._read_json()
        updates = {}
        if "storage_limit_gb" in body:
            updates["storage_limit_gb"] = float(body["storage_limit_gb"])
        if "is_active" in body:
            updates["is_active"] = 1 if body["is_active"] else 0
        if updates:
            self.state.db.update_user(int(user_id), **updates)
        self._send_json({"ok": True})

    def _h_reset_password(self, user_id):
        body = self._read_json()
        new = str(body.get("password", ""))
        if len(new) < 8:
            raise ApiError(400, "Password must be at least 8 characters")
        self.state.db.update_user(int(user_id),
                                  password_hash=hash_password(new))
        self._send_json({"ok": True})

    def _h_delete_user(self, user_id):
        user = self.state.db.get_user_by_id(int(user_id))
        if not user:
            raise ApiError(404, "User not found")
        if user["role"] == "admin":
            raise ApiError(400, "Cannot delete an admin account")
        self.state.db.delete_user(int(user_id))
        self._send_json({"ok": True})

    def ep_admin_create_user(self):
        self._require_admin()
        self._h_create_user()

    def ep_admin_update_user(self, user_id):
        self._require_admin()
        self._h_update_user(user_id)

    def ep_admin_reset_password(self, user_id):
        self._require_admin()
        self._h_reset_password(user_id)

    def ep_admin_delete_user(self, user_id):
        self._require_admin()
        self._h_delete_user(user_id)

    # -- sessions administration -------------------------------------------
    def _h_sessions(self):
        self._send_json({"sessions": self.state.db.get_all_sessions()})

    def _h_kill_session(self, session_id):
        self.state.kill_session(session_id)
        self._send_json({"success": True})

    def _h_cleanup_sessions(self):
        cleaned = self.state.cleanup_expired_sessions()
        self._send_json({"success": True, "cleaned_count": cleaned})

    def ep_admin_sessions(self):
        self._require_admin()
        self._h_sessions()

    def ep_admin_kill_session(self, session_id):
        self._require_admin()
        self._h_kill_session(session_id)

    def ep_admin_cleanup_sessions(self):
        self._require_admin()
        self._h_cleanup_sessions()

    # -- server config ------------------------------------------------------
    def ep_admin_get_config(self):
        self._require_admin()
        cfg = self.state.config.to_dict()
        cfg.pop("admin_password_hash", None)
        self._send_json(cfg)

    def ep_admin_put_config(self):
        """Validated config update (reference server.py:2130-2151):
        unknown and read-only keys are skipped, known keys validated."""
        self._require_admin()
        body = self._read_json()
        cfg = self.state.config
        changed = []
        for key, value in body.items():
            if key not in cfg.DEFAULTS or key in cfg.READONLY:
                continue
            if not cfg.validate(key, value):
                raise ApiError(400, f"Invalid value for {key}")
            cfg.set(key, value)
            changed.append(key)
        cfg.save()
        self._send_json({"success": True, "changed": changed})

    def ep_admin_download_summarizer(self):
        """Reference downloads the GGUF summarizer from HuggingFace
        (server.py:2153-2176); this deployment is offline, so the endpoint
        validates a locally provisioned model instead."""
        self._require_admin()
        path = self.state.config.get("summarizer_model_path")
        if path and os.path.isfile(path):
            self._send_json({"success": True, "path": path,
                             "message": "Model already present"})
            return
        raise ApiError(503, "Model download requires network access; "
                            "provision summarizer_model_path manually "
                            "(scripts/download_models.py)")

    # -- localhost-only GUI-admin aliases (no JWT) --------------------------
    def ep_stats_local(self):
        self._require_localhost()
        self._send_json({"stats": self.state.db.get_stats()})

    def ep_local_sessions(self):
        self._require_localhost()
        self._h_sessions()

    def ep_local_kill_session(self, session_id):
        self._require_localhost()
        self._h_kill_session(session_id)

    def ep_local_cleanup_sessions(self):
        self._require_localhost()
        self._h_cleanup_sessions()

    def ep_local_rate_limits(self):
        self._require_localhost()
        self._send_json({"locked_ips": self.state.login_limiter.locked_keys(),
                         "locked_accounts":
                             self.state.account_limiter.locked_keys()})

    def ep_local_rate_limits_clear(self):
        self._require_localhost()
        self.state.login_limiter.clear()
        self.state.account_limiter.clear()
        self._send_json({"ok": True})

    def ep_local_queue(self):
        self._require_localhost()
        self._send_json({"queue": self.state.db.get_all_queue(),
                         "paused": self.state.queue.paused,
                         "current": self.state.queue.current_file_id})

    def ep_local_queue_pause(self):
        self._require_localhost()
        self.state.queue.pause()
        self._send_json({"ok": True})

    def ep_local_queue_resume(self):
        self._require_localhost()
        self.state.queue.resume()
        self._send_json({"ok": True})

    def ep_local_queue_cancel(self, file_id):
        self._require_localhost()
        self._send_json({"ok": self.state.queue.cancel(int(file_id))})

    def ep_local_users(self):
        self._require_localhost()
        users = [{k: u[k] for k in ("id", "username", "role", "is_active",
                                    "storage_limit_gb", "created_at")}
                 for u in self.state.db.get_all_users()]
        self._send_json({"users": users})

    def ep_local_create_user(self):
        self._require_localhost()
        self._h_create_user()

    def ep_local_update_user(self, user_id):
        self._require_localhost()
        self._h_update_user(user_id)

    def ep_local_reset_password(self, user_id):
        self._require_localhost()
        self._h_reset_password(user_id)

    def ep_local_delete_user(self, user_id):
        self._require_localhost()
        self._h_delete_user(user_id)

    def ep_rate_limits(self):
        self._require_admin()
        self._send_json({"locked_ips": self.state.login_limiter.locked_keys(),
                         "locked_accounts":
                             self.state.account_limiter.locked_keys()})

    def ep_rate_limits_clear(self):
        self._require_admin()
        self.state.login_limiter.clear()
        self.state.account_limiter.clear()
        self._send_json({"ok": True})

    def ep_summarize(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        if rec["status"] != "completed" or not rec.get("asr_result_json"):
            raise ApiError(409, "Transcription not completed")
        from sherpa_vietnamese_asr_tpu_torch.web_service.summarizer import Summarizer

        data = json.loads(rec["asr_result_json"])
        text = data.get("text") or " ".join(
            s.get("text", "") for s in data.get("segments", [])
            if s.get("type") == "text")
        summary = Summarizer(device=self.state.device).summarize(text)
        self.state.db.update_file(
            file_id, summary_json=json.dumps(summary, ensure_ascii=False))
        self._send_json({"summary": summary})

    def ep_get_summary(self, file_id):
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        if not rec.get("summary_json"):
            raise ApiError(404, "No summary")
        self._send_json({"summary": json.loads(rec["summary_json"])})

    def ep_summarizer_status(self):
        from sherpa_vietnamese_asr_tpu_torch.web_service.summarizer import Summarizer

        self._send_json(Summarizer(device=self.state.device).status())

    # -- pages / certificate ------------------------------------------------
    def ep_index(self):
        """GET / and /login. The reference serves its PWA frontend here
        (server.py:425-433); the browser UI is out of scope (PARITY.md), so
        this serves an API landing page — or a user-provided static/
        index.html if one is installed next to the data dir."""
        custom = os.path.join(self.state.data_dir, "static", "index.html")
        if os.path.exists(custom):
            self._send_file(custom, "text/html; charset=utf-8")
        else:
            self._send_html(INDEX_HTML)

    def ep_install_cert(self):
        """Download the live TLS certificate for client install
        (reference server.py:436-448)."""
        from sherpa_vietnamese_asr_tpu_torch.web_service.ssl_utils import (
            get_install_cert_path,
        )

        path = get_install_cert_path(self.state.cert_dir)
        if not path:
            raise ApiError(404, "SSL certificate not found")
        self._send_file(path, "application/x-x509-ca-cert",
                        download_name="sherpa-asr-vn.crt")

    # -- session status -----------------------------------------------------
    def ep_session_status(self):
        """Detailed session status (reference session_manager
        .get_session_status): identity, WS connectivity, active queue item,
        newest file."""
        sid = self._session_id()
        sess = self.state.db.get_session(sid)
        if not sess:
            raise ApiError(404, "Session not found")
        q = self.state.db.get_queue_status_for_session(sid)
        latest = self.state.db.get_latest_file_for_session(sid)
        self._send_json({
            "session_id": sid,
            "is_anonymous": bool(sess.get("is_anonymous", 1)),
            "user_id": sess.get("user_id"),
            "connected": self.state.ws_connected(sid),
            "queue_item": {
                "file_id": q["file_id"], "status": q["status"],
                "progress_percent": q["progress_percent"],
                "progress_message": q["progress_message"],
                "original_filename": q.get("original_filename"),
            } if q else None,
            "latest_file": {
                "file_id": latest["id"],
                "original_filename": latest["original_filename"],
                "status": latest["status"],
                "has_result": bool(latest["has_result"]),
            } if latest else None,
        })

    # -- result import/export ----------------------------------------------
    def _read_result_json(self, max_bytes=MAX_RESULT_JSON_BYTES):
        length = int(self.headers.get("Content-Length") or 0)
        if length > max_bytes:
            raise ApiError(400, "JSON too large (max 50 MB)")
        if length == 0:
            return {}
        try:
            return json.loads(self.rfile.read(length).decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise ApiError(400, "Invalid JSON")

    def ep_upload_json(self, file_id):
        """Attach a previously exported ASR JSON to an uploaded file
        (reference server.py:940-978): sanitize, store, mark completed."""
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        data = self._read_result_json()
        if "segments" not in data:
            raise ApiError(400, "Not an ASR result JSON (missing "
                                "'segments')")
        data = sanitize_asr_json(data)
        names = data.get("speaker_names", {})
        self.state.db.update_file(
            file_id, status="completed",
            asr_result_json=json.dumps(data, ensure_ascii=False),
            speaker_names_json=json.dumps(names, ensure_ascii=False),
            model_used=data.get("model", "imported"),
            duration_sec=data.get("duration_sec", 0))
        self._send_json({"success": True, "message": "JSON loaded"})

    def ep_save_result(self, file_id):
        """Save a client-edited result (logged-in users; reference
        server.py:1137-1168); syncs the linked meeting best-effort."""
        self._require_auth()
        file_id = int(file_id)
        rec = self.state.db.get_file(file_id)
        self._check_file_access(rec)
        body = self._read_result_json()
        asr_data = body.get("asr_result")
        if not asr_data or not isinstance(asr_data, dict):
            raise ApiError(400, "Missing asr_result")
        if "segments" not in asr_data:
            raise ApiError(400, "asr_result missing 'segments'")
        result_json = json.dumps(sanitize_asr_json(asr_data),
                                 ensure_ascii=False)
        self.state.db.push_edit_history(
            file_id, "save-result", rec.get("asr_result_json"),
            rec.get("speaker_names_json"))
        self.state.db.update_file(file_id, asr_result_json=result_json)
        try:
            meeting = self.state.db.get_meeting_by_file_id(file_id)
            if meeting:
                self.state.db.update_meeting(meeting["id"],
                                             asr_result_json=result_json)
        except Exception:
            pass  # meeting sync is best-effort
        self._send_json({"ok": True})

    def ep_file_audio(self, file_id):
        rec = self.state.db.get_file(int(file_id))
        self._check_file_access(rec)
        self._serve_stored_audio(rec["stored_filename"],
                                 rec["original_filename"])

    def ep_download_audio(self, file_id):
        rec = self.state.db.get_file(int(file_id))
        self._check_file_access(rec)
        self._serve_stored_audio(rec["stored_filename"],
                                 rec["original_filename"], download=True)

    def ep_download_json(self, file_id):
        rec = self.state.db.get_file(int(file_id))
        self._check_file_access(rec)
        if not rec.get("asr_result_json"):
            raise ApiError(404, "No ASR result yet")
        from urllib.parse import quote

        base = rec["original_filename"].rsplit(".", 1)[0]
        body = rec["asr_result_json"].encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header(
            "Content-Disposition",
            f"attachment; filename*=UTF-8''{quote(base + '.asr.json')}")
        for k, v in SECURITY_HEADERS.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def ep_queue_position(self, file_id):
        file_id = int(file_id)
        self._check_file_access(self.state.db.get_file(file_id))
        self._send_json({
            "position": self.state.db.get_queue_position(file_id),
            "total": self.state.db.get_queue_total_waiting()})

    def ep_meeting_audio(self, meeting_id):
        user = self._require_auth()
        m = self.state.db.get_meeting(int(meeting_id))
        if not m or m["user_id"] != user["id"]:
            raise ApiError(404, "Meeting not found")
        self._serve_stored_audio(m["stored_filename"],
                                 m["original_filename"])

    # -- calibration --------------------------------------------------------
    # The reference persists an ORT execution-provider profile
    # (server.py:575-651); the TPU analogue is backend (auto/cpu) + the
    # calibrated serving dtype/batch, persisted in the same way.
    def _calibration_profile(self):
        return {
            "serving_dtype": self.state.config.get("serving_dtype"),
            "max_batch": self.state.config.get_int("max_batch"),
        }

    def ep_calibration_status(self):
        status = {"current_execution_provider":
                  self.state.config.get("execution_provider") or "auto",
                  "current_serving_profile": self._calibration_profile()}
        import torch

        status["backend"] = f"torch-{self.state.device.type}"
        status["devices"] = (
            [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else ["cpu"])
        report_path = os.path.join(self.state.data_dir,
                                   "calibration_report.json")
        status["calibrated"] = os.path.exists(report_path)
        self._send_json(status)

    def _reject_if_processing(self):
        if self.state.queue.current_file_id is not None:
            raise ApiError(409, "A file is being processed; wait for it "
                                "to finish before calibrating")

    def ep_calibration_run(self):
        """Run device calibration and persist the accepted profile
        (reference server.py:586-618)."""
        self._reject_if_processing()
        body = self._read_json()
        from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import (
            autotune_max_batch,
            run_device_calibration,
        )

        report_path = os.path.join(self.state.data_dir,
                                   "calibration_report.json")
        report = run_device_calibration(report_path=report_path)
        selected = "auto" if report.get("accelerated_stages") else "cpu"
        self.state.config.set("execution_provider", selected)
        if body.get("autotune"):
            best = autotune_max_batch(device=self.state.device)["best_batch"]
            if best:
                self.state.config.set("max_batch", int(best))
        self.state.config.save()
        report["current_execution_provider"] = selected
        report["current_serving_profile"] = self._calibration_profile()
        self._send_json(report)

    def ep_calibration_cpu_only(self):
        """Force the CPU backend while keeping the saved profile
        (reference server.py:620-631)."""
        self._reject_if_processing()
        self.state.config.set("execution_provider", "cpu")
        self.state.config.save()
        self._send_json({"current_execution_provider": "cpu",
                         "current_serving_profile":
                             self._calibration_profile()})

    def ep_calibration_auto(self):
        """Switch back to the calibrated accelerator profile (reference
        /api/calibration/gpu-auto, server.py:633-651; path kept for API
        compatibility — the accelerator here is the TPU)."""
        self._reject_if_processing()
        report_path = os.path.join(self.state.data_dir,
                                   "calibration_report.json")
        accepted = []
        try:
            with open(report_path, encoding="utf-8") as f:
                accepted = json.load(f).get("accelerated_stages") or []
        except (OSError, ValueError):
            pass
        if not accepted:
            raise ApiError(400, "No saved calibration profile. Run "
                                "calibration first.")
        self.state.config.set("execution_provider", "auto")
        self.state.config.save()
        self._send_json({"current_execution_provider": "auto",
                         "current_serving_profile":
                             self._calibration_profile()})

    # -- websocket ---------------------------------------------------------------
    def _ws_session_id(self):
        """Session id from the X-Session-Id header or ?session_id= query
        (the reference accepts query/cookie, server.py:2180-2186)."""
        sid = self._session_id()
        if not sid and "?" in self.path:
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            sid = (q.get("session_id") or [""])[0]
        return sid

    def ep_websocket(self):
        """Progress push + client messages: 'heartbeat' -> heartbeat_ack
        (+ DB heartbeat), 'subscribe_queue' -> immediate queue_position
        (position -1 on invalid/denied file). Invalid sessions are closed
        with code 4001 (reference server.py:2178-2251)."""
        self._ws_handshake()
        sock = self.connection
        sock.settimeout(300)
        sid = self._ws_session_id()
        session = self.state.db.get_session(sid) if sid else None
        if not session:
            sock.sendall(_ws_frame(
                struct.pack(">H", 4001) + b"Invalid session", opcode=0x8))
            return
        self.state.add_ws_client(sid, sock)
        try:
            while True:
                opcode, payload = self._ws_read_frame(sock)
                if opcode is None or opcode == 0x8:    # EOF / close
                    break
                if opcode == 0x9:                       # ping -> pong
                    sock.sendall(_ws_frame(payload, opcode=0xA))
                    continue
                if opcode != 0x1:                       # only text msgs
                    continue
                try:
                    data = json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    continue
                msg_type = data.get("type", "")
                if msg_type == "heartbeat":
                    self.state.db.update_heartbeat(sid)
                    sock.sendall(_ws_frame(json.dumps(
                        {"type": "heartbeat_ack"}).encode()))
                elif msg_type == "subscribe_queue":
                    sock.sendall(_ws_frame(json.dumps(
                        self._queue_position_msg(session, sid,
                                                 data.get("file_id"))
                    ).encode()))
        except OSError:
            pass
        finally:
            self.state.remove_ws_client(sock)

    def _queue_position_msg(self, session, sid, file_id):
        denied = {"type": "queue_position", "file_id": file_id,
                  "position": -1, "total": 0}
        try:
            file_id = int(file_id)
        except (TypeError, ValueError):
            return denied
        denied["file_id"] = file_id
        rec = self.state.db.get_file(file_id)
        if rec is None:
            return denied
        user = None
        if session.get("user_id"):
            user = self.state.db.get_user_by_id(int(session["user_id"]))
        allowed = (rec.get("session_id") == sid) or (
            user and (user["id"] == rec.get("user_id")
                      or user.get("role") == "admin"))
        if not allowed:
            return denied
        return {"type": "queue_position", "file_id": file_id,
                "position": self.state.db.get_queue_position(file_id),
                "total": self.state.db.get_queue_total_waiting()}


    def _ws_handshake(self):
        key = self.headers.get("Sec-WebSocket-Key")
        if not key or self.headers.get("Upgrade", "").lower() != "websocket":
            raise ApiError(400, "WebSocket upgrade required")
        accept = base64.b64encode(hashlib.sha1(
            (key + _WS_MAGIC).encode()).digest()).decode()
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        self.end_headers()
        self.close_connection = True

    @staticmethod
    def _ws_read_frame(sock):
        """Read one frame; returns (opcode, payload) or (None, None) on
        EOF. Client->server payloads are unmasked per RFC 6455."""
        def recv_exact(n):
            buf = b""
            while len(buf) < n:
                part = sock.recv(n - len(buf))
                if not part:
                    return None
                buf += part
            return buf

        head = recv_exact(2)
        if head is None:
            return None, None
        opcode = head[0] & 0x0F
        ln = head[1] & 0x7F
        masked = head[1] & 0x80
        if ln == 126:
            ln = struct.unpack(">H", recv_exact(2))[0]
        elif ln == 127:
            ln = struct.unpack(">Q", recv_exact(8))[0]
        mask = recv_exact(4) if masked else None
        payload = recv_exact(ln) if ln else b""
        if payload is None:
            return None, None
        if mask:
            payload = bytes(b ^ mask[i % 4]
                            for i, b in enumerate(payload))
        return opcode, payload

    def ep_ws_stream(self):
        """Live transcription: client streams binary PCM16 mono 16 kHz
        frames; the server replies with JSON partials after each decoded
        chunk and a final on close. One slot of the shared batched
        recognizer per connection (reference's live mode is the desktop
        tab, streaming_asr_online.py; this is the server-side analogue)."""
        import numpy as np

        streamer = self.state.get_streamer()
        self._ws_handshake()
        sock = self.connection
        sock.settimeout(300)
        with self.state._streamer_lock:
            slot = streamer.open_stream()
        if slot is None:
            sock.sendall(_ws_frame(json.dumps(
                {"type": "error", "message": "all stream slots busy"}
            ).encode()))
            return
        sock.sendall(_ws_frame(json.dumps(
            {"type": "ready", "slot": slot}).encode()))
        try:
            while True:
                opcode, payload = self._ws_read_frame(sock)
                if opcode is None or opcode == 0x8:   # EOF / close
                    break
                if opcode == 0x9:                      # ping -> pong
                    sock.sendall(_ws_frame(payload, opcode=0xA))
                    continue
                if opcode == 0x2 and payload:          # binary PCM16
                    audio = np.frombuffer(payload, np.int16
                                          ).astype(np.float32) / 32768.0
                    emitted = False
                    with self.state._streamer_lock:
                        streamer.accept_waveform(slot, audio)
                        while slot in streamer.ready_slots():
                            out = streamer.step()
                            emitted = emitted or bool(out.get(slot))
                        text = streamer.get_result(slot)
                    if emitted:
                        sock.sendall(_ws_frame(json.dumps(
                            {"type": "partial", "text": text},
                            ensure_ascii=False).encode()))
        except OSError:
            pass
        finally:
            with self.state._streamer_lock:
                final = streamer.close_stream(slot)
            try:
                sock.sendall(_ws_frame(json.dumps(
                    {"type": "final", "text": final},
                    ensure_ascii=False).encode()))
            except OSError:
                pass


ROUTES = [
    (r"/", "GET", Handler.ep_index),
    (r"/login", "GET", Handler.ep_index),
    (r"/install-cert", "GET", Handler.ep_install_cert),
    (r"/api/version", "GET", Handler.ep_version),
    (r"/api/config/models", "GET", Handler.ep_models),
    (r"/api/config/defaults", "GET", Handler.ep_defaults),
    (r"/api/calibration/status", "GET", Handler.ep_calibration_status),
    (r"/api/calibration/run", "POST", Handler.ep_calibration_run),
    (r"/api/calibration/cpu-only", "POST", Handler.ep_calibration_cpu_only),
    (r"/api/calibration/gpu-auto", "POST", Handler.ep_calibration_auto),
    (r"/api/session", "POST", Handler.ep_create_session),
    (r"/api/session", "GET", Handler.ep_get_session),
    (r"/api/session/heartbeat", "POST", Handler.ep_heartbeat),
    (r"/api/session/status", "GET", Handler.ep_session_status),
    (r"/api/auth/login", "POST", Handler.ep_login),
    (r"/api/auth/me", "GET", Handler.ep_me),
    (r"/api/auth/logout", "POST", Handler.ep_logout),
    (r"/api/auth/change-password", "POST", Handler.ep_change_password),
    (r"/api/upload", "POST", Handler.ep_upload),
    (r"/api/upload-json/(\d+)", "POST", Handler.ep_upload_json),
    (r"/api/process/(\d+)", "POST", Handler.ep_process),
    (r"/api/cancel/(\d+)", "POST", Handler.ep_cancel),
    (r"/api/queue/position/(\d+)", "GET", Handler.ep_queue_position),
    (r"/api/files/(\d+)/status", "GET", Handler.ep_status),
    (r"/api/files/(\d+)/result", "GET", Handler.ep_result),
    (r"/api/files/(\d+)/save-result", "POST", Handler.ep_save_result),
    (r"/api/files/(\d+)/audio", "GET", Handler.ep_file_audio),
    (r"/api/files/(\d+)/download-audio", "GET", Handler.ep_download_audio),
    (r"/api/files/(\d+)/download-json", "GET", Handler.ep_download_json),
    (r"/api/files/(\d+)/speakers", "POST", Handler.ep_rename_speakers),
    (r"/api/files/(\d+)/split-speaker", "POST", Handler.ep_split_speaker),
    (r"/api/files/(\d+)/merge-speaker", "POST", Handler.ep_merge_speaker),
    (r"/api/files/(\d+)/undo-edit", "POST", Handler.ep_undo_edit),
    (r"/api/files/(\d+)/edit-history", "GET", Handler.ep_edit_history),
    (r"/api/files/(\d+)/summarize", "POST", Handler.ep_summarize),
    (r"/api/files/(\d+)/summary", "GET", Handler.ep_get_summary),
    (r"/api/summarizer/status", "GET", Handler.ep_summarizer_status),
    (r"/api/user/files", "GET", Handler.ep_user_files),
    (r"/api/user/files/(\d+)", "DELETE", Handler.ep_delete_file),
    (r"/api/meetings", "GET", Handler.ep_meetings),
    (r"/api/meetings/(\d+)", "GET", Handler.ep_meeting),
    (r"/api/meetings/(\d+)", "PUT", Handler.ep_update_meeting),
    (r"/api/meetings/(\d+)", "DELETE", Handler.ep_delete_meeting),
    (r"/api/meetings/(\d+)/audio", "GET", Handler.ep_meeting_audio),
    (r"/api/stats", "GET", Handler.ep_stats_local),
    (r"/api/admin/stats", "GET", Handler.ep_stats),
    (r"/api/admin/sessions", "GET", Handler.ep_admin_sessions),
    (r"/api/admin/sessions/([0-9a-f-]+)", "DELETE",
     Handler.ep_admin_kill_session),
    (r"/api/admin/sessions/cleanup", "POST",
     Handler.ep_admin_cleanup_sessions),
    (r"/api/admin/config", "GET", Handler.ep_admin_get_config),
    (r"/api/admin/config", "PUT", Handler.ep_admin_put_config),
    (r"/api/admin/download-summarizer-model", "POST",
     Handler.ep_admin_download_summarizer),
    (r"/api/admin/queue", "GET", Handler.ep_queue_state),
    (r"/api/admin/queue/pause", "POST", Handler.ep_queue_pause),
    (r"/api/admin/queue/resume", "POST", Handler.ep_queue_resume),
    (r"/api/admin/queue/cancel/(\d+)", "POST", Handler.ep_queue_cancel),
    (r"/api/admin/users", "GET", Handler.ep_admin_users),
    (r"/api/admin/users", "POST", Handler.ep_admin_create_user),
    (r"/api/admin/users/(\d+)", "PUT", Handler.ep_admin_update_user),
    (r"/api/admin/users/(\d+)", "DELETE", Handler.ep_admin_delete_user),
    (r"/api/admin/users/(\d+)/reset-password", "POST",
     Handler.ep_admin_reset_password),
    (r"/api/admin/rate-limits", "GET", Handler.ep_rate_limits),
    (r"/api/admin/rate-limits/clear", "POST", Handler.ep_rate_limits_clear),
    # Localhost-only GUI-admin aliases (no JWT; reference server.py
    # /api/local/* family)
    (r"/api/local/sessions", "GET", Handler.ep_local_sessions),
    (r"/api/local/sessions/([0-9a-f-]+)", "DELETE",
     Handler.ep_local_kill_session),
    (r"/api/local/sessions/cleanup", "POST",
     Handler.ep_local_cleanup_sessions),
    (r"/api/local/rate-limits", "GET", Handler.ep_local_rate_limits),
    (r"/api/local/rate-limits/clear", "POST",
     Handler.ep_local_rate_limits_clear),
    (r"/api/local/queue", "GET", Handler.ep_local_queue),
    (r"/api/local/queue/pause", "POST", Handler.ep_local_queue_pause),
    (r"/api/local/queue/resume", "POST", Handler.ep_local_queue_resume),
    (r"/api/local/queue/cancel/(\d+)", "POST",
     Handler.ep_local_queue_cancel),
    (r"/api/local/users", "GET", Handler.ep_local_users),
    (r"/api/local/users", "POST", Handler.ep_local_create_user),
    (r"/api/local/users/(\d+)", "PUT", Handler.ep_local_update_user),
    (r"/api/local/users/(\d+)", "DELETE", Handler.ep_local_delete_user),
    (r"/api/local/users/(\d+)/reset-password", "POST",
     Handler.ep_local_reset_password),
    (r"/ws", "GET", Handler.ep_websocket),
    (r"/ws/stream", "GET", Handler.ep_ws_stream),
]


def make_server(host="127.0.0.1", port=0, use_tls=False, **state_kwargs):
    """Create (server, state). Serve with server.serve_forever().

    use_tls: True = HTTPS with a self-signed (or custom.crt/key) pair in
    <data_dir>/certs, like the reference's default port-8443 mode; None =
    follow the persisted server config (http_mode — `svt serve` passes
    this); False (default, embedding/tests) = plain HTTP. Falls back to
    HTTP when no certificate backend is available.
    """
    state = AppState(**state_kwargs)
    state.bind_host = host

    class BoundHandler(Handler):
        pass

    BoundHandler.state = state
    server = ThreadingHTTPServer((host, port), BoundHandler)
    if use_tls is None:
        use_tls = state.config.get("http_mode") != "1"
    if use_tls:
        from sherpa_vietnamese_asr_tpu_torch.web_service.ssl_utils import (
            ensure_ssl_certs,
            publish_active_ssl_cert,
        )

        cert, key = ensure_ssl_certs(state.cert_dir)
        if cert and key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            server.socket = ctx.wrap_socket(server.socket, server_side=True)
            publish_active_ssl_cert(cert, key, data_dir=state.data_dir)
            state.tls_active = True
        else:
            state.tls_active = False
    else:
        state.tls_active = False
    return server, state
