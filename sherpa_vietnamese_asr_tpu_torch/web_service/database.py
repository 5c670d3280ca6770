# Copied from sherpa_vietnamese_asr_tpu/web_service/database.py (stdlib only; only the package path changes).
# SQLite persistence for the web service.
#
# Schema and operation set mirror reference web_service/database.py (users,
# sessions, files, queue, meetings; same columns) with a thread-safe
# connection-per-call wrapper (the workload is one transcription at a time;
# the reference's 8-connection pool exists for the same reason).

from __future__ import annotations

import json
import os
import sqlite3
import threading

SCHEMA_SQL = """
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    username TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    role TEXT DEFAULT 'user',
    storage_limit_gb REAL DEFAULT 5.0,
    storage_used_bytes INTEGER DEFAULT 0,
    is_active BOOLEAN DEFAULT 1,
    created_at TEXT DEFAULT (datetime('now')),
    updated_at TEXT DEFAULT (datetime('now'))
);
CREATE TABLE IF NOT EXISTS sessions (
    id TEXT PRIMARY KEY,
    user_id INTEGER NULL,
    ip_address TEXT,
    user_agent TEXT,
    is_anonymous BOOLEAN DEFAULT 1,
    last_heartbeat TEXT DEFAULT (datetime('now')),
    created_at TEXT DEFAULT (datetime('now')),
    expired_at TEXT NULL
);
CREATE TABLE IF NOT EXISTS files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    session_id TEXT NOT NULL,
    user_id INTEGER NULL,
    original_filename TEXT NOT NULL,
    stored_filename TEXT NOT NULL,
    file_size_bytes INTEGER DEFAULT 0,
    duration_sec REAL NULL,
    status TEXT DEFAULT 'uploaded',
    asr_result_json TEXT NULL,
    speaker_names_json TEXT NULL,
    model_used TEXT NULL,
    config_json TEXT NULL,
    summary_json TEXT NULL,
    created_at TEXT DEFAULT (datetime('now')),
    completed_at TEXT NULL
);
CREATE TABLE IF NOT EXISTS queue (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    file_id INTEGER NOT NULL UNIQUE,
    session_id TEXT NOT NULL,
    priority REAL NOT NULL,
    status TEXT DEFAULT 'waiting',
    progress_percent INTEGER DEFAULT 0,
    progress_message TEXT DEFAULT '',
    config_json TEXT,
    created_at TEXT DEFAULT (datetime('now')),
    started_at TEXT NULL,
    completed_at TEXT NULL
);
CREATE TABLE IF NOT EXISTS meetings (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER NOT NULL,
    file_id INTEGER NOT NULL,
    meeting_name TEXT NOT NULL,
    original_filename TEXT NOT NULL,
    stored_filename TEXT NOT NULL,
    asr_result_json TEXT NULL,
    status TEXT DEFAULT 'waiting',
    error_message TEXT NULL,
    file_size INTEGER DEFAULT 0,
    created_at TEXT DEFAULT (datetime('now')),
    updated_at TEXT DEFAULT (datetime('now'))
);
CREATE TABLE IF NOT EXISTS edit_history (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    file_id INTEGER NOT NULL,
    op TEXT NOT NULL,
    asr_result_json TEXT NULL,
    speaker_names_json TEXT NULL,
    created_at TEXT DEFAULT (datetime('now'))
);
CREATE INDEX IF NOT EXISTS idx_edit_history_file ON edit_history(file_id);
CREATE INDEX IF NOT EXISTS idx_sessions_anonymous
    ON sessions(is_anonymous, expired_at);
CREATE INDEX IF NOT EXISTS idx_files_session ON files(session_id);
CREATE INDEX IF NOT EXISTS idx_files_user ON files(user_id);
CREATE INDEX IF NOT EXISTS idx_queue_status ON queue(status, priority);
CREATE INDEX IF NOT EXISTS idx_meetings_user ON meetings(user_id);
"""


def _rows_to_dicts(cursor, rows):
    cols = [d[0] for d in cursor.description]
    return [dict(zip(cols, r)) for r in rows]


class Database:
    """Thread-safe SQLite wrapper (one shared connection + lock)."""

    def __init__(self, db_path=":memory:"):
        self.db_path = db_path
        if db_path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(db_path)),
                        exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._lock:
            self._conn.executescript(SCHEMA_SQL)
            self._conn.commit()

    def _exec(self, sql, params=(), fetch=None):
        with self._lock:
            cur = self._conn.execute(sql, params)
            if fetch == "one":
                row = cur.fetchone()
                out = _rows_to_dicts(cur, [row])[0] if row else None
            elif fetch == "all":
                out = _rows_to_dicts(cur, cur.fetchall())
            else:
                out = cur.lastrowid
            self._conn.commit()
            return out

    # -- users --------------------------------------------------------------
    def create_user(self, username, password_hash, role="user",
                    storage_limit_gb=5.0):
        return self._exec(
            "INSERT INTO users (username, password_hash, role, "
            "storage_limit_gb) VALUES (?, ?, ?, ?)",
            (username, password_hash, role, storage_limit_gb))

    def get_user_by_username(self, username):
        return self._exec("SELECT * FROM users WHERE username = ?",
                          (username,), fetch="one")

    def get_user_by_id(self, user_id):
        return self._exec("SELECT * FROM users WHERE id = ?", (user_id,),
                          fetch="one")

    def get_all_users(self):
        return self._exec("SELECT * FROM users ORDER BY id", fetch="all")

    def update_user(self, user_id, **kw):
        if not kw:
            return
        sets = ", ".join(f"{k} = ?" for k in kw)
        self._exec(f"UPDATE users SET {sets}, updated_at = datetime('now') "
                   "WHERE id = ?", (*kw.values(), user_id))

    def delete_user(self, user_id):
        self._exec("DELETE FROM users WHERE id = ?", (user_id,))

    # -- sessions -------------------------------------------------------------
    def create_session(self, session_id, ip_address="", user_agent="",
                       user_id=None):
        self._exec(
            "INSERT OR REPLACE INTO sessions (id, user_id, ip_address, "
            "user_agent, is_anonymous) VALUES (?, ?, ?, ?, ?)",
            (session_id, user_id, ip_address, user_agent,
             1 if user_id is None else 0))

    def get_session(self, session_id):
        return self._exec(
            "SELECT * FROM sessions WHERE id = ? AND expired_at IS NULL",
            (session_id,), fetch="one")

    def update_heartbeat(self, session_id):
        self._exec("UPDATE sessions SET last_heartbeat = datetime('now') "
                   "WHERE id = ?", (session_id,))

    def expire_session(self, session_id):
        self._exec("UPDATE sessions SET expired_at = datetime('now') "
                   "WHERE id = ?", (session_id,))

    def link_session_to_user(self, session_id, user_id):
        self._exec("UPDATE sessions SET user_id = ?, is_anonymous = 0 "
                   "WHERE id = ?", (user_id, session_id))

    def get_all_sessions(self):
        return self._exec("SELECT * FROM sessions WHERE expired_at IS NULL",
                          fetch="all")

    def get_active_session_count(self):
        row = self._exec(
            "SELECT COUNT(*) AS n FROM sessions WHERE expired_at IS NULL",
            fetch="one")
        return int(row["n"])

    def get_oldest_idle_anonymous_session(self):
        """Least-recently-heartbeating live anonymous session (eviction
        candidate when max_sessions is reached)."""
        return self._exec(
            "SELECT * FROM sessions WHERE is_anonymous = 1 AND expired_at "
            "IS NULL ORDER BY last_heartbeat LIMIT 1", fetch="one")

    def get_expired_anonymous_sessions(self, timeout_minutes):
        return self._exec(
            "SELECT * FROM sessions WHERE is_anonymous = 1 AND expired_at "
            "IS NULL AND last_heartbeat < datetime('now', ?)",
            (f"-{int(timeout_minutes)} minutes",), fetch="all")

    # -- files ------------------------------------------------------------------
    def create_file(self, session_id, original_filename, stored_filename,
                    file_size_bytes=0, user_id=None):
        return self._exec(
            "INSERT INTO files (session_id, user_id, original_filename, "
            "stored_filename, file_size_bytes) VALUES (?, ?, ?, ?, ?)",
            (session_id, user_id, original_filename, stored_filename,
             file_size_bytes))

    def get_file(self, file_id):
        return self._exec("SELECT * FROM files WHERE id = ?", (file_id,),
                          fetch="one")

    def get_session_files(self, session_id):
        return self._exec(
            "SELECT * FROM files WHERE session_id = ? ORDER BY id DESC",
            (session_id,), fetch="all")

    def get_user_files(self, user_id):
        return self._exec(
            "SELECT * FROM files WHERE user_id = ? ORDER BY id DESC",
            (user_id,), fetch="all")

    def get_latest_file_for_session(self, session_id):
        """Newest file of a session with a has_result flag (reference
        session_manager.get_session_status's latest_file block)."""
        return self._exec(
            "SELECT *, (asr_result_json IS NOT NULL) AS has_result "
            "FROM files WHERE session_id = ? ORDER BY id DESC LIMIT 1",
            (session_id,), fetch="one")

    def delete_session_files(self, session_id):
        """Delete all file rows of a session; returns their stored
        filenames so the caller can remove the uploads (the reference keeps
        one file per anonymous session, server.py:866-875)."""
        rows = self._exec(
            "SELECT stored_filename FROM files WHERE session_id = ? AND "
            "user_id IS NULL", (session_id,), fetch="all")
        self._exec("DELETE FROM files WHERE session_id = ? AND "
                   "user_id IS NULL", (session_id,))
        return [r["stored_filename"] for r in rows]

    def update_user_storage(self, user_id):
        """Recompute storage_used_bytes from the user's file rows."""
        row = self._exec(
            "SELECT COALESCE(SUM(file_size_bytes), 0) AS used FROM files "
            "WHERE user_id = ?", (user_id,), fetch="one")
        self._exec("UPDATE users SET storage_used_bytes = ? WHERE id = ?",
                   (int(row["used"]), user_id))
        return int(row["used"])

    def update_file(self, file_id, **kw):
        if not kw:
            return
        sets = ", ".join(f"{k} = ?" for k in kw)
        self._exec(f"UPDATE files SET {sets} WHERE id = ?",
                   (*kw.values(), file_id))

    def delete_file(self, file_id):
        self._exec("DELETE FROM files WHERE id = ?", (file_id,))
        self._exec("DELETE FROM edit_history WHERE file_id = ?", (file_id,))

    # -- transcript edit history (undo stack) --------------------------------
    # The reference desktop editor keeps an in-memory undo stack for speaker
    # split/merge/rename edits (reference tab_file.py:285-360); the web
    # service's equivalent is a persisted per-file stack so undo survives
    # reconnects. Capped at EDIT_HISTORY_DEPTH like a desktop undo buffer.
    EDIT_HISTORY_DEPTH = 50

    def push_edit_history(self, file_id, op, asr_result_json,
                          speaker_names_json):
        """Snapshot the PRE-edit state so undo restores it."""
        self._exec(
            "INSERT INTO edit_history (file_id, op, asr_result_json, "
            "speaker_names_json) VALUES (?, ?, ?, ?)",
            (file_id, op, asr_result_json, speaker_names_json))
        self._exec(
            "DELETE FROM edit_history WHERE file_id = ? AND id NOT IN "
            "(SELECT id FROM edit_history WHERE file_id = ? "
            " ORDER BY id DESC LIMIT ?)",
            (file_id, file_id, self.EDIT_HISTORY_DEPTH))

    def pop_edit_history(self, file_id):
        """Remove and return the most recent pre-edit snapshot, or None."""
        row = self._exec(
            "SELECT * FROM edit_history WHERE file_id = ? "
            "ORDER BY id DESC LIMIT 1", (file_id,), fetch="one")
        if row:
            self._exec("DELETE FROM edit_history WHERE id = ?", (row["id"],))
        return row

    def get_edit_history(self, file_id):
        """Newest-first [{id, op, created_at}] (snapshots omitted: large)."""
        return self._exec(
            "SELECT id, op, created_at FROM edit_history WHERE file_id = ? "
            "ORDER BY id DESC", (file_id,), fetch="all")

    # -- queue (strict FIFO by priority = insertion time) -------------------------
    def add_to_queue(self, file_id, session_id, config):
        import time

        return self._exec(
            "INSERT INTO queue (file_id, session_id, priority, config_json) "
            "VALUES (?, ?, ?, ?)",
            (file_id, session_id, time.time(), json.dumps(config)))

    def get_next_queue_item(self):
        return self._exec(
            "SELECT * FROM queue WHERE status = 'waiting' "
            "ORDER BY priority LIMIT 1", fetch="one")

    def get_queue_item(self, file_id):
        return self._exec("SELECT * FROM queue WHERE file_id = ?",
                          (file_id,), fetch="one")

    def get_queue_position(self, file_id):
        item = self.get_queue_item(file_id)
        if not item or item["status"] != "waiting":
            return 0
        row = self._exec(
            "SELECT COUNT(*) AS n FROM queue WHERE status = 'waiting' AND "
            "priority < ?", (item["priority"],), fetch="one")
        return int(row["n"]) + 1

    def get_waiting_queue(self):
        return self._exec(
            "SELECT * FROM queue WHERE status IN ('waiting', 'processing') "
            "ORDER BY priority", fetch="all")

    def get_queue_total_waiting(self):
        row = self._exec(
            "SELECT COUNT(*) AS n FROM queue WHERE status = 'waiting'",
            fetch="one")
        return int(row["n"])

    def get_all_queue(self):
        return self._exec(
            "SELECT q.*, f.original_filename FROM queue q "
            "LEFT JOIN files f ON f.id = q.file_id ORDER BY q.priority",
            fetch="all")

    def get_queue_status_for_session(self, session_id):
        """Most recent active queue item of a session, with the filename
        (reference session_manager.get_session_status's queue_item block)."""
        return self._exec(
            "SELECT q.*, f.original_filename FROM queue q "
            "LEFT JOIN files f ON f.id = q.file_id "
            "WHERE q.session_id = ? AND q.status IN ('waiting', "
            "'processing') ORDER BY q.priority LIMIT 1",
            (session_id,), fetch="one")

    def update_queue_progress(self, file_id, percent, message):
        self._exec(
            "UPDATE queue SET progress_percent = ?, progress_message = ? "
            "WHERE file_id = ?", (int(percent), message, file_id))

    def set_queue_status(self, file_id, status):
        extra = ""
        if status == "processing":
            extra = ", started_at = datetime('now')"
        elif status in ("completed", "error", "cancelled"):
            extra = ", completed_at = datetime('now')"
        self._exec(f"UPDATE queue SET status = ?{extra} WHERE file_id = ?",
                   (status, file_id))

    def remove_from_queue(self, file_id):
        self._exec("DELETE FROM queue WHERE file_id = ?", (file_id,))

    # -- meetings ------------------------------------------------------------------
    def create_meeting(self, user_id, file_id, meeting_name,
                       original_filename, stored_filename, file_size=0):
        return self._exec(
            "INSERT INTO meetings (user_id, file_id, meeting_name, "
            "original_filename, stored_filename, file_size) "
            "VALUES (?, ?, ?, ?, ?, ?)",
            (user_id, file_id, meeting_name, original_filename,
             stored_filename, file_size))

    def get_meeting(self, meeting_id):
        return self._exec("SELECT * FROM meetings WHERE id = ?",
                          (meeting_id,), fetch="one")

    def get_meeting_by_file_id(self, file_id):
        return self._exec("SELECT * FROM meetings WHERE file_id = ?",
                          (file_id,), fetch="one")

    def get_user_meetings(self, user_id):
        return self._exec(
            "SELECT * FROM meetings WHERE user_id = ? ORDER BY id DESC",
            (user_id,), fetch="all")

    def update_meeting(self, meeting_id, **kw):
        if not kw:
            return
        sets = ", ".join(f"{k} = ?" for k in kw)
        self._exec(f"UPDATE meetings SET {sets}, updated_at = "
                   "datetime('now') WHERE id = ?", (*kw.values(), meeting_id))

    def delete_meeting(self, meeting_id):
        self._exec("DELETE FROM meetings WHERE id = ?", (meeting_id,))

    # -- stats --------------------------------------------------------------------
    def get_stats(self):
        return {
            "users": self._exec("SELECT COUNT(*) AS n FROM users",
                                fetch="one")["n"],
            "active_sessions": self._exec(
                "SELECT COUNT(*) AS n FROM sessions WHERE expired_at IS NULL",
                fetch="one")["n"],
            "files": self._exec("SELECT COUNT(*) AS n FROM files",
                                fetch="one")["n"],
            "queue_waiting": self._exec(
                "SELECT COUNT(*) AS n FROM queue WHERE status = 'waiting'",
                fetch="one")["n"],
            "completed": self._exec(
                "SELECT COUNT(*) AS n FROM files WHERE status = 'completed'",
                fetch="one")["n"],
        }

    def close(self):
        with self._lock:
            self._conn.close()
