# Copied from sherpa_vietnamese_asr_tpu/web_service/__init__.py (stdlib only; only the package path changes).
# Web service tier: HTTP API + queue over the TPU transcription pipeline.
#
# Mirrors the reference's web_service/ package (FastAPI server, strict-FIFO
# queue manager, SQLite persistence, JWT auth, WebSocket progress) on the
# Python standard library — FastAPI is not available in this environment, so
# the server is a ThreadingHTTPServer with the same endpoint surface and a
# minimal RFC6455 WebSocket implementation for progress push.
