# Copied from sherpa_vietnamese_asr_tpu/web_service/ssl_utils.py (stdlib only; only the package path changes).
# Self-signed HTTPS certificate management — reimplements reference
# web_service/ssl_utils.py: custom.crt/key takes priority over the generated
# server.crt/key, the certificate loaded at server start is snapshotted so
# /install-cert always serves the LIVE cert (regeneration before a restart
# must not desync the download), and generation uses RSA-3072 / 2-year
# validity with localhost SANs. Generation prefers the `cryptography`
# package and falls back to the openssl CLI; with neither available the
# server runs plain HTTP (http_mode=1 behavior).

from __future__ import annotations

import logging
import os
import shutil
import stat
import subprocess

logger = logging.getLogger("asr.ssl")

ACTIVE_CERT_ENV = "SVT_ASR_ACTIVE_CERT_FILE"
ACTIVE_KEY_ENV = "SVT_ASR_ACTIVE_KEY_FILE"


def _configured_cert_pair(cert_dir):
    """(cert, key) selected by priority — custom.* over server.* — or
    (None, None) without generating anything."""
    custom = (os.path.join(cert_dir, "custom.crt"),
              os.path.join(cert_dir, "custom.key"))
    generated = (os.path.join(cert_dir, "server.crt"),
                 os.path.join(cert_dir, "server.key"))
    for cert, key in (custom, generated):
        if os.path.exists(cert) and os.path.exists(key):
            return cert, key
    return None, None


def publish_active_ssl_cert(cert_file, key_file=None, data_dir=None):
    """Snapshot the cert actually loaded at TLS start for /install-cert."""
    if not cert_file:
        os.environ.pop(ACTIVE_CERT_ENV, None)
        os.environ.pop(ACTIVE_KEY_ENV, None)
        return None
    cert_file = os.path.abspath(cert_file)
    active = cert_file
    if data_dir:
        snapshot = os.path.join(data_dir, "active_tls_cert.crt")
        try:
            os.makedirs(data_dir, exist_ok=True)
            shutil.copy2(cert_file, snapshot)
            active = os.path.abspath(snapshot)
        except OSError as exc:
            logger.warning("[SSL] could not snapshot active cert: %s", exc)
    os.environ[ACTIVE_CERT_ENV] = active
    if key_file:
        os.environ[ACTIVE_KEY_ENV] = os.path.abspath(key_file)
    else:
        os.environ.pop(ACTIVE_KEY_ENV, None)
    return active


def get_install_cert_path(cert_dir=None, generate_if_missing=False):
    """The certificate clients should install for the active server."""
    active = os.environ.get(ACTIVE_CERT_ENV)
    if active and os.path.exists(active):
        return active
    if cert_dir:
        cert, _key = _configured_cert_pair(cert_dir)
        if cert:
            return cert
        if generate_if_missing:
            cert, key = ensure_ssl_certs(cert_dir)
            if cert:
                return publish_active_ssl_cert(cert, key) or cert
    return None


def _generate_cryptography(cert_file, key_file):
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=3072)
    name = x509.Name([
        x509.NameAttribute(NameOID.COMMON_NAME, "Sherpa Vietnamese ASR TPU"),
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "ASR VN"),
    ])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=730))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.IPv4Address("127.0.0.1")),
        ]), critical=False)
        .sign(key, hashes.SHA256())
    )
    with open(key_file, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_file, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def _generate_openssl_cli(cert_file, key_file):
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:3072", "-nodes",
         "-keyout", key_file, "-out", cert_file, "-days", "730",
         "-subj", "/CN=Sherpa Vietnamese ASR TPU/O=ASR VN",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)


def ensure_ssl_certs(cert_dir):
    """(cert, key), generating a self-signed pair if none configured.
    Returns (None, None) when no generation backend is available."""
    cert, key = _configured_cert_pair(cert_dir)
    if cert and key:
        return cert, key
    os.makedirs(cert_dir, exist_ok=True)
    cert = os.path.join(cert_dir, "server.crt")
    key = os.path.join(cert_dir, "server.key")
    try:
        try:
            _generate_cryptography(cert, key)
        except ImportError:
            _generate_openssl_cli(cert, key)
    except Exception as exc:  # no backend / generation failure -> HTTP
        logger.warning("[SSL] certificate generation unavailable: %s", exc)
        return None, None
    try:
        os.chmod(key, stat.S_IRUSR | stat.S_IWUSR)  # 0600
    except OSError:
        pass
    logger.info("[SSL] generated self-signed certificate: %s", cert)
    return cert, key
