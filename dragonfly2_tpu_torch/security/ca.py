"""Certificate authority + peer identity (pkg/issuer analog).

The manager hosts the CA; schedulers/daemons generate a key + CSR at boot
and request a short-lived certificate carrying their host identity in the
SAN — the auto-issued-mTLS flow the reference builds on certify.

Port of ``dragonfly2_tpu/security/ca.py``, verbatim.
"""

from __future__ import annotations

import datetime
import ipaddress
from dataclasses import dataclass
from typing import List, Optional

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

DEFAULT_CERT_TTL = datetime.timedelta(hours=24)
# Server-side ceiling on client-requested TTLs: revocation is
# non-renewal, so no caller may mint an effectively permanent cert.
MAX_CERT_TTL = datetime.timedelta(days=7)


def clamp_ttl(ttl_hours: int) -> datetime.timedelta:
    """Requested hours → issued validity: 0/negative → default, anything
    else capped at MAX_CERT_TTL (and immune to timedelta overflow)."""
    if ttl_hours <= 0:
        return DEFAULT_CERT_TTL
    return min(
        datetime.timedelta(hours=min(int(ttl_hours), 24 * 365)), MAX_CERT_TTL
    )


def _name(common_name: str) -> x509.Name:
    return x509.Name(
        [
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, "dragonfly2-tpu"),
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]
    )


def _san(hostnames: List[str], ips: List[str]) -> x509.SubjectAlternativeName:
    entries: list = [x509.DNSName(h) for h in hostnames]
    for ip in ips:
        entries.append(x509.IPAddress(ipaddress.ip_address(ip)))
    return x509.SubjectAlternativeName(entries)


def _new_key_and_csr(
    common_name: str,
    hostnames: Optional[List[str]],
    ips: Optional[List[str]],
):
    """Fresh EC key + CSR — ONE builder for the in-process and
    over-the-wire issuance paths, so subject/SAN construction can't
    diverge between them."""
    key = ec.generate_private_key(ec.SECP256R1())
    csr = (
        x509.CertificateSigningRequestBuilder()
        .subject_name(_name(common_name))
        .add_extension(
            _san(hostnames or [common_name], ips or []), critical=False
        )
        .sign(key, hashes.SHA256())
    )
    return key, csr


class CertificateAuthority:
    """Self-signed EC-P256 root that signs peer CSRs with short validity."""

    def __init__(self, common_name: str = "dragonfly2-tpu-ca") -> None:
        self._key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        self.certificate = (
            x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(_name(common_name))
            .public_key(self._key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
            .add_extension(
                x509.KeyUsage(
                    digital_signature=True, key_cert_sign=True, crl_sign=True,
                    content_commitment=False, key_encipherment=False,
                    data_encipherment=False, key_agreement=False,
                    encipher_only=False, decipher_only=False,
                ),
                critical=True,
            )
            .sign(self._key, hashes.SHA256())
        )

    @property
    def cert_pem(self) -> bytes:
        return self.certificate.public_bytes(serialization.Encoding.PEM)

    @property
    def key_pem(self) -> bytes:
        return self._key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )

    @classmethod
    def from_pem(cls, key_pem: bytes, cert_pem: bytes) -> "CertificateAuthority":
        """Reload a persisted CA — a restarting daemon must keep its trust
        anchor or every already-distributed sni-ca.pem goes stale."""
        ca = cls.__new__(cls)
        ca._key = serialization.load_pem_private_key(key_pem, password=None)
        ca.certificate = x509.load_pem_x509_certificate(cert_pem)
        return ca

    @classmethod
    def persistent(cls, directory: str, common_name: str = "dragonfly2-tpu-ca") -> "CertificateAuthority":
        """Load the CA from `directory`, creating + saving it on first use."""
        import os

        key_path = os.path.join(directory, "ca-key.pem")
        cert_path = os.path.join(directory, "ca-cert.pem")
        if os.path.exists(key_path) and os.path.exists(cert_path):
            with open(key_path, "rb") as f:
                key_pem = f.read()
            with open(cert_path, "rb") as f:
                cert_pem = f.read()
            return cls.from_pem(key_pem, cert_pem)
        ca = cls(common_name)
        os.makedirs(directory, exist_ok=True)
        for path, data in ((key_path, ca.key_pem), (cert_path, ca.cert_pem)):
            # 0600 from the first byte: no default-umask window where
            # another local user could read the signing key.
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(data)
        return ca

    def sign_csr(
        self,
        csr_pem: bytes,
        *,
        ttl: datetime.timedelta = DEFAULT_CERT_TTL,
    ) -> bytes:
        """Issue a peer certificate from a CSR (manager-side issuance).

        The CSR's subject and SAN are honored; validity is capped short so
        revocation is simply non-renewal (the reference's certify flow).
        """
        csr = x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self.certificate.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + ttl)
            .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
            .add_extension(
                x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                     x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]
                ),
                critical=False,
            )
        )
        try:
            san = csr.extensions.get_extension_for_class(x509.SubjectAlternativeName)
            builder = builder.add_extension(san.value, critical=False)
        except x509.ExtensionNotFound:
            pass
        cert = builder.sign(self._key, hashes.SHA256())
        return cert.public_bytes(serialization.Encoding.PEM)


class IdentityRenewer:
    """Keeps an auto-issued identity alive past its TTL: re-requests a
    fresh certificate at ``fraction`` of the remaining validity and
    reloads the given ssl contexts IN PLACE (security.tls.reload_context
    — live piece servers/fetchers pick the new chain up at the next
    handshake, no restart).  Issue failures retry on a short backoff
    while the old cert is still valid.

    Scope note: Python ``ssl`` contexts renew live; gRPC channel/server
    credentials are immutable once built — a cluster running mTLS gRPC
    rotates those by service restart within the cert TTL (documented in
    config.SecuritySection).
    """

    def __init__(
        self,
        identity: "PeerIdentity",
        request_fn,
        contexts,
        *,
        fraction: float = 0.5,
        min_interval_s: float = 60.0,
    ) -> None:
        import threading as _threading

        self.identity = identity
        self._request_fn = request_fn
        self._contexts = list(contexts)
        self.fraction = fraction
        self.min_interval_s = min_interval_s
        self.renewals = 0
        self._stop = _threading.Event()
        self._thread: Optional[object] = None

    def start(self) -> "IdentityRenewer":
        import threading as _threading

        self._thread = _threading.Thread(
            target=self._loop, name="mtls-renew", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        from .tls import reload_context

        while not self._stop.is_set():
            wait = max(
                self.identity.seconds_left() * self.fraction,
                self.min_interval_s,
            )
            if self._stop.wait(wait):
                return
            try:
                fresh = self._request_fn()
                for ctx in self._contexts:
                    reload_context(ctx, fresh)
                self.identity = fresh
                self.renewals += 1
            except Exception:  # noqa: BLE001 — old cert still valid; retry soon
                if self._stop.wait(self.min_interval_s):
                    return


@dataclass
class PeerIdentity:
    """A peer's key + CA-issued certificate (daemon/scheduler side)."""

    key_pem: bytes
    cert_pem: bytes
    ca_pem: bytes

    @classmethod
    def issue(
        cls,
        ca: CertificateAuthority,
        *,
        common_name: str,
        hostnames: Optional[List[str]] = None,
        ips: Optional[List[str]] = None,
        ttl: datetime.timedelta = DEFAULT_CERT_TTL,
    ) -> "PeerIdentity":
        """Generate a key, CSR against the CA, receive the signed cert —
        the whole certify bootstrap in one call (in-process CA; over the
        wire the CSR posts to the manager)."""
        key, csr = _new_key_and_csr(common_name, hostnames, ips)
        cert_pem = ca.sign_csr(
            csr.public_bytes(serialization.Encoding.PEM), ttl=ttl
        )
        return cls(
            key_pem=key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            ),
            cert_pem=cert_pem,
            ca_pem=ca.cert_pem,
        )

    @classmethod
    def request_from_manager(
        cls,
        manager_url: str,
        *,
        common_name: str,
        hostnames: Optional[List[str]] = None,
        ips: Optional[List[str]] = None,
        ttl_hours: int = 0,
        token: Optional[str] = None,
        timeout: float = 10.0,
        attempts: int = 5,
    ) -> "PeerIdentity":
        """Self-provision an mTLS identity OVER THE WIRE at boot (the
        reference certify flow, scheduler.go:186-222 / pkg/issuer): the
        private key is generated HERE and never leaves the process —
        only the CSR travels; the manager answers with the signed cert
        and the cluster trust root (POST /api/v1/certs:issue).

        Retries connection failures with backoff — services routinely
        boot before the manager's port listens (compose/systemd restart
        order); an HTTP error (401, 400) is terminal and raises as-is."""
        import json as _json
        import time as _time
        import urllib.error
        import urllib.request

        key, csr = _new_key_and_csr(common_name, hostnames, ips)
        body = _json.dumps({
            "csr_pem": csr.public_bytes(serialization.Encoding.PEM).decode(),
            "ttl_hours": ttl_hours,
        }).encode()
        req = urllib.request.Request(
            manager_url.rstrip("/") + "/api/v1/certs:issue",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        for attempt in range(attempts):
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    reply = _json.loads(resp.read())
                break
            except urllib.error.HTTPError:
                raise  # the manager answered: retrying cannot help
            except (urllib.error.URLError, ConnectionError, TimeoutError, OSError):
                if attempt == attempts - 1:
                    raise
                _time.sleep(min(0.5 * 2 ** attempt, 5.0))
        return cls(
            key_pem=key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            ),
            cert_pem=reply["cert_pem"].encode(),
            ca_pem=reply["ca_pem"].encode(),
        )

    def seconds_left(self) -> float:
        """Validity remaining on this identity's certificate."""
        cert = x509.load_pem_x509_certificate(self.cert_pem)
        now = datetime.datetime.now(datetime.timezone.utc)
        return (cert.not_valid_after_utc - now).total_seconds()

    def write(self, directory: str) -> dict:
        """Materialize to files (ssl contexts need paths); returns paths."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths = {}
        for name, data in (
            ("key.pem", self.key_pem),
            ("cert.pem", self.cert_pem),
            ("ca.pem", self.ca_pem),
        ):
            path = os.path.join(directory, name)
            with open(path, "wb") as f:
                f.write(data)
            os.chmod(path, 0o600)
            paths[name.split(".")[0]] = path
        return paths
