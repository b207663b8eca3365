"""Security: CA-backed mTLS + token auth (reference: pkg/issuer +
pkg/rpc/security — the manager acts as a CA issuing short-lived certs that
schedulers/daemons use for auto-provisioned mTLS, scheduler/scheduler.go:186-222).

- ``ca``     — an EC-P256 certificate authority: self-signed root, CSR
  signing with short validity, SAN support (the certify-integration
  equivalent); peer helpers to generate keys/CSRs and request certs.
- ``tokens`` — HMAC-signed bearer tokens with roles and expiry (the
  manager's personal-access-token / RBAC-lite surface for REST mutations).
- ``tls``    — ssl.SSLContext builders wiring CA-issued identities into
  the HTTP servers/clients for mutual TLS.

Port of ``dragonfly2_tpu/security/__init__.py``, verbatim.
"""

from .tokens import Role, TokenIssuer, TokenVerifier  # noqa: F401

try:  # pragma: no cover - environment-dependent
    from .ca import CertificateAuthority, PeerIdentity  # noqa: F401
    from .tls import client_context, server_context  # noqa: F401
except ImportError:  # `cryptography` absent: token auth (and everything
    # that merely imports the manager package) must keep working — only
    # the mTLS/CA surface itself is gated off.  Callers that configure
    # auto-issue get the ImportError at use, not at import of unrelated
    # modules.
    CertificateAuthority = PeerIdentity = None  # type: ignore[assignment]
    client_context = server_context = None  # type: ignore[assignment]
