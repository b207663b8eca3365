"""ssl contexts from CA-issued identities (the mTLS wiring).

``server_context`` requires and verifies client certificates against the
CA (mutual TLS — the reference's auto-issued mTLS between services);
``client_context`` presents the peer identity and verifies the server
against the same CA.  The HTTP services wrap their listening sockets with
these; clients pass theirs to urllib.

Port of ``dragonfly2_tpu/security/tls.py``, verbatim.
"""

from __future__ import annotations

import contextlib
import shutil
import ssl
import tempfile

from .ca import PeerIdentity


@contextlib.contextmanager
def _materialized(identity: PeerIdentity):
    """ssl needs files; load_cert_chain/load_verify_locations read them
    eagerly, so the key material is DELETED the moment the context is
    built — nothing lingers on disk."""
    directory = tempfile.mkdtemp(prefix="df-tls-")
    try:
        yield identity.write(directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def server_context(identity: PeerIdentity) -> ssl.SSLContext:
    with _materialized(identity) as paths:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(paths["cert"], paths["key"])
        ctx.load_verify_locations(paths["ca"])
    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx


def reload_context(ctx: ssl.SSLContext, identity: PeerIdentity) -> None:
    """Swap a NEW identity into an existing context in place — live
    listeners/dialers pick the fresh chain up at their next handshake
    (ssl reads the context at handshake time, not at wrap time), which
    is what makes short-TTL auto-issued certs renewable without a
    restart."""
    with _materialized(identity) as paths:
        ctx.load_cert_chain(paths["cert"], paths["key"])
        ctx.load_verify_locations(paths["ca"])


def client_context(
    identity: PeerIdentity, *, check_hostname: bool = False
) -> ssl.SSLContext:
    """Client mTLS context.

    ``check_hostname`` defaults OFF: peers dial each other by announced IP
    and the trust anchor here is CERT_REQUIRED chain verification against
    the private CA (only CA-issued identities connect at all) — hostname
    matching adds value only when server identities embed their IP/DNS
    SANs (PeerIdentity.issue(..., ips=[...]) supports that; turn this on
    then)."""
    with _materialized(identity) as paths:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(paths["cert"], paths["key"])
        ctx.load_verify_locations(paths["ca"])
    ctx.check_hostname = check_hostname
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx
