"""Wire-protocol versioning + negotiation (VERDICT r4 #6).

Reference: the scheduler serves gRPC v1 AND v2 concurrently and ships a
compatibility e2e mode that runs old client images against new servers
(DRAGONFLY_COMPATIBILITY_E2E_TEST_MODE, SURVEY §4).  The analog here:

- **v1** is the legacy, UNVERSIONED dialect — every request shape this
  wire spoke before the handshake existed.  A v1 client sends no
  ``protocol_version`` field anywhere and uses request-paired calls
  only.  Absence of the field IS the v1 signature, so every client
  built before this module is, by construction, a v1 client.
- **v2** adds the explicit handshake: ``announce_host`` carries
  ``protocol_version``; the server answers with its own version window
  and the NEGOTIATED version (min of both), and advertises capability
  strings (the server-push reschedule stream, steering).  All v2
  changes are additive on the wire, so a v2 server serves v1 clients
  with byte-compatible responses — the compat e2e in
  tests/test_compat.py downloads through a frozen v1 shim against the
  current scheduler every CI run.

Skew policy (DESIGN.md §10d): a server supports [PROTOCOL_VERSION - 1,
PROTOCOL_VERSION] — one release of client skew, the reference's
v1+v2-concurrently posture.  Clients NEWER than the server downgrade
themselves to the server's negotiated answer; clients OLDER than
MIN_SUPPORTED get a typed INVALID_ARGUMENT telling them exactly what to
upgrade.
"""

from __future__ import annotations

from ..utils.dferrors import Code

PROTOCOL_VERSION = 2
MIN_SUPPORTED = 1

# Capability strings a v2 server advertises in the announce response —
# feature discovery is by capability, not by sniffing version numbers
# (a v2.1 server can add one without a version bump).  BASE_CAPABILITIES
# hold on every transport; the gRPC binding adds "push-reschedule" (the
# server-push stream only exists on its bidi announce_peer wire).
BASE_CAPABILITIES = ("steering", "probe-sync")


class UnsupportedProtocolError(ValueError):
    """Client dialect older than the server's support window.
    (A ValueError: the gRPC transport maps those to INVALID_ARGUMENT.)"""

    code = Code.INVALID_ARGUMENT

    def __init__(self, client_version: int):
        super().__init__(
            f"protocol version {client_version} is no longer supported "
            f"(server speaks {MIN_SUPPORTED}..{PROTOCOL_VERSION}); "
            f"upgrade the client"
        )
        self.client_version = client_version


def negotiate(client_version: int) -> int:
    """Server side: the version this connection speaks — min(client,
    ours).  A FUTURE client downgrades to us (it understands our
    dialect by its own skew policy); a too-old client gets the typed
    refusal."""
    if client_version < MIN_SUPPORTED:
        raise UnsupportedProtocolError(client_version)
    return min(int(client_version), PROTOCOL_VERSION)


def protocol_info(negotiated: int, capabilities=BASE_CAPABILITIES) -> dict:
    """The handshake block a server attaches to its announce response."""
    return {
        "version": PROTOCOL_VERSION,
        "min_supported": MIN_SUPPORTED,
        "negotiated": negotiated,
        "capabilities": list(capabilities),
    }
