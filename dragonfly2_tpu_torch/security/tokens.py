"""HMAC bearer tokens with roles (manager PAT / RBAC-lite).

Reference: manager's personal access tokens + casbin RBAC guard the REST
surface.  Here: manager-signed HMAC tokens carrying (subject, role,
expiry); servers verify with the shared secret and enforce a minimum role
per operation.  Token format: base64url(payload).base64url(hmac).

Port of ``dragonfly2_tpu/security/tokens.py``, verbatim.
"""

from __future__ import annotations

import base64
import enum
import hmac
import json
import time
from dataclasses import dataclass
from typing import Optional


class Role(enum.IntEnum):
    """Ordered roles: a check passes when token.role >= required."""

    READONLY = 0
    PEER = 1       # daemons/schedulers: announce, register, report
    OPERATOR = 2   # model activation, preheat
    ADMIN = 3


@dataclass
class TokenClaims:
    subject: str
    role: Role
    expires_at: float

    @property
    def expired(self) -> bool:
        return time.time() > self.expires_at


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


class TokenIssuer:
    def __init__(self, secret: bytes) -> None:
        if len(secret) < 16:
            raise ValueError("token secret must be >= 16 bytes")
        self._secret = secret

    def issue(
        self, subject: str, role: Role, *, ttl_s: float = 24 * 3600.0
    ) -> str:
        payload = json.dumps(
            {"sub": subject, "role": int(role), "exp": time.time() + ttl_s},
            separators=(",", ":"),
        ).encode()
        sig = hmac.new(self._secret, payload, "sha256").digest()
        return f"{_b64(payload)}.{_b64(sig)}"


class TokenVerifier:
    def __init__(self, secret: bytes) -> None:
        self._secret = secret

    def verify(self, token: str) -> Optional[TokenClaims]:
        """Claims when the token is authentic and unexpired, else None."""
        try:
            payload_b64, sig_b64 = token.split(".", 1)
            payload = _unb64(payload_b64)
            sig = _unb64(sig_b64)
        except (ValueError, TypeError):
            return None
        expected = hmac.new(self._secret, payload, "sha256").digest()
        if not hmac.compare_digest(sig, expected):
            return None
        try:
            data = json.loads(payload)
            claims = TokenClaims(
                subject=data["sub"],
                role=Role(int(data["role"])),
                expires_at=float(data["exp"]),
            )
        except (KeyError, ValueError, json.JSONDecodeError):
            return None
        return None if claims.expired else claims

    def authorize(self, token: Optional[str], required: Role) -> Optional[TokenClaims]:
        """Claims when the token grants at least ``required``, else None."""
        if token is None:
            return None
        claims = self.verify(token)
        if claims is None or claims.role < required:
            return None
        return claims


def resolve_credential(token, verifier, users):
    """ONE credential-resolution path for every transport (REST + gRPC):
    → (subject, Role, kind) or None.  kind ∈ {"session", "pat"}.

    Session tokens are re-checked against the live user store so a
    disable or demotion takes effect immediately on ALL ports, not at
    token expiry; PATs resolve through the store with their capped role.
    """
    if token is None:
        return None
    if users is not None:
        from ..manager.users import PAT_PREFIX

        if token.startswith(PAT_PREFIX):
            user = users.authenticate_pat(token)
            return None if user is None else (user.id, user.role, "pat")
    if verifier is not None:
        claims = verifier.verify(token)
        if claims is None:
            return None
        role = claims.role
        if users is not None:
            user = users.get(claims.subject)
            if user is not None:
                if user.state != "enabled":
                    return None
                role = min(role, user.role)
        return (claims.subject, role, "session")
    return None
