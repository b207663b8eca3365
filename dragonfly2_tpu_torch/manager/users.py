"""Users and personal access tokens (manager RBAC completion).

Reference: manager's user accounts (manager/models/user.go, signup/signin
handlers in manager/handlers/user.go), casbin role bindings
(manager/permission/rbac), and personal access tokens
(manager/models/personal_access_token.go) guarding the REST surface.

This package's shape: pbkdf2-hashed passwords and sha256-hashed PATs in the
same embedded-sqlite idiom as the model registry; session auth is the
HMAC bearer token from security/tokens.py, so one verifier chain covers
console sessions AND machine PATs.

Port of ``dragonfly2_tpu/manager/users.py``, verbatim.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

from ..security.tokens import Role

if TYPE_CHECKING:  # state seam type (no runtime import needed)
    from .state import StateBackend

PBKDF2_ITERATIONS = 100_000
PAT_PREFIX = "dfp_"  # raw token shape: dfp_<hex>; only the hash is stored


@dataclass
class User:
    id: str
    name: str
    email: str = ""
    role: Role = Role.READONLY
    state: str = "enabled"  # enabled | disabled
    created_at: float = field(default_factory=time.time)


@dataclass
class PersonalAccessToken:
    id: str
    user_id: str
    name: str
    role: Role
    token_hash: str
    expires_at: float
    revoked: bool = False
    created_at: float = field(default_factory=time.time)

    @property
    def expired(self) -> bool:
        return time.time() > self.expires_at


def _hash_password(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, PBKDF2_ITERATIONS
    )


def _hash_pat(raw: str) -> str:
    return hashlib.sha256(raw.encode()).hexdigest()


class _BackendUserStore:
    """users/pats as JSON docs behind the manager's state seam
    (manager/state.StateBackend); binary hash/salt fields ride base64."""

    def __init__(self, backend: "StateBackend") -> None:
        self._users = backend.table("users")
        self._pats = backend.table("pats")

    def upsert_user(self, u: "User", password_hash: bytes, salt: bytes) -> None:
        import base64

        self._users.put(u.id, {
            "id": u.id, "name": u.name, "email": u.email,
            "role": int(u.role), "state": u.state, "created_at": u.created_at,
            "password_hash": base64.b64encode(password_hash).decode(),
            "salt": base64.b64encode(salt).decode(),
        })

    def upsert_pat(self, p: "PersonalAccessToken") -> None:
        self._pats.put(p.id, {
            "id": p.id, "user_id": p.user_id, "name": p.name,
            "role": int(p.role), "token_hash": p.token_hash,
            "expires_at": p.expires_at, "revoked": p.revoked,
            "created_at": p.created_at,
        })

    def load_all(self):
        import base64

        users, creds, pats = {}, {}, {}
        for d in self._users.load_all().values():
            u = User(id=d["id"], name=d["name"], email=d["email"],
                     role=Role(d["role"]), state=d["state"],
                     created_at=d["created_at"])
            users[u.id] = u
            creds[u.id] = (
                base64.b64decode(d["password_hash"]),
                base64.b64decode(d["salt"]),
            )
        for d in self._pats.load_all().values():
            pats[d["id"]] = PersonalAccessToken(
                id=d["id"], user_id=d["user_id"], name=d["name"],
                role=Role(d["role"]), token_hash=d["token_hash"],
                expires_at=d["expires_at"], revoked=bool(d["revoked"]),
                created_at=d["created_at"],
            )
        return users, creds, pats


class UserStore:
    """In-memory source of truth with write-through persistence via
    the manager state seam (sqlite embedded; external SQL/KV for HA)."""

    def __init__(
        self, db_path: Optional[str] = None, *,
        backend: "Optional[StateBackend]" = None,
    ) -> None:
        self._mu = threading.RLock()
        self._users: Dict[str, User] = {}
        self._creds: Dict[str, tuple] = {}  # user_id → (hash, salt)
        self._pats: Dict[str, PersonalAccessToken] = {}
        self._db: Optional[_BackendUserStore] = None
        if backend is None and db_path:
            from .state import SQLiteBackend

            backend = SQLiteBackend(db_path)
        if backend is not None:
            self._db = _BackendUserStore(backend)
            self._users, self._creds, self._pats = self._db.load_all()

    # -- users (handlers/user.go signup/signin) -----------------------------

    def create_user(
        self,
        name: str,
        password: str,
        *,
        email: str = "",
        role: Role = Role.READONLY,
    ) -> User:
        if len(password) < 8:
            raise ValueError("password must be >= 8 characters")
        with self._mu:
            if any(u.name == name for u in self._users.values()):
                raise ValueError(f"user {name!r} already exists")
            salt = secrets.token_bytes(16)
            user = User(
                id=f"user-{secrets.token_hex(8)}", name=name,
                email=email, role=role,
            )
            pw_hash = _hash_password(password, salt)
            self._users[user.id] = user
            self._creds[user.id] = (pw_hash, salt)
            if self._db:
                self._db.upsert_user(user, pw_hash, salt)
            return user

    def ensure_root(self, password: str) -> User:
        """First-boot bootstrap: an admin 'root' user (the reference seeds
        one through DB migration)."""
        with self._mu:
            existing = self.by_name("root")
            if existing is not None:
                return existing
        return self.create_user("root", password, role=Role.ADMIN)

    def by_name(self, name: str) -> Optional[User]:
        with self._mu:
            for u in self._users.values():
                if u.name == name:
                    return u
        return None

    def get(self, user_id: str) -> Optional[User]:
        with self._mu:
            return self._users.get(user_id)

    def list_users(self) -> List[User]:
        with self._mu:
            return sorted(self._users.values(), key=lambda u: u.created_at)

    def verify_password(self, name: str, password: str) -> Optional[User]:
        """The signin check; None on unknown user / bad password /
        disabled account.  Constant-time hash comparison."""
        user = self.by_name(name)
        if user is None or user.state != "enabled":
            return None
        with self._mu:
            pw_hash, salt = self._creds[user.id]
        if hmac.compare_digest(_hash_password(password, salt), pw_hash):
            return user
        return None

    def reset_password(self, user_id: str, new_password: str) -> None:
        if len(new_password) < 8:
            raise ValueError("password must be >= 8 characters")
        with self._mu:
            user = self._users[user_id]
            salt = secrets.token_bytes(16)
            pw_hash = _hash_password(new_password, salt)
            self._creds[user_id] = (pw_hash, salt)
            if self._db:
                self._db.upsert_user(user, pw_hash, salt)

    def set_role(self, user_id: str, role: Role) -> User:
        with self._mu:
            user = self._users[user_id]
            user.role = role
            if self._db:
                pw_hash, salt = self._creds[user_id]
                self._db.upsert_user(user, pw_hash, salt)
            return user

    def set_state(self, user_id: str, state: str) -> User:
        if state not in ("enabled", "disabled"):
            raise ValueError(f"bad state {state!r}")
        with self._mu:
            user = self._users[user_id]
            user.state = state
            if self._db:
                pw_hash, salt = self._creds[user_id]
                self._db.upsert_user(user, pw_hash, salt)
            return user

    # -- personal access tokens ---------------------------------------------

    def create_pat(
        self,
        user_id: str,
        name: str,
        *,
        role: Optional[Role] = None,
        ttl_s: float = 90 * 24 * 3600.0,
    ) -> tuple:
        """→ (PersonalAccessToken, raw_token).  The raw token is shown
        exactly once; only its sha256 is stored.  A PAT's role is capped
        at its owner's role — tokens can't escalate."""
        with self._mu:
            user = self._users[user_id]
            granted = user.role if role is None else min(role, user.role)
            raw = PAT_PREFIX + secrets.token_hex(20)
            pat = PersonalAccessToken(
                id=f"pat-{secrets.token_hex(8)}", user_id=user_id, name=name,
                role=Role(granted), token_hash=_hash_pat(raw),
                expires_at=time.time() + ttl_s,
            )
            self._pats[pat.id] = pat
            if self._db:
                self._db.upsert_pat(pat)
            return pat, raw

    def list_pats(self, user_id: Optional[str] = None) -> List[PersonalAccessToken]:
        with self._mu:
            pats = list(self._pats.values())
        if user_id is not None:
            pats = [p for p in pats if p.user_id == user_id]
        return sorted(pats, key=lambda p: p.created_at)

    def revoke_pat(self, pat_id: str) -> None:
        with self._mu:
            pat = self._pats[pat_id]
            pat.revoked = True
            if self._db:
                self._db.upsert_pat(pat)

    def authenticate_pat(self, raw: str) -> Optional[User]:
        """→ owning user (with role capped to the PAT's grant) when the
        raw token is live; None otherwise."""
        if not raw.startswith(PAT_PREFIX):
            return None
        h = _hash_pat(raw)
        with self._mu:
            for pat in self._pats.values():
                if hmac.compare_digest(pat.token_hash, h):
                    if pat.revoked or pat.expired:
                        return None
                    user = self._users.get(pat.user_id)
                    if user is None or user.state != "enabled":
                        return None
                    # The caller sees the PAT's effective role.
                    return User(
                        id=user.id, name=user.name, email=user.email,
                        role=min(pat.role, user.role), state=user.state,
                        created_at=user.created_at,
                    )
        return None
