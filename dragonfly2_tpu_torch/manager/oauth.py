"""OAuth2 sign-in seam (reference: manager/models/oauth.go + handlers —
configurable oauth providers backing console sign-in).

Standard authorization-code flow with an injectable transport: the
manager redirects to the provider's authorize URL, exchanges the
callback code for an access token, fetches the profile, and maps it to
a local user (get-or-create by email, READONLY by default — an admin
raises roles afterwards).

Port of ``dragonfly2_tpu/manager/oauth.py``, verbatim.
"""

from __future__ import annotations

import json
import secrets
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..security.tokens import Role
from .users import User, UserStore


def _default_transport(req: urllib.request.Request, timeout: float):
    return urllib.request.urlopen(req, timeout=timeout)


class OAuthUnavailable(RuntimeError):
    """The IdP was unreachable or errored (5xx/timeout) — a TRANSIENT
    outcome: callers must keep refresh grants intact and retry, never
    treat it as a revocation."""


@dataclass
class OAuthProvider:
    """One configured provider (oauth.go rows: name, client id/secret,
    endpoints)."""

    name: str
    client_id: str
    client_secret: str
    auth_url: str
    token_url: str
    profile_url: str
    scopes: str = "openid email"


class OAuthSignin:
    def __init__(
        self,
        users: UserStore,
        *,
        timeout: float = 15.0,
        transport: Optional[Callable] = None,
    ) -> None:
        self.users = users
        self.timeout = timeout
        self.transport = transport or _default_transport
        self._providers: Dict[str, OAuthProvider] = {}
        # state → (provider name, issued_at).  The authorize-url endpoint
        # is unauthenticated: entries expire and the map is pruned so it
        # can't be grown without bound remotely.
        self._states: Dict[str, tuple] = {}
        self.state_ttl_s = 600.0
        # refresh handle → (provider, user_id, provider refresh token,
        # issued_at); see refresh().  Guarded by _grants_mu: the REST
        # server handles requests on concurrent threads, and two
        # refreshes racing the same handle must not BOTH redeem the
        # provider token (rotation-strict IdPs invalidate the grant
        # family on the second redemption).
        self._grants: Dict[str, tuple] = {}
        import threading

        self._grants_mu = threading.Lock()

    def register(self, provider: OAuthProvider) -> None:
        self._providers[provider.name] = provider

    def providers(self):
        return sorted(self._providers)

    def _prune_states(self) -> None:
        import time

        cutoff = time.time() - self.state_ttl_s
        for s in [s for s, (_, t) in self._states.items() if t < cutoff]:
            self._states.pop(s, None)

    def authorize_url(self, provider_name: str, redirect_uri: str) -> str:
        import time

        self._prune_states()
        p = self._providers[provider_name]
        state = secrets.token_urlsafe(16)
        self._states[state] = (p.name, time.time())
        return p.auth_url + "?" + urllib.parse.urlencode(
            {
                "client_id": p.client_id,
                "redirect_uri": redirect_uri,
                "response_type": "code",
                "scope": p.scopes,
                "state": state,
            }
        )

    def _token_request(self, p: OAuthProvider, grant: Dict[str, str]) -> dict:
        body = urllib.parse.urlencode(
            {
                "client_id": p.client_id,
                "client_secret": p.client_secret,
                **grant,
            }
        ).encode()
        req = urllib.request.Request(
            p.token_url, data=body,
            headers={"Accept": "application/json"}, method="POST",
        )
        try:
            with self.transport(req, self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            if exc.code in (400, 401, 403):
                # The IdP REJECTED the grant (invalid/revoked) — an auth
                # outcome.
                return {}
            # 5xx/429: the IdP is having a moment, the grant may well be
            # fine — transient, never destroy state over it.
            raise OAuthUnavailable(
                f"provider {p.name} returned HTTP {exc.code}"
            ) from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise OAuthUnavailable(
                f"provider {p.name} unreachable: {exc}"
            ) from exc

    def _map_profile(self, p: OAuthProvider, access_token: str) -> User:
        req = urllib.request.Request(
            p.profile_url, headers={"Authorization": f"Bearer {access_token}"}
        )
        with self.transport(req, self.timeout) as resp:
            profile = json.loads(resp.read())
        email = profile.get("email") or ""
        login = profile.get("login") or profile.get("name") or email
        if not login:
            raise PermissionError("oauth profile has no usable identity")
        username = f"{p.name}:{login}"
        existing = self.users.by_name(username)
        if existing is not None:
            # Same gate verify_password applies: a disabled account must
            # not regain access through the OAuth door.
            if existing.state != "enabled":
                raise PermissionError(f"account {username!r} is disabled")
            return existing
        # OAuth users get an unguessable local password (they sign in
        # through the provider, not with it).
        return self.users.create_user(
            username, secrets.token_urlsafe(24), email=email,
            role=Role.READONLY,
        )

    def signin(
        self, provider_name: str, code: str, state: str, redirect_uri: str
    ) -> User:
        """Code exchange → profile fetch → local user (get-or-create).
        Stores NO refresh grant — a caller that discards the handle must
        not leave orphan grants evicting live users' under the cap."""
        return self.signin_with_refresh(
            provider_name, code, state, redirect_uri, store_grant=False
        )[0]

    def signin_with_refresh(
        self, provider_name: str, code: str, state: str, redirect_uri: str,
        *, store_grant: bool = True,
    ):
        """The full flow, keeping the provider's refresh grant: returns
        (user, refresh_id) — refresh_id is an opaque manager-side handle
        (the provider refresh token itself never leaves the manager) the
        console presents to ``refresh`` for a new session without an
        interactive authorize round-trip; None when the IdP issued no
        refresh token."""
        self._prune_states()
        entry = self._states.pop(state, None)
        if entry is None or entry[0] != provider_name:
            raise PermissionError("oauth state mismatch (CSRF)")
        p = self._providers[provider_name]
        tokens = self._token_request(p, {
            "code": code,
            "grant_type": "authorization_code",
            "redirect_uri": redirect_uri,
        })
        access = tokens.get("access_token", "")
        if not access:
            raise PermissionError("oauth code exchange failed")
        user = self._map_profile(p, access)
        refresh_id = None
        if store_grant and tokens.get("refresh_token"):
            refresh_id = self._store_grant(
                p.name, user.id, tokens["refresh_token"]
            )
        return user, refresh_id

    # -- refresh (oauth.go refresh-token semantics) -------------------------

    # Stored provider refresh grants, keyed by the opaque handle the
    # console holds.  Bounded two ways: a TTL (a browser that never came
    # back holds no live grant) and a hard cap with oldest-first
    # eviction.
    MAX_GRANTS = 10_000
    GRANT_TTL_S = 30 * 86_400.0

    def _store_grant(self, provider: str, user_id: str, refresh_token: str) -> str:
        import time

        now = time.time()
        with self._grants_mu:
            for rid_ in [
                r for r, (_, _, _, t) in self._grants.items()
                if now - t > self.GRANT_TTL_S
            ]:
                self._grants.pop(rid_, None)
            rid = secrets.token_urlsafe(24)
            self._grants[rid] = (provider, user_id, refresh_token, now)
            while len(self._grants) > self.MAX_GRANTS:
                self._grants.pop(next(iter(self._grants)))
        return rid

    def refresh(self, refresh_id: str):
        """Renew a session from the stored provider refresh token:
        re-validates the identity against the IdP (a token the provider
        revoked — or a deleted/disabled account — degrades to
        re-authentication, never to a silent session).  Rotates both the
        handle and, when the IdP sends one, the provider refresh token.
        Returns (user, new_refresh_id).

        The handle is SINGLE-USE: popped under the lock before the IdP
        call, restored only on transient (OAuthUnavailable) outcomes.
        A concurrent refresh with the same handle finds it gone and
        degrades to re-authentication — never a double redemption that
        a rotation-strict IdP would treat as token theft."""
        with self._grants_mu:
            entry = self._grants.pop(refresh_id, None)
        if entry is None:
            raise PermissionError("unknown refresh handle; re-authenticate")
        provider, user_id, refresh_token, issued = entry

        def restore(rt: str) -> None:
            # setdefault: never clobber state a concurrent signin/evict
            # wrote under this handle while we held the IdP call open.
            with self._grants_mu:
                self._grants.setdefault(
                    refresh_id, (provider, user_id, rt, issued)
                )

        p = self._providers.get(provider)
        if p is None:
            raise PermissionError(f"provider {provider!r} no longer configured")
        try:
            # May raise OAuthUnavailable — grant restored, caller retries.
            tokens = self._token_request(p, {
                "refresh_token": refresh_token,
                "grant_type": "refresh_token",
            })
        except OAuthUnavailable:
            restore(refresh_token)
            raise
        access = tokens.get("access_token", "")
        if not access:
            # The IdP rejected (revoked/expired) the grant: it stays
            # destroyed — the console falls back to the authorize flow.
            raise PermissionError(
                "oauth refresh rejected by provider; re-authenticate"
            )
        # The IdP may have ROTATED the refresh token: record it under the
        # old handle immediately, so a crash/transport failure below
        # cannot strand the only copy of the rotated token.
        new_rt = tokens.get("refresh_token") or refresh_token
        restore(new_rt)
        try:
            user = self._map_profile(p, access)
        except urllib.error.HTTPError as exc:
            # HTTPError ⊂ URLError: without this arm a persistent 401/403
            # from the profile endpoint (access revoked at the IdP while
            # refresh still mints tokens, or a misconfigured profile_url)
            # would classify as transient forever — the console looping
            # 503s instead of degrading to re-authentication.
            if exc.code in (401, 403):
                with self._grants_mu:
                    self._grants.pop(refresh_id, None)
                raise PermissionError(
                    f"profile endpoint rejected token (HTTP {exc.code}); "
                    "re-authenticate"
                ) from exc
            raise OAuthUnavailable(
                f"provider {provider} profile endpoint HTTP {exc.code}"
            ) from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise OAuthUnavailable(
                f"provider {provider} unreachable: {exc}"
            ) from exc
        except PermissionError:
            with self._grants_mu:
                self._grants.pop(refresh_id, None)  # disabled account
            raise
        with self._grants_mu:
            self._grants.pop(refresh_id, None)
        new_rid = self._store_grant(provider, user.id, new_rt)
        return user, new_rid
