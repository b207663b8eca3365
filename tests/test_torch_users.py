"""Port parity: manager users, personal access tokens and OAuth sign-in,
``dragonfly2_tpu_torch/manager/{users,oauth,console,openapi}.py`` and
their REST routes.

The 22 cases of ``tests/test_users.py`` on the port, with the
reference's inputs and assertions; then the two packages against each
other: a user database written by either package signs in and resolves a
PAT through the other's ``UserStore``, the console page and the OpenAPI
spec are byte-equal, and the new REST routes answer equal JSON for the
same requests.
"""

import io
import json
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from dragonfly2_tpu_torch.manager import (
    ClusterManager,
    ModelRegistry,
    OAuthProvider,
    OAuthSignin,
    UserStore,
)
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.security.tokens import Role, TokenIssuer, TokenVerifier

SECRET = b"manager-secret-0123456789abcd"


class TestUserStore:
    def test_create_and_signin(self):
        store = UserStore()
        u = store.create_user("alice", "password123", email="a@x", role=Role.OPERATOR)
        assert store.verify_password("alice", "password123").id == u.id
        assert store.verify_password("alice", "wrong") is None
        assert store.verify_password("nobody", "password123") is None

    def test_duplicate_and_weak_password(self):
        store = UserStore()
        store.create_user("bob", "password123")
        with pytest.raises(ValueError):
            store.create_user("bob", "password456")
        with pytest.raises(ValueError):
            store.create_user("carl", "short")

    def test_disabled_user_cannot_signin_or_use_pat(self):
        store = UserStore()
        u = store.create_user("dave", "password123", role=Role.ADMIN)
        _, raw = store.create_pat(u.id, "ci")
        assert store.authenticate_pat(raw) is not None
        store.set_state(u.id, "disabled")
        assert store.verify_password("dave", "password123") is None
        assert store.authenticate_pat(raw) is None

    def test_ensure_root_idempotent(self):
        store = UserStore()
        r1 = store.ensure_root("rootpassword")
        r2 = store.ensure_root("otherpassword")
        assert r1.id == r2.id and r1.role == Role.ADMIN
        assert store.verify_password("root", "rootpassword") is not None

    def test_sqlite_persistence_roundtrip(self, tmp_path):
        db = str(tmp_path / "users.db")
        store = UserStore(db)
        u = store.create_user("eve", "password123", role=Role.OPERATOR)
        pat, raw = store.create_pat(u.id, "laptop")
        store2 = UserStore(db)  # restart
        assert store2.verify_password("eve", "password123").role == Role.OPERATOR
        again = store2.authenticate_pat(raw)
        assert again is not None and again.id == u.id
        store2.revoke_pat(pat.id)
        store3 = UserStore(db)
        assert store3.authenticate_pat(raw) is None  # revocation persisted


class TestPATs:
    def test_role_capped_at_owner(self):
        store = UserStore()
        u = store.create_user("peer", "password123", role=Role.PEER)
        pat, raw = store.create_pat(u.id, "t", role=Role.ADMIN)
        assert pat.role == Role.PEER  # no escalation
        assert store.authenticate_pat(raw).role == Role.PEER

    def test_expiry_and_revocation(self):
        store = UserStore()
        u = store.create_user("frank", "password123", role=Role.OPERATOR)
        pat, raw = store.create_pat(u.id, "gone", ttl_s=0.05)
        assert store.authenticate_pat(raw) is not None
        time.sleep(0.1)
        assert store.authenticate_pat(raw) is None
        pat2, raw2 = store.create_pat(u.id, "kept")
        store.revoke_pat(pat2.id)
        assert store.authenticate_pat(raw2) is None

    def test_bad_tokens_rejected(self):
        store = UserStore()
        assert store.authenticate_pat("dfp_deadbeef") is None
        assert store.authenticate_pat("not-a-pat") is None


def _post(url, payload, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers=headers, method="POST"
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


def _get(url, token=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read())


@pytest.fixture
def rest_server():
    users = UserStore()
    users.ensure_root("rootpassword")
    server = ManagerRESTServer(
        ModelRegistry(),
        ClusterManager(),
        token_verifier=TokenVerifier(SECRET),
        token_issuer=TokenIssuer(SECRET),
        users=users,
        oauth=None,
    )
    server.serve()
    yield server
    server.stop()


class TestUserREST:
    def test_signup_signin_and_admin_flow(self, rest_server):
        base = rest_server.url
        # Open signup → READONLY.
        u = _post(base + "/api/v1/users:signup",
                  {"name": "grace", "password": "password123"})
        assert u["role"] == "readonly"
        # Signin → session token.
        sess = _post(base + "/api/v1/users:signin",
                     {"name": "grace", "password": "password123"})
        assert sess["role"] == "readonly"
        # Listing users needs ADMIN.
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/api/v1/users", token=sess["token"])
        assert exc.value.code == 403
        # root promotes grace to operator.
        root = _post(base + "/api/v1/users:signin",
                     {"name": "root", "password": "rootpassword"})
        promoted = _post(base + f"/api/v1/users/{u['id']}:role",
                         {"role": "operator"}, token=root["token"])
        assert promoted["role"] == "operator"
        listing = _get(base + "/api/v1/users", token=root["token"])
        assert {x["name"] for x in listing} >= {"root", "grace"}

    def test_bad_signin_rejected(self, rest_server):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(rest_server.url + "/api/v1/users:signin",
                  {"name": "root", "password": "nope"})
        assert exc.value.code == 401

    def test_pat_lifecycle_and_model_auth(self, rest_server):
        base = rest_server.url
        root = _post(base + "/api/v1/users:signin",
                     {"name": "root", "password": "rootpassword"})
        # Create a PEER-scoped PAT; the raw token appears exactly once.
        pat = _post(base + "/api/v1/pats",
                    {"name": "trainer-ci", "role": "peer"}, token=root["token"])
        raw = pat["token"]
        assert raw.startswith("dfp_") and pat["role"] == "peer"
        # The PAT authenticates model creation (Role.PEER route)...
        created = _post(base + "/api/v1/models",
                        {"name": "m", "type": "mlp", "scheduler_id": "s"},
                        token=raw)
        assert created["name"] == "m"
        # ...but not activation (OPERATOR).
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + f"/api/v1/models/{created['id']}:activate", {},
                  token=raw)
        assert exc.value.code == 401
        # Listing my PATs works with the session token.
        pats = _get(base + "/api/v1/pats", token=root["token"])
        assert [p["id"] for p in pats] == [pat["id"]]
        # Revoke → the raw token dies.
        _post(base + f"/api/v1/pats/{pat['id']}:revoke", {}, token=root["token"])
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/api/v1/models",
                  {"name": "m2", "type": "mlp", "scheduler_id": "s"}, token=raw)
        assert exc.value.code == 401

    def test_capped_pat_cannot_escalate(self, rest_server):
        """A READONLY-capped PAT of an admin must not mint admin PATs or
        rotate the admin's password."""
        base = rest_server.url
        root = _post(base + "/api/v1/users:signin",
                     {"name": "root", "password": "rootpassword"})
        limited = _post(base + "/api/v1/pats",
                        {"name": "ci", "role": "readonly"}, token=root["token"])
        # Minting a new PAT through the capped PAT: role stays READONLY.
        minted = _post(base + "/api/v1/pats",
                       {"name": "evil", "role": "admin"}, token=limited["token"])
        assert minted["role"] == "readonly"
        # Password rotation through a PAT is refused outright.
        root_id = None
        listing = _get(base + "/api/v1/users", token=root["token"])
        root_id = next(u["id"] for u in listing if u["name"] == "root")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + f"/api/v1/users/{root_id}:reset-password",
                  {"password": "ownedpassword1"}, token=limited["token"])
        assert exc.value.code == 403

    def test_disable_kills_live_session(self, rest_server):
        base = rest_server.url
        u = _post(base + "/api/v1/users:signup",
                  {"name": "mallory", "password": "password123"})
        sess = _post(base + "/api/v1/users:signin",
                     {"name": "mallory", "password": "password123"})
        # Session works now.
        assert _get(base + "/api/v1/pats", token=sess["token"]) == []
        root = _post(base + "/api/v1/users:signin",
                     {"name": "root", "password": "rootpassword"})
        _post(base + f"/api/v1/users/{u['id']}:state",
              {"state": "disabled"}, token=root["token"])
        # The outstanding 24h session token dies immediately.
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/api/v1/pats", token=sess["token"])
        assert exc.value.code == 401

    def test_reset_password_self_only(self, rest_server):
        base = rest_server.url
        u = _post(base + "/api/v1/users:signup",
                  {"name": "henry", "password": "password123"})
        sess = _post(base + "/api/v1/users:signin",
                     {"name": "henry", "password": "password123"})
        other = _post(base + "/api/v1/users:signup",
                      {"name": "iris", "password": "password123"})
        # henry cannot reset iris's password.
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + f"/api/v1/users/{other['id']}:reset-password",
                  {"password": "hacked12345"}, token=sess["token"])
        assert exc.value.code == 403
        # but can reset his own.
        _post(base + f"/api/v1/users/{u['id']}:reset-password",
              {"password": "newpassword1"}, token=sess["token"])
        assert _post(base + "/api/v1/users:signin",
                     {"name": "henry", "password": "newpassword1"})["token"]


class TestConsole:
    def test_console_served_at_root(self, rest_server):
        with urllib.request.urlopen(rest_server.url + "/", timeout=5) as r:
            body = r.read().decode()
            assert r.headers.get_content_type() == "text/html"
        assert "manager console" in body and "/api/v1" in body
        with urllib.request.urlopen(rest_server.url + "/console", timeout=5) as r:
            assert r.status == 200


class TestManagerAuthConfig:
    def test_short_token_secret_is_config_error(self):
        from dragonfly2_tpu_torch.config import ConfigError
        from dragonfly2_tpu_torch.config.schema import ManagerConfig

        cfg = ManagerConfig(token_secret="abc")
        with pytest.raises(ConfigError):
            cfg.validate()
        ManagerConfig(token_secret="long-enough-secret-123").validate()

    def test_oauth_provider_needs_name(self):
        from dragonfly2_tpu_torch.config import ConfigError
        from dragonfly2_tpu_torch.config.schema import ManagerConfig

        cfg = ManagerConfig(oauth_providers=[{"client_id": "x"}])
        with pytest.raises(ConfigError):
            cfg.validate()


class _FakeOAuthTransport:
    """Answers the provider's token + profile endpoints in-process."""

    def __init__(self):
        self.seen = []

    def __call__(self, req, timeout):
        self.seen.append(req.full_url)
        if "token" in req.full_url:
            body = json.dumps({"access_token": "at-123"}).encode()
        else:
            assert req.headers.get("Authorization") == "Bearer at-123"
            body = json.dumps(
                {"login": "octocat", "email": "octo@cat"}
            ).encode()

        class _Resp(io.BytesIO):
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        return _Resp(body)


class TestOAuth:
    def test_full_signin_flow(self):
        users = UserStore()
        oauth = OAuthSignin(users, transport=_FakeOAuthTransport())
        oauth.register(OAuthProvider(
            name="hub", client_id="cid", client_secret="cs",
            auth_url="https://hub/oauth/authorize",
            token_url="https://hub/oauth/token",
            profile_url="https://hub/api/user",
        ))
        url = oauth.authorize_url("hub", "https://manager/cb")
        state = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))["state"]
        user = oauth.signin("hub", "code-1", state, "https://manager/cb")
        assert user.name == "hub:octocat" and user.role == Role.READONLY
        # Second signin with the SAME identity maps to the same user.
        url2 = oauth.authorize_url("hub", "https://manager/cb")
        state2 = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url2).query))["state"]
        again = oauth.signin("hub", "code-2", state2, "https://manager/cb")
        assert again.id == user.id

    def test_disabled_user_blocked_at_oauth_door(self):
        users = UserStore()
        oauth = OAuthSignin(users, transport=_FakeOAuthTransport())
        oauth.register(OAuthProvider(
            name="hub", client_id="c", client_secret="s",
            auth_url="https://h/a", token_url="https://h/token",
            profile_url="https://h/profile",
        ))
        url = oauth.authorize_url("hub", "https://m/cb")
        state = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))["state"]
        user = oauth.signin("hub", "c1", state, "https://m/cb")
        users.set_state(user.id, "disabled")
        url2 = oauth.authorize_url("hub", "https://m/cb")
        state2 = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url2).query))["state"]
        with pytest.raises(PermissionError):
            oauth.signin("hub", "c2", state2, "https://m/cb")

    def test_stale_states_pruned(self):
        users = UserStore()
        oauth = OAuthSignin(users, transport=_FakeOAuthTransport())
        oauth.register(OAuthProvider(
            name="hub", client_id="c", client_secret="s",
            auth_url="https://h/a", token_url="https://h/t",
            profile_url="https://h/p",
        ))
        oauth.state_ttl_s = 0.05
        for _ in range(50):
            oauth.authorize_url("hub", "https://m/cb")
        time.sleep(0.1)
        oauth.authorize_url("hub", "https://m/cb")
        assert len(oauth._states) == 1  # the fresh one; the 50 are gone

    def test_state_mismatch_rejected(self):
        users = UserStore()
        oauth = OAuthSignin(users, transport=_FakeOAuthTransport())
        oauth.register(OAuthProvider(
            name="hub", client_id="c", client_secret="s",
            auth_url="https://h/a", token_url="https://h/t",
            profile_url="https://h/p",
        ))
        with pytest.raises(PermissionError):
            oauth.signin("hub", "code", "forged-state", "https://m/cb")

    def test_rest_oauth_routes(self):
        users = UserStore()
        oauth = OAuthSignin(users, transport=_FakeOAuthTransport())
        oauth.register(OAuthProvider(
            name="hub", client_id="cid", client_secret="cs",
            auth_url="https://hub/oauth/authorize",
            token_url="https://hub/oauth/token",
            profile_url="https://hub/api/user",
        ))
        server = ManagerRESTServer(
            ModelRegistry(), ClusterManager(),
            token_verifier=TokenVerifier(SECRET),
            token_issuer=TokenIssuer(SECRET),
            users=users, oauth=oauth,
        )
        server.serve()
        try:
            base = server.url
            assert _get(base + "/api/v1/oauth:providers") == ["hub"]
            out = _get(
                base + "/api/v1/oauth/hub:authorize-url?"
                + urllib.parse.urlencode({"redirect_uri": "https://m/cb"})
            )
            state = dict(
                urllib.parse.parse_qsl(urllib.parse.urlsplit(out["url"]).query)
            )["state"]
            sess = _post(base + "/api/v1/oauth/hub:signin",
                         {"code": "c1", "state": state,
                          "redirect_uri": "https://m/cb"})
            assert sess["role"] == "readonly" and sess["token"]
        finally:
            server.stop()


# -- the two packages against each other -------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_user_database_signs_in_through_the_other_package(tmp_path, writer):
    """Passwords (pbkdf2) and PAT hashes are byte for byte the reference's:
    a user database one package wrote signs in, and resolves a PAT, through
    the other's store."""
    from dragonfly2_tpu.manager.users import UserStore as JUserStore
    from dragonfly2_tpu.security.tokens import Role as JRole

    db = str(tmp_path / "users.db")
    w_store, w_role = (JUserStore, JRole) if writer == "jax" else (UserStore, Role)
    r_store = UserStore if writer == "jax" else JUserStore
    store = w_store(db)
    u = store.create_user("eve", "password123", email="e@x", role=w_role.OPERATOR)
    pat, raw = store.create_pat(u.id, "laptop", role=w_role.PEER)
    revoked, raw_revoked = store.create_pat(u.id, "old")
    store.revoke_pat(revoked.id)
    other = r_store(db)
    signed = other.verify_password("eve", "password123")
    assert signed is not None and signed.id == u.id and int(signed.role) == int(Role.OPERATOR)
    assert other.verify_password("eve", "wrong-password") is None
    by_pat = other.authenticate_pat(raw)
    assert by_pat is not None and by_pat.id == u.id and int(by_pat.role) == int(Role.PEER)
    assert other.authenticate_pat(raw_revoked) is None
    assert [p.id for p in other.list_pats(u.id)] == [pat.id, revoked.id]


def test_console_and_openapi_are_the_references():
    from dragonfly2_tpu.manager import console as jconsole
    from dragonfly2_tpu.manager import openapi as jopenapi
    from dragonfly2_tpu_torch.manager import console, openapi

    assert console.CONSOLE_HTML.encode() == jconsole.CONSOLE_HTML.encode()
    assert json.dumps(openapi.spec(), sort_keys=True) == json.dumps(
        jopenapi.spec(), sort_keys=True)


def _normalized(value, names):
    """Random ids, tokens and times replaced by stable placeholders (the
    n-th distinct value of a kind → ``<kind:n>``)."""
    import re

    if isinstance(value, dict):
        return {k: ("<time>" if k in ("expires_at", "created_at") else _normalized(v, names))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_normalized(v, names) for v in value]
    if not isinstance(value, str):
        return value

    def sub(kind):
        def repl(m):
            key = (kind, m.group(0))
            names.setdefault(key, f"<{kind}:{sum(1 for k in names if k[0] == kind)}>")
            return names[key]
        return repl

    value = re.sub(r"-----BEGIN CERTIFICATE-----[\s\S]*?-----END CERTIFICATE-----\n?",
                   sub("pem"), value)
    value = re.sub(r"[A-Za-z0-9_-]{20,}\.[A-Za-z0-9_-]{20,}", sub("session"), value)
    value = re.sub(r"dfp_[0-9a-f]{40}", sub("pat"), value)
    return re.sub(r"[0-9a-f]{12,}", sub("id"), value)


def _route_sequence(server) -> list:
    """One fixed sequence of requests over the new routes → each answer's
    (method, path, status, normalized JSON)."""
    base = server.url
    names: dict = {}
    seen = []
    tokens = {}

    def call(method, path, body=None, who=None):
        path = path.format(**{k: v for k, v in tokens.items() if isinstance(v, str)})
        headers = {"Content-Type": "application/json"}
        if who:
            headers["Authorization"] = f"Bearer {tokens[who]}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                status, payload = resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            status, payload = exc.code, json.loads(exc.read() or b"{}")
        seen.append((method, _normalized(path, names), status, _normalized(payload, names)))
        return payload

    tokens["grace_id"] = call("POST", "/api/v1/users:signup",
                              {"name": "grace", "password": "password123"})["id"]
    call("POST", "/api/v1/users:signup", {"name": "grace", "password": "password456"})
    call("POST", "/api/v1/users:signup", {"name": "carl", "password": "short"})
    tokens["grace"] = call("POST", "/api/v1/users:signin",
                           {"name": "grace", "password": "password123"})["token"]
    call("POST", "/api/v1/users:signin", {"name": "root", "password": "nope"})
    call("GET", "/api/v1/users", who="grace")
    tokens["root"] = call("POST", "/api/v1/users:signin",
                          {"name": "root", "password": "rootpassword"})["token"]
    call("POST", "/api/v1/users/{grace_id}:role", {"role": "operator"}, who="root")
    call("POST", "/api/v1/users/{grace_id}:role", {"role": "admin"}, who="grace")
    call("GET", "/api/v1/users", who="root")
    pat = call("POST", "/api/v1/pats", {"name": "ci", "role": "peer"}, who="root")
    tokens["pat"], tokens["pat_id"] = pat["token"], pat["id"]
    call("GET", "/api/v1/pats", who="root")
    call("GET", "/api/v1/pats")
    call("POST", "/api/v1/users/{grace_id}:reset-password", {"password": "x" * 10}, who="pat")
    call("POST", "/api/v1/users/{grace_id}:reset-password", {"password": "newpassword1"},
         who="grace")
    call("POST", "/api/v1/users/{grace_id}:state", {"state": "disabled"}, who="root")
    call("GET", "/api/v1/pats", who="grace")
    call("POST", "/api/v1/pats/{pat_id}:revoke", {}, who="root")
    call("POST", "/api/v1/pats/{pat_id}:revoke", {}, who="pat")
    call("GET", "/api/v1/certs:ca")
    call("POST", "/api/v1/certs:issue", {"csr_pem": "not a csr"}, who="root")
    call("POST", "/api/v1/certs:issue", {"csr_pem": "not a csr"})
    call("GET", "/api/v1/oauth:providers")
    call("GET", "/api/v1/oauth/ghost:authorize-url?redirect_uri=x")
    call("POST", "/api/v1/oauth/ghost:signin", {"code": "c", "state": "s"})
    call("POST", "/api/v1/oauth:refresh", {"refresh_id": "nope"})
    call("GET", "/api/v1/buckets")
    call("POST", "/api/v1/buckets", {"name": "b"}, who="root")
    for route in ("status", "log", "snapshot"):
        call("GET", f"/api/v1/replication:{route}")
    call("GET", "/swagger.json")
    return seen


def test_new_rest_routes_answer_equal_json_across_packages():
    """The users, PAT, OAuth, certificate, bucket and replication routes of
    each package's manager answer the same statuses and JSON (random ids,
    tokens and times normalized) for one sequence of requests."""
    from dragonfly2_tpu.manager import ClusterManager as JClusterManager
    from dragonfly2_tpu.manager import ModelRegistry as JModelRegistry
    from dragonfly2_tpu.manager import OAuthSignin as JOAuthSignin
    from dragonfly2_tpu.manager import UserStore as JUserStore
    from dragonfly2_tpu.manager.rest import ManagerRESTServer as JManagerRESTServer
    from dragonfly2_tpu.security.tokens import TokenIssuer as JIssuer
    from dragonfly2_tpu.security.tokens import TokenVerifier as JVerifier

    sequences = {}
    for name, (srv_cls, reg, clu, store, oauth, issuer, verifier) in {
        "jax": (JManagerRESTServer, JModelRegistry, JClusterManager, JUserStore,
                JOAuthSignin, JIssuer, JVerifier),
        "port": (ManagerRESTServer, ModelRegistry, ClusterManager, UserStore,
                 OAuthSignin, TokenIssuer, TokenVerifier),
    }.items():
        users = store()
        users.ensure_root("rootpassword")
        server = srv_cls(reg(), clu(), token_verifier=verifier(SECRET),
                         token_issuer=issuer(SECRET), users=users, oauth=oauth(users))
        server.serve()
        try:
            sequences[name] = _route_sequence(server)
        finally:
            server.stop()
    assert len(sequences["port"]) == len(sequences["jax"]) > 30
    for j, t in zip(sequences["jax"], sequences["port"]):
        assert t == j
    assert {s for _, _, s, _ in sequences["port"]} >= {200, 400, 401, 403, 404}
