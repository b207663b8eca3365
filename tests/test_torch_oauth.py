"""Port parity: OAuth against a real (fake) IdP over real HTTP, the 2
cases of ``tests/test_oauth_e2e.py`` on the port's manager, with the
reference's inputs and assertions.

A fake IdP process-local HTTP server implements /authorize (302 with
code), /token (code + refresh grants, revocation) and /profile, and the
e2e drives the port manager's REST surface end to end with the default
urllib transport: authorize → code → token → profile → manager session →
refresh (handle + provider token both rotate) → revocation at the IdP
degrades to re-authentication.
"""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dragonfly2_tpu_torch.manager import ClusterManager, ModelRegistry
from dragonfly2_tpu_torch.manager.oauth import OAuthProvider, OAuthSignin
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.manager.users import UserStore
from dragonfly2_tpu_torch.security.tokens import TokenIssuer, TokenVerifier


class FakeIdP:
    """A minimal OAuth2 provider: auth codes, bearer tokens, refresh
    tokens with rotation, and operator revocation."""

    def __init__(self):
        self.codes = set()
        self.access = set()
        self.refresh = set()
        self.revoked = set()
        self._n = 0
        srv = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                if url.path == "/authorize":
                    code = srv._mint("code")
                    srv.codes.add(code)
                    sep = "&" if "?" in q["redirect_uri"] else "?"
                    dest = (
                        q["redirect_uri"] + sep
                        + urllib.parse.urlencode(
                            {"code": code, "state": q.get("state", "")}
                        )
                    )
                    self.send_response(302)
                    self.send_header("Location", dest)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif url.path == "/profile":
                    tok = self.headers.get("Authorization", "")[len("Bearer "):]
                    if tok not in srv.access:
                        self._json(401, {"error": "bad token"})
                        return
                    self._json(200, {"login": "octocat",
                                     "email": "octo@cat.example"})
                else:
                    self._json(404, {})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                form = dict(urllib.parse.parse_qsl(
                    self.rfile.read(n).decode()
                ))
                if self.path != "/token":
                    self._json(404, {})
                    return
                grant = form.get("grant_type")
                if grant == "authorization_code":
                    if form.get("code") not in srv.codes:
                        self._json(400, {"error": "invalid_grant"})
                        return
                    srv.codes.discard(form["code"])  # single-use
                    self._json(200, srv._issue())
                elif grant == "refresh_token":
                    rt = form.get("refresh_token", "")
                    if rt not in srv.refresh or rt in srv.revoked:
                        self._json(400, {"error": "invalid_grant"})
                        return
                    srv.refresh.discard(rt)  # rotation: single-use
                    self._json(200, srv._issue())
                else:
                    self._json(400, {"error": "unsupported_grant_type"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def _mint(self, kind):
        self._n += 1
        return f"{kind}-{self._n}"

    def _issue(self):
        a, r = self._mint("at"), self._mint("rt")
        self.access.add(a)
        self.refresh.add(r)
        return {"access_token": a, "refresh_token": r, "expires_in": 3600}

    def revoke_all_refresh(self):
        self.revoked |= set(self.refresh)

    def stop(self):
        self.httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, body, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers=headers, method="POST"
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


@pytest.fixture()
def stack():
    idp = FakeIdP()
    users = UserStore()
    secret = b"manager-secret-0123456789abcd"
    oauth = OAuthSignin(users)  # DEFAULT transport: real HTTP to the IdP
    oauth.register(OAuthProvider(
        name="hub", client_id="cid", client_secret="cs",
        auth_url=idp.url + "/authorize",
        token_url=idp.url + "/token",
        profile_url=idp.url + "/profile",
    ))
    server = ManagerRESTServer(
        ModelRegistry(), ClusterManager(),
        token_verifier=TokenVerifier(secret),
        token_issuer=TokenIssuer(secret),
        users=users, oauth=oauth,
    )
    server.serve()
    yield idp, server
    server.stop()
    idp.stop()


def _authorize(idp, server, cb="https://console/cb"):
    """Drive the authorize leg: manager URL → IdP 302 → code + state."""
    out = _get(
        server.url + "/api/v1/oauth/hub:authorize-url?redirect_uri="
        + urllib.parse.quote(cb)
    )
    opener = urllib.request.build_opener(_NoRedirect())
    try:
        opener.open(out["url"], timeout=10)
        raise AssertionError("IdP did not redirect")
    except urllib.error.HTTPError as exc:
        assert exc.code == 302
        loc = exc.headers["Location"]
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(loc).query))
    return q["code"], q["state"]


class TestOAuthE2E:
    def test_full_flow_with_refresh_and_revocation(self, stack):
        idp, server = stack
        cb = "https://console/cb"

        # authorize → code → token → profile → manager session
        code, state = _authorize(idp, server, cb)
        out = _post(server.url + "/api/v1/oauth/hub:signin",
                    {"code": code, "state": state, "redirect_uri": cb})
        assert out["role"] == "readonly" and out["refresh_id"]
        token, rid = out["token"], out["refresh_id"]
        # The session works on an authed route (own PATs listing).
        with urllib.request.urlopen(urllib.request.Request(
            server.url + "/api/v1/pats",
            headers={"Authorization": f"Bearer {token}"},
        ), timeout=10) as r:
            assert r.status == 200

        # refresh: new session, BOTH the handle and the provider token
        # rotate (the old handle is dead).
        out2 = _post(server.url + "/api/v1/oauth:refresh",
                     {"refresh_id": rid})
        assert out2["token"] and out2["refresh_id"] != rid
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.url + "/api/v1/oauth:refresh", {"refresh_id": rid})
        assert exc.value.code == 403

        # Revocation at the IdP: the next refresh degrades to re-auth...
        idp.revoke_all_refresh()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.url + "/api/v1/oauth:refresh",
                  {"refresh_id": out2["refresh_id"]})
        assert exc.value.code == 403
        assert "re-authenticate" in json.loads(exc.value.read())["error"]
        # ...and the authorize flow still signs the SAME user in.
        code, state = _authorize(idp, server, cb)
        out3 = _post(server.url + "/api/v1/oauth/hub:signin",
                     {"code": code, "state": state, "redirect_uri": cb})
        assert out3["token"] and out3["refresh_id"]

    def test_console_ships_the_oauth_flow(self):
        from dragonfly2_tpu_torch.manager.console import CONSOLE_HTML

        for needle in (
            "oauthStart", "oauthCallback", "oauthRefresh",
            '"/oauth:refresh"', ":authorize-url", "df_refresh_id",
        ):
            assert needle in CONSOLE_HTML, needle
