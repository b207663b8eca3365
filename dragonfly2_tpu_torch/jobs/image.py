"""Image-manifest resolution for preheat (manager/job/preheat.go:169-333).

Given a registry manifest URL (``https://<registry>/v2/<repo>/manifests/
<ref>``), resolve the layer blob URLs to preheat: basic-auth or
distribution token-flow auth, Accept headers for the docker/OCI manifest
media types, manifest LISTS filtered per platform with each matched
entry fetched by digest, layers collected across entries.

Port of ``dragonfly2_tpu/jobs/image.py``, verbatim but for the imports.
"""

from __future__ import annotations

import base64
import json
import re
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

MANIFEST_ACCEPT = ", ".join(
    [
        "application/vnd.docker.distribution.manifest.v2+json",
        "application/vnd.docker.distribution.manifest.list.v2+json",
        "application/vnd.oci.image.manifest.v1+json",
        "application/vnd.oci.image.index.v1+json",
    ]
)
LIST_TYPES = (
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
)


def parse_manifest_url(url: str) -> Tuple[str, str, str]:
    """…/v2/<repo>/manifests/<ref> → (registry_base, repo, ref)."""
    parsed = urllib.parse.urlsplit(url)
    m = re.match(r"^/v2/(.+)/manifests/([^/]+)$", parsed.path)
    if not m:
        raise ValueError(f"not a registry manifest URL: {url}")
    base = f"{parsed.scheme}://{parsed.netloc}"
    return base, m.group(1), m.group(2)


def _default_transport(req: urllib.request.Request, timeout: float):
    from ..utils import faultinject

    faultinject.fire("jobs.image.fetch")
    return urllib.request.urlopen(req, timeout=timeout)


@dataclass
class ResolvedLayers:
    urls: List[str]
    headers: Dict[str, str]  # auth header the downloaders must carry


class ImageResolver:
    def __init__(
        self,
        *,
        username: str = "",
        password: str = "",
        token: str = "",     # pre-issued Authorization value (Harbor V1 path)
        platform: str = "",  # "os/arch", "" = accept all entries
        timeout: float = 15.0,
        transport: Optional[Callable] = None,
    ) -> None:
        self.username = username
        self.password = password
        self.token = token
        self.platform = platform
        self.timeout = timeout
        self.transport = transport or _default_transport

    # -- auth (imageAuthClient: basic → WWW-Authenticate token flow) --------

    def _basic(self) -> str:
        raw = f"{self.username}:{self.password}".encode()
        return "Basic " + base64.b64encode(raw).decode()

    def _fetch_token(self, challenge: str, repo: str) -> str:
        """Parse `Bearer realm="…",service="…"` and fetch a pull token."""
        _, _, params = challenge.partition(" ")
        fields = dict(re.findall(r'(\w+)="([^"]*)"', params))
        realm = fields.get("realm", "")
        if not realm:
            raise PermissionError(f"unparseable auth challenge: {challenge}")
        qs = {"scope": fields.get("scope", f"repository:{repo}:pull")}
        if fields.get("service"):
            qs["service"] = fields["service"]
        req = urllib.request.Request(
            realm + "?" + urllib.parse.urlencode(qs),
            headers={"Authorization": self._basic()} if self.username else {},
        )
        with self.transport(req, self.timeout) as resp:
            data = json.loads(resp.read())
        token = data.get("token") or data.get("access_token") or ""
        if not token:
            raise PermissionError("token endpoint returned no token")
        return "Bearer " + token

    def _get(self, url: str, headers: Dict[str, str]):
        req = urllib.request.Request(url, headers=headers)
        return self.transport(req, self.timeout)

    def _authed_get(self, url: str, repo: str, headers: Dict[str, str]):
        """GET with the current auth, driving the 401 token flow once."""
        hdrs = dict(headers)
        if self.token:
            hdrs["Authorization"] = self.token
        elif self.username:
            hdrs["Authorization"] = self._basic()
        try:
            return self._get(url, hdrs), hdrs.get("Authorization", "")
        except urllib.error.HTTPError as exc:
            challenge = exc.headers.get("WWW-Authenticate", "")
            if exc.code != 401 or not challenge.startswith("Bearer"):
                raise
            auth = self._fetch_token(challenge, repo)
            hdrs["Authorization"] = auth
            return self._get(url, hdrs), auth

    # -- manifests (getManifests + parseLayers) -----------------------------

    def _platform_matches(self, entry: dict) -> bool:
        if not self.platform:
            return True
        p = entry.get("platform") or {}
        want_os, _, want_arch = self.platform.partition("/")
        return p.get("os") == want_os and (
            not want_arch or p.get("architecture") == want_arch
        )

    def resolve_layers(self, manifest_url: str) -> ResolvedLayers:
        base, repo, _ref = parse_manifest_url(manifest_url)
        resp, auth = self._authed_get(
            manifest_url, repo, {"Accept": MANIFEST_ACCEPT}
        )
        with resp:
            media_type = resp.headers.get("Content-Type", "").split(";")[0]
            manifest = json.loads(resp.read())

        manifests = []
        if media_type in LIST_TYPES or "manifests" in manifest:
            entries = [
                e for e in manifest.get("manifests", [])
                if self._platform_matches(e)
            ]
            if not entries:
                raise LookupError(
                    f"no matching manifest for platform {self.platform!r}"
                )
            headers = {"Accept": MANIFEST_ACCEPT}
            if auth:
                headers["Authorization"] = auth
            for e in entries:
                sub_url = f"{base}/v2/{repo}/manifests/{e['digest']}"
                with self._get(sub_url, headers) as sub:
                    manifests.append(json.loads(sub.read()))
        else:
            manifests.append(manifest)

        urls: List[str] = []
        for m in manifests:
            for layer in m.get("layers") or m.get("fsLayers") or []:
                digest = layer.get("digest") or layer.get("blobSum")
                if digest:
                    urls.append(f"{base}/v2/{repo}/blobs/{digest}")
        if not urls:
            raise LookupError(f"manifest has no layers: {manifest_url}")
        headers = {"Authorization": auth} if auth else {}
        return ResolvedLayers(urls=urls, headers=headers)
