"""oras:// / oci:// source client (reference: pkg/source/clients/orasprotocol).

Flow mirrors oras_source_client.go: fetch a bearer token
(`/service/token/?scope=repository:<path>:pull&service=harbor-registry`,
:360), fetch the manifest (`/v2/<path>/manifests/<tag>` with the OCI
accept header, :282) taking the LAST layer's digest (:296-298), then
read the blob (`/v2/<path>/blobs/<digest>`, :306).  This package adds
what the piece engine needs and the reference lacked: the layer *size*
from the manifest (so content_length is one manifest fetch, not a full
blob download) and Range reads against the blob endpoint.

URL form: ``oras://<registry>/<repository>:<tag>``.

Port of ``dragonfly2_tpu/source/oci.py``, verbatim.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, Optional, Tuple

from .client import _ranged_body, default_transport

OCI_MANIFEST_ACCEPT = "application/vnd.oci.image.manifest.v1+json"


def parse_oras_url(url: str) -> Tuple[str, str, str]:
    """oras://host/repo/path:tag → (host, repo/path, tag)."""
    parsed = urllib.parse.urlsplit(url)
    path = parsed.path.lstrip("/")
    if ":" not in path:
        raise ValueError(f"oras URL missing ':tag': {url}")
    repo, tag = path.rsplit(":", 1)
    return parsed.netloc, repo, tag


class ORASSourceClient:
    def __init__(
        self,
        *,
        auth_header: str = "",
        insecure_http: bool = False,
        timeout: float = 30.0,
        transport: Optional[Callable] = None,
    ) -> None:
        self.auth_header = auth_header  # e.g. "Basic <b64>" for token fetch
        self.scheme = "http" if insecure_http else "https"
        self.timeout = timeout
        self.transport = transport or default_transport
        self._mu = threading.Lock()
        # url → (token, layer_digest, layer_size): one token+manifest
        # round-trip serves every subsequent piece read.
        self._resolved: Dict[str, Tuple[str, str, int]] = {}

    def _get(self, http_url: str, headers: dict):
        req = urllib.request.Request(http_url, headers=headers)
        return self.transport(req, self.timeout)

    def _resolve(self, url: str) -> Tuple[str, str, int]:
        with self._mu:
            hit = self._resolved.get(url)
        if hit is not None:
            return hit
        host, repo, tag = parse_oras_url(url)
        token_url = (
            f"{self.scheme}://{host}/service/token/"
            f"?scope=repository:{repo}:pull&service=harbor-registry"
        )
        headers = {"Accept": "application/json"}
        if self.auth_header:
            headers["Authorization"] = self.auth_header
        with self._get(token_url, headers) as resp:
            token = str(json.loads(resp.read()).get("token", ""))

        manifest_url = f"{self.scheme}://{host}/v2/{repo}/manifests/{tag}"
        with self._get(
            manifest_url,
            {"Accept": OCI_MANIFEST_ACCEPT, "Authorization": f"Bearer {token}"},
        ) as resp:
            manifest = json.loads(resp.read())
        layers = manifest.get("layers") or []
        if not layers:
            raise ValueError(f"manifest is empty for {url}")
        layer = layers[-1]  # reference keeps the last layer's digest
        resolved = (token, layer["digest"], int(layer.get("size", -1)))
        with self._mu:
            self._resolved[url] = resolved
        return resolved

    def _blob_url(self, url: str, digest: str) -> str:
        host, repo, _ = parse_oras_url(url)
        return f"{self.scheme}://{host}/v2/{repo}/blobs/{digest}"

    # -- SourceClient protocol ----------------------------------------------

    def content_length(self, url: str) -> int:
        try:
            _, _, size = self._resolve(url)
            return size
        except (OSError, ValueError, KeyError):
            return -1

    def _blob_read(
        self, url: str, token: str, digest: str, start: int, length: int
    ) -> bytes:
        with self._get(
            self._blob_url(url, digest),
            {
                "Accept": OCI_MANIFEST_ACCEPT,
                "Authorization": f"Bearer {token}",
                "Range": f"bytes={start}-{start + length - 1}",
            },
        ) as resp:
            return _ranged_body(resp, start, length)

    def read_range(self, url: str, start: int, length: int) -> bytes:
        token, digest, _ = self._resolve(url)
        try:
            return self._blob_read(url, token, digest, start, length)
        except urllib.error.HTTPError as e:
            if e.code not in (401, 403):
                raise
            # Registry tokens are short-lived (Harbor ~30 min): drop the
            # cached resolution, re-auth once, retry the read.
            with self._mu:
                self._resolved.pop(url, None)
            token, digest, _ = self._resolve(url)
            return self._blob_read(url, token, digest, start, length)

    def exists(self, url: str) -> bool:
        return self.content_length(url) >= 0
