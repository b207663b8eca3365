"""Source clients + registry (reference: pkg/source/source_client.go,
clients/httpprotocol, loader/*.go).

Port of ``dragonfly2_tpu/source/client.py``, verbatim.
"""

from __future__ import annotations

import logging
import os
import threading
import urllib.parse
import urllib.request
from typing import Dict, Optional, Protocol


class SourceClient(Protocol):
    def content_length(self, url: str) -> int:
        """Total bytes; -1 when the origin won't say."""
        ...

    def read_range(self, url: str, start: int, length: int) -> bytes:
        ...


def default_transport(req: urllib.request.Request, timeout: float):
    """The injectable-transport default shared by the cloud clients
    (tests swap in local fixture servers)."""
    from ..utils import faultinject

    faultinject.fire("source.transport")
    return urllib.request.urlopen(req, timeout=timeout)


def _accepts_headers(fn) -> bool:
    """True when `fn` takes a `headers` kwarg (or **kwargs).  Inspected
    once per callable — a genuine TypeError raised INSIDE a headers-aware
    call must propagate, never silently retry without auth."""
    try:
        cached = fn.__dict__.get("_df_accepts_headers")
    except AttributeError:
        cached = None
    if cached is not None:
        return cached
    import inspect

    try:
        sig = inspect.signature(fn)
        ok = "headers" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        )
    except (ValueError, TypeError):
        ok = False
    try:
        fn.__dict__["_df_accepts_headers"] = ok
    except AttributeError:
        pass  # bound methods / builtins: re-inspect next time
    return ok


def call_with_optional_headers(fn, *args, headers=None):
    """Invoke `fn(*args, headers=headers)` when supported, else
    `fn(*args)` — but ONLY based on the signature: headers are never
    dropped because of an exception."""
    if headers and _accepts_headers(fn):
        return fn(*args, headers=headers)
    return fn(*args)


class RangedHTTPClient:
    """Shared HEAD-length / range-GET / exists over a ``_request`` hook.

    Subclasses implement ``_request(url, method, extra_headers)`` doing
    their own URL mapping and signing.  Errors in content_length are
    answered with -1 across the board — including network-level OSError
    (DNS, refused), not just HTTP status errors.
    """

    def _request(self, url: str, method: str, extra_headers=None):
        raise NotImplementedError

    def content_length(self, url: str) -> int:
        try:
            with self._request(url, "HEAD") as resp:
                cl = resp.headers.get("Content-Length")
                return int(cl) if cl is not None else -1
        except (OSError, ValueError):
            return -1

    def read_range(self, url: str, start: int, length: int) -> bytes:
        with self._request(
            url, "GET", {"Range": f"bytes={start}-{start + length - 1}"}
        ) as resp:
            return _ranged_body(resp, start, length)

    def exists(self, url: str) -> bool:
        return self.content_length(url) >= 0


def _ranged_body(resp, start: int, length: int) -> bytes:
    """Range responses are optional for some origins (e.g. OCI blob
    endpoints): a 200 carries the WHOLE object from byte 0 (a
    range-honoring origin answers 206), so extract the piece rather than
    storing the full blob as one corrupt piece.  The prefix is read in
    chunks and discarded — never the whole object buffered — and the
    tail past the piece is simply not read (the connection closes)."""
    status = getattr(resp, "status", None) or getattr(resp, "code", 206)
    if status != 200:
        return resp.read()
    remaining = start
    while remaining > 0:
        skipped = resp.read(min(remaining, 1 << 20))
        if not skipped:
            return b""  # object shorter than `start`
        remaining -= len(skipped)
    out = b""
    while len(out) < length:
        chunk = resp.read(length - len(out))
        if not chunk:
            break
        out += chunk
    return out


class FileSourceClient:
    """file:// and bare paths — the test/e2e fixture origin."""

    def _path(self, url: str) -> str:
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme == "file":
            # Writers quote paths so '#'/'?' survive urlsplit — but raw
            # unquoted URLs whose filenames contain literal '%' predate
            # that convention, so prefer the decoded path only when it
            # actually exists (or the raw one doesn't).
            decoded = urllib.parse.unquote(parsed.path)
            if decoded != parsed.path and not os.path.exists(decoded) \
                    and os.path.exists(parsed.path):
                return parsed.path
            return decoded
        return url

    def content_length(self, url: str) -> int:
        try:
            return os.path.getsize(self._path(url))
        except OSError:
            return -1

    def read_range(self, url: str, start: int, length: int) -> bytes:
        with open(self._path(url), "rb") as f:
            f.seek(start)
            return f.read(length)


class HTTPSourceClient:
    """http(s):// via urllib range GETs (clients/httpprotocol).

    ``headers`` (per call) carry request auth — preheat of private
    registry blobs rides the pull token through here.
    """

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def content_length(self, url: str, headers: Optional[dict] = None) -> int:
        from ..utils import faultinject

        req = urllib.request.Request(url, headers=headers or {}, method="HEAD")
        try:
            faultinject.fire("source.content_length")
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                cl = resp.headers.get("Content-Length")
                return int(cl) if cl is not None else -1
        except Exception as exc:  # noqa: BLE001 — origin won't say → -1
            logging.getLogger(__name__).debug("HEAD %s: %s", url, exc)
            return -1

    def read_range(
        self, url: str, start: int, length: int,
        headers: Optional[dict] = None,
    ) -> bytes:
        from ..utils import faultinject

        all_headers = {"Range": f"bytes={start}-{start + length - 1}"}
        all_headers.update(headers or {})
        faultinject.fire("source.read_range")
        with urllib.request.urlopen(
            urllib.request.Request(url, headers=all_headers),
            timeout=self.timeout,
        ) as resp:
            return _ranged_body(resp, start, length)


class SourceRegistry:
    """scheme → client (pkg/source Register/ResourceClient)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._clients: Dict[str, SourceClient] = {}

    def register(self, scheme: str, client: SourceClient) -> None:
        with self._mu:
            self._clients[scheme.lower()] = client

    def client_for(self, url: str) -> SourceClient:
        scheme = urllib.parse.urlsplit(url).scheme.lower() or "file"
        with self._mu:
            client = self._clients.get(scheme)
        if client is None:
            raise KeyError(f"no source client for scheme {scheme!r}")
        return client


default_registry = SourceRegistry()
default_registry.register("file", FileSourceClient())
default_registry.register("", FileSourceClient())
default_registry.register("http", HTTPSourceClient())
default_registry.register("https", HTTPSourceClient())


class PieceSourceFetcher:
    """Adapts a SourceClient registry to the conductor's SourceFetcher."""

    def __init__(self, registry: Optional[SourceRegistry] = None):
        self.registry = registry or default_registry

    def content_length(self, url: str, headers: Optional[dict] = None) -> int:
        client = self.registry.client_for(url)
        return call_with_optional_headers(
            client.content_length, url, headers=headers
        )

    def fetch(
        self, url: str, number: int, piece_size: int,
        headers: Optional[dict] = None,
    ) -> bytes:
        from ..utils import faultinject

        # Back-to-source chaos seam: every origin scheme funnels through
        # here, so one site covers http/s3/oss/oci/hdfs/file alike.
        faultinject.fire("source.fetch")
        client = self.registry.client_for(url)
        data = call_with_optional_headers(
            client.read_range, url, number * piece_size, piece_size,
            headers=headers,
        )
        return faultinject.fire("source.fetch.body", data)
