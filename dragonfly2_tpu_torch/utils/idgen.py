"""Deterministic ID generation (reference: pkg/idgen/*.go).

IDs are stable hashes so every service derives the same identity for the
same entity without coordination:

- host ID v1:  ``<hostname>-<port>``          (pkg/idgen/host_id.go:26-28)
- host ID v2:  sha256(ip, hostname)           (pkg/idgen/host_id.go:31-33)
- task ID:     sha256 over filtered URL + digest + range + tag + application
               (pkg/idgen/task_id.go:60-95)
- peer ID:     ``<ip>-<hostname>-<random>-<suffix>``
- model ID:    sha256(ip, hostname, model name) (pkg/idgen/model_id.go:31-39)
"""

from __future__ import annotations

import urllib.parse
import uuid
from dataclasses import dataclass, field
from typing import Sequence

from .digest import sha256_from_strings


@dataclass(frozen=True)
class URLMeta:
    """Subset of the wire URL metadata that keys a task (common.UrlMeta)."""

    digest: str = ""
    tag: str = ""
    range: str = ""
    filtered_query_params: Sequence[str] = field(default_factory=tuple)
    application: str = ""
    priority: int = 0


def host_id_v1(hostname: str, port: int) -> str:
    return f"{hostname}-{port}"


def host_id_v2(ip: str, hostname: str, seed_peer: bool = False) -> str:
    if seed_peer:
        return sha256_from_strings(ip, hostname, "seed")
    return sha256_from_strings(ip, hostname)


def _filter_query_params(url: str, filtered: Sequence[str]) -> str:
    """Drop the named query params and sort the rest for a canonical URL.

    With no params to filter the raw URL is returned unchanged, so
    ``task_id(url)`` and ``task_id(url, URLMeta())`` agree (the reference's
    FilterQueryParams is likewise a no-op on an empty filter list,
    pkg/net/url/url.go:24-27 — canonicalization only kicks in when
    filtering already rewrites the query).
    """
    if not any(f.strip() for f in filtered):
        return url
    try:
        parts = urllib.parse.urlsplit(url)
        query = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
        drop = {f.strip() for f in filtered if f.strip()}
        kept = sorted((k, v) for k, v in query if k not in drop)
        return urllib.parse.urlunsplit(
            parts._replace(query=urllib.parse.urlencode(kept))
        )
    except ValueError:
        return ""


def task_id(url: str, meta: URLMeta | None = None, *, ignore_range: bool = False) -> str:
    """Task identity: same content fetched the same way ⇒ same swarm."""
    if meta is None:
        return sha256_from_strings(url)
    data = [_filter_query_params(url, meta.filtered_query_params)]
    if meta.digest:
        data.append(meta.digest)
    if not ignore_range and meta.range:
        data.append(meta.range)
    if meta.tag:
        data.append(meta.tag)
    if meta.application:
        data.append(meta.application)
    return sha256_from_strings(*data)


def parent_task_id(url: str, meta: URLMeta | None = None) -> str:
    """Task ID ignoring byte range — keys the whole-file parent of a ranged task."""
    return task_id(url, meta, ignore_range=True)


def cache_task_id(path: str, tag: str = "", application: str = "") -> str:
    data = [path]
    if tag:
        data.append(tag)
    if application:
        data.append(application)
    return sha256_from_strings(*data)


def peer_id(ip: str, hostname: str, *, seed: bool = False) -> str:
    suffix = "seed" if seed else "normal"
    return f"{ip}-{hostname}-{uuid.uuid4().hex}-{suffix}"


def model_id(ip: str, hostname: str, name: str) -> str:
    return sha256_from_strings(ip, hostname, name)


def model_version_id(data: bytes) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()[:16]
