"""AWS Signature Version 4 request signing, dependency-free.

The reference delegates this to the AWS SDK
(pkg/source/clients/s3protocol/s3_source_client.go:78 — credentials are
carried per-request and handed to aws-sdk-go).  This package has no SDK,
so the public SigV4 algorithm is implemented directly: canonical request
→ string-to-sign → derived signing key → hex signature.

Port of ``dragonfly2_tpu/source/sigv4.py``, verbatim.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from typing import Dict, Tuple

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def canonical_request(
    method: str,
    url: str,
    headers: Dict[str, str],
    payload_sha256: str,
) -> Tuple[str, str]:
    """Returns (canonical_request, signed_headers)."""
    parsed = urllib.parse.urlsplit(url)
    # Canonical URI: percent-encoded path, '/' preserved.
    path = urllib.parse.quote(urllib.parse.unquote(parsed.path or "/"), safe="/~")
    # Canonical query: sorted by key, strictly encoded.
    pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canon_query = "&".join(
        f"{urllib.parse.quote(k, safe='~')}={urllib.parse.quote(v, safe='~')}"
        for k, v in sorted(pairs)
    )
    lower = {k.lower().strip(): " ".join(v.split()) for k, v in headers.items()}
    signed_headers = ";".join(sorted(lower))
    canon_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    req = "\n".join(
        [method.upper(), path, canon_query, canon_headers, signed_headers,
         payload_sha256]
    )
    return req, signed_headers


def string_to_sign(
    amz_date: str, region: str, service: str, canon_request: str
) -> Tuple[str, str]:
    """Returns (string_to_sign, credential_scope)."""
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    sts = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(canon_request.encode()).hexdigest()]
    )
    return sts, scope


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def sign_request(
    method: str,
    url: str,
    headers: Dict[str, str],
    *,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    amz_date: str,
    payload_sha256: str = EMPTY_SHA256,
) -> str:
    """Returns the value for the Authorization header.

    `headers` must already contain every header to be signed (including
    host and x-amz-date — the caller owns what gets signed).
    """
    canon, signed = canonical_request(method, url, headers, payload_sha256)
    sts, scope = string_to_sign(amz_date, region, service, canon)
    key = signing_key(secret_key, amz_date[:8], region, service)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}"
    )
