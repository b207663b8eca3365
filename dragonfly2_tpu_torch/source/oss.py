"""oss:// source client (reference: pkg/source/clients/ossprotocol).

URL form ``oss://<bucket>/<key>`` (ossprotocol uses the aliyun SDK with
per-request endpoint/accessKeyID/accessKeySecret headers).  Signing is
the public OSS header scheme: HMAC-SHA1 over
``VERB\\nContent-MD5\\nContent-Type\\nDate\\n<canonicalized-oss-headers>
<canonicalized-resource>`` carried as ``Authorization: OSS <id>:<sig>``.

Port of ``dragonfly2_tpu/source/oss.py``, verbatim.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse
import urllib.request
from email.utils import formatdate
from typing import Callable, Optional

from .client import RangedHTTPClient, default_transport


def sign_oss(
    secret: str,
    method: str,
    *,
    date: str,
    bucket: str,
    key: str,
    content_md5: str = "",
    content_type: str = "",
    oss_headers: Optional[dict] = None,
    resource: Optional[str] = None,
    header_prefix: str = "x-oss-",
) -> str:
    """``resource`` overrides the default ``/{bucket}/{key}`` canonical
    resource — service-level requests (list buckets) sign the bare "/"
    that the bucket/key form cannot express.  ``header_prefix`` selects
    the vendor header namespace: Huawei OBS uses the SAME HMAC-SHA1
    canonical scheme with ``x-obs-`` headers (one signer for both,
    objectstorage.go:179-212 dispatch parity)."""
    canon_headers = ""
    if oss_headers:
        lower = {
            k.lower(): v for k, v in oss_headers.items()
            if k.lower().startswith(header_prefix)
        }
        canon_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    if resource is None:
        resource = f"/{bucket}/{key}"
    to_sign = (
        f"{method}\n{content_md5}\n{content_type}\n{date}\n"
        f"{canon_headers}{resource}"
    )
    mac = hmac.new(secret.encode(), to_sign.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


class OSSSourceClient(RangedHTTPClient):
    def __init__(
        self,
        *,
        access_key_id: str = "",
        access_key_secret: str = "",
        endpoint: str = "",
        timeout: float = 30.0,
        transport: Optional[Callable] = None,
    ) -> None:
        self.access_key_id = access_key_id
        self.access_key_secret = access_key_secret
        # e.g. "http://127.0.0.1:9001" (fixture) or
        # "https://oss-cn-hangzhou.aliyuncs.com"
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self.transport = transport or default_transport

    def _request(self, url: str, method: str, extra_headers=None):
        parsed = urllib.parse.urlsplit(url)
        bucket, key = parsed.netloc, parsed.path.lstrip("/")
        http_url = f"{self.endpoint}/{bucket}/{urllib.parse.quote(key)}"
        headers = dict(extra_headers or {})
        if self.access_key_id:
            date = formatdate(time.time(), usegmt=True)
            headers["Date"] = date
            sig = sign_oss(
                self.access_key_secret, method, date=date, bucket=bucket, key=key
            )
            headers["Authorization"] = f"OSS {self.access_key_id}:{sig}"
        req = urllib.request.Request(http_url, headers=headers, method=method)
        return self.transport(req, self.timeout)
