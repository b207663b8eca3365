"""s3:// source client (reference: pkg/source/clients/s3protocol).

URL form matches the reference: ``s3://<bucket>/<key>`` with the
bucket as the URL host (s3_source_client.go:104).  Credentials, region
and endpoint are constructor config here (the reference smuggles them in
per-request headers because its interface is request-shaped); an
injectable ``transport`` lets tests run against a local fixture server
that *re-derives* the SigV4 signature.

Port of ``dragonfly2_tpu/source/s3.py``, verbatim.
"""

from __future__ import annotations

import time
import urllib.parse
import urllib.request
from typing import Callable, Optional

from . import sigv4
from .client import RangedHTTPClient, default_transport


class S3SourceClient(RangedHTTPClient):
    def __init__(
        self,
        *,
        access_key: str = "",
        secret_key: str = "",
        session_token: str = "",
        region: str = "us-east-1",
        endpoint: str = "",
        force_path_style: bool = True,
        timeout: float = 30.0,
        transport: Optional[Callable] = None,
    ) -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region
        # endpoint e.g. "http://127.0.0.1:9000" (minio/test fixture) or
        # "" → https://<bucket>.s3.<region>.amazonaws.com virtual-host.
        self.endpoint = endpoint.rstrip("/")
        self.force_path_style = force_path_style
        self.timeout = timeout
        self.transport = transport or default_transport

    # -- request plumbing ---------------------------------------------------

    def _http_url(self, url: str) -> str:
        parsed = urllib.parse.urlsplit(url)
        bucket, key = parsed.netloc, parsed.path.lstrip("/")
        if self.endpoint:
            if self.force_path_style:
                return f"{self.endpoint}/{bucket}/{urllib.parse.quote(key)}"
            scheme, host = self.endpoint.split("://", 1)
            return f"{scheme}://{bucket}.{host}/{urllib.parse.quote(key)}"
        return (
            f"https://{bucket}.s3.{self.region}.amazonaws.com/"
            f"{urllib.parse.quote(key)}"
        )

    def _request(self, url: str, method: str, extra_headers=None):
        http_url = self._http_url(url)
        headers = dict(extra_headers or {})
        if self.access_key:
            amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            signed = {
                "host": urllib.parse.urlsplit(http_url).netloc,
                "x-amz-date": amz_date,
                "x-amz-content-sha256": sigv4.EMPTY_SHA256,
            }
            if self.session_token:
                signed["x-amz-security-token"] = self.session_token
            headers.update(signed)
            headers["Authorization"] = sigv4.sign_request(
                method, http_url, signed,
                access_key=self.access_key, secret_key=self.secret_key,
                region=self.region, service="s3", amz_date=amz_date,
            )
            headers.pop("host")  # urllib sets Host itself, identically
        req = urllib.request.Request(http_url, headers=headers, method=method)
        return self.transport(req, self.timeout)
