"""S3 and OSS object-storage backends, dependency-free.

Reference: pkg/objectstorage/objectstorage.go:179-212 dispatches the
daemon gateway's backend to s3/oss/obs client packages (aws-sdk /
aliyun-oss-go-sdk).  This build has no SDKs: the S3 backend signs
requests with the repo's own SigV4 implementation (source/sigv4.py — the
same signer the s3:// source client uses) and the OSS backend implements
the public OSS header-signature scheme (HMAC-SHA1 over the canonicalized
request).  Both speak path-style HTTP to any compatible endpoint (AWS,
MinIO, Ceph RGW, Aliyun) and satisfy the ObjectStorageBackend protocol
(backend.py), so the gateway/dfstore select them by config alone.

Port of ``dragonfly2_tpu/objectstorage/s3.py``, verbatim.
"""

from __future__ import annotations

import calendar
import email.utils
import hashlib
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import List, Optional

from ..source import sigv4
from .backend import ObjectMetadata


class ObjectStorageError(RuntimeError):
    pass


def _parse_list_xml(body: bytes) -> List[ObjectMetadata]:
    """ListBucketResult → metadata rows (S3 ListObjectsV2 and OSS list
    share the Contents/Key/Size/ETag/LastModified shape)."""
    root = ET.fromstring(body)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    out = []
    for contents in root.iter(f"{ns}Contents"):
        key = contents.findtext(f"{ns}Key", "")
        size = int(contents.findtext(f"{ns}Size", "0"))
        etag = contents.findtext(f"{ns}ETag", "").strip('"')
        modified = contents.findtext(f"{ns}LastModified", "")
        try:
            # timegm, not mktime: LastModified is UTC; mktime would shift
            # it by the machine's zone offset (and disagree with
            # head_object's correctly-parsed timestamps).
            ts = float(
                calendar.timegm(time.strptime(modified[:19], "%Y-%m-%dT%H:%M:%S"))
            )
        except ValueError:
            ts = 0.0
        out.append(ObjectMetadata(
            key=key, content_length=size, etag=etag, last_modified=ts,
        ))
    return out


def _parse_bucket_names(body: bytes) -> List[str]:
    """ListAllMyBucketsResult → sorted bucket names (S3 and OSS share
    the Buckets/Bucket/Name shape)."""
    root = ET.fromstring(body)
    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    return sorted(
        b.findtext(f"{ns}Name", "") for b in root.iter(f"{ns}Bucket")
    )


class _HTTPBackendBase:
    """Shared request plumbing: sign → send → translate errors."""

    def __init__(self, endpoint: str, *, timeout: float = 30.0) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        path = f"/{bucket}"
        if key:
            path += "/" + urllib.parse.quote(key.strip("/"), safe="/~")
        return self.endpoint + path + (f"?{query}" if query else "")

    def _sign(
        self, method: str, url: str, headers: dict, payload: bytes,
        bucket: str, key: str,
    ) -> dict:
        raise NotImplementedError

    def _request(
        self,
        method: str,
        bucket: str,
        key: str = "",
        *,
        query: str = "",
        payload: bytes = b"",
        extra_headers: Optional[dict] = None,
    ):
        url = self._url(bucket, key, query)
        headers = dict(extra_headers or {})
        if method in ("PUT", "POST"):
            # Sign the Content-Type the server will actually SEE: urllib
            # silently adds application/x-www-form-urlencoded to requests
            # with a body, which would break signature verification on
            # real endpoints (the signature covers Content-Type on OSS).
            headers.setdefault("Content-Type", "application/octet-stream")
        headers = self._sign(method, url, headers, payload, bucket, key)
        req = urllib.request.Request(
            url, data=payload if method in ("PUT", "POST") else None,
            headers=headers, method=method,
        )
        from ..utils import faultinject

        faultinject.fire("objectstorage.request")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _head_meta(self, bucket: str, key: str) -> ObjectMetadata:
        with self._request("HEAD", bucket, key) as resp:
            modified = resp.headers.get("Last-Modified", "")
            try:
                ts = email.utils.parsedate_to_datetime(modified).timestamp()
            except (TypeError, ValueError):
                ts = 0.0
            return ObjectMetadata(
                key=key,
                content_length=int(resp.headers.get("Content-Length", 0)),
                etag=resp.headers.get("ETag", "").strip('"'),
                last_modified=ts,
            )

    # -- ObjectStorageBackend protocol ---------------------------------------

    def create_bucket(self, bucket: str) -> None:
        try:
            self._request("PUT", bucket).close()
        except urllib.error.HTTPError as exc:
            # 409 BucketAlreadyOwnedByYou → idempotent success.
            if exc.code != 409:
                raise ObjectStorageError(f"create_bucket: HTTP {exc.code}") from exc

    def bucket_exists(self, bucket: str) -> bool:
        try:
            self._request("HEAD", bucket).close()
            return True
        except urllib.error.HTTPError as exc:
            if exc.code in (404, 403):
                return False
            raise

    def list_buckets(self) -> List[str]:
        """Service-level list (GET /): ListAllMyBucketsResult names —
        ONE request path and ONE parser for both protocols (the signers
        get bucket="" and canonicalize the bare "/")."""
        try:
            with self._request("GET", "") as resp:
                return _parse_bucket_names(resp.read())
        except urllib.error.HTTPError as exc:
            raise ObjectStorageError(f"list_buckets: HTTP {exc.code}") from exc

    def delete_bucket(self, bucket: str) -> None:
        """DestroyBucket (handlers/bucket.go); deleting a ghost is
        idempotent."""
        try:
            self._request("DELETE", bucket).close()
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise ObjectStorageError(
                    f"delete_bucket: HTTP {exc.code}"
                ) from exc

    def put_object(self, bucket: str, key: str, data: bytes) -> ObjectMetadata:
        try:
            with self._request("PUT", bucket, key, payload=data) as resp:
                etag = resp.headers.get("ETag", "").strip('"')
        except urllib.error.HTTPError as exc:
            raise ObjectStorageError(f"put_object {key}: HTTP {exc.code}") from exc
        return ObjectMetadata(
            key=key, content_length=len(data),
            etag=etag or hashlib.md5(data).hexdigest(),
            last_modified=time.time(),
        )

    def get_object(self, bucket: str, key: str) -> bytes:
        try:
            with self._request("GET", bucket, key) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise KeyError(f"{bucket}/{key}") from exc
            raise ObjectStorageError(f"get_object {key}: HTTP {exc.code}") from exc

    def head_object(self, bucket: str, key: str) -> ObjectMetadata:
        try:
            return self._head_meta(bucket, key)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise KeyError(f"{bucket}/{key}") from exc
            raise ObjectStorageError(f"head_object {key}: HTTP {exc.code}") from exc

    def object_exists(self, bucket: str, key: str) -> bool:
        try:
            self.head_object(bucket, key)
            return True
        except KeyError:
            return False

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            self._request("DELETE", bucket, key).close()
        except urllib.error.HTTPError as exc:
            if exc.code != 404:  # deleting a ghost is idempotent
                raise ObjectStorageError(f"delete_object {key}: HTTP {exc.code}") from exc

    def copy_object(self, bucket: str, src: str, dst: str) -> ObjectMetadata:
        # Server-side copy via the copy-source header both protocols use.
        try:
            self._request(
                "PUT", bucket, dst,
                extra_headers={
                    self._copy_header: f"/{bucket}/{src.strip('/')}"
                },
            ).close()
        except urllib.error.HTTPError as exc:
            raise ObjectStorageError(f"copy_object: HTTP {exc.code}") from exc
        return self.head_object(bucket, dst)

    def list_objects(self, bucket: str, prefix: str = "") -> List[ObjectMetadata]:
        query = "list-type=2"
        if prefix:
            query += "&prefix=" + urllib.parse.quote(prefix, safe="~")
        try:
            with self._request("GET", bucket, query=query) as resp:
                return _parse_list_xml(resp.read())
        except urllib.error.HTTPError as exc:
            raise ObjectStorageError(f"list_objects: HTTP {exc.code}") from exc


class S3Backend(_HTTPBackendBase):
    """SigV4-signed path-style S3 (AWS / MinIO / Ceph RGW / any clone)."""

    _copy_header = "x-amz-copy-source"

    def __init__(
        self,
        endpoint: str,
        *,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        timeout: float = 30.0,
    ) -> None:
        super().__init__(endpoint, timeout=timeout)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _sign(
        self, method: str, url: str, headers: dict, payload: bytes,
        bucket: str, key: str,
    ) -> dict:
        parsed = urllib.parse.urlsplit(url)
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        payload_sha = hashlib.sha256(payload).hexdigest()
        signed = dict(headers)
        signed["host"] = parsed.netloc
        signed["x-amz-date"] = amz_date
        signed["x-amz-content-sha256"] = payload_sha
        signed["Authorization"] = sigv4.sign_request(
            method, url, signed,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, service="s3", amz_date=amz_date,
            payload_sha256=payload_sha,
        )
        # urllib sets Host itself; it was only needed for the signature.
        signed.pop("host")
        return signed


class OSSBackend(_HTTPBackendBase):
    """Aliyun OSS header-signature backend (public HMAC-SHA1 scheme:
    sign(VERB\\nContent-MD5\\nContent-Type\\nDate\\nCanonicalizedOSSHeaders
    CanonicalizedResource)).  The vendor specifics live in three class
    attributes so OBS (same scheme, different namespace) is attribute
    overrides, not a second copy of the signing flow."""

    _copy_header = "x-oss-copy-source"
    _header_prefix = "x-oss-"
    _auth_label = "OSS"

    def __init__(
        self,
        endpoint: str,
        *,
        access_key: str,
        secret_key: str,
        timeout: float = 30.0,
    ) -> None:
        super().__init__(endpoint, timeout=timeout)
        self.access_key = access_key
        self.secret_key = secret_key

    def _sign(
        self, method: str, url: str, headers: dict, payload: bytes,
        bucket: str, key: str,
    ) -> dict:
        # ONE canonicalization implementation: delegate to the oss://
        # source client's signer (source/oss.py sign_oss) — it signs the
        # raw /{bucket}/{key} resource, which is the scheme real OSS
        # verifies (not the percent-encoded request path).
        from ..source.oss import sign_oss

        date = email.utils.formatdate(usegmt=True)
        signed = dict(headers)
        signed["Date"] = date
        sig = sign_oss(
            self.secret_key, method.upper(), date=date,
            bucket=bucket, key=key.strip("/"),
            content_type=signed.get("Content-Type", ""),
            oss_headers=signed,
            # Service-level requests (list buckets) sign the bare "/".
            resource=None if bucket else "/",
            header_prefix=self._header_prefix,
        )
        signed["Authorization"] = f"{self._auth_label} {self.access_key}:{sig}"
        return signed



class OBSBackend(OSSBackend):
    """Huawei Cloud OBS header-signature backend.  OBS's public auth is
    the SAME HMAC-SHA1 canonical scheme as OSS with the ``x-obs-``
    header namespace and an ``OBS`` authorization prefix — so this IS
    the OSS backend re-parameterized: three attribute overrides, one
    shared signing flow (source/oss.py sign_oss; reference dispatch
    parity: objectstorage.go:179-212 handles s3/oss/obs)."""

    _copy_header = "x-obs-copy-source"
    _header_prefix = "x-obs-"
    _auth_label = "OBS"


def make_backend(kind: str, **kwargs):
    """Config-selected backend (objectstorage.go:179-212 New dispatch):
    kind ∈ {"fs", "s3", "oss", "obs"}."""
    from .backend import FilesystemBackend

    if kind in ("fs", "filesystem"):
        return FilesystemBackend(kwargs["root"])
    if kind == "s3":
        return S3Backend(
            kwargs["endpoint"], access_key=kwargs.get("access_key", ""),
            secret_key=kwargs.get("secret_key", ""),
            region=kwargs.get("region", "us-east-1"),
        )
    if kind == "oss":
        return OSSBackend(
            kwargs["endpoint"], access_key=kwargs.get("access_key", ""),
            secret_key=kwargs.get("secret_key", ""),
        )
    if kind == "obs":
        return OBSBackend(
            kwargs["endpoint"], access_key=kwargs.get("access_key", ""),
            secret_key=kwargs.get("secret_key", ""),
        )
    raise ValueError(f"unknown object-storage backend {kind!r}")
