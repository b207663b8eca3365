"""Backend interface + filesystem implementation.

Operations mirror the reference's ObjectStorage iface
(pkg/objectstorage/objectstorage.go:179-212): bucket CRUD, object
get/put/delete/head/copy/list, and download URLs are replaced by direct
reads (the gateway streams instead of redirecting).

Port of ``dragonfly2_tpu/objectstorage/backend.py``, verbatim.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol


@dataclass
class ObjectMetadata:
    key: str
    content_length: int
    etag: str
    last_modified: float


class ObjectStorageBackend(Protocol):
    def create_bucket(self, bucket: str) -> None: ...
    def bucket_exists(self, bucket: str) -> bool: ...
    def list_buckets(self) -> List[str]: ...
    def delete_bucket(self, bucket: str) -> None: ...
    def put_object(self, bucket: str, key: str, data: bytes) -> ObjectMetadata: ...
    def get_object(self, bucket: str, key: str) -> bytes: ...
    def head_object(self, bucket: str, key: str) -> ObjectMetadata: ...
    def delete_object(self, bucket: str, key: str) -> None: ...
    def copy_object(self, bucket: str, src: str, dst: str) -> ObjectMetadata: ...
    def list_objects(self, bucket: str, prefix: str = "") -> List[ObjectMetadata]: ...
    def object_exists(self, bucket: str, key: str) -> bool: ...


class FilesystemBackend:
    """Buckets as directories, objects as files (fixture + on-prem backend)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._mu = threading.Lock()

    def _bucket_dir(self, bucket: str) -> str:
        # Empty names are rejected HERE, not just at the REST boundary:
        # os.path.join(root, "") is the root itself, so delete_bucket("")
        # would rmtree the whole store.
        if not bucket or "/" in bucket or bucket in (".", ".."):
            raise ValueError(f"invalid bucket {bucket!r}")
        return os.path.join(self.root, bucket)

    def _path(self, bucket: str, key: str) -> str:
        safe = key.strip("/")
        if not safe or safe == ".":
            # Would resolve to the bucket directory itself.
            raise ValueError(f"invalid object key {key!r}")
        if ".." in safe.split("/"):
            raise ValueError(f"invalid key {key!r}")
        return os.path.join(self._bucket_dir(bucket), safe)

    def create_bucket(self, bucket: str) -> None:
        os.makedirs(self._bucket_dir(bucket), exist_ok=True)

    def bucket_exists(self, bucket: str) -> bool:
        return os.path.isdir(self._bucket_dir(bucket))

    def list_buckets(self) -> List[str]:
        try:
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            )
        except FileNotFoundError:
            return []

    def delete_bucket(self, bucket: str) -> None:
        """Destroy the bucket (handlers/bucket.go DestroyBucket — the
        reference deletes regardless of contents).  Only a MISSING bucket
        is ignored (idempotency); a failed deletion must surface, not
        return success while the bucket still lists."""
        import shutil

        try:
            shutil.rmtree(self._bucket_dir(bucket))
        except FileNotFoundError:
            pass

    def put_object(self, bucket: str, key: str, data: bytes) -> ObjectMetadata:
        if not self.bucket_exists(bucket):
            raise KeyError(f"bucket {bucket} not found")
        path = self._path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return self.head_object(bucket, key)

    def get_object(self, bucket: str, key: str) -> bytes:
        try:
            with open(self._path(bucket, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(f"{bucket}/{key} not found") from None

    def head_object(self, bucket: str, key: str) -> ObjectMetadata:
        path = self._path(bucket, key)
        try:
            st = os.stat(path)
        except FileNotFoundError:
            raise KeyError(f"{bucket}/{key} not found") from None
        with open(path, "rb") as f:
            etag = hashlib.md5(f.read()).hexdigest()
        return ObjectMetadata(
            key=key, content_length=st.st_size, etag=etag, last_modified=st.st_mtime
        )

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            os.remove(self._path(bucket, key))
        except FileNotFoundError:
            pass

    def copy_object(self, bucket: str, src: str, dst: str) -> ObjectMetadata:
        data = self.get_object(bucket, src)
        return self.put_object(bucket, dst, data)

    def list_objects(self, bucket: str, prefix: str = "") -> List[ObjectMetadata]:
        bdir = self._bucket_dir(bucket)
        out: List[ObjectMetadata] = []
        for dirpath, _, files in os.walk(bdir):
            for name in files:
                path = os.path.join(dirpath, name)
                key = os.path.relpath(path, bdir)
                if key.startswith(prefix):
                    out.append(self.head_object(bucket, key))
        return sorted(out, key=lambda m: m.key)

    def object_exists(self, bucket: str, key: str) -> bool:
        return os.path.exists(self._path(bucket, key))


class ObjectStorageRegistry:
    """name → backend (the reference's multi-vendor switch)."""

    def __init__(self) -> None:
        self._backends: Dict[str, ObjectStorageBackend] = {}

    def register(self, name: str, backend: ObjectStorageBackend) -> None:
        self._backends[name] = backend

    def get(self, name: str) -> ObjectStorageBackend:
        if name not in self._backends:
            raise KeyError(f"no object-storage backend {name!r}")
        return self._backends[name]


def default_backends(fs_root: Optional[str] = None) -> ObjectStorageRegistry:
    reg = ObjectStorageRegistry()
    if fs_root:
        reg.register("fs", FilesystemBackend(fs_root))
    return reg
