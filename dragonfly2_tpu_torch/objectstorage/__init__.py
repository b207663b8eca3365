"""Object storage backends (reference: pkg/objectstorage/).

One interface (objectstorage.go:179-212) over pluggable backends,
matching the reference's S3/OSS/OBS dispatch: the filesystem backend is
built in (the e2e fixtures use it), and ``S3Backend``/``OSSBackend``
(s3.py) speak signed path-style HTTP to any compatible endpoint —
selected by config via ``make_backend``.

Port of ``dragonfly2_tpu/objectstorage/__init__.py``, verbatim.
"""

from .backend import (  # noqa: F401
    FilesystemBackend,
    ObjectMetadata,
    ObjectStorageBackend,
    ObjectStorageRegistry,
    default_backends,
)
from .s3 import (  # noqa: F401
    ObjectStorageError,
    OBSBackend,
    OSSBackend,
    S3Backend,
    make_backend,
)
