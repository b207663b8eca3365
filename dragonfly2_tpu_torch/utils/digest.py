"""Content digests (reference: pkg/digest/digest.go).

Digest strings are ``<algorithm>:<hex>`` (e.g. ``sha256:ab12...``); helpers
hash strings, bytes, and file-like readers.
"""

from __future__ import annotations

import hashlib
from typing import BinaryIO, Iterable

ALGORITHM_SHA256 = "sha256"
ALGORITHM_SHA512 = "sha512"
ALGORITHM_MD5 = "md5"

_ALGOS = {
    ALGORITHM_SHA256: hashlib.sha256,
    ALGORITHM_SHA512: hashlib.sha512,
    ALGORITHM_MD5: hashlib.md5,
}


def sha256_from_strings(*parts: str) -> str:
    """Hex sha256 over newline-joined parts (reference: pkg/digest SHA256FromStrings)."""
    h = hashlib.sha256()
    for i, p in enumerate(parts):
        if i:
            h.update(b"\n")
        h.update(p.encode("utf-8"))
    return h.hexdigest()


def sha256_from_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def new(algorithm: str, encoded: str) -> str:
    if algorithm not in _ALGOS:
        raise ValueError(f"unknown digest algorithm {algorithm!r}")
    return f"{algorithm}:{encoded}"


def parse(value: str) -> tuple[str, str]:
    """Split ``algo:hex`` and validate the algorithm and hex length."""
    algorithm, sep, encoded = value.partition(":")
    if not sep or algorithm not in _ALGOS:
        raise ValueError(f"invalid digest {value!r}")
    want = _ALGOS[algorithm]().digest_size * 2
    if len(encoded) != want:
        raise ValueError(f"invalid {algorithm} digest length {len(encoded)} != {want}")
    return algorithm, encoded


def hash_reader(algorithm: str, reader: BinaryIO, chunk_size: int = 1 << 20) -> str:
    h = _ALGOS[algorithm]()
    while True:
        chunk = reader.read(chunk_size)
        if not chunk:
            break
        h.update(chunk)
    return new(algorithm, h.hexdigest())


def hash_chunks(algorithm: str, chunks: Iterable[bytes]) -> str:
    h = _ALGOS[algorithm]()
    for chunk in chunks:
        h.update(chunk)
    return new(algorithm, h.hexdigest())
