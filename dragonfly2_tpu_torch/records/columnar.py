"""Fixed-width columnar record files (DFC1) — the trainer's ingest format.

Port of ``dragonfly2_tpu/records/columnar.py``, numpy logic verbatim: the
same bytes on disk, so a file written by either package reads in the
other.  Every record is featurized at write time into a fixed-width
float32 row (features.py), and files are raw row-major matrices with a
small JSON header:

    [4B magic "DFC1"][4B little-endian header length][header JSON][rows...]

- Append is O(row) with no serialization beyond ``ndarray.tobytes``.
- Read is zero-copy ``np.memmap``: the input pipeline slices batches
  straight out of the page cache.
- Fixed width: every batch has the same shape.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from . import abi_contracts as _abi

# Shared with the native record engine (native.cpp kMagic) through the
# ABI registry.
MAGIC = _abi.constant("kMagic").encode("ascii")
_LEN_FMT = "<I"


@dataclass(frozen=True)
class ColumnarHeader:
    columns: tuple
    dtype: str = "float32"
    created_at_ns: int = 0

    @property
    def row_nbytes(self) -> int:
        return np.dtype(self.dtype).itemsize * len(self.columns)


def _encode_header(header: ColumnarHeader) -> bytes:
    # sort_keys pins canonical header bytes (DF019): equal headers must
    # serialize identically regardless of dict hash order.
    payload = json.dumps(
        {
            "columns": list(header.columns),
            "dtype": header.dtype,
            "created_at_ns": header.created_at_ns,
        },
        sort_keys=True,
    ).encode("utf-8")
    return MAGIC + struct.pack(_LEN_FMT, len(payload)) + payload


def _header_from_meta(meta: dict) -> ColumnarHeader:
    """ONE place that maps the header's JSON meta onto ColumnarHeader —
    the file reader and the streaming decoder must agree on defaults."""
    return ColumnarHeader(
        columns=tuple(meta["columns"]),
        dtype=meta.get("dtype", "float32"),
        created_at_ns=meta.get("created_at_ns", 0),
    )


def read_header(path: str) -> tuple[ColumnarHeader, int]:
    """Returns (header, data_offset).  Every malformed-prefix shape —
    short magic, short length word, a header cut off mid-JSON, corrupt
    JSON — raises ValueError (never struct/json errors or silent
    garbage): callers distinguish exactly 'bad file' from IO errors."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        raw_len = f.read(4)
        if len(raw_len) < 4:
            raise ValueError(f"{path}: truncated header length")
        (hlen,) = struct.unpack(_LEN_FMT, raw_len)
        raw = f.read(hlen)
        if len(raw) < hlen:
            raise ValueError(
                f"{path}: truncated header ({len(raw)} of {hlen} bytes)"
            )
        try:
            meta = json.loads(raw.decode("utf-8"))
            header = _header_from_meta(meta)
        except (UnicodeDecodeError, json.JSONDecodeError, KeyError, TypeError) as exc:
            raise ValueError(f"{path}: corrupt header: {exc}") from exc
    return header, 8 + hlen


class ColumnarWriter:
    """Append-only writer. Safe for a single writer; readers may mmap live files
    (rows are only visible once fully flushed, tracked by file size)."""

    def __init__(self, path: str, columns: Sequence[str], dtype: str = "float32"):
        self.path = path
        self.header = ColumnarHeader(columns=tuple(columns), dtype=dtype)
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            existing, self._data_offset = read_header(path)
            if existing.columns != self.header.columns:
                raise ValueError(
                    f"{path}: existing columns {existing.columns} != {self.header.columns}"
                )
            self.header = existing
            self._f = open(path, "ab")
        else:
            self._f = open(path, "wb")
            raw = _encode_header(self.header)
            self._f.write(raw)
            self._data_offset = len(raw)
        self._width = len(self.header.columns)
        self._np_dtype = np.dtype(self.header.dtype)

    def append(self, rows: np.ndarray) -> int:
        """Append a [n, ncols] (or [ncols]) array; returns rows written."""
        rows = np.ascontiguousarray(rows, dtype=self._np_dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[-1] != self._width:
            raise ValueError(f"row width {rows.shape[-1]} != {self._width}")
        self._f.write(rows.tobytes())
        return rows.shape[0]

    def flush(self) -> None:
        self._f.flush()

    def tell_rows(self) -> int:
        return (self._f.tell() - self._data_offset) // (
            self._np_dtype.itemsize * self._width
        )

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "ColumnarWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamingRowDecoder:
    """Incremental DFC1 decode over a byte stream.

    The mmap reader needs a whole file; the ONLINE ingest path
    (trainer/service feeding an online sink straight off the ``Train``
    stream, service_v1.go:128-143 semantics) gets arbitrary
    chunk boundaries mid-flight.  ``feed(data)`` buffers, parses the
    header once, and returns every COMPLETE row received so far; the
    partial tail stays buffered for the next chunk.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self.header: ColumnarHeader | None = None
        self.rows_decoded = 0

    def feed(self, data: bytes) -> np.ndarray:
        """Returns the complete rows in ``data`` (+ any buffered tail) as
        a READ-ONLY view where possible — bytearray churn on 100 MB
        chunks cost seconds per chunk (measured), so the bulk of every
        chunk decodes as a zero-copy view even when chunk boundaries
        never align with rows (fixed-size chunkers realign every chunk:
        only the split row is assembled from the buffer, never the
        whole chunk)."""
        width_zero = (0, 0)
        if self.header is None:
            self._buf += data
            if len(self._buf) < 8:
                return np.zeros(width_zero, np.float32)
            if bytes(self._buf[:4]) != MAGIC:
                raise ValueError(f"bad magic {bytes(self._buf[:4])!r}")
            (hlen,) = struct.unpack(_LEN_FMT, self._buf[4:8])
            if len(self._buf) < 8 + hlen:
                return np.zeros(width_zero, np.float32)
            meta = json.loads(bytes(self._buf[8 : 8 + hlen]).decode("utf-8"))
            self.header = _header_from_meta(meta)
            data = bytes(self._buf[8 + hlen :])
            self._buf = bytearray()

        rb = self.header.row_nbytes
        width = len(self.header.columns)
        first = None
        if self._buf:
            # Complete ONLY the split row from the new chunk (tiny copy);
            # the remainder stays eligible for the zero-copy view.
            need = rb - len(self._buf)
            if len(data) < need:
                self._buf += data
                return np.zeros((0, width), np.float32)
            self._buf += data[:need]
            first = np.frombuffer(
                bytes(self._buf), dtype=self.header.dtype
            ).reshape(1, width)
            self._buf = bytearray()
            data = memoryview(data)[need:]
        n = len(data) // rb
        tail = len(data) - n * rb
        if tail:
            self._buf += data[n * rb :]
        if n == 0:
            rows = np.zeros((0, width), np.float32) if first is None else first
        else:
            rows = np.frombuffer(
                memoryview(data)[: n * rb], dtype=self.header.dtype
            ).reshape(n, width)
            if first is not None:
                rows = np.concatenate([first, rows], axis=0)
        self.rows_decoded += len(rows)
        return rows


class ColumnarReader:
    """Zero-copy mmap reader over one columnar file."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._data_offset = read_header(path)
        self._np_dtype = np.dtype(self.header.dtype)
        self._width = len(self.header.columns)
        size = os.path.getsize(path) - self._data_offset
        self.num_rows = size // (self._np_dtype.itemsize * self._width)
        if self.num_rows > 0:
            self._mm = np.memmap(
                path,
                dtype=self._np_dtype,
                mode="r",
                offset=self._data_offset,
                shape=(self.num_rows, self._width),
            )
        else:
            self._mm = np.empty((0, self._width), dtype=self._np_dtype)

    @property
    def columns(self) -> tuple:
        return self.header.columns

    def __len__(self) -> int:
        return self.num_rows

    def __getitem__(self, idx) -> np.ndarray:
        return self._mm[idx]

    def to_array(self) -> np.ndarray:
        return np.asarray(self._mm)

    def batches(self, batch_size: int, drop_remainder: bool = False) -> Iterator[np.ndarray]:
        n = self.num_rows
        for start in range(0, n, batch_size):
            end = start + batch_size
            if end > n and drop_remainder:
                return
            yield np.asarray(self._mm[start:end])


def concat_readers(paths: Sequence[str]) -> np.ndarray:
    """Materialize multiple shards into one array (small datasets / tests)."""
    readers = [ColumnarReader(p) for p in paths if os.path.getsize(p) > 0]
    if not readers:
        raise ValueError("no non-empty shards")
    cols = readers[0].columns
    for r in readers[1:]:
        if r.columns != cols:
            raise ValueError(f"{r.path}: column mismatch")
    return np.concatenate([r.to_array() for r in readers], axis=0)
