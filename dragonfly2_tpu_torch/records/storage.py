"""Buffered, size-rotated training-record store (reference: scheduler/storage/storage.go).

Same lifecycle as the reference's CSV store — in-memory buffer flushed at
``buffer_size`` records (storage.go:139-203), active file rotated once it
exceeds ``max_size`` with at most ``max_backups`` retained (storage.go:255+)
— but each logical record is written twice:

- ``<base>.jsonl``   full-fidelity record (audit / replay / re-featurize),
  the analog of the reference's CSV row;
- ``<base>.dfc``     featurized fixed-width float32 rows (columnar.py),
  which is what the trainer actually ingests.

``CreateDownload`` / ``CreateNetworkTopology`` mirror the reference's
Storage interface (storage.go:58-89); ``*_columnar_paths()`` etc. hand
the shard list to the trainer (``cli/trainer --train-once`` reads the
directory's ``download*.dfc`` and ``networktopology*.dfc``).

Port of ``dragonfly2_tpu/records/storage.py``, logic verbatim, with one
difference: the directory is made at the first flush, not at
construction, so a scheduler built with the default ``storage.dir``
touches no disk until it writes a record.  The DFC1 mirror is written by
the port's native C++ writer when it builds, else by ``ColumnarWriter``,
as in the reference; both write the same bytes, so either package reads
either writer's shards.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np

from . import schema
from .columnar import ColumnarWriter
from .features import DOWNLOAD_COLUMNS, TOPO_COLUMNS, download_to_rows, topology_to_rows

DOWNLOAD_BASE = "download"
NETWORK_TOPOLOGY_BASE = "networktopology"

DEFAULT_BUFFER_SIZE = 100          # records buffered before flush
DEFAULT_MAX_SIZE = 100 << 20       # bytes before rotation
DEFAULT_MAX_BACKUPS = 10


def _make_columnar_writer(path: str, columns: Sequence[str]):
    """C++ engine when buildable, Python otherwise — same DFC1 format, so
    readers never care which wrote the shard (native/src/native.cpp)."""
    from .. import native

    if native.available():
        try:
            return native.NativeColumnarWriter(path, columns)
        except native.NativeError:
            pass
    return ColumnarWriter(path, columns)


class _RotatingRecordFile:
    def __init__(
        self,
        directory: str,
        base: str,
        columns: Sequence[str],
        featurize: Callable[[object], np.ndarray],
        buffer_size: int,
        max_size: int,
        max_backups: int,
    ) -> None:
        self._dir = directory
        self._base = base
        self._columns = columns
        self._featurize = featurize
        self._buffer_size = buffer_size
        self._max_size = max_size
        self._max_backups = max_backups
        self._mu = threading.Lock()
        self._buffer: List[dict] = []
        self._count = 0

    @property
    def _jsonl_path(self) -> str:
        return os.path.join(self._dir, f"{self._base}.jsonl")

    @property
    def _dfc_path(self) -> str:
        return os.path.join(self._dir, f"{self._base}.dfc")

    def create(self, record) -> None:
        with self._mu:
            self._buffer.append(record)
            self._count += 1
            if len(self._buffer) >= self._buffer_size:
                self._flush_locked()

    def flush(self) -> None:
        with self._mu:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        records, self._buffer = self._buffer, []
        os.makedirs(self._dir, exist_ok=True)
        with open(self._jsonl_path, "a") as f:
            for r in records:
                f.write(json.dumps(schema.to_dict(r), separators=(",", ":")))
                f.write("\n")
        rows = [self._featurize(r) for r in records]
        rows = [r for r in rows if r.shape[0] > 0]
        if rows:
            with _make_columnar_writer(self._dfc_path, self._columns) as w:
                w.append(np.concatenate(rows, axis=0))
        if os.path.getsize(self._jsonl_path) >= self._max_size:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        # Shift backups: base.N -> base.N+1, drop the oldest beyond max_backups.
        for ext in (".jsonl", ".dfc"):
            oldest = os.path.join(self._dir, f"{self._base}.{self._max_backups}{ext}")
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self._max_backups - 1, 0, -1):
                src = os.path.join(self._dir, f"{self._base}.{i}{ext}")
                if os.path.exists(src):
                    os.replace(src, os.path.join(self._dir, f"{self._base}.{i + 1}{ext}"))
            active = os.path.join(self._dir, f"{self._base}{ext}")
            if os.path.exists(active):
                os.replace(active, os.path.join(self._dir, f"{self._base}.1{ext}"))

    def shard_paths(self, ext: str) -> List[str]:
        """Active + backup files, newest first."""
        paths = []
        active = os.path.join(self._dir, f"{self._base}{ext}")
        if os.path.exists(active):
            paths.append(active)
        for i in range(1, self._max_backups + 1):
            p = os.path.join(self._dir, f"{self._base}.{i}{ext}")
            if os.path.exists(p):
                paths.append(p)
        return paths

    def iter_records(self, cls: type) -> Iterator[object]:
        self.flush()
        for path in self.shard_paths(".jsonl"):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield schema.from_dict(cls, json.loads(line))

    def clear(self) -> None:
        with self._mu:
            self._buffer.clear()
            for ext in (".jsonl", ".dfc"):
                for p in self.shard_paths(ext):
                    os.remove(p)

    @property
    def count(self) -> int:
        return self._count


class Storage:
    """Scheduler-side training record store (reference Storage iface, storage.go:58-89)."""

    def __init__(
        self,
        directory: str,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
        max_size: int = DEFAULT_MAX_SIZE,
        max_backups: int = DEFAULT_MAX_BACKUPS,
    ) -> None:
        self.directory = directory
        self._download = _RotatingRecordFile(
            directory, DOWNLOAD_BASE, DOWNLOAD_COLUMNS, download_to_rows,
            buffer_size, max_size, max_backups,
        )
        self._topology = _RotatingRecordFile(
            directory, NETWORK_TOPOLOGY_BASE, TOPO_COLUMNS, topology_to_rows,
            buffer_size, max_size, max_backups,
        )

    # -- writes (hot path, called by the scheduler service) ------------------

    def create_download(self, record: schema.Download) -> None:
        self._download.create(record)

    def create_network_topology(self, record: schema.NetworkTopologyRecord) -> None:
        self._topology.create(record)

    def flush(self) -> None:
        self._download.flush()
        self._topology.flush()

    # -- reads (announcer upload + trainer local mode) -----------------------

    def list_download(self) -> List[schema.Download]:
        return list(self._download.iter_records(schema.Download))

    def list_network_topology(self) -> List[schema.NetworkTopologyRecord]:
        return list(self._topology.iter_records(schema.NetworkTopologyRecord))

    def download_columnar_paths(self) -> List[str]:
        self._download.flush()
        return self._download.shard_paths(".dfc")

    def network_topology_columnar_paths(self) -> List[str]:
        self._topology.flush()
        return self._topology.shard_paths(".dfc")

    def download_raw_paths(self) -> List[str]:
        self._download.flush()
        return self._download.shard_paths(".jsonl")

    def network_topology_raw_paths(self) -> List[str]:
        self._topology.flush()
        return self._topology.shard_paths(".jsonl")

    def clear_download(self) -> None:
        self._download.clear()

    def clear_network_topology(self) -> None:
        self._topology.clear()

    def clear(self) -> None:
        self.clear_download()
        self.clear_network_topology()

    @property
    def download_count(self) -> int:
        return self._download.count

    @property
    def network_topology_count(self) -> int:
        return self._topology.count
