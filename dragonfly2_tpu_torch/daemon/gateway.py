"""Object-storage gateway: S3-ish operations onto P2P + backend store.

Reference: client/daemon/objectstorage (the daemon's S3/OSS-compatible
HTTP gateway, objectstorage.go:86-103) + client/dfstore semantics
(dfstore.go:54-111 — Get/Put/Copy/Delete/IsExist + metadata through the
daemon).

Reads go P2P-first: the object's task id keys the swarm, so a hot object
is served by peers and the backend sees one fetch per cluster.  Writes
land in the backend and seed the local piece store so this daemon is the
swarm's first parent.

Port of ``dragonfly2_tpu/daemon/gateway.py``, verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..objectstorage import ObjectMetadata, ObjectStorageBackend
from ..utils import idgen
from ..utils.httprange import RangeNotSatisfiable, parse_range


@dataclass
class GatewayConfig:
    bucket: str = "dragonfly"
    piece_size: int = 4 << 20


class ObjectGateway:
    def __init__(self, daemon, backend: ObjectStorageBackend, config: Optional[GatewayConfig] = None):
        self.daemon = daemon
        self.backend = backend
        self.config = config or GatewayConfig()
        if not backend.bucket_exists(self.config.bucket):
            backend.create_bucket(self.config.bucket)

    def _object_url(self, key: str) -> str:
        return f"dfstore://{self.config.bucket}/{key.strip('/')}"

    def _task_id(self, key: str) -> str:
        return idgen.task_id(self._object_url(key))

    # -- dfstore ops ---------------------------------------------------------

    def put_object(self, key: str, data: bytes) -> ObjectMetadata:
        meta = self.backend.put_object(self.config.bucket, key, data)
        # Seed the P2P swarm: write the pieces locally AND register with the
        # scheduler as a succeeded peer, so this daemon is handed out as the
        # first parent (the reference's seed-peer trigger path,
        # scheduler/resource/seed_peer.go TriggerTask).
        url = self._object_url(key)
        ps = self.config.piece_size
        n_pieces = max((len(data) + ps - 1) // ps, 1)
        task_id = self._task_id(key)
        self.daemon.storage.register_task(
            task_id, piece_size=ps, content_length=len(data)
        )
        for n in range(n_pieces):
            self.daemon.storage.write_piece(task_id, n, data[n * ps : (n + 1) * ps])

        scheduler = self.daemon.scheduler
        reg = scheduler.register_peer(host=self.daemon.host, url=url, task_id=task_id)
        scheduler.set_task_info(reg.peer, len(data), n_pieces, ps)
        for n in range(n_pieces):
            scheduler.report_piece_finished(
                reg.peer,
                n,
                parent_id="",
                length=min(ps, len(data) - n * ps),
                cost_ns=1,
            )
        scheduler.report_peer_finished(reg.peer)

        if self.daemon.pex is not None:
            self.daemon.pex.advertise(task_id, set(range(n_pieces)))
        return meta

    def get_object(self, key: str) -> bytes:
        """P2P first (other daemons may hold it); backend fallback."""
        try:
            return b"".join(self.get_object_stream(key))
        except (IOError, OSError, KeyError):
            # P2P completely failed → straight backend read.
            return self.backend.get_object(self.config.bucket, key)

    def get_object_stream(self, key: str, *, start: int = 0,
                          length: Optional[int] = None):
        """Streaming read (StartStreamTask consumer): chunks flow from
        the commit tee as the P2P download commits pieces — a hot object
        starts serving before the swarm transfer finishes, with no disk
        round-trip on the fast path.  ``start``/``length`` serve a byte
        window over the in-flight task (the overlapping pieces schedule
        first).  Raises on P2P failure; ``get_object`` adds the backend
        fallback for byte-level callers."""
        return self._open_stream(key, start=start, length=length).chunks()

    def _open_stream(self, key: str, *, start: int = 0,
                     length: Optional[int] = None):
        url = self._object_url(key)
        meta = (
            self.backend.head_object(self.config.bucket, key)
            if self.backend.object_exists(self.config.bucket, key)
            else None
        )
        content_length = meta.content_length if meta else None
        return self.daemon.open_stream(
            url,
            piece_size=self.config.piece_size,
            content_length=content_length,
            start=start,
            length=length,
        )

    def get_object_range(
        self, key: str, range_header: Optional[str]
    ) -> Tuple[Tuple[int, int, int], Iterator[bytes]]:
        """RFC-7233 ranged read over the (possibly in-flight) task:
        ``Range`` header → ``((start, end_inclusive, total), chunks)``.
        A missing/ignorable header serves the full body (start=0,
        end=total-1 — the caller answers 200 instead of 206); an
        unsatisfiable range raises :class:`RangeNotSatisfiable` (416)
        WITHOUT touching the swarm when the backend knows the length."""
        meta = (
            self.backend.head_object(self.config.bucket, key)
            if self.backend.object_exists(self.config.bucket, key)
            else None
        )
        if meta is not None:
            total = meta.content_length
            rng = parse_range(range_header, total)  # may raise 416
            start, length = (
                (rng[0], rng[1] - rng[0] + 1) if rng else (0, None)
            )
            handle = self._open_stream(key, start=start, length=length)
        else:
            # P2P-only object: the stream's own sizing is the total.
            handle = self._open_stream(key)
            total = handle.content_length
            try:
                rng = parse_range(range_header, total)
            except RangeNotSatisfiable:
                handle.close()
                raise
            if rng is not None:
                handle.narrow(rng[0], rng[1] + 1)
        span = rng if rng is not None else (0, max(total - 1, 0))
        return (span[0], span[1], total), handle.chunks()

    def head_object(self, key: str) -> ObjectMetadata:
        return self.backend.head_object(self.config.bucket, key)

    def object_exists(self, key: str) -> bool:
        return self.backend.object_exists(self.config.bucket, key)

    def delete_object(self, key: str) -> None:
        self.backend.delete_object(self.config.bucket, key)
        task_id = self._task_id(key)
        if hasattr(self.daemon, "delete_task"):
            self.daemon.delete_task(task_id)

    def copy_object(self, src: str, dst: str) -> ObjectMetadata:
        return self.backend.copy_object(self.config.bucket, src, dst)

    def list_objects(self, prefix: str = "") -> List[ObjectMetadata]:
        return self.backend.list_objects(self.config.bucket, prefix)


class GatewaySourceFetcher:
    """Back-to-source client for dfstore:// URLs: pieces come from the
    object backend (registered into the daemon's source chain so P2P
    misses fall back to the store, reference's object gateway semantics)."""

    def __init__(self, backend: ObjectStorageBackend):
        self.backend = backend

    def fetch(self, url: str, number: int, piece_size: int) -> bytes:
        assert url.startswith("dfstore://"), url
        bucket, key = url[len("dfstore://") :].split("/", 1)
        data = self.backend.get_object(bucket, key)
        return data[number * piece_size : (number + 1) * piece_size]
