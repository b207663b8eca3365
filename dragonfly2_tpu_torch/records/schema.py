"""Training-record schemas (reference: scheduler/storage/types.go).

Field-for-field parity with the reference's record types so the training
data carries the same signal:

- ``Download``        — one finished (or failed) peer download, with the
                        task, the child host's full machine stats, and up to
                        MAX_PARENTS parents each with up to MAX_PIECES piece
                        cost samples (types.go:189-221, Parent :143-173,
                        Piece :131-138, Host :59-126).
- ``NetworkTopologyRecord`` — one probe-graph snapshot row: a source host and
                        up to MAX_DEST_HOSTS destinations with EMA RTT
                        (types.go:285-297, SrcHost/DestHost :240-283).

Timestamps are nanoseconds since epoch (the reference stores nanosecond
int64s).  Records serialize to/from plain dicts (JSONL storage) and to
fixed-width feature rows (columnar ingest — see features.py).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, List, get_args, get_origin

from ..utils.hostinfo import BuildInfo, CPUStat, DiskStat, MemoryStat, NetworkStat

# Array caps from the reference's csv[] tags (types.go:168 pieces=10,
# :215 parents=20, :295 destHosts=5). Fixed caps are what make the records
# convertible to static-shape tensors.
MAX_PIECES_PER_PARENT = 10
MAX_PARENTS_PER_DOWNLOAD = 20
MAX_DEST_HOSTS = 5


def now_ns() -> int:
    return time.time_ns()


@dataclass
class TaskRecord:
    id: str = ""
    url: str = ""
    type: str = ""
    content_length: int = -1
    total_piece_count: int = 0
    back_to_source_limit: int = 0
    back_to_source_peer_count: int = 0
    state: str = ""
    created_at: int = 0
    updated_at: int = 0


@dataclass
class HostRecord:
    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPUStat = field(default_factory=CPUStat)
    memory: MemoryStat = field(default_factory=MemoryStat)
    network: NetworkStat = field(default_factory=NetworkStat)
    disk: DiskStat = field(default_factory=DiskStat)
    build: BuildInfo = field(default_factory=BuildInfo)
    scheduler_cluster_id: int = 0
    created_at: int = 0
    updated_at: int = 0


@dataclass
class Piece:
    length: int = 0
    cost: int = 0  # nanoseconds
    created_at: int = 0


@dataclass
class Parent:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    cost: int = 0  # task download duration, nanoseconds
    upload_piece_count: int = 0
    finished_piece_count: int = 0
    host: HostRecord = field(default_factory=HostRecord)
    pieces: List[Piece] = field(default_factory=list)
    created_at: int = 0
    updated_at: int = 0

    def observed_bandwidth(self) -> float:
        """Bytes/sec actually achieved from this parent (the training target)."""
        total_bytes = sum(p.length for p in self.pieces)
        total_ns = sum(p.cost for p in self.pieces)
        if total_ns <= 0:
            return 0.0
        return total_bytes / (total_ns / 1e9)


@dataclass
class DownloadError:
    code: str = ""
    message: str = ""


@dataclass
class Download:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    error: DownloadError = field(default_factory=DownloadError)
    cost: int = 0  # nanoseconds
    finished_piece_count: int = 0
    task: TaskRecord = field(default_factory=TaskRecord)
    host: HostRecord = field(default_factory=HostRecord)
    parents: List[Parent] = field(default_factory=list)
    created_at: int = 0
    updated_at: int = 0


@dataclass
class ProbeStats:
    average_rtt: int = 0  # nanoseconds (EMA — see networktopology store)
    created_at: int = 0
    updated_at: int = 0


@dataclass
class TopoHost:
    """Source/destination host in a topology snapshot (types.go SrcHost/DestHost)."""

    id: str = ""
    type: str = "normal"
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: NetworkStat = field(default_factory=NetworkStat)
    probes: ProbeStats = field(default_factory=ProbeStats)


@dataclass
class NetworkTopologyRecord:
    id: str = ""
    host: TopoHost = field(default_factory=TopoHost)
    dest_hosts: List[TopoHost] = field(default_factory=list)
    created_at: int = 0


# ---------------------------------------------------------------------------
# dict <-> dataclass (JSONL storage codec)
# ---------------------------------------------------------------------------


def to_dict(record: Any) -> dict:
    return dataclasses.asdict(record)


def _build(cls: type, data: Any) -> Any:
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            val = data[f.name]
            ftype = f.type if not isinstance(f.type, str) else _resolve(f.name, cls)
            kwargs[f.name] = _convert(ftype, val)
        return cls(**kwargs)
    return data


def _resolve(field_name: str, cls: type) -> type:
    import typing

    hints = typing.get_type_hints(cls)
    return hints[field_name]


def _convert(ftype: Any, val: Any) -> Any:
    origin = get_origin(ftype)
    if origin in (list, List):
        (inner,) = get_args(ftype)
        return [_convert(inner, v) for v in val]
    if dataclasses.is_dataclass(ftype):
        return _build(ftype, val)
    return val


def from_dict(cls: type, data: dict) -> Any:
    return _build(cls, data)
