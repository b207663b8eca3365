"""Reference-CSV compatibility codec (scheduler/storage/types.go +
gocsv MarshalWithoutHeaders).

Port of ``dragonfly2_tpu/records/csv_compat.py``, verbatim: the same CSV
text and the same DFC1 bytes from the same records in both packages.

The reference persists training records as HEADERLESS positional CSV:
struct fields flattened in declaration order, slice fields padded to
fixed caps (pieces=10 types.go:169, parents=20 :218, destHosts=5 :293).
A Download row is exactly 1934 columns, a NetworkTopology row 71 —
verified against trainer/storage/testdata/*.csv.

This module reads/writes that exact layout so a reference deployment's
accumulated datasets (or a reference trainer expecting CSV) interoperate
with this framework's records.  Two schema divergences are adapted at
the boundary:

- reference CPUTimes carries ``guestNice`` (our CPUTimes stops at
  ``guest``) → written as 0, ignored on read;
- our NetworkStat appends download/upload rate fields the reference
  lacks → only the reference's four columns cross the CSV boundary.
"""

from __future__ import annotations

import csv
import io
from typing import Iterable, List

from ..utils.hostinfo import BuildInfo, CPUStat, CPUTimes, DiskStat, MemoryStat, NetworkStat
from .schema import (
    Download,
    DownloadError,
    HostRecord,
    NetworkTopologyRecord,
    Parent,
    Piece,
    ProbeStats,
    TaskRecord,
    TopoHost,
)

_PAD = "__pad__"  # reference-only column: write zero value, skip on read

# Spec grammar: a list of entries, each one of
#   (field_name, type)                    scalar (str | int | float)
#   (field_name, [spec])                  nested dataclass
#   (field_name, [spec], count, factory)  fixed-cap list of dataclasses
_TIMES = [(n, float) for n in (
    "user", "system", "idle", "nice", "iowait", "irq", "softirq", "steal",
    "guest",
)] + [(_PAD, float)]  # guestNice (host.go:267)

_CPU = [
    ("logical_count", int), ("physical_count", int),
    ("percent", float), ("process_percent", float),
    ("times", _TIMES),
]

_MEMORY = [
    ("total", int), ("available", int), ("used", int),
    ("used_percent", float), ("process_used_percent", float), ("free", int),
]

# Reference Network (host.go:294-303) has exactly these four.
_NETWORK = [
    ("tcp_connection_count", int), ("upload_tcp_connection_count", int),
    ("location", str), ("idc", str),
]

_DISK = [
    ("total", int), ("free", int), ("used", int), ("used_percent", float),
    ("inodes_total", int), ("inodes_used", int), ("inodes_free", int),
    ("inodes_used_percent", float),
]

_BUILD = [
    ("git_version", str), ("git_commit", str), ("go_version", str),
    ("platform", str),
]

_HOST = [
    ("id", str), ("type", str), ("hostname", str), ("ip", str),
    ("port", int), ("download_port", int), ("os", str), ("platform", str),
    ("platform_family", str), ("platform_version", str),
    ("kernel_version", str), ("concurrent_upload_limit", int),
    ("concurrent_upload_count", int), ("upload_count", int),
    ("upload_failed_count", int),
    ("cpu", _CPU), ("memory", _MEMORY), ("network", _NETWORK),
    ("disk", _DISK), ("build", _BUILD),
    ("scheduler_cluster_id", int), ("created_at", int), ("updated_at", int),
]

_TASK = [
    ("id", str), ("url", str), ("type", str), ("content_length", int),
    ("total_piece_count", int), ("back_to_source_limit", int),
    ("back_to_source_peer_count", int), ("state", str),
    ("created_at", int), ("updated_at", int),
]

_PIECE = [("length", int), ("cost", int), ("created_at", int)]

_PARENT = [
    ("id", str), ("tag", str), ("application", str), ("state", str),
    ("cost", int), ("upload_piece_count", int), ("finished_piece_count", int),
    ("host", _HOST), ("pieces", _PIECE, 10, Piece),
    ("created_at", int), ("updated_at", int),
]

_DOWNLOAD = [
    ("id", str), ("tag", str), ("application", str), ("state", str),
    ("error", [("code", str), ("message", str)]),
    ("cost", int), ("finished_piece_count", int),
    ("task", _TASK), ("host", _HOST),
    ("parents", _PARENT, 20, Parent),
    ("created_at", int), ("updated_at", int),
]

_PROBES = [("average_rtt", int), ("created_at", int), ("updated_at", int)]

_SRC_HOST = [
    ("id", str), ("type", str), ("hostname", str), ("ip", str),
    ("port", int), ("network", _NETWORK),
]

_DEST_HOST = _SRC_HOST + [("probes", _PROBES)]

_NETWORK_TOPOLOGY = [
    ("id", str), ("host", _SRC_HOST),
    ("dest_hosts", _DEST_HOST, 5, TopoHost),
    ("created_at", int),
]

# Nested dataclass factories for read-side construction, keyed by the
# spec object identity.
_FACTORIES = {
    id(_TIMES): CPUTimes, id(_CPU): CPUStat, id(_MEMORY): MemoryStat,
    id(_NETWORK): NetworkStat, id(_DISK): DiskStat, id(_BUILD): BuildInfo,
    id(_HOST): HostRecord, id(_TASK): TaskRecord, id(_PIECE): Piece,
    id(_PARENT): Parent, id(_DOWNLOAD): Download, id(_PROBES): ProbeStats,
    id(_SRC_HOST): TopoHost, id(_DEST_HOST): TopoHost,
    id(_NETWORK_TOPOLOGY): NetworkTopologyRecord,
    id(_DOWNLOAD[4][1]): DownloadError,
}


def _spec_width(spec) -> int:
    width = 0
    for entry in spec:
        if len(entry) == 4:
            _, sub, count, _ = entry
            width += _spec_width(sub) * count
        elif isinstance(entry[1], list):
            width += _spec_width(entry[1])
        else:
            width += 1
    return width

DOWNLOAD_COLUMNS_TOTAL = _spec_width(_DOWNLOAD)            # 1934
NETWORK_TOPOLOGY_COLUMNS_TOTAL = _spec_width(_NETWORK_TOPOLOGY)  # 71
assert DOWNLOAD_COLUMNS_TOTAL == 1934
assert NETWORK_TOPOLOGY_COLUMNS_TOTAL == 71


def _go_float(value: float) -> str:
    """Go's %v for float64: strconv.FormatFloat(v, 'g', -1, 64) —
    shortest round-trip digits; scientific form when the decimal
    exponent is < -4 or >= 6 (ftoa.go uses eprec=6 for the shortest
    path), else plain form.  So 123456.78 → "123456.78" but
    1000000 → "1e+06" and 8589934592 → "8.589934592e+09"."""
    import math

    v = float(value)
    if v == 0.0:
        return "0"
    if not math.isfinite(v):  # Go fmt: +Inf / -Inf / NaN
        return "NaN" if math.isnan(v) else ("+Inf" if v > 0 else "-Inf")
    # Fast path: derive the decimal exponent from repr() without Decimal
    # (this runs per float across 1934-column rows).
    s = repr(v)
    mant_str, _, exp_str = s.partition("e")
    if exp_str:
        # repr e-notation is normalized to one integer digit.
        sci_exp = int(exp_str)
    else:
        digits_str = mant_str.lstrip("-")
        int_part, _, frac = digits_str.partition(".")
        if int_part != "0":
            sci_exp = len(int_part) - 1
        else:
            leading_zeros = len(frac) - len(frac.lstrip("0"))
            sci_exp = -(leading_zeros + 1)
    if -4 <= sci_exp < 6:
        # Python repr is plain-form throughout this range already.
        return s[:-2] if s.endswith(".0") else s
    from decimal import Decimal

    sign, digits, _exp = Decimal(s).normalize().as_tuple()
    prefix = "-" if sign else ""
    mantissa = str(digits[0])
    if len(digits) > 1:
        mantissa += "." + "".join(map(str, digits[1:]))
    return (
        f"{prefix}{mantissa}e{'+' if sci_exp >= 0 else '-'}{abs(sci_exp):02d}"
    )


def _fmt(value, typ) -> str:
    if typ is str:
        return value or ""
    if typ is float:
        return _go_float(value)
    return str(int(value))


def _flatten_zero(spec, out: List[str]) -> None:
    """Padding slots render as GO zero values (""/0) regardless of our
    dataclass defaults — what gocsv writes for empty array slots."""
    for entry in spec:
        if len(entry) == 4:
            _, sub, count, _ = entry
            for _ in range(count):
                _flatten_zero(sub, out)
        elif isinstance(entry[1], list):
            _flatten_zero(entry[1], out)
        else:
            out.append(_fmt(entry[1](), entry[1]))


def _flatten(obj, spec, out: List[str]) -> None:
    for entry in spec:
        if len(entry) == 4:
            name, sub, count, _factory = entry
            items = list(getattr(obj, name))[:count]
            for item in items:
                _flatten(item, sub, out)
            for _ in range(count - len(items)):
                _flatten_zero(sub, out)
        elif isinstance(entry[1], list):
            name, sub = entry
            _flatten(getattr(obj, name), sub, out)
        else:
            name, typ = entry
            if name is _PAD:
                out.append(_fmt(typ(), typ))
            else:
                out.append(_fmt(getattr(obj, name), typ))


_PARSED_BLANKS = {}


def _parsed_blank(spec):
    """The record an all-empty cell run parses to — the padding shape.
    NOT the dataclass defaults: ours differ from Go zero values (e.g.
    content_length=-1, host type 'normal'), and padding written by the
    reference is Go-zero shaped."""
    blank = _PARSED_BLANKS.get(id(spec))
    if blank is None:
        blank, _ = _parse([""] * _spec_width(spec), 0, spec)
        _PARSED_BLANKS[id(spec)] = blank
    return blank


def _parse(cells, pos: int, spec):
    factory = _FACTORIES[id(spec)]
    kwargs = {}
    for entry in spec:
        if len(entry) == 4:
            name, sub, count, _item_factory = entry
            items = []
            for _ in range(count):
                item, pos = _parse(cells, pos, sub)
                items.append(item)
            # Trailing padding slots are not data.
            blank = _parsed_blank(sub)
            while items and items[-1] == blank:
                items.pop()
            kwargs[name] = items
        elif isinstance(entry[1], list):
            name, sub = entry
            kwargs[name], pos = _parse(cells, pos, sub)
        else:
            name, typ = entry
            raw = cells[pos]
            pos += 1
            if name is _PAD:
                continue
            if typ is str:
                kwargs[name] = raw
            elif typ is float:
                kwargs[name] = float(raw) if raw else 0.0
            elif not raw:
                kwargs[name] = 0
            else:
                try:
                    # Direct int parse: the float detour rounds int64s
                    # ≥ 2^53 (nanosecond timestamps) — silent corruption.
                    kwargs[name] = int(raw)
                except ValueError:
                    kwargs[name] = int(float(raw))
    return factory(**kwargs), pos


# -- public API --------------------------------------------------------------


def download_to_row(d: Download) -> List[str]:
    out: List[str] = []
    _flatten(d, _DOWNLOAD, out)
    return out


def download_from_row(cells: List[str]) -> Download:
    if len(cells) != DOWNLOAD_COLUMNS_TOTAL:
        raise ValueError(
            f"download row has {len(cells)} columns, "
            f"expected {DOWNLOAD_COLUMNS_TOTAL}"
        )
    record, _ = _parse(cells, 0, _DOWNLOAD)
    return record


def topology_to_row(t: NetworkTopologyRecord) -> List[str]:
    out: List[str] = []
    _flatten(t, _NETWORK_TOPOLOGY, out)
    return out


def topology_from_row(cells: List[str]) -> NetworkTopologyRecord:
    if len(cells) != NETWORK_TOPOLOGY_COLUMNS_TOTAL:
        raise ValueError(
            f"topology row has {len(cells)} columns, "
            f"expected {NETWORK_TOPOLOGY_COLUMNS_TOTAL}"
        )
    record, _ = _parse(cells, 0, _NETWORK_TOPOLOGY)
    return record


def write_download_csv(records: Iterable[Download], path: str) -> int:
    n = 0
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        for r in records:
            writer.writerow(download_to_row(r))
            n += 1
    return n


def read_download_csv(path: str) -> List[Download]:
    return list(iter_download_csv(path))


def write_topology_csv(records: Iterable[NetworkTopologyRecord], path: str) -> int:
    n = 0
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        for r in records:
            writer.writerow(topology_to_row(r))
            n += 1
    return n


def read_topology_csv(path: str) -> List[NetworkTopologyRecord]:
    return list(iter_topology_csv(path))


def iter_download_csv(path: str):
    """Stream Download records row by row — a multi-GB reference dataset
    must never be materialized as a list of deep dataclasses."""
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if row:
                yield download_from_row(row)


def iter_topology_csv(path: str):
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if row:
                yield topology_from_row(row)


def convert_download_csv_to_columnar(csv_path: str, out_path: str) -> int:
    """Reference CSV dataset → this framework's columnar ingest shard
    (the migration path for a reference deployment's accumulated data).
    Streams record-by-record; returns feature rows written."""
    import numpy as np

    from .columnar import ColumnarWriter
    from .features import DOWNLOAD_COLUMNS, download_to_rows

    n = 0
    with ColumnarWriter(out_path, DOWNLOAD_COLUMNS) as w:
        for record in iter_download_csv(csv_path):
            rows = download_to_rows(record)
            if len(rows):
                w.append(np.asarray(rows, np.float32))
                n += len(rows)
    return n


def convert_topology_csv_to_columnar(csv_path: str, out_path: str) -> int:
    import numpy as np

    from .columnar import ColumnarWriter
    from .features import TOPO_COLUMNS, topology_to_rows

    n = 0
    with ColumnarWriter(out_path, TOPO_COLUMNS) as w:
        for record in iter_topology_csv(csv_path):
            rows = topology_to_rows(record)
            if len(rows):
                w.append(np.asarray(rows, np.float32))
                n += len(rows)
    return n


def parse_download_csv_bytes(data: bytes) -> List[Download]:
    return [
        download_from_row(row)
        for row in csv.reader(io.StringIO(data.decode()))
        if row
    ]


def parse_topology_csv_bytes(data: bytes) -> List[NetworkTopologyRecord]:
    return [
        topology_from_row(row)
        for row in csv.reader(io.StringIO(data.decode()))
        if row
    ]
