"""Featurization: records → fixed-width tensors (the model's input spec).

The reference intended (but never built) this step — trainer/training's
TODOs say "preprocess dataset" (training.go:82-99).  Here it is explicit
and versioned: every Download record yields one training row per parent
edge (features of child host, parent host, and the transfer; target =
observed bandwidth), and NetworkTopology records yield probe-graph edges.

Feature engineering notes:
- Everything is float32, fixed width, no strings — rows append straight
  into columnar files and batch into static-shape device arrays.
- Counts/bytes are log1p-compressed; percentages scaled to [0,1]; the
  bandwidth target is log1p(bytes/sec) (dynamic range spans KB/s..GB/s).
- Host identity is carried as a hash bucket so the GNN can build its node
  index without string lookups on device.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np

from .schema import Download, HostRecord, NetworkTopologyRecord, Parent

# ---------------------------------------------------------------------------
# Host features
# ---------------------------------------------------------------------------

HOST_FEATURE_NAMES = (
    "cpu_percent",            # [0,1]
    "mem_used_percent",       # [0,1]
    "disk_used_percent",      # [0,1]
    "tcp_conn_log",           # log1p
    "upload_tcp_conn_log",    # log1p
    "upload_load",            # concurrent uploads / limit
    "upload_success_ratio",   # 1 - failed/total
    "upload_count_log",       # log1p
    "type_normal",
    "type_super",
    "type_strong",
    "type_weak",
)
HOST_FEATURE_DIM = len(HOST_FEATURE_NAMES)

_HOST_TYPE_INDEX = {"normal": 8, "super": 9, "strong": 10, "weak": 11}


def host_features(h: HostRecord) -> np.ndarray:
    out = np.zeros(HOST_FEATURE_DIM, dtype=np.float32)
    out[0] = min(max(h.cpu.percent / 100.0, 0.0), 1.0)
    out[1] = min(max(h.memory.used_percent / 100.0, 0.0), 1.0)
    out[2] = min(max(h.disk.used_percent / 100.0, 0.0), 1.0)
    out[3] = math.log1p(max(h.network.tcp_connection_count, 0))
    out[4] = math.log1p(max(h.network.upload_tcp_connection_count, 0))
    limit = max(h.concurrent_upload_limit, 1)
    out[5] = min(h.concurrent_upload_count / limit, 4.0)
    total = max(h.upload_count, 1)
    out[6] = 1.0 - min(h.upload_failed_count / total, 1.0)
    out[7] = math.log1p(max(h.upload_count, 0))
    idx = _HOST_TYPE_INDEX.get(h.type, 8)
    out[idx] = 1.0
    return out


@functools.lru_cache(maxsize=65536)
def _location_affinity(a: str, b: str) -> float:
    """Fraction of matching location path segments (reference scores location
    affinity by shared '|'-separated prefix, evaluator_base.go).

    lru_cache: location strings come from a small fleet-topology
    vocabulary and recur on every announce — the split-and-compare was a
    measurable slice of the serving featurize profile (BENCHMARKS.md)."""
    if not a or not b:
        return 0.0
    pa, pb = a.split("|"), b.split("|")
    n = min(len(pa), len(pb))
    match = 0
    for i in range(n):
        if pa[i] != pb[i]:
            break
        match += 1
    return match / max(len(pa), len(pb))


# ---------------------------------------------------------------------------
# Download → MLP training rows (one per parent edge)
# ---------------------------------------------------------------------------

EDGE_FEATURE_NAMES = (
    "same_idc",
    "location_affinity",
    "piece_count_log",
    "mean_piece_size_log",
    "content_length_log",
    "finished_piece_ratio",
    "parent_cost_log_s",
    "parent_upload_pieces_log",
)
EDGE_FEATURE_DIM = len(EDGE_FEATURE_NAMES)

DOWNLOAD_FEATURE_NAMES = (
    tuple(f"child_{n}" for n in HOST_FEATURE_NAMES)
    + tuple(f"parent_{n}" for n in HOST_FEATURE_NAMES)
    + EDGE_FEATURE_NAMES
)
DOWNLOAD_FEATURE_DIM = len(DOWNLOAD_FEATURE_NAMES)  # 32

# Features measured DURING/AFTER the very transfer being predicted — known
# in a completed Download record but NOT at scheduling time (the evaluator
# ranks parents before any piece moves).  The deployed scorer must train
# with these zeroed so train and serve distributions match; leaving them in
# lets the model key on the leak and collapse at serve time.
POST_HOC_FEATURE_NAMES = (
    "piece_count_log",          # pieces this parent served to this child
    "mean_piece_size_log",
    "parent_cost_log_s",        # duration of this parent's transfers
    "parent_upload_pieces_log",
)
POST_HOC_FEATURE_IDX = tuple(
    i for i, n in enumerate(DOWNLOAD_FEATURE_NAMES)
    if n in POST_HOC_FEATURE_NAMES
)


_POST_HOC_IDX_ARR = np.asarray(POST_HOC_FEATURE_IDX, dtype=np.intp)


def mask_post_hoc(features: np.ndarray) -> np.ndarray:
    """Zero the post-hoc columns of [n, DOWNLOAD_FEATURE_DIM] rows (copy)."""
    out = np.array(features, dtype=np.float32, copy=True)
    out[..., _POST_HOC_IDX_ARR] = 0.0
    return out

# Full columnar row = src hash bucket, dst hash bucket, features..., target.
DOWNLOAD_COLUMNS = ("src_bucket", "dst_bucket") + DOWNLOAD_FEATURE_NAMES + ("target_log_bw",)

NUM_HASH_BUCKETS = 1 << 20


def accumulate_host_feature_sums(
    rows: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    feat_sum: np.ndarray,
    feat_cnt: np.ndarray,
) -> None:
    """Fold download rows' host features into per-node (sum, count)
    accumulators: child features at cols [2, 2+H) credit ``dst``, parent
    features at [2+H, 2+2H) credit ``src``.  THE one implementation of
    this attribution — the batch trainer and the online wire adapter
    must agree on it.  Uses bincount, not ``np.add.at``: the fancy-index
    scatter runs at single-digit M updates/s and measurably capped the
    online wire soak (BENCHMARKS.md)."""
    n_nodes = feat_cnt.shape[0]
    child_f = rows[:, 2 : 2 + HOST_FEATURE_DIM]
    parent_f = rows[:, 2 + HOST_FEATURE_DIM : 2 + 2 * HOST_FEATURE_DIM]
    for ids, feats in ((src, parent_f), (dst, child_f)):
        feat_cnt += np.bincount(ids, minlength=n_nodes).astype(feat_cnt.dtype)
        for j in range(feats.shape[1]):
            feat_sum[:, j] += np.bincount(
                ids, weights=feats[:, j], minlength=n_nodes
            ).astype(feat_sum.dtype)


def host_bucket(host_id: str) -> int:
    """Stable hash bucket for a host id (string → int node key)."""
    import zlib

    return zlib.crc32(host_id.encode("utf-8")) % NUM_HASH_BUCKETS


def edge_features(download: Download, parent: Parent) -> np.ndarray:
    out = np.zeros(EDGE_FEATURE_DIM, dtype=np.float32)
    child, ph = download.host, parent.host
    out[0] = 1.0 if (child.network.idc and child.network.idc == ph.network.idc) else 0.0
    out[1] = _location_affinity(child.network.location, ph.network.location)
    out[2] = math.log1p(len(parent.pieces))
    total_len = sum(p.length for p in parent.pieces)
    if parent.pieces:
        out[3] = math.log1p(total_len / len(parent.pieces))
    out[4] = math.log1p(max(download.task.content_length, 0))
    total_pieces = max(download.task.total_piece_count, 1)
    out[5] = min(parent.finished_piece_count / total_pieces, 1.0)
    out[6] = math.log1p(max(parent.cost, 0) / 1e9)
    out[7] = math.log1p(max(parent.upload_piece_count, 0))
    return out


def edge_features_batch(  # dflint: hotpath
    *,
    same_idc: np.ndarray,
    location_affinity: np.ndarray,
    served_counts: np.ndarray,
    served_len_sums: np.ndarray,
    content_length: int,
    finished_piece_counts: np.ndarray,
    total_piece_count: int,
    cost_ns: np.ndarray,
    upload_piece_counts: np.ndarray,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Vectorized ``edge_features`` over n parent edges (the scheduler
    serving hot path, DESIGN.md §14).

    Inputs mirror what ``Peer.to_parent_record`` would have materialized
    per edge: ``served_counts``/``served_len_sums`` are the child's
    pieces attributed to each parent AFTER the ``MAX_PIECES_PER_PARENT``
    truncation (they feed columns 2-3), while ``upload_piece_counts`` is
    the untruncated per-parent serve count (column 7) — exactly the
    record's split.  Column-for-column byte-identical to stacking scalar
    ``edge_features`` rows (asserted in tests/test_sched_vectorized.py):
    every column runs the same float64 math and takes one float32
    rounding on assignment, like the scalar path's array fill.

    ``out`` (optional, [n, EDGE_FEATURE_DIM] float32, may be a column
    slice of a larger matrix): written in place and returned — the
    serving path lands edge features directly in its feature matrix
    instead of paying a temp + copy.  Every column is assigned.
    """
    n = len(finished_piece_counts)
    if out is None:
        out = np.empty((n, EDGE_FEATURE_DIM), dtype=np.float32)
    out[:, 0] = same_idc
    out[:, 1] = location_affinity
    # dflint: disable=DF012 pragmas below: reviewed float64 INTERMEDIATES
    # — the scalar path's math runs in float64 and each column takes one
    # float32 rounding on assignment into `out` (byte-parity contract).
    counts = np.asarray(served_counts, dtype=np.float64)  # dflint: disable=DF012
    lens = np.asarray(served_len_sums, dtype=np.float64)  # dflint: disable=DF012
    out[:, 2] = np.log1p(counts)
    out[:, 3] = np.where(
        counts > 0, np.log1p(lens / np.maximum(counts, 1.0)), 0.0
    )
    out[:, 4] = math.log1p(max(content_length, 0))
    total = max(total_piece_count, 1)
    out[:, 5] = np.minimum(
        np.asarray(finished_piece_counts, dtype=np.float64) / total, 1.0  # dflint: disable=DF012
    )
    out[:, 6] = np.log1p(
        np.maximum(np.asarray(cost_ns, dtype=np.float64), 0) / 1e9  # dflint: disable=DF012
    )
    out[:, 7] = np.log1p(
        np.maximum(np.asarray(upload_piece_counts, dtype=np.float64), 0)  # dflint: disable=DF012
    )
    return out


def target_log_bandwidth(parent: Parent) -> Optional[float]:
    bw = parent.observed_bandwidth()
    if bw <= 0.0:
        return None
    return math.log1p(bw)


def download_to_rows(download: Download) -> np.ndarray:
    """[n_parents_with_signal, len(DOWNLOAD_COLUMNS)] float32 rows."""
    child_f = host_features(download.host)
    child_b = float(host_bucket(download.host.id))
    rows: List[np.ndarray] = []
    for parent in download.parents:
        target = target_log_bandwidth(parent)
        if target is None:
            continue
        row = np.concatenate(
            [
                np.array([host_bucket(parent.host.id), child_b], dtype=np.float32),
                child_f,
                host_features(parent.host),
                edge_features(download, parent),
                np.array([target], dtype=np.float32),
            ]
        )
        rows.append(row)
    if not rows:
        return np.zeros((0, len(DOWNLOAD_COLUMNS)), dtype=np.float32)
    return np.stack(rows)


def unlog_bandwidth(y: np.ndarray) -> np.ndarray:
    return np.expm1(y)


# ---------------------------------------------------------------------------
# NetworkTopology → probe-edge rows
# ---------------------------------------------------------------------------

TOPO_COLUMNS = (
    "src_bucket",
    "dst_bucket",
    "avg_rtt_norm",      # EMA RTT / 1s ping timeout, clipped to [0,1]
    "src_tcp_conn_log",
    "dst_tcp_conn_log",
    "same_idc",
    "location_affinity",
    "freshness",         # exp(-age_hours)
)

PING_TIMEOUT_NS = 1_000_000_000  # 1s normalization, evaluator_network_topology.go:53-56


def topology_to_rows(record: NetworkTopologyRecord, now_ns: Optional[int] = None) -> np.ndarray:
    import time as _time

    if now_ns is None:
        now_ns = _time.time_ns()
    src = record.host
    src_b = float(host_bucket(src.id))
    src_conn = math.log1p(max(src.network.tcp_connection_count, 0))
    rows: List[np.ndarray] = []
    for dst in record.dest_hosts:
        rtt = min(max(dst.probes.average_rtt, 0) / PING_TIMEOUT_NS, 1.0)
        age_h = max(now_ns - dst.probes.updated_at, 0) / 3.6e12
        rows.append(
            np.array(
                [
                    src_b,
                    float(host_bucket(dst.id)),
                    rtt,
                    src_conn,
                    math.log1p(max(dst.network.tcp_connection_count, 0)),
                    1.0 if (src.network.idc and src.network.idc == dst.network.idc) else 0.0,
                    _location_affinity(src.network.location, dst.network.location),
                    math.exp(-age_h),
                ],
                dtype=np.float32,
            )
        )
    if not rows:
        return np.zeros((0, len(TOPO_COLUMNS)), dtype=np.float32)
    return np.stack(rows)
