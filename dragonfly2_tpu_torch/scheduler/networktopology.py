"""Network-topology probe store + snapshotter (reference: scheduler/networktopology/).

Port of ``dragonfly2_tpu/scheduler/networktopology.py``, logic verbatim,
with one difference: ``find_probed_hosts`` draws its candidates from an
explicit ``random.Random`` (``NetworkTopology(rng=...)``), as the port's
``HostManager.load_random_hosts`` takes one.  The simulator and the CLI
hand it the generator ``Scheduling.rng`` uses, so one seeded stream drives
candidate sampling and probe-target choice, in the order the reference's
process-global ``random`` does.

The reference keeps the probe graph in Redis (adjacency hashes
``networktopology:<src>:<dst>``, capped probe lists, probed-count keys) with
a read-through TTL cache.  Here the store is an embedded, thread-safe
in-process KV with identical semantics — the scheduler is the only writer
in both designs, and dropping the Redis round-trips removes the hot-path
latency — plus a **columnar export** (src/dst/rtt arrays) that feeds the
GNN trainer directly.

Semantics preserved:
- per-edge probe queue capped at ``queue_length`` (probes.go:145-222),
  oldest dropped on overflow;
- moving-average RTT recomputed over the queue on enqueue with weight 0.1
  on the running average: ``avg = 0.1*avg + 0.9*rtt`` folded left-to-right
  (probes.go:38-39, :188-197) — heavily favoring fresh probes;
- per-destination probed-count incremented on enqueue (probes.go:216-219);
- ``find_probed_hosts``: sample 50 random hosts, return the
  ``probe_count`` least-probed (network_topology.go:47-48, :190-256);
- ``snapshot``: serialize the whole graph into NetworkTopologyRecord rows
  (capped dest hosts per record) written to record storage
  (network_topology.go:386-497).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..records import schema
from .resource import Host, HostManager

MOVING_AVERAGE_WEIGHT = 0.1  # probes.go defaultMovingAverageWeight
FIND_PROBED_CANDIDATE_HOSTS_LIMIT = 50  # network_topology.go:47-48
DEFAULT_PROBE_QUEUE_LENGTH = 5  # config/constants.go:112-115
DEFAULT_PROBE_COUNT = 5


@dataclass
class Probe:
    """One ICMP probe result (probes.go Probe)."""

    host_id: str  # destination host
    rtt_ns: int
    created_at: float = field(default_factory=time.time)


class _Edge:
    __slots__ = ("probes", "average_rtt_ns", "created_at", "updated_at")

    def __init__(self, queue_length: int) -> None:
        self.probes: Deque[Probe] = deque(maxlen=queue_length)
        self.average_rtt_ns: Optional[int] = None
        self.created_at = time.time()
        self.updated_at = self.created_at


@dataclass
class TopologyConfig:
    probe_queue_length: int = DEFAULT_PROBE_QUEUE_LENGTH
    probe_count: int = DEFAULT_PROBE_COUNT
    collect_interval: float = 2 * 3600.0  # snapshot cadence


class NetworkTopology:
    """The probe-graph store (network_topology.go NetworkTopology iface :55-88)."""

    def __init__(
        self,
        host_manager: Optional[HostManager] = None,
        config: Optional[TopologyConfig] = None,
        *,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.config = config or TopologyConfig()
        self._host_manager = host_manager
        self.rng = rng if rng is not None else random.Random()
        self._mu = threading.RLock()
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._probed_count: Dict[str, int] = {}

    # -- writes -------------------------------------------------------------

    def store(self, src_host_id: str, dest_host_id: str) -> None:
        """Ensure the edge exists (network_topology.go:172-186 Store)."""
        with self._mu:
            key = (src_host_id, dest_host_id)
            if key not in self._edges:
                self._edges[key] = _Edge(self.config.probe_queue_length)

    def enqueue_probe(self, src_host_id: str, dest_host_id: str, probe: Probe) -> None:
        """probes.go:145-222 Enqueue: capped queue + EMA + probed count."""
        with self._mu:
            key = (src_host_id, dest_host_id)
            edge = self._edges.get(key)
            if edge is None:
                edge = _Edge(self.config.probe_queue_length)
                self._edges[key] = edge
            edge.probes.append(probe)  # deque(maxlen) drops the oldest
            avg: Optional[float] = None
            for p in edge.probes:
                if avg is None:
                    avg = float(p.rtt_ns)
                else:
                    avg = avg * MOVING_AVERAGE_WEIGHT + p.rtt_ns * (1 - MOVING_AVERAGE_WEIGHT)
            edge.average_rtt_ns = int(avg) if avg is not None else None
            edge.updated_at = probe.created_at
            self._probed_count[dest_host_id] = self._probed_count.get(dest_host_id, 0) + 1

    def delete_host(self, host_id: str) -> None:
        """Drop all edges touching the host (network_topology.go DeleteHost)."""
        with self._mu:
            self._edges = {
                k: v for k, v in self._edges.items() if host_id not in k
            }
            self._probed_count.pop(host_id, None)

    # -- reads --------------------------------------------------------------

    def has(self, src_host_id: str, dest_host_id: str) -> bool:
        with self._mu:
            return (src_host_id, dest_host_id) in self._edges

    def average_rtt(self, src_host_id: str, dest_host_id: str) -> Optional[int]:
        with self._mu:
            edge = self._edges.get((src_host_id, dest_host_id))
            return edge.average_rtt_ns if edge else None

    def probes(self, src_host_id: str, dest_host_id: str) -> List[Probe]:
        with self._mu:
            edge = self._edges.get((src_host_id, dest_host_id))
            return list(edge.probes) if edge else []

    def probed_count(self, host_id: str) -> int:
        with self._mu:
            return self._probed_count.get(host_id, 0)

    def neighbours(self, src_host_id: str) -> List[str]:
        with self._mu:
            return [dst for (src, dst) in self._edges if src == src_host_id]

    def edge_count(self) -> int:
        with self._mu:
            return len(self._edges)

    def find_probed_hosts(self, host_id: str) -> List[Host]:
        """Least-probed of 50 random candidates (network_topology.go:190-256)."""
        if self._host_manager is None:
            return []
        candidates = self._host_manager.load_random_hosts(
            FIND_PROBED_CANDIDATE_HOSTS_LIMIT, self.rng, blocklist={host_id}
        )
        if not candidates:
            return []
        if len(candidates) <= self.config.probe_count:
            return candidates
        with self._mu:
            counts = {h.id: self._probed_count.get(h.id, 0) for h in candidates}
            # First selection initializes the count (network_topology.go:228-234).
            for h in candidates:
                self._probed_count.setdefault(h.id, 0)
        candidates.sort(key=lambda h: counts[h.id])
        return candidates[: self.config.probe_count]

    # -- snapshot / export --------------------------------------------------

    def snapshot(self, max_dest_hosts: int = schema.MAX_DEST_HOSTS) -> List[schema.NetworkTopologyRecord]:
        """Whole-graph serialization to records (network_topology.go:386-497).

        Host metadata comes from the host manager when available; edges to
        unknown hosts still snapshot with bare IDs so no signal is lost.
        """
        with self._mu:
            by_src: Dict[str, List[Tuple[str, _Edge]]] = {}
            for (src, dst), edge in self._edges.items():
                if edge.average_rtt_ns is None:
                    continue
                by_src.setdefault(src, []).append((dst, edge))

        def topo_host(host_id: str, edge: Optional[_Edge] = None) -> schema.TopoHost:
            host = self._host_manager.load(host_id) if self._host_manager else None
            th = schema.TopoHost(id=host_id)
            if host is not None:
                th.type = host.type.name_str
                th.hostname = host.hostname
                th.ip = host.ip
                th.port = host.port
                th.network = host.stats.network
            if edge is not None:
                th.probes = schema.ProbeStats(
                    average_rtt=edge.average_rtt_ns or 0,
                    created_at=int(edge.created_at * 1e9),
                    updated_at=int(edge.updated_at * 1e9),
                )
            return th

        now = time.time_ns()
        records: List[schema.NetworkTopologyRecord] = []
        for src, dests in by_src.items():
            for i in range(0, len(dests), max_dest_hosts):
                chunk = dests[i : i + max_dest_hosts]
                records.append(
                    schema.NetworkTopologyRecord(
                        id=f"networktopology-{src[:16]}-{now}-{i}",
                        host=topo_host(src),
                        dest_hosts=[topo_host(d, e) for d, e in chunk],
                        created_at=now,
                    )
                )
        return records

    # -- durability + cross-replica sharing (the Redis analog) ---------------
    #
    # The reference's probe graph lives in Redis (network_topology.go:55-88,
    # pkg/redis): it survives scheduler restarts and is readable by every
    # replica.  Here durability is a JSON state file per scheduler
    # (save/load below) and sharing rides the manager: each scheduler
    # pushes its edge summaries and pulls the other replicas' (the JAX
    # package's scheduler/topology_sync.py, ported as this package's),
    # merged newest-wins into the live store.

    def export_state(self) -> dict:
        """Full-fidelity state (probe queues + counts) for save/load."""
        with self._mu:
            return {
                "edges": [
                    {
                        "src": src, "dst": dst,
                        "average_rtt_ns": e.average_rtt_ns,
                        "created_at": e.created_at,
                        "updated_at": e.updated_at,
                        "probes": [
                            {"host_id": p.host_id, "rtt_ns": p.rtt_ns,
                             "created_at": p.created_at}
                            for p in e.probes
                        ],
                    }
                    for (src, dst), e in self._edges.items()
                ],
                "probed_count": dict(self._probed_count),
            }

    def import_state(self, state: dict) -> int:
        """Restore a saved state (restart reload); returns edges loaded."""
        edges = state.get("edges", [])
        with self._mu:
            for rec in edges:
                edge = _Edge(self.config.probe_queue_length)
                for p in rec.get("probes", []):
                    edge.probes.append(Probe(
                        host_id=p["host_id"], rtt_ns=int(p["rtt_ns"]),
                        created_at=float(p.get("created_at", 0.0)),
                    ))
                edge.average_rtt_ns = rec.get("average_rtt_ns")
                edge.created_at = float(rec.get("created_at", time.time()))
                edge.updated_at = float(rec.get("updated_at", edge.created_at))
                self._edges[(rec["src"], rec["dst"])] = edge
            for host_id, count in state.get("probed_count", {}).items():
                self._probed_count[host_id] = max(
                    self._probed_count.get(host_id, 0), int(count)
                )
        return len(edges)

    def save(self, path: str) -> None:
        # Per-writer tmp name: even if two savers ever coexist, each
        # os.replace installs a COMPLETE document (no interleaved writes).
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.export_state(), f)
        os.replace(tmp, path)

    def load(self, path: str) -> int:
        """Reload a persisted probe graph; 0 when absent/corrupt — a bad
        state file must degrade to an empty graph, never a boot crash."""
        try:
            with open(path) as f:
                state = json.load(f)
            return self.import_state(state)
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            return 0

    def export_edges(self) -> List[dict]:
        """Edge summaries for cross-replica sharing (no probe queues —
        replicas need the averaged signal, not the raw samples)."""
        with self._mu:
            return [
                {
                    "src": src, "dst": dst,
                    "average_rtt_ns": e.average_rtt_ns,
                    "updated_at": e.updated_at,
                }
                for (src, dst), e in self._edges.items()
                if e.average_rtt_ns is not None
            ]

    def merge_remote_edges(self, edges: List[dict]) -> int:
        """Adopt another replica's edge summaries, newest-wins; local
        probe queues and probed counts stay untouched (remote knowledge
        must not skew THIS scheduler's probe-target selection).  Returns
        the number of edges adopted."""
        adopted = 0
        with self._mu:
            for rec in edges:
                avg = rec.get("average_rtt_ns")
                src, dst = rec.get("src"), rec.get("dst")
                # Skip malformed records — one bad replica's push must not
                # kill sharing for the whole cluster.
                if avg is None or not src or not dst:
                    continue
                key = (src, dst)
                updated = float(rec.get("updated_at", 0.0))
                edge = self._edges.get(key)
                if edge is None:
                    edge = _Edge(self.config.probe_queue_length)
                    self._edges[key] = edge
                elif edge.updated_at >= updated:
                    continue  # local knowledge is fresher
                edge.average_rtt_ns = int(avg)
                edge.updated_at = updated
                adopted += 1
        return adopted

    def to_edge_arrays(self) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
        """Columnar export for the GNN: (host_ids, src_idx, dst_idx, rtt_ns).

        This replaces the reference's CSV snapshot → trainer path: the
        probe graph leaves the scheduler already in
        index/array form, ready for static-shape batching.
        """
        with self._mu:
            edges = [
                (src, dst, e.average_rtt_ns)
                for (src, dst), e in self._edges.items()
                if e.average_rtt_ns is not None
            ]
        ids: Dict[str, int] = {}
        for src, dst, _ in edges:
            for h in (src, dst):
                if h not in ids:
                    ids[h] = len(ids)
        src_idx = np.array([ids[s] for s, _, _ in edges], dtype=np.int32)
        dst_idx = np.array([ids[d] for _, d, _ in edges], dtype=np.int32)
        rtt = np.array([r for _, _, r in edges], dtype=np.float32)
        return list(ids.keys()), src_idx, dst_idx, rtt


class ProbeAgent:
    """Daemon-side probe loop (reference: client/daemon/networktopology/).

    The reference daemon syncs with the scheduler over a ``SyncProbes``
    stream, pings the returned candidates with ICMP in parallel, and
    reports RTTs (network_topology.go:72-210).  In-process, the agent asks
    the store for candidates and reports simulated/measured RTTs via a
    pluggable ping function — the e2e swarm simulator injects ground-truth
    RTT; a real deployment injects pkg/net/ping-style ICMP.
    """

    def __init__(
        self,
        host: Host,
        topology: NetworkTopology,
        ping,  # Callable[[Host], Optional[int]] → rtt_ns or None on timeout
    ) -> None:
        self.host = host
        self.topology = topology
        self._ping = ping

    def sync_probes(self) -> int:
        """One probe round; returns the number of successful probes."""
        targets = self.topology.find_probed_hosts(self.host.id)
        ok = 0
        for target in targets:
            rtt_ns = self._ping(target)
            if rtt_ns is None:
                continue
            self.topology.store(self.host.id, target.id)
            self.topology.enqueue_probe(
                self.host.id, target.id, Probe(host_id=target.id, rtt_ns=int(rtt_ns))
            )
            ok += 1
        return ok
