"""Synthetic cluster with ground-truth bandwidth.

Port of ``dragonfly2_tpu/records/synthetic.py``, numpy logic verbatim.  A
latent cluster model whose per-edge bandwidth is a deterministic function
of latent host capacities, load and topology plus noise, so training can
be verified (MAE falls) and measured at any scale.

Two paths:
- record-level: full Download / NetworkTopologyRecord dataclasses, for
  end-to-end tests (the trainer service's shards);
- vectorized: numpy row batches in DOWNLOAD_COLUMNS layout, and the host
  feature matrix and probe graph the graph trainers take.

Every draw happens in the JAX package's order, so one seed gives the same
cluster, records, rows, probe edges and noise in both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..utils import idgen
from ..utils.hostinfo import CPUStat, DiskStat, MemoryStat, NetworkStat
from .schema import (
    Download,
    HostRecord,
    NetworkTopologyRecord,
    Parent,
    Piece,
    ProbeStats,
    TaskRecord,
    TopoHost,
    now_ns,
)

IDC_NAMES = ("idc-a", "idc-b", "idc-c", "idc-d")
REGIONS = ("region-1", "region-2")
PIECE_SIZE = 4 << 20  # 4 MiB default piece size (reference daemon default)


@dataclass
class LatentHost:
    index: int
    id: str
    hostname: str
    ip: str
    type: str            # normal | super | strong | weak
    idc: int
    region: int
    zone: int
    up_capacity: float   # bytes/sec
    down_capacity: float
    cpu_load: float      # [0,1]
    mem_load: float
    disk_load: float
    tcp_conns: int
    upload_conns: int
    concurrent_uploads: int
    upload_limit: int
    upload_count: int
    upload_failed: int

    @property
    def location(self) -> str:
        return f"{REGIONS[self.region]}|zone-{self.zone}|rack-{self.index % 8}"

    @property
    def idc_name(self) -> str:
        return IDC_NAMES[self.idc]


class SyntheticCluster:
    """A latent cluster whose edge bandwidth is ground truth.

    bandwidth(parent→child) =
        min(parent_up / (1 + a·uploads), child_down)
        · idc/region affinity factor · cpu-load factor · lognormal noise
    rtt(src→dst) = base(region, idc, zone) + load jitter.
    """

    def __init__(self, num_hosts: int = 64, seed: int = 0, seed_peer_fraction: float = 0.06):
        self.rng = np.random.default_rng(seed)
        self.num_hosts = num_hosts
        r = self.rng
        n = num_hosts
        self.idc = r.integers(0, len(IDC_NAMES), n)
        self.region = r.integers(0, len(REGIONS), n)
        self.zone = r.integers(0, 4, n)
        # capacities: lognormal around 60 MB/s up, 120 MB/s down; seeds beefier
        self.up_cap = np.exp(r.normal(math.log(60e6), 0.7, n))
        self.down_cap = np.exp(r.normal(math.log(120e6), 0.5, n))
        is_seed = r.random(n) < seed_peer_fraction
        self.host_type = np.where(is_seed, 1, 0)  # 1 => super seed
        self.up_cap[is_seed] *= 4.0
        self.cpu_load = np.clip(r.beta(2, 5, n), 0, 1)
        self.mem_load = np.clip(r.beta(2, 4, n), 0, 1)
        self.disk_load = np.clip(r.beta(2, 6, n), 0, 1)
        self.tcp_conns = r.integers(4, 400, n)
        self.upload_conns = r.integers(0, 60, n)
        self.upload_limit = np.full(n, 50)
        self.concurrent_uploads = r.integers(0, 30, n)
        self.upload_count = r.integers(10, 5000, n)
        self.upload_failed = (self.upload_count * np.clip(r.beta(1, 12, n), 0, 1)).astype(np.int64)
        self.hosts: List[LatentHost] = [self._make_host(i) for i in range(n)]

    def _make_host(self, i: int) -> LatentHost:
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        hostname = f"host-{i}"
        htype = "super" if self.host_type[i] == 1 else "normal"
        # Identity never changes across drift() rebuilds — cache the hash
        # (drift replay at soak scale would otherwise re-hash 100k ids
        # per epoch).
        if not hasattr(self, "_host_id_cache"):
            self._host_id_cache = {}
        hid = self._host_id_cache.get(i)
        if hid is None:
            hid = idgen.host_id_v2(ip, hostname, seed_peer=htype != "normal")
            self._host_id_cache[i] = hid
        return LatentHost(
            index=i,
            id=hid,
            hostname=hostname,
            ip=ip,
            type=htype,
            idc=int(self.idc[i]),
            region=int(self.region[i]),
            zone=int(self.zone[i]),
            up_capacity=float(self.up_cap[i]),
            down_capacity=float(self.down_cap[i]),
            cpu_load=float(self.cpu_load[i]),
            mem_load=float(self.mem_load[i]),
            disk_load=float(self.disk_load[i]),
            tcp_conns=int(self.tcp_conns[i]),
            upload_conns=int(self.upload_conns[i]),
            concurrent_uploads=int(self.concurrent_uploads[i]),
            upload_limit=int(self.upload_limit[i]),
            upload_count=int(self.upload_count[i]),
            upload_failed=int(self.upload_failed[i]),
        )

    # -- ground truth --------------------------------------------------------

    def bandwidth(self, parent: int, child: int, noise: bool = True) -> float:
        return float(self._bandwidth_vec(np.array([parent]), np.array([child]), noise)[0])

    def _bandwidth_vec(
        self,
        parent: np.ndarray,
        child: np.ndarray,
        noise: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """``rng`` overrides the cluster's SHARED generator for the
        measurement noise — position-deterministic streams (the 1B soak's
        resumable ingest) must not depend on how many draws happened
        before; the noise model itself (σ=0.12 lognormal, 1 KB/s floor
        AFTER noise) lives only here."""
        up = self.up_cap[parent] / (1.0 + 0.15 * self.concurrent_uploads[parent])
        eff = np.minimum(up, self.down_cap[child])
        same_idc = self.idc[parent] == self.idc[child]
        same_region = self.region[parent] == self.region[child]
        factor = np.where(same_idc, 1.0, np.where(same_region, 0.55, 0.25))
        cpu_factor = 1.0 - 0.5 * self.cpu_load[parent] ** 2
        bw = eff * factor * cpu_factor
        if noise:
            bw = bw * np.exp((rng or self.rng).normal(0.0, 0.12, bw.shape))
        return np.maximum(bw, 1e3)

    def rtt_ns(self, src: int, dst: int, noise: bool = True) -> float:
        return float(self._rtt_vec(np.array([src]), np.array([dst]), noise)[0])

    def _rtt_vec(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        noise: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """``rng`` overrides the shared generator for the jitter, like
        ``_bandwidth_vec`` — position-deterministic topology streams (the
        online soak's resumable probe feed) need it."""
        base = np.where(
            self.idc[src] == self.idc[dst],
            0.3e6,  # 0.3 ms intra-idc
            np.where(self.region[src] == self.region[dst], 2e6, 30e6),
        ).astype(np.float64)
        base = base * (1.0 + (self.zone[src] != self.zone[dst]) * 0.5)
        base = base + 0.5e6 * self.cpu_load[dst]
        if noise:
            base = base * np.exp((rng or self.rng).normal(0.0, 0.08, base.shape))
        return base

    # -- record-level generation --------------------------------------------

    def host_record(self, i: int, now: Optional[int] = None) -> HostRecord:
        h = self.hosts[i]
        now = now or now_ns()
        return HostRecord(
            id=h.id,
            type=h.type,
            hostname=h.hostname,
            ip=h.ip,
            port=8002,
            download_port=8001,
            os="linux",
            platform="linux",
            concurrent_upload_limit=h.upload_limit,
            concurrent_upload_count=h.concurrent_uploads,
            upload_count=h.upload_count,
            upload_failed_count=h.upload_failed,
            cpu=CPUStat(logical_count=16, percent=h.cpu_load * 100.0),
            memory=MemoryStat(total=64 << 30, used_percent=h.mem_load * 100.0),
            network=NetworkStat(
                tcp_connection_count=h.tcp_conns,
                upload_tcp_connection_count=h.upload_conns,
                location=h.location,
                idc=h.idc_name,
            ),
            disk=DiskStat(total=1 << 40, used_percent=h.disk_load * 100.0),
            created_at=now,
            updated_at=now,
        )

    def generate_download(self, rng: Optional[np.random.Generator] = None) -> Download:
        r = rng or self.rng
        child = int(r.integers(0, self.num_hosts))
        n_parents = int(r.integers(1, 5))
        parents_idx = r.choice(self.num_hosts, size=n_parents, replace=False)
        parents_idx = parents_idx[parents_idx != child]
        content_length = int(np.exp(r.normal(math.log(256e6), 1.0)))
        total_pieces = max(1, content_length // PIECE_SIZE)
        now = now_ns()
        task = TaskRecord(
            id=idgen.task_id(f"https://example.com/blob/{int(r.integers(0, 1 << 30))}"),
            url="https://example.com/blob",
            type="standard",
            content_length=content_length,
            total_piece_count=int(total_pieces),
            back_to_source_limit=3,
            state="Succeeded",
            created_at=now,
            updated_at=now,
        )
        parents: List[Parent] = []
        for p in parents_idx:
            p = int(p)
            bw = self.bandwidth(p, child)
            n_pieces = int(min(r.integers(1, 11), total_pieces))
            pieces = []
            for _ in range(n_pieces):
                length = int(min(PIECE_SIZE, content_length))
                cost_ns = int(length / bw * 1e9 * float(np.exp(r.normal(0, 0.05))))
                pieces.append(Piece(length=length, cost=max(cost_ns, 1000), created_at=now))
            total_cost = sum(pc.cost for pc in pieces)
            parents.append(
                Parent(
                    id=idgen.peer_id(self.hosts[p].ip, self.hosts[p].hostname),
                    state="Succeeded",
                    cost=total_cost,
                    upload_piece_count=n_pieces,
                    finished_piece_count=n_pieces,
                    host=self.host_record(p, now),
                    pieces=pieces,
                    created_at=now,
                    updated_at=now,
                )
            )
        total_cost = max((p.cost for p in parents), default=0)
        return Download(
            id=idgen.peer_id(self.hosts[child].ip, self.hosts[child].hostname),
            state="Succeeded",
            cost=total_cost,
            finished_piece_count=sum(p.finished_piece_count for p in parents),
            task=task,
            host=self.host_record(child, now),
            parents=parents,
            created_at=now,
            updated_at=now,
        )

    def generate_downloads(self, n: int) -> List[Download]:
        return [self.generate_download() for _ in range(n)]

    def topo_host(self, i: int, avg_rtt: int = 0, now: Optional[int] = None) -> TopoHost:
        h = self.hosts[i]
        now = now or now_ns()
        return TopoHost(
            id=h.id,
            type=h.type,
            hostname=h.hostname,
            ip=h.ip,
            port=8002,
            network=NetworkStat(
                tcp_connection_count=h.tcp_conns,
                upload_tcp_connection_count=h.upload_conns,
                location=h.location,
                idc=h.idc_name,
            ),
            probes=ProbeStats(average_rtt=avg_rtt, created_at=now, updated_at=now),
        )

    def generate_topology_record(self, src: Optional[int] = None) -> NetworkTopologyRecord:
        r = self.rng
        if src is None:
            src = int(r.integers(0, self.num_hosts))
        n_dst = int(min(5, self.num_hosts - 1))
        dsts = r.choice(self.num_hosts, size=n_dst + 1, replace=False)
        dsts = [int(d) for d in dsts if int(d) != src][:n_dst]
        now = now_ns()
        return NetworkTopologyRecord(
            id=f"networktopology-{src}-{int(r.integers(0, 1 << 30))}",
            host=self.topo_host(src, now=now),
            dest_hosts=[self.topo_host(d, avg_rtt=int(self.rtt_ns(src, d)), now=now) for d in dsts],
            created_at=now,
        )

    def generate_topology_records(self, n: int) -> List[NetworkTopologyRecord]:
        return [self.generate_topology_record() for _ in range(n)]

    def drift(self, rng: np.random.Generator) -> None:
        """Evolve the cluster's LOAD state in place (the online-trainer
        story, BASELINE configs[5]): concurrent uploads churn, CPU/mem
        load random-walks, upload tallies grow.  Ground-truth bandwidth
        and RTT both depend on these, so after a drift the topology a
        model was trained on is STALE — the mid-training snapshot
        refresh exists to chase exactly this.  Capacities and placement
        (idc/region/zone) stay fixed: machines don't move racks.

        Takes an explicit rng so a position-seeded caller (the resumable
        1B soak) replays the identical drift sequence.
        """
        n = self.num_hosts
        self.concurrent_uploads = np.clip(
            self.concurrent_uploads + rng.integers(-6, 7, n), 0, 60
        )
        self.cpu_load = np.clip(
            self.cpu_load + rng.normal(0.0, 0.12, n), 0.0, 1.0
        )
        self.mem_load = np.clip(
            self.mem_load + rng.normal(0.0, 0.08, n), 0.0, 1.0
        )
        grown = rng.integers(0, 50, n)
        self.upload_count = self.upload_count + grown
        self.upload_failed = self.upload_failed + (
            grown * np.clip(rng.beta(1, 12, n), 0, 1)
        ).astype(np.int64)
        self.upload_conns = np.clip(
            self.upload_conns + rng.integers(-4, 5, n), 0, 120
        )
        # Record-level views (host_record / hosts[i]) must see the same
        # drifted state as the vectorized path.
        self.hosts = [self._make_host(i) for i in range(n)]

    # -- vectorized generation (bench scale) ---------------------------------

    def _host_feature_matrix(self) -> np.ndarray:
        """[num_hosts, HOST_FEATURE_DIM] matching features.host_features()."""
        n = self.num_hosts
        out = np.zeros((n, 12), dtype=np.float32)
        out[:, 0] = self.cpu_load
        out[:, 1] = self.mem_load
        out[:, 2] = self.disk_load
        out[:, 3] = np.log1p(self.tcp_conns)
        out[:, 4] = np.log1p(self.upload_conns)
        out[:, 5] = np.minimum(self.concurrent_uploads / np.maximum(self.upload_limit, 1), 4.0)
        out[:, 6] = 1.0 - np.minimum(self.upload_failed / np.maximum(self.upload_count, 1), 1.0)
        out[:, 7] = np.log1p(self.upload_count)
        out[:, 8] = (self.host_type == 0).astype(np.float32)
        out[:, 9] = (self.host_type == 1).astype(np.float32)
        return out

    def _bucket_table(self) -> np.ndarray:
        """crc32 hash buckets per host — the SAME node keys as the
        record-level path (features.host_bucket), so vectorized bench data
        and record-level data index one node space."""
        if not hasattr(self, "_bucket_cache"):
            from .features import host_bucket

            self._bucket_cache = np.array(
                [host_bucket(h.id) for h in self.hosts], dtype=np.float32
            )
        return self._bucket_cache

    def _location_affinity_vec(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # location = region|zone|rack (3 segments)
        same_region = (self.region[a] == self.region[b]).astype(np.float32)
        same_zone = same_region * (self.zone[a] == self.zone[b]).astype(np.float32)
        same_rack = same_zone * ((a % 8) == (b % 8)).astype(np.float32)
        return (same_region + same_zone + same_rack) / 3.0

    def generate_feature_rows(self, n_rows: int, seed: Optional[int] = None) -> np.ndarray:
        """Vectorized batch of training rows in DOWNLOAD_COLUMNS layout."""
        r = np.random.default_rng(seed) if seed is not None else self.rng
        host_f = self._host_feature_matrix()
        parent = r.integers(0, self.num_hosts, n_rows)
        child = r.integers(0, self.num_hosts, n_rows)
        bump = (parent == child).astype(np.int64)
        child = (child + bump) % self.num_hosts

        bw = self._bandwidth_vec(parent, child)
        n_pieces = r.integers(1, 11, n_rows)
        piece_len = np.full(n_rows, PIECE_SIZE, dtype=np.float64)
        content_length = np.exp(r.normal(math.log(256e6), 1.0, n_rows))
        total_pieces = np.maximum(content_length // PIECE_SIZE, 1)
        parent_cost_s = n_pieces * piece_len / bw

        edge = np.zeros((n_rows, 8), dtype=np.float32)
        edge[:, 0] = (self.idc[parent] == self.idc[child]).astype(np.float32)
        edge[:, 1] = self._location_affinity_vec(child, parent)
        edge[:, 2] = np.log1p(n_pieces)
        edge[:, 3] = np.log1p(piece_len)
        edge[:, 4] = np.log1p(content_length)
        edge[:, 5] = np.minimum(n_pieces / total_pieces, 1.0)
        edge[:, 6] = np.log1p(parent_cost_s)
        edge[:, 7] = np.log1p(n_pieces)

        target = np.log1p(bw).astype(np.float32)[:, None]
        buckets = self._bucket_table()
        src_b = buckets[parent][:, None]
        dst_b = buckets[child][:, None]
        return np.concatenate(
            [src_b, dst_b, host_f[child], host_f[parent], edge, target], axis=1
        ).astype(np.float32)

    def probe_edges(self, density: float = 0.1, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Random directed probe edges: (senders, receivers, rtt_ns). No self loops."""
        r = np.random.default_rng(seed)
        n_edges = int(self.num_hosts * max(self.num_hosts - 1, 1) * density)
        n_edges = max(n_edges, self.num_hosts)
        src = r.integers(0, self.num_hosts, n_edges)
        dst = r.integers(0, self.num_hosts, n_edges)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        return src, dst, self._rtt_vec(src, dst)
