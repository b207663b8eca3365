"""Synthetic cluster with ground-truth bandwidth: the host latents.

A latent cluster model whose per-edge bandwidth is a deterministic
function of latent host capacities, load and topology plus noise.  This
package keeps the host latents (the announce swarm and the serving
smoke run build their hosts from them), the bandwidth and RTT ground
truth, the host feature matrix and the probe graph (the GAT trainer's
inputs).  The record-level and vectorized training-row generators wait
for the MLP trainer.  Every draw happens in the JAX package's order, so
one seed gives the same cluster, probe edges and noise in both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..utils import idgen

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
